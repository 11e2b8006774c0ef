"""QC roll routing vs general gather routing, on the card.

A QC code (codes.qc) can route messages with static block rolls instead
of general row gathers.  This harness measures, interleaved in ONE
process:

1. full decode iteration, unstructured flagship, gather routing
   (the round-2 operating point),
2. full decode iteration, QC code (matched N/R/profile), gather routing
   (isolates code-structure effects from routing effects),
3. full decode iteration, QC code, ROLL routing (decoder/qc_routing),
4. end-to-end sweep-chunk throughput (keygen+channel+decode+stats) on
   the QC code, roll vs gather, at the bench.py operating point.

Usage (on the GPU): python benchmarks/qc.py [--batch 512] [--z 512]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks._timing import load_flagship, timed


def _undecodable_iter_time(code, opts, B, reps, rng):
    """ms per decode iteration with every frame running all `reps`
    iterations (random high-weight syndrome: no convergence)."""
    from qkd_ldpc_tpu.decoder.bp import _bp_decode_jit

    N, M = code.n_vars, code.n_checks
    syn = jnp.asarray(rng.integers(0, 2, (M, B)), jnp.int8)
    llr = jnp.asarray(rng.normal(2, 1, (N, B)), jnp.float32)
    o = dataclasses.replace(opts, max_iterations=reps)

    def full():
        return _bp_decode_jit(code, llr, syn, o)[1]

    it = np.asarray(full())
    assert int(it.min()) == reps, "expected no convergence"
    return timed(full) / reps


def _e2e_chunk_rate(code, opts, B, reps, qber):
    """End-to-end trials/s at the bench.py operating point (one fused
    scan-chained program: keygen + channel + decode + stats)."""
    from bench import _sweep_chunk
    from qkd_ldpc_tpu.channel.keys import num_errors_for

    n_err = num_errors_for(code.n_vars, qber)
    key = jax.random.fold_in(jax.random.PRNGKey(777), 0)

    def chunk(start):
        return _sweep_chunk(
            code, key, jnp.asarray(n_err, jnp.int32),
            jnp.asarray(start, jnp.int32), B, reps, opts,
        )

    np.asarray(chunk(0))  # compile + warm
    t0 = time.perf_counter()
    pending = [chunk((k + 1) * B * reps) for k in range(3)]
    accs = [np.asarray(p) for p in pending]
    dt = (time.perf_counter() - t0) / 3
    n_sp = sum(int(a[1]) for a in accs)
    return B * reps / dt, n_sp / (3 * B * reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--z", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--alg", default="sum-product")
    ap.add_argument("--reps", type=int, default=150)
    ap.add_argument("--skip-e2e", action="store_true")
    args = ap.parse_args()

    from qkd_ldpc_tpu.codes import make_qc_code
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    B, reps, z = args.batch, args.reps, args.z
    nb, mb = 10240 // z, 5120 // z  # N=10240, M=5120, R=0.5, dc=6

    flag = load_flagship().to_device()
    qc = make_qc_code(z=z, nb=nb, mb=mb, dv=3, seed=666).to_device()
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    print(f"flagship: {flag}", file=sys.stderr)
    print(f"qc:       {qc}", file=sys.stderr)

    base = DecodeOptions(
        max_iterations=100, message_dtype=args.dtype, algorithm=args.alg,
    )
    o_gather = dataclasses.replace(base, routing="gather")
    o_roll = dataclasses.replace(base, routing="roll")

    rng = np.random.default_rng(0)
    rows = [
        ("flagship gather", flag, o_gather),
        ("qc gather", qc, o_gather),
        ("qc roll", qc, o_roll),
    ]
    # Interleave 3 measurement passes over all rows.
    times = {label: [] for label, *_ in rows}
    for _ in range(3):
        for label, code, opts in rows:
            times[label].append(
                _undecodable_iter_time(code, opts, B, reps, rng)
            )
    t_ref = None
    for label, code, opts in rows:
        t = float(np.median(times[label]))
        E = code.n_edges
        extra = ""
        if label == "flagship gather":
            t_ref = t
        elif t_ref:
            extra = f"  ({t_ref / t:.2f}x vs flagship gather)"
        print(f"{label:18s}: {t*1e3:.3f} ms/iter  "
              f"({E*B/t/1e9:.1f} G edge-iters/s){extra}")

    if not args.skip_e2e:
        print("--- end-to-end sweep chunk (QBER 0.05, reps=24) ---")
        for label, code, opts in [("qc roll", qc, o_roll),
                                  ("qc gather", qc, o_gather),
                                  ("flagship gather", flag, o_gather)]:
            rate, sp = _e2e_chunk_rate(code, opts, B, 24, 0.05)
            ib = rate * code.n_info_bits
            print(f"{label:18s}: {rate:.1f} frames/s = {ib/1e6:.1f} "
                  f"Minfo-bits/s (SP {sp:.3f})")


if __name__ == "__main__":
    main()
