"""Serving latency/throughput for the Reconciler endpoint.

End-to-end host-to-host reconcile() latency (NumPy in -> NumPy out,
including padding, device transfer, decode, fetch) at several lane
widths, 50 samples per row with p50/p95.  Device-side step time is
measured by CHAINED SLOPE: two scan-chained programs of k1/k2 identical
serve steps, per-step time = the timing difference over (k2 - k1), so
the per-dispatch host latency cancels.  The full secure chain
(reconcile -> verification tags -> privacy amplification) is measured
alongside.

Usage (on the GPU): python benchmarks/serving.py [--samples 50]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ALIST = (
    "/root/reference/alist_sparse_matrices/"
    "(N=10240,M=5231,R=0.49,CW=3,SEED=666).txt"
)


def _percentiles(lat):
    a = np.asarray(lat) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 95))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--qc", action="store_true",
                    help="serve the QC z=512 code (roll routing)")
    ap.add_argument("--schedule", default="flooding",
                    choices=("flooding", "layered"),
                    help="decode schedule (layered needs --qc; fewer "
                         "sweeps -> lower tail latency is the hypothesis)")
    args = ap.parse_args()
    if args.schedule == "layered" and not args.qc:
        ap.error("--schedule layered requires --qc")

    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.codes import make_code, make_qc_code, read_alist
    from qkd_ldpc_tpu.decoder import DecodeOptions
    from qkd_ldpc_tpu.serve import Reconciler
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    if args.qc:
        code = make_qc_code(z=512, nb=20, mb=10, dv=3, seed=666)
    elif os.path.exists(REFERENCE_ALIST):
        code = read_alist(REFERENCE_ALIST)
    else:
        code = make_code(n=10240, m=5231, dv=3, seed=666)

    print(f"device: {jax.devices()[0]}  code: {code.name}  "
          f"samples={args.samples}", file=sys.stderr)

    qber = 0.04
    n_err = num_errors_for(code.n_vars, qber)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(1), code.n_vars, 512, jnp.asarray(n_err, jnp.int32)
    )
    alice, bob = np.asarray(alice), np.asarray(bob)

    from functools import partial

    from qkd_ldpc_tpu.serve import _serve_step

    @partial(jax.jit, static_argnames=("opts",))
    def _device_step(code, bob_d, syn_d, q, opts):
        z, it, ok = _serve_step(code, bob_d, syn_d, q, opts)
        # scalar checksum: forces the full decode without a 5 MB download
        return z.astype(jnp.int32).sum() + it.sum() + ok.sum()

    @partial(jax.jit, static_argnames=("opts", "k"))
    def _device_chain(code, bob_d, syn_d, q, opts, k):
        """k sequential serve steps in ONE program.  Device time per step
        is the SLOPE between two chain lengths — the dispatch latency
        appears once in each timing and cancels in the difference.  The carry
        feeds the next step's q as ``q + 0.0 * checksum`` — value-
        preserving (checksum is finite) but a real data dependency, so
        XLA cannot collapse the identical steps."""

        def body(carry, _):
            z, it, ok = _serve_step(code, bob_d, syn_d,
                                    q + 0.0 * carry, opts)
            s = z.astype(jnp.int32).sum() + it.sum() + ok.sum()
            return s.astype(jnp.float32), None

        out, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=k)
        return out

    print(f"{'lanes':>6} {'host p50':>9} {'host p95':>9} "
          f"{'dev p50':>8} {'dev p95':>8} {'frames/s(dev)':>13}")
    opts = DecodeOptions(message_dtype="bfloat16", schedule=args.schedule)
    q = jnp.asarray(n_err / code.n_vars, jnp.float32)
    for lanes in (1, 32, 128, 512):
        rec = Reconciler(code, opts, lanes=lanes).warmup()
        syn = rec.syndromes(alice[:lanes])
        rec.reconcile(bob[:lanes], syn, qber=n_err / code.n_vars)
        lat = []
        for _ in range(args.samples):
            t0 = time.perf_counter()
            out = rec.reconcile(bob[:lanes], syn, qber=n_err / code.n_vars)
            lat.append(time.perf_counter() - t0)
        assert out.syndromes_match.all()
        h50, h95 = _percentiles(lat)

        bob_d = jnp.asarray(bob[:lanes])
        syn_d = jnp.asarray(syn)
        k1, k2 = 4, 12
        np.asarray(_device_chain(rec.code, bob_d, syn_d, q, opts, k1))  # warm
        np.asarray(_device_chain(rec.code, bob_d, syn_d, q, opts, k2))
        dev = []
        for _ in range(max(args.samples // 4, 8)):
            t0 = time.perf_counter()
            np.asarray(_device_chain(rec.code, bob_d, syn_d, q, opts, k1))
            t1 = time.perf_counter()
            np.asarray(_device_chain(rec.code, bob_d, syn_d, q, opts, k2))
            t2 = time.perf_counter()
            dev.append(((t2 - t1) - (t1 - t0)) / (k2 - k1))
        d50, d95 = _percentiles(dev)
        rate = f"{lanes / (d50 / 1e3):13.0f}"
        print(f"{lanes:>6} {h50:7.1f}ms {h95:7.1f}ms "
              f"{d50:6.2f}ms {d95:6.2f}ms {rate}")

    # Full secure chain at the throughput lane width.
    lanes = 128
    rec = Reconciler(code, opts, lanes=lanes).warmup()
    syn = rec.syndromes(alice[:lanes])
    tk, pk = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    a_tags = rec.tags(alice[:lanes], tk)
    sec = rec.reconcile_secure(bob[:lanes], syn, n_err / code.n_vars,
                               a_tags, tk, pk)
    assert sec.verified.all()
    lat = []
    for _ in range(args.samples):
        t0 = time.perf_counter()
        rec.reconcile_secure(bob[:lanes], syn, n_err / code.n_vars,
                             a_tags, tk, pk)
        lat.append(time.perf_counter() - t0)
    s50, s95 = _percentiles(lat)
    print(f"secure chain (reconcile+verify+amplify, {lanes} lanes): "
          f"p50 {s50:.1f} ms  p95 {s95:.1f} ms  "
          f"final {sec.final_bits} bits/frame")


if __name__ == "__main__":
    main()
