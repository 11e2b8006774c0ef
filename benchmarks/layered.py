"""Layered vs flooding schedule on hardware (round 4).

Two questions, answered interleaved in ONE process (the shared chip
drifts +-20%; memory: never ship an op-level win without an
interleaved full-program measurement):

1. **Per-sweep cost**: ms per layered sweep vs ms per flooding
   iteration at equal edge work, with every frame forced to run all
   ``reps`` sweeps (undecodable random syndromes).  The layered sweep
   is mb sequential layer steps of XLA-level roll/stack ops; flooding
   is one fused iteration — layered buys its ~1.7x iteration reduction
   only if its sweep doesn't cost ~1.7x more.
2. **End-to-end**: the bench.py sweep chunk (keygen + channel + decode
   + stats) under BOTH schedules, interleaved, plus convergence stats
   (the layered chunk should show mean sweeps ~3.5 vs flooding's ~6.8
   at QBER 0.05 — the CPU-measured ratio).

Usage (on the GPU): python benchmarks/layered.py [--batch 512]
Findings: benchmarks/layered.md.
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


def _undecodable(code, opts, B, reps, seed):
    """ms per iteration with every frame running all `reps` iterations:
    random high-weight syndromes are (w.h.p.) undecodable, so the
    while_loop never exits early and the timing is pure iteration cost."""
    from qkd_ldpc_tpu.decoder.bp import bp_decode_batch_last

    rng = np.random.default_rng(seed)
    llr = jnp.asarray(rng.normal(0, 2, (code.n_vars, B)).astype(np.float32))
    syn = jnp.asarray(rng.integers(0, 2, (code.n_checks, B)), jnp.int32)
    o = dataclasses.replace(opts, max_iterations=reps)

    @jax.jit
    def run(llr, syn):
        z, it, ok = bp_decode_batch_last(code, llr, syn, o)
        return z.astype(jnp.int32).sum() + it.sum()

    np.asarray(run(llr, syn))  # compile + warm
    return run, llr, syn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--samples", type=int, default=7)
    args = ap.parse_args()

    from qkd_ldpc_tpu.codes import make_qc_code
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    code = make_qc_code(z=512, nb=20, mb=10, dv=3, seed=666).to_device()
    B, reps = args.batch, args.reps
    print(f"device: {jax.devices()[0]}  B={B} reps={reps}", file=sys.stderr)

    base = DecodeOptions(max_iterations=100, message_dtype="bfloat16")
    runs = {}
    for name, o in (("flooding", base),
                    ("layered", dataclasses.replace(base, schedule="layered"))):
        runs[name] = _undecodable(code, o, B, reps, seed=17)

    # Interleaved per-iteration timing.
    per_iter = {k: [] for k in runs}
    for s in range(args.samples):
        for name, (run, llr, syn) in runs.items():
            t0 = time.perf_counter()
            np.asarray(run(llr, syn))
            dt = time.perf_counter() - t0
            per_iter[name].append(dt / reps * 1e3)
    for name, v in per_iter.items():
        print(f"{name:9s}: {np.median(v):.3f} ms/iteration "
              f"(min {np.min(v):.3f}, n={len(v)})")

    # End-to-end bench chunk, interleaved (bench.py's program shape).
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench as bench_mod

    from qkd_ldpc_tpu.channel.keys import master_key, num_errors_for
    from qkd_ldpc_tpu.sim.stats import STAT_KEYS

    n_err = num_errors_for(code.n_vars, 0.05)
    key = jax.random.fold_in(master_key(777), 0)
    chunk_reps = 24
    e2e = {}
    # Layered converges in ~half the sweeps, so its compaction point is
    # half of flooding's (bit-identity: test_layered_compaction_bit_identical).
    for name, o in (("flooding", dataclasses.replace(
                        base, compact_after=8, compact_lanes=B // 4)),
                    ("layered", dataclasses.replace(base, schedule="layered")),
                    ("lay+cmp", dataclasses.replace(
                        base, schedule="layered",
                        compact_after=4, compact_lanes=B // 4))):
        out = bench_mod._sweep_chunk(
            code, key, jnp.asarray(n_err, jnp.int32),
            jnp.asarray(0, jnp.int32), B, chunk_reps, o)
        v = dict(zip(STAT_KEYS, np.asarray(out).tolist()))  # warm + stats
        e2e[name] = dict(opts=o, stats=v, times=[])
        mean_it = v["sum_it"] / max(v["n_sp"], 1)
        print(f"{name:9s} e2e warm: SP {int(v['n_sp'])}/{B*chunk_reps} "
              f"mean iters {mean_it:.2f}", file=sys.stderr)
    for s in range(args.samples):
        for name, d in e2e.items():
            t0 = time.perf_counter()
            np.asarray(bench_mod._sweep_chunk(
                code, key, jnp.asarray(n_err, jnp.int32),
                jnp.asarray((s + 1) * B * chunk_reps, jnp.int32),
                B, chunk_reps, d["opts"]))
            d["times"].append(time.perf_counter() - t0)
    for name, d in e2e.items():
        dt = float(np.median(d["times"]))
        fps = B * chunk_reps / dt
        print(f"{name:9s} e2e: {dt:.3f} s/chunk = {fps:.0f} frames/s = "
              f"{fps * code.n_info_bits / 1e6:.1f} Minfo-bits/s")


if __name__ == "__main__":
    main()
