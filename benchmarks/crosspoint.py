"""Cross-point continuation vs per-point continuation (round 3, item 7).

The round-2 waterfall record (waterfall.md) measured a 12-18% tail
drain at 6000 trials: each point's last generation runs ~max_iterations
with mostly-empty lanes.  Cross-point continuation
(sim.continuation._continuation_core with P > 1) lets drained lanes
host the NEXT point's trials, so only the final point of a sweep pays a
drain.  Statistics are bit-identical (tests/test_continuation.py).

Measures, interleaved in one process: per-point continuation dispatches
(P separate programs) vs one cross-point program, for the
window QBER 0.0825-0.085 at 6000 trials.

Usage (on the GPU): python benchmarks/crosspoint.py [--trials 6000]
Findings: appended to benchmarks/waterfall.md.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--mesh", action="store_true",
                    help="run through the sharded continuation path "
                    "(trial mesh over all local devices)")
    args = ap.parse_args()

    from benchmarks._timing import load_flagship
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.sim.continuation import dispatch_sweep_continuation
    from qkd_ldpc_tpu.sim.stats import PointPartials, partials_from_stacked
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    code = load_flagship().to_device()
    opts = DecodeOptions(max_iterations=100, message_dtype="bfloat16")
    qbers = [0.08, 0.0825, 0.085]
    master = jax.random.PRNGKey(777)
    keys = [jax.random.fold_in(master, i) for i in range(len(qbers))]
    mesh = None
    if args.mesh:
        from qkd_ldpc_tpu.parallel.mesh import make_trial_mesh

        mesh = make_trial_mesh()
    print(f"device: {jax.devices()[0]}  {code}", file=sys.stderr)
    print(f"qbers={qbers} trials={args.trials} batch={args.batch} "
          f"mesh={dict(mesh.shape) if mesh else None}")

    def fetch_all(futs):
        return [
            PointPartials().merge(partials_from_stacked(f[0].fetch()))
            for f in futs
        ]

    def per_point():
        parts = []
        for k, q in zip(keys, qbers):
            futs, _ = dispatch_sweep_continuation(
                code, [k], [q], args.trials, args.batch, opts, mesh=mesh
            )
            parts += fetch_all(futs)
        return parts

    def cross_point():
        futs, _ = dispatch_sweep_continuation(
            code, keys, qbers, args.trials, args.batch, opts, mesh=mesh
        )
        return fetch_all(futs)

    # warm-up / compile both programs, and check statistics agree
    ref = per_point()
    out = cross_point()
    assert out == ref, "cross-point statistics diverged!"
    fers = [1 - p.n_ldpc / p.n_trials for p in ref]
    print("FER per point:", [f"{f:.3f}" for f in fers])

    t_pp, t_cp = [], []
    for _ in range(args.rounds):
        t0 = time.perf_counter(); per_point(); t_pp.append(time.perf_counter() - t0)
        t0 = time.perf_counter(); cross_point(); t_cp.append(time.perf_counter() - t0)
    pp, cp = float(np.median(t_pp)), float(np.median(t_cp))
    total = len(qbers) * args.trials
    print(f"per-point : {pp:.3f} s  ({total/pp:.0f} trials/s)")
    print(f"cross-point: {cp:.3f} s  ({total/cp:.0f} trials/s)  "
          f"speedup {pp/cp:.3f}x")


if __name__ == "__main__":
    main()
