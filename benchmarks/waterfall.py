"""Waterfall-region throughput: continuation batching vs the plain runner.

Measures effective trials/s at QBER points around the flagship code's
decoding threshold, interleaved in one process (the shared chip drifts),
and asserts the two runners produce BIT-IDENTICAL statistics on every
point.  Results are written up in benchmarks/waterfall.md.

Usage (on the GPU): python benchmarks/waterfall.py [--trials 2000]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ALIST = (
    "/root/reference/alist_sparse_matrices/"
    "(N=10240,M=5231,R=0.49,CW=3,SEED=666).txt"
)


def _load_flagship():
    from qkd_ldpc_tpu.codes import make_code, read_alist

    if os.path.exists(REFERENCE_ALIST):
        return read_alist(REFERENCE_ALIST)
    return make_code(n=10240, m=5231, dv=3, seed=666, name="flagship-n10240")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--segment", type=int, default=4)
    ap.add_argument("--refill-frac", type=float, default=0.125)
    args = ap.parse_args()

    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.sim.continuation import run_point_continuation
    from qkd_ldpc_tpu.sim.runner import run_point
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    code = _load_flagship().to_device()
    opts = DecodeOptions(max_iterations=100, message_dtype="bfloat16")
    trials, batch = args.trials, args.batch
    print(f"device: {jax.devices()[0]}  trials={trials} batch={batch} "
          f"segment={args.segment}", file=sys.stderr)

    qbers = [0.0775, 0.08, 0.0825, 0.085, 0.0875, 0.09]
    print(f"{'QBER':>7} {'FER':>6} {'meanIt':>7} | {'plain tr/s':>10} "
          f"{'cont tr/s':>10} {'speedup':>8} | stats")
    for i, q in enumerate(qbers):
        key = jax.random.fold_in(jax.random.PRNGKey(777), i)

        # warm-up both compiles at the REAL chunk shapes (a different
        # trial count compiles a different scan length for the plain
        # runner; without this the first timed point eats a compile)
        run_point(code, key, q, trials=trials, batch=batch, opts=opts)
        run_point_continuation(code, key, q, trials=batch, batch=batch,
                               opts=opts, segment=args.segment,
                               refill_frac=args.refill_frac)

        t0 = time.perf_counter()
        p1, _ = run_point(code, key, q, trials=trials, batch=batch, opts=opts)
        t_plain = time.perf_counter() - t0

        t0 = time.perf_counter()
        p2, _ = run_point_continuation(
            code, key, q, trials=trials, batch=batch, opts=opts,
            segment=args.segment, refill_frac=args.refill_frac,
        )
        t_cont = time.perf_counter() - t0

        same = (p1 == p2)
        fer = 1.0 - p1.n_ldpc / p1.n_trials
        mean_it = p1.sum_it / max(p1.n_sp, 1)
        print(f"{q:7.4f} {fer:6.3f} {mean_it:7.1f} | {trials/t_plain:10.0f} "
              f"{trials/t_cont:10.0f} {t_plain/t_cont:7.2f}x | "
              f"{'IDENTICAL' if same else 'MISMATCH ' + str((p1, p2))}")
        assert same, f"statistics diverged at QBER {q}"


if __name__ == "__main__":
    main()
