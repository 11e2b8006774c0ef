"""bf16 message-storage FER bias at the waterfall (>=10^4 trials/point).

f32 and bf16 runs use IDENTICAL trials (same point keys, same channel
realizations) so the comparison is paired: the reported delta is the
count of trials whose outcome flipped, not two independent MC estimates.

Usage (on the GPU): python benchmarks/bf16_bias.py [--trials 10000]
Writes the table for PARITY.md / benchmarks/waterfall.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import jax

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
    ap.add_argument("--trials", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=512)
    args = ap.parse_args()

    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.sim.runner import run_point
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    code = _load_flagship().to_device()
    base = DecodeOptions(max_iterations=100)
    trials = args.trials
    print(f"device: {jax.devices()[0]}  trials={trials}", file=sys.stderr)

    print(f"{'QBER':>7} | {'FER f32':>9} {'FER bf16':>9} {'dFER':>9} "
          f"{'1sigma':>8} | {'meanIt f32':>10} {'meanIt bf16':>11}")
    for i, q in enumerate([0.080, 0.085, 0.0875, 0.090]):
        key = jax.random.fold_in(jax.random.PRNGKey(777), 100 + i)
        rows = {}
        for dt in ("float32", "bfloat16"):
            opts = dataclasses.replace(base, message_dtype=dt)
            p, _ = run_point(code, key, q, trials=trials, batch=args.batch,
                             opts=opts)
            rows[dt] = p
        f, b = rows["float32"], rows["bfloat16"]
        fer_f = 1 - f.n_ldpc / f.n_trials
        fer_b = 1 - b.n_ldpc / b.n_trials
        # paired-trial binomial sigma on the f32 FER estimate, for scale
        sigma = (fer_f * (1 - fer_f) / trials) ** 0.5
        print(f"{q:7.4f} | {fer_f:9.4f} {fer_b:9.4f} {fer_b-fer_f:+9.4f} "
              f"{sigma:8.4f} | {f.sum_it/max(f.n_sp,1):10.2f} "
              f"{b.sum_it/max(b.n_sp,1):11.2f}")


if __name__ == "__main__":
    main()
