"""Rate-adaptation envelope: one mother code serving a range of QBERs.

FER vs QBER for the flagship N=10240 mother code at several
puncturing/shortening settings (d = p + s fixed at 1024 where adapted),
500 trials/point.  Shows the production story: a single code covers the
channel range that the reference needs its whole rate table of codes for.

Usage (on the GPU): python benchmarks/rate_adapt.py
"""

from __future__ import annotations

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


def main():
    from qkd_ldpc_tpu.channel.keys import introduce_errors, num_errors_for
    from qkd_ldpc_tpu.codes import make_code, read_alist
    from qkd_ldpc_tpu.decoder import DecodeOptions
    from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    code = (read_alist(REFERENCE_ALIST) if os.path.exists(REFERENCE_ALIST)
            else make_code(n=10240, m=5231, dv=3, seed=666)).to_device()
    opts = DecodeOptions(max_iterations=100, message_dtype="bfloat16")
    trials, batch = 500, 250

    settings = [
        ("p=1024 (R=0.54)", dict(n_punctured=1024)),
        ("mother (R=0.49)", dict()),
        ("s=1024 (R=0.43)", dict(n_shortened=1024)),
        ("s=2048 (R=0.36)", dict(n_shortened=2048)),
        ("s=4096 (R=0.15)", dict(n_shortened=4096)),
    ]
    qbers = [0.05, 0.07, 0.085, 0.095, 0.11, 0.14, 0.21]

    print(f"{'setting':>18} {'R_eff':>6} {'leak':>5}", end="")
    for q in qbers:
        print(f" {q:>7.3f}", end="")
    print()

    for name, kw in settings:
        ad = RateAdapter.make(code, seed=1, **kw)
        print(f"{name:>18} {ad.effective_rate:6.3f} {ad.leak_bits:>5}", end="")
        for q in qbers:
            l = ad.payload_bits
            n_err = num_errors_for(l, q)
            fails = 0
            for b in range(0, trials, batch):
                kk = jax.random.fold_in(jax.random.PRNGKey(777), b * 1000 + int(q * 1e4))
                ak = jax.random.bernoulli(kk, 0.5, (batch, l)).astype(jnp.uint8)
                bk = introduce_errors(jax.random.fold_in(kk, 1), ak, n_err)
                fr = ad.build_frames(ak, jax.random.fold_in(kk, 2))
                syn = ad.syndromes(fr)
                kh, it, ok = ad.reconcile(bk, syn, n_err / l, opts=opts)
                good = np.asarray(ok) & np.all(np.asarray(kh) == np.asarray(ak), axis=1)
                fails += int((~good).sum())
            fer = fails / trials
            print(f" {fer:7.3f}", end="", flush=True)
        print()


if __name__ == "__main__":
    main()
