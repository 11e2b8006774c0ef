"""Shared helpers of the benchmark scripts: the flagship code and a timer."""

from __future__ import annotations

import os
import time

import jax
import numpy as np

FLAGSHIP_ALIST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "alist_sparse_matrices", "(N=10240,M=5231,R=0.49,CW=3,GEN=666).alist",
)


def load_flagship():
    """The committed N=10240 flagship alist (data/alist_sparse_matrices)."""
    from qkd_ldpc_tpu.codes import read_alist

    return read_alist(FLAGSHIP_ALIST)


def timed(fn, rounds=5):
    """Median wall time of fn(), each call ended by a host fetch."""
    np.asarray(jax.tree.leaves(fn())[0])  # warm-up + compile
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        np.asarray(jax.tree.leaves(fn())[0])
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
