"""Node-sharded per-shard compute vs the single-device decoder.

Measures the node-sharded loop's per-shard compute: a 1-device `node`
mesh on the card (collectives are self-copies) vs the single-device
dc-first decoder at EQUAL work, interleaved in one process.

Usage (on the GPU): python benchmarks/nodeshard_compute.py
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks._timing import load_flagship, timed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--alg", default="sum-product")
    args = ap.parse_args()

    import dataclasses

    from qkd_ldpc_tpu.decoder.bp import DecodeOptions, _bp_decode_jit
    from qkd_ldpc_tpu.parallel.mesh import NODE_AXIS
    from qkd_ldpc_tpu.parallel.node_sharded import _decode_node_sharded_jit
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    code = load_flagship().to_device()
    B, reps = args.batch, args.reps
    N, M = code.n_vars, code.n_checks
    rng = np.random.default_rng(0)
    # Random high-weight syndrome: no convergence, every frame runs all
    # `reps` iterations — pure per-iteration compute.
    syn = jnp.asarray(rng.integers(0, 2, (M, B)), jnp.int8)
    llr = jnp.asarray(rng.normal(2, 1, (N, B)), jnp.float32)
    opts = dataclasses.replace(
        DecodeOptions(message_dtype="bfloat16", algorithm=args.alg),
        max_iterations=reps,
    )
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), (NODE_AXIS,))

    print(f"device: {jax.devices()[0]}  {code.name}  B={B} reps={reps} "
          f"alg={args.alg}")

    def single():
        return _bp_decode_jit(code, llr, syn, opts)[1]

    def sharded():
        return _decode_node_sharded_jit(code, llr, syn.astype(jnp.int32),
                                        opts, mesh1)[1]

    assert int(np.asarray(single()).min()) == reps
    assert int(np.asarray(sharded()).min()) == reps

    t_s, t_n = [], []
    for _ in range(3):
        t_s.append(timed(single) / reps)
        t_n.append(timed(sharded) / reps)
    ts, tn = float(np.median(t_s)), float(np.median(t_n))
    print(f"single-device decoder    : {ts*1e3:.3f} ms/iter")
    print(f"node-sharded (1-dev mesh): {tn*1e3:.3f} ms/iter  "
          f"ratio {tn/ts:.2f}x")


if __name__ == "__main__":
    main()
