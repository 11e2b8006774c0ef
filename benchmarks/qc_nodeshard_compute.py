"""QC node-sharded per-shard compute vs the single-device decoder.

Per-shard ms/iteration of the QC-structured node-sharded decoder
(parallel.qc_node_sharded — block rolls, complement-product
leave-one-out, no segment ops/logs) and of the general node-sharded
decoder, against the single-device decoder at EQUAL per-shard work.

Method matches benchmarks/nodeshard_compute.py: a 1-device ``node``
mesh on the card (collectives are self-copies, so this isolates
per-shard COMPUTE), random high-weight syndromes so every frame runs
all ``reps`` iterations, interleaved single-process timing.

Usage (on the GPU): python benchmarks/qc_nodeshard_compute.py
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

from benchmarks._timing import timed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--alg", default="sum-product")
    ap.add_argument("--z", type=int, default=512)
    ap.add_argument("--nb", type=int, default=20)
    ap.add_argument("--mb", type=int, default=10)
    ap.add_argument("--skip-general", action="store_true",
                    help="skip the general node-sharded leg (slow compile)")
    args = ap.parse_args()

    import dataclasses

    from qkd_ldpc_tpu.codes import make_qc_code
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions, _bp_decode_jit
    from qkd_ldpc_tpu.parallel.mesh import NODE_AXIS
    from qkd_ldpc_tpu.parallel.node_sharded import _decode_node_sharded_jit
    from qkd_ldpc_tpu.parallel.qc_node_sharded import (
        _decode_qc_node_sharded_jit,
    )
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    # The shipping QC flagship (bench.py): z=512, nb=20, mb=10, girth>=6.
    code = make_qc_code(
        z=args.z, nb=args.nb, mb=args.mb, dv=3, seed=666
    ).to_device()
    B, reps = args.batch, args.reps
    N, M = code.n_vars, code.n_checks
    rng = np.random.default_rng(0)
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

    def qc_sharded():
        return _decode_qc_node_sharded_jit(
            code, llr, syn.astype(jnp.int32), opts, mesh1
        )[1]

    def gen_sharded():
        return _decode_node_sharded_jit(
            code, llr, syn.astype(jnp.int32), opts, mesh1
        )[1]

    opts_lay = dataclasses.replace(opts, schedule="layered")

    def single_layered():
        return _bp_decode_jit(code, llr, syn, opts_lay)[1]

    def qc_sharded_layered():
        return _decode_qc_node_sharded_jit(
            code, llr, syn.astype(jnp.int32), opts_lay, mesh1
        )[1]

    legs = {"single-device decoder": single,
            "QC node-sharded (1-dev)": qc_sharded,
            # Round 5: the layered x node-sharded composition's per-shard
            # sweep cost (one sweep = mb serial layers = one flooding
            # iteration's edge work; ~half the sweeps to converge).
            "single-device layered": single_layered,
            "QC node-sharded layered": qc_sharded_layered}
    if not args.skip_general:
        legs["general node-sharded"] = gen_sharded

    for name, fn in legs.items():
        assert int(np.asarray(fn()).min()) == reps, name
        print(f"compiled {name}", file=sys.stderr, flush=True)

    times = {name: [] for name in legs}
    for _ in range(3):  # interleave legs
        for name, fn in legs.items():
            times[name].append(timed(fn) / reps)
    base = float(np.median(times["single-device decoder"]))
    for name in legs:
        t = float(np.median(times[name]))
        print(f"{name:>26}: {t*1e3:.3f} ms/iter  ratio {t/base:.2f}x")


if __name__ == "__main__":
    main()
