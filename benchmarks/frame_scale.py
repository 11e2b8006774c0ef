"""Frame-size scaling on one chip: full pipeline throughput vs N.

Generated production-profile codes (column-regular dv=3, R~0.49), QBER
0.05, sum-product bf16, scan-chained reps.  Rows wider than the channel
kernel's block (channel.pallas_select.MAX_KERNEL_COLS) take the XLA
threshold search (channel.keys.kth_threshold_impl).

Usage (on the GPU): python benchmarks/frame_scale.py
"""

from __future__ import annotations

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import argparse

    from qkd_ldpc_tpu.channel.keys import num_errors_for
    from qkd_ldpc_tpu.codes import make_code, make_qc_code
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.sim.runner import _point_chunk_step
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--qc", action="store_true",
                    help="quasi-cyclic codes at each size (roll routing)")
    args = ap.parse_args()

    enable_compilation_cache()
    opts = DecodeOptions(max_iterations=100, message_dtype="bfloat16")
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    print(f"{'N':>8} {'M':>7} {'batch':>6} {'frames/s':>9} "
          f"{'Minfo-bits/s':>12} {'mean iters':>10}")
    # QC variants keep nb <= 128 so the unrolled roll program stays
    # compile-tractable (z grows with N instead).
    qc_shapes = {
        10240: dict(z=512, nb=20, mb=10),
        65536: dict(z=1024, nb=64, mb=32),
        262144: dict(z=2048, nb=128, mb=65),
    }
    for n, m, batch, reps in ((10240, 5231, 512, 24),
                              (65536, 33481, 256, 8),
                              (262144, 133924, 128, 4)):
        if args.qc:
            q = qc_shapes[n]
            code = make_qc_code(dv=3, seed=1, **q)
            n, m = code.n_vars, code.n_checks
            code = code.to_device()
        else:
            code = make_code(
                n=n, m=m, dv=3, seed=1, name=f"scale-{n}"
            ).to_device()
        n_err = num_errors_for(n, 0.05)
        key = jax.random.fold_in(jax.random.PRNGKey(777), 0)

        def chunk(off):
            out = _point_chunk_step(
                code, key, jnp.asarray(n_err, jnp.int32),
                jnp.asarray(off, jnp.int32),
                jnp.asarray(batch * reps, jnp.int32), batch, reps, opts,
            )
            return np.asarray(out)

        r = chunk(0)  # compile + warm
        t0 = time.perf_counter()
        rounds = 3
        vals = [chunk((k + 1) * batch * reps) for k in range(rounds)]
        dt = (time.perf_counter() - t0) / rounds
        fps = batch * reps / dt
        n_sp = sum(int(v[1]) for v in vals)
        mean_it = sum(float(v[3]) for v in vals) / max(n_sp, 1)
        print(f"{n:>8} {m:>7} {batch:>6} {fps:9.0f} "
              f"{fps * (n - m) / 1e6:12.1f} {mean_it:10.2f}")


if __name__ == "__main__":
    main()
