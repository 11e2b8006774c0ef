"""Privacy-amplification throughput at production frame sizes (round 3).

The dense Toeplitz path materializes T [n_out, n_in]: at N=262,144 that
is ~61 GB bf16 — it cannot exist on device (the round-2 weakness).  The
round-3 streaming block-Toeplitz path (postprocess._hash_apply_blocked)
builds T one VMEM block at a time from the seed sequence and consumes
it with MXU matmuls; peak memory is O(n).  This harness measures it at
the frame sizes the decoder itself serves (benchmarks/frame_scale.py),
plus the dense path where it fits for comparison.

Usage (on the GPU): python benchmarks/amplify.py
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
    from qkd_ldpc_tpu.postprocess import toeplitz_hash
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(7)
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    print(f"{'n_in':>8} {'n_out':>8} {'B':>4} {'method':>8} "
          f"{'ms/call':>8} {'Gbit/s in':>9}")

    cases = [
        (10_240, 4_845, 128, "dense", 512),   # flagship secure-chain shape
        (10_240, 4_845, 128, "blocked", 512),
        (65_536, 31_000, 32, "blocked", 512),
        (262_144, 125_000, 8, "blocked", 512),  # frame_scale.py's largest
        (262_144, 125_000, 32, "blocked", 256),
        (262_144, 125_000, 32, "blocked", 512),
        (262_144, 125_000, 32, "blocked", 1024),
    ]
    for n_in, n_out, B, method, bo in cases:
        bits = jnp.asarray(
            rng.integers(0, 2, (B, n_in), dtype=np.uint8)
        )
        out = toeplitz_hash(bits, key, n_out, method=method, block_out=bo)
        np.asarray(out)  # compile + warm
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            np.asarray(toeplitz_hash(bits, key, n_out, method=method,
                                     block_out=bo))
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts))
        print(f"{n_in:>8} {n_out:>8} {B:>4} {method:>8}/bo={bo:<5} "
              f"{t*1e3:8.1f} {B*n_in/t/1e9:9.2f}")


if __name__ == "__main__":
    main()
