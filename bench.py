"""Headline benchmark: decoded info-bits/s on one GPU, N=10240 codes.

Reproduces the reference's measured operating point (BASELINE.md): an
N=10240 R~0.49 column-weight-3 code at QBER 0.05, sum-product with
100-iteration cap and LLR clamp 100.0.  The reference decodes
0.0117 s/frame single-core => ~428,000 info-bits/s (K=5009); vs_baseline
is measured against that number.

``BENCH_CODE`` picks the code: ``qc`` (default; the quasi-cyclic
construction at matched N/R/profile, z=512, girth >= 6 — FER parity vs
the random ensemble in benchmarks/qc_parity.md), ``qc-ref`` (the QC
family at the reference's own rate profile) or ``flagship`` (the
committed generated alist in data/alist_sparse_matrices).

The timed region is the full production pipeline per trial batch: key
generation, exact-weight error injection, a-priori LLRs, Alice syndrome,
batched BP decode with early exit, keys-match check, stats reduction.
All ``reps`` batches are chained sequentially inside one jitted program
(lax.scan) and the final scalars are fetched to host, which forces
completion.

Runs on the GPU only: elsewhere it exits non-zero.  The device identity
(platform, device kind, count, card name and power limit) goes to stderr
before the one JSON line on stdout.
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_INFO_BITS_PER_S = 428_000.0  # reference @ QBER 0.05, 1 CPU core
QBER = 0.05
FLAGSHIP_ALIST = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data",
    "alist_sparse_matrices", "(N=10240,M=5231,R=0.49,CW=3,GEN=666).alist",
)


def _load_flagship():
    from qkd_ldpc_tpu.codes import make_qc_code, read_alist

    which = os.environ.get("BENCH_CODE", "qc")
    if which == "qc":
        return make_qc_code(z=512, nb=20, mb=10, dv=3, seed=666)
    if which == "qc-ref":
        # The QC family at the reference's own rate profile: N=10240,
        # M=5248, R=0.4875, mixed 5/6 base rows — the closest QC point to
        # the reference alist's R=0.489 histogram.
        return make_qc_code(z=128, nb=80, mb=41, dv=3, seed=666)
    if which == "flagship":
        return read_alist(FLAGSHIP_ALIST)
    raise ValueError(f"unknown BENCH_CODE {which!r}")


@partial(jax.jit, static_argnames=("batch", "reps", "opts"))
def _sweep_chunk(code, point_key, n_err, start_offset, batch, reps, opts):
    """reps sequential trial batches fused into one device program.

    Returns the stacked [7] int32 stat vector so the result comes home in
    ONE device->host transfer.
    """
    from qkd_ldpc_tpu.sim.runner import merge_partials_tree, point_batch_partials
    from qkd_ldpc_tpu.sim.stats import stack_partials

    def body(carry, i):
        red = point_batch_partials(
            code, point_key, n_err, start_offset + i * batch,
            jnp.asarray(batch, jnp.int32), batch, opts,
        )
        return merge_partials_tree(carry, red), None

    init = point_batch_partials(
        code, point_key, n_err, start_offset, jnp.asarray(batch, jnp.int32),
        batch, opts,
    )
    out, _ = jax.lax.scan(body, init, jnp.arange(1, reps, dtype=jnp.int32))
    return stack_partials(out)


def _device_identity() -> str:
    """Platform, device kind and count as JAX reports them, and the card's
    name and power limit."""
    from qkd_ldpc_tpu.utils import card_identity

    devs = jax.devices()
    return (f"platform={devs[0].platform} device_kind={devs[0].device_kind} "
            f"count={len(devs)} card={card_identity()}")


def main() -> None:
    import dataclasses

    from qkd_ldpc_tpu.channel.keys import master_key, num_errors_for
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.sim.stats import STAT_KEYS
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: JAX runs on {jax.devices()[0].platform!r}, not "
                 "on a GPU; nothing to measure")
    print(_device_identity(), file=sys.stderr)
    enable_compilation_cache()

    # Device-resident adjacency: the code's host numpy leaves upload once.
    code = _load_flagship().to_device()
    opts = DecodeOptions(
        max_iterations=100, clip_messages=True, message_threshold=100.0,
        algorithm=os.environ.get("BENCH_ALG", "sum-product"),
        # bf16 message storage (f32 compute): waterfall FER bias measured
        # below Monte-Carlo resolution at 10^4 paired trials/point
        # (PARITY.md).  "float32" and "int8" are also accepted.
        message_dtype=os.environ.get("BENCH_DTYPE", "bfloat16"),
    )
    batch = int(os.environ.get("BENCH_BATCH", "512"))
    reps = int(os.environ.get("BENCH_REPS", "24"))
    # Residency compaction (bit-identical results; schedule only):
    # BENCH_COMPACT=0 disables it.
    compact = int(os.environ.get("BENCH_COMPACT", "8"))
    if compact:
        opts = dataclasses.replace(
            opts, compact_after=compact, compact_lanes=batch // 4
        )
    # BENCH_SCHEDULE=layered: serial check-layered sweeps (a different
    # trajectory family than the reference's flooding schedule; fewer
    # sweeps at equal-or-better FER, benchmarks/layered.md).  Layered
    # converges in ~half the sweeps, so the compaction point is halved.
    schedule = os.environ.get("BENCH_SCHEDULE", "flooding")
    if schedule != "flooding":
        opts = dataclasses.replace(
            opts, schedule=schedule,
            compact_after=max(compact // 2, 1) if compact else 0,
        )
    n_err = num_errors_for(code.n_vars, QBER)
    point_key = jax.random.fold_in(master_key(777), 0)
    print(f"code: {code}, batch={batch}, reps={reps}, alg={opts.algorithm}, "
          f"dtype={opts.message_dtype}, compact={compact}, "
          f"schedule={opts.schedule}", file=sys.stderr)

    def chunk(start):
        return _sweep_chunk(
            code, point_key, jnp.asarray(n_err, jnp.int32),
            jnp.asarray(start, jnp.int32), batch, reps, opts,
        )

    r = dict(zip(STAT_KEYS, np.asarray(chunk(0)).tolist()))  # compile
    print(
        f"warmup: SP success {int(r['n_sp'])}/{batch * reps}, "
        f"mean iters {float(r['sum_it']) / max(int(r['n_sp']), 1):.2f}",
        file=sys.stderr,
    )

    rounds = int(os.environ.get("BENCH_ROUNDS", "5"))
    # Steady-state throughput: dispatch ALL chunks up front (XLA queues
    # them back-to-back on device), then fetch in order, so per-dispatch
    # host latency overlaps device compute.
    t0 = time.perf_counter()
    pending = [chunk((k + 1) * batch * reps) for k in range(rounds)]
    accs = [dict(zip(STAT_KEYS, np.asarray(p).tolist())) for p in pending]
    dt = (time.perf_counter() - t0) / rounds

    trials = batch * reps
    frames_per_s = trials / dt
    info_bits_per_s = frames_per_s * code.n_info_bits
    n_sp = sum(int(a["n_sp"]) for a in accs)
    mean_it = sum(float(a["sum_it"]) for a in accs) / max(n_sp, 1)
    print(
        f"{trials} trials/chunk x {rounds} pipelined chunks, "
        f"{dt:.3f}s/chunk = {frames_per_s:.1f} frames/s, "
        f"{info_bits_per_s / 1e6:.2f} Minfo-bits/s, "
        f"SP success {n_sp}/{rounds * trials}, mean iters {mean_it:.2f}",
        file=sys.stderr,
    )

    print(
        json.dumps(
            {
                "metric": "decoded_info_bits_per_s_n10240_qber05",
                "value": round(info_bits_per_s, 1),
                "unit": "info-bits/s",
                "vs_baseline": round(info_bits_per_s / BASELINE_INFO_BITS_PER_S, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
