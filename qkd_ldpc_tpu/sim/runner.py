"""Monte-Carlo sweep orchestration.

Device-side replacement for the reference's batch simulator
(``QKD_LDPC_batch_simulation``, ``src/simulation.cpp:192-316``).  Where the
reference fork-joins a CPU thread pool over trials (one decode per thread),
here a whole trial batch is one jitted device program: key generation,
exact-weight error injection, syndrome computation, batched BP decode, and
the statistics reduction all fuse into a single XLA executable whose only
host traffic is seven scalars per batch.

Additions over the reference (SURVEY.md §5 gaps):

- **Checkpoint/resume**: each completed (matrix, QBER) point appends a JSON
  line; an interrupted sweep resumes where it stopped (the reference loses
  a dying 5000-trial sweep entirely — CSV is written only at the very end,
  ``src/main.cpp:51``).
- **Determinism contract**: point key = fold_in(master_seed, global point
  index); trial t = fold_in(point_key, t) — reproducible independent of
  batch size or sharding (the analog of ``seeds[k] + curr_sim``,
  simulation.cpp:247).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu.codes import LDPCCode, load_code, list_matrix_files
from qkd_ldpc_tpu.config import Config
from qkd_ldpc_tpu.decoder.bp import DecodeOptions
from qkd_ldpc_tpu.decoder.reconcile import reconcile
from qkd_ldpc_tpu.sim.planner import rate_based_qber_range
from qkd_ldpc_tpu.sim.progress import ProgressBar
from qkd_ldpc_tpu.sim.stats import (
    PointPartials,
    SimResult,
    finalize_point,
    partials_from_stacked,
    reduce_trials,
    stack_partials,
)


@dataclasses.dataclass
class SimInput:
    """One matrix plus its planned QBER sweep (reference ``sim_input``,
    ``src/simulation.hpp:16-21``)."""

    code: LDPCCode
    matrix_filename: str
    qber: list[float]


def decode_options_from_config(cfg: Config) -> DecodeOptions:
    return DecodeOptions(
        max_iterations=cfg.sum_product_max_iterations,
        clip_messages=cfg.enable_sum_product_msg_llr_threshold,
        message_threshold=cfg.sum_product_msg_llr_threshold,
        algorithm=cfg.decoder,
        min_sum_alpha=cfg.min_sum_alpha,
        min_sum_beta=cfg.min_sum_beta,
        message_dtype=cfg.dtype,
        schedule=cfg.schedule,
    )


def prepare_sim_inputs(
    matrix_paths: Sequence[str | Path], cfg: Config
) -> list[SimInput]:
    """Load all matrices and plan their QBER sweeps
    (reference ``prepare_sim_inputs``, simulation.cpp:140-158).

    ``cfg.threads_number`` sizes the host thread pool for matrix ingest —
    this build's consumer of the reference's thread-count knob (the
    reference sizes its trial pool with it, simulation.cpp:230; here trial
    parallelism is a sharded device batch, so the host threads go to the
    remaining host-side work: parsing many alist files concurrently).
    """
    paths = list(matrix_paths)
    if cfg.threads_number > 1 and len(paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cfg.threads_number) as pool:
            codes = list(
                pool.map(lambda p: load_code(p, dense=cfg.use_dense_matrices), paths)
            )
    else:
        codes = [load_code(p, dense=cfg.use_dense_matrices) for p in paths]
    inputs = []
    for path, code in zip(paths, codes):
        qber = rate_based_qber_range(code.code_rate, cfg.r_qber_parameters)
        inputs.append(
            SimInput(code=code, matrix_filename=Path(path).name, qber=qber)
        )
    return inputs


def point_batch_partials(
    code: LDPCCode,
    point_key: jax.Array,
    num_errors: jax.Array,  # scalar int32 (traced)
    trial_offset: jax.Array,  # scalar int32 (traced)
    valid_count: jax.Array,  # scalar int32 (traced)
    batch: int,
    opts: DecodeOptions,
) -> dict[str, jax.Array]:
    """One fused device step: trials [offset, offset+batch) -> partial sums.

    Traceable (un-jitted) so callers can embed it in larger programs
    (lax.scan chains, sharded sweeps); ``_point_batch_step`` is the jitted
    entry the sequential runner uses.
    """
    alice, bob = make_trial_batch(
        point_key, code.n_vars, batch, num_errors, trial_offset
    )
    actual_qber = num_errors.astype(jnp.float32) / code.n_vars
    res = reconcile(code, alice, bob, actual_qber, opts)
    valid = jnp.arange(batch, dtype=jnp.int32) < valid_count
    return reduce_trials(
        res.syndromes_match, res.keys_match, res.iterations,
        opts.max_iterations, valid,
    )


def _point_batch_stacked(code, point_key, num_errors, trial_offset,
                         valid_count, batch, opts):
    return stack_partials(
        point_batch_partials(
            code, point_key, num_errors, trial_offset, valid_count, batch,
            opts,
        )
    )


# Stacked [7] int32 output: ONE device->host transfer per batch instead of
# seven scalar fetches.
_point_batch_step = jax.jit(
    _point_batch_stacked, static_argnames=("batch", "opts")
)


def _point_chunk(code, point_key, num_errors, start_offset, total_valid,
                 batch, n_batches, opts):
    """``n_batches`` sequential trial batches chained on-device via scan:
    one dispatch + one host fetch per chunk instead of per batch.  The
    tail batch masks its excess trials through ``valid_count``."""

    def body(carry, i):
        offset = start_offset + i * batch
        valid = jnp.clip(total_valid - i * batch, 0, batch)
        red = point_batch_partials(
            code, point_key, num_errors, offset, valid, batch, opts
        )
        return merge_partials_tree(carry, red), None

    init = point_batch_partials(
        code, point_key, num_errors, start_offset,
        jnp.clip(total_valid, 0, batch), batch, opts,
    )
    out, _ = jax.lax.scan(
        body, init, jnp.arange(1, n_batches, dtype=jnp.int32)
    )
    return stack_partials(out)


_point_chunk_step = jax.jit(
    _point_chunk, static_argnames=("batch", "n_batches", "opts")
)


def merge_partials_tree(a: dict, b: dict) -> dict:
    """Device-side merge of two partial-sum dicts (min/max-aware)."""
    return dict(
        n_trials=a["n_trials"] + b["n_trials"],
        n_sp=a["n_sp"] + b["n_sp"],
        n_ldpc=a["n_ldpc"] + b["n_ldpc"],
        sum_it=a["sum_it"] + b["sum_it"],
        sum_it2=a["sum_it2"] + b["sum_it2"],
        min_it=jnp.minimum(a["min_it"], b["min_it"]),
        max_it=jnp.maximum(a["max_it"], b["max_it"]),
    )


def _dispatch_point(
    code: LDPCCode,
    point_key: jax.Array,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    max_batches_per_dispatch: int = 64,
) -> tuple[list, float]:
    """Dispatch all trials of one point as queued device calls WITHOUT
    fetching; returns (list of unfetched stacked stats, actual QBER).

    Callers fetch with :func:`_collect_point`; keeping dispatch and fetch
    separate lets the sweep pipeline the per-dispatch host latency
    of point k+1 under point k's device compute.
    """
    n_err = num_errors_for(code.n_vars, qber)
    if n_err == 0:
        # Reference treats floor(N*q)==0 as fatal (simulation.cpp:170-175).
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    actual_qber = n_err / code.n_vars

    # Device-side Σ iters² accumulates in exact int32; bound the trials per
    # dispatch so chunk_trials * max_iterations^2 < 2^31 (host-side merges
    # across chunks are exact Python ints).
    mi2 = max(opts.max_iterations, 1) ** 2
    if batch * mi2 > 2**31 - 1:
        raise ValueError(
            f"batch ({batch}) x max_iterations^2 ({opts.max_iterations}^2) "
            "overflows the int32 iteration statistics; lower batch_size"
        )
    safe_batches = max(1, (2**31 - 1) // (batch * mi2))

    futures = []
    offset = 0
    while offset < trials:
        remaining = trials - offset
        n_batches = min(
            -(-remaining // batch), max_batches_per_dispatch, safe_batches
        )
        valid = min(n_batches * batch, remaining)
        futures.append(
            _point_chunk_step(
                code,
                point_key,
                jnp.asarray(n_err, jnp.int32),
                jnp.asarray(offset, jnp.int32),
                jnp.asarray(valid, jnp.int32),
                batch,
                n_batches,
                opts,
            )
        )
        offset += valid
    return futures, actual_qber


def _collect_point(futures: list) -> PointPartials:
    total = PointPartials()
    for stacked in futures:
        # Continuation-sweep slices share one group fetch (fetch());
        # plain futures are device arrays.
        host = stacked.fetch() if hasattr(stacked, "fetch") else (
            jax.device_get(stacked)
        )
        total = total.merge(partials_from_stacked(host))
    return total


def run_point(
    code: LDPCCode,
    point_key: jax.Array,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
) -> tuple[PointPartials, float]:
    """Run all trials of one (matrix, QBER) point; returns (partials, actual QBER).

    Batches are scan-chained on-device in chunks of up to
    ``max_batches_per_dispatch``, so a whole sweep point usually costs one
    dispatch + one scalar fetch regardless of trial count.
    """
    futures, actual_qber = _dispatch_point(
        code, point_key, qber, trials, batch, opts, max_batches_per_dispatch,
    )
    total = _collect_point(futures)
    if tick is not None:
        tick(total.n_trials)
    return total, actual_qber


def auto_batch_size(cfg: Config, code: LDPCCode) -> int:
    """Pick a trial batch size: large enough to saturate the chip, small
    enough to keep message state well under HBM limits."""
    if cfg.batch_size:
        return min(cfg.batch_size, cfg.trials_number)
    # 512 frames per device, capped by message-state memory.  Not measured
    # on the card: larger batches pay more for the all-frames early-exit
    # barrier (a batch runs to its max iteration count), smaller ones
    # leave the device idle between launches.
    bytes_per_trial = code.n_checks * code.dc_max * 4 * 6
    cap = max(1, (3 << 29) // bytes_per_trial)
    return int(min(cfg.trials_number, 512, cap))


# --------------------------------------------------------------------------
# Checkpointing


def _experiment_fingerprint(sim_inputs: Sequence[SimInput], cfg: Config) -> str:
    """Hash of everything that determines a sweep's results, so a resumed
    checkpoint can never be silently reused for a *different* experiment
    (different matrices, QBER plan, decoder algorithm, dtype, or
    thresholds would otherwise collide on the same filename)."""
    import hashlib

    # NOTE: compact_after is deliberately absent — compaction is a
    # schedule change with bit-identical results, so resuming a sweep
    # with it toggled is sound.
    parts = [
        f"{cfg.trials_number}|{cfg.simulation_seed}|"
        f"{cfg.sum_product_max_iterations}|{cfg.decoder}|{cfg.min_sum_alpha}|"
        f"{cfg.dtype}|{cfg.enable_sum_product_msg_llr_threshold}|"
        f"{cfg.sum_product_msg_llr_threshold}"
        # The layered schedule produces different trajectories (and so
        # different statistics) than flooding — result-determining.
        + ("" if cfg.schedule == "flooding" else f"|sched={cfg.schedule}")
    ]
    for si in sim_inputs:
        parts.append(
            f"{si.matrix_filename}|{si.code.n_vars}|{si.code.n_checks}|"
            f"{si.code.n_edges}|" + ",".join(f"{q:.9g}" for q in si.qber)
        )
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:12]


def _checkpoint_path(cfg: Config, sim_inputs: Sequence[SimInput]) -> Path | None:
    if not cfg.checkpoint_dir:
        return None
    d = Path(cfg.checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    return d / (
        f"sweep(trial_num={cfg.trials_number},"
        f"max_sum_prod_iters={cfg.sum_product_max_iterations},"
        f"seed={cfg.simulation_seed},"
        f"exp={_experiment_fingerprint(sim_inputs, cfg)}).jsonl"
    )


def _load_checkpoint(path: Path | None) -> dict[int, dict]:
    if path is None or not path.exists():
        return {}
    done = {}
    for line in path.read_text().splitlines():
        if line.strip():
            rec = json.loads(line)
            done[rec["sim_number"]] = rec
    return done


def _append_checkpoint(path: Path | None, record: dict) -> None:
    if path is None:
        return
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")


# --------------------------------------------------------------------------
# Batch simulation


def batch_simulation(
    sim_inputs: Sequence[SimInput],
    cfg: Config,
    progress: bool = True,
) -> list[SimResult]:
    """Full sweep over all matrices x QBER points (reference
    ``QKD_LDPC_batch_simulation``), with checkpoint/resume.

    Points are PIPELINED: the next point's device work is dispatched
    before the current point's scalar results are fetched, hiding the
    per-dispatch host latency under device compute (results are
    unchanged — every point's trials depend only on its own key).
    """
    opts = decode_options_from_config(cfg)
    ckpt_path = _checkpoint_path(cfg, sim_inputs)
    done = _load_checkpoint(ckpt_path)
    from qkd_ldpc_tpu.channel.keys import master_key

    master = master_key(cfg.simulation_seed)
    # Rank-awareness (multi-process jax.distributed runs): every process
    # executes the same device programs (collectives require it) and
    # reads the checkpoint for resume decisions — which must agree, so
    # multi-process resume needs checkpoint_dir on a shared filesystem —
    # but only process 0 appends checkpoints and shows progress.
    is_coord = jax.process_index() == 0
    if not is_coord:
        ckpt_path = None
        progress = False

    # Multi-device hosts shard the trial grid over ALL devices
    # automatically (pure DP over a `trial` mesh; results bit-identical
    # to single-device by the determinism contract — tests/test_sharding).
    mesh = None
    if cfg.use_mesh and jax.device_count() > 1:
        from qkd_ldpc_tpu.parallel.mesh import make_trial_mesh

        mesh = make_trial_mesh()

    total_trials = sum(len(si.qber) for si in sim_inputs) * cfg.trials_number
    bar = ProgressBar(total_trials, enabled=progress)

    results: dict[int, SimResult] = {}
    pending: list[tuple] = []  # (sim_number, si, actual_qber, futures)

    def _flush_one() -> None:
        num, si, actual_qber, futures = pending.pop(0)
        partials = _collect_point(futures)
        result = finalize_point(
            partials,
            sim_number=num,
            matrix_filename=si.matrix_filename,
            is_regular=si.code.is_regular,
            num_bit_nodes=si.code.n_vars,
            num_check_nodes=si.code.n_checks,
            initial_qber=actual_qber,
            max_iterations=opts.max_iterations,
        )
        results[num] = result
        _append_checkpoint(
            ckpt_path, dict(sim_number=num, result=dataclasses.asdict(result))
        )
        bar.tick(partials.n_trials)

    sim_number = 0
    for si in sim_inputs:
        batch = auto_batch_size(cfg, si.code)
        # Per-matrix options derive from the config-derived base every
        # iteration (never mutate the shared `opts`: the auto batch size
        # is per-matrix, so compaction sizing must not leak from one
        # matrix into the next).
        m_opts = opts
        if cfg.compact_after > 0 and batch >= 8:
            # Residency compaction: schedule-only, bit-identical
            # (decoder/bp.py).  Lanes = batch/4 — comfortably above the
            # unconverged fraction at any plateau point; waterfall
            # points overflow into the exact full-batch fallback.
            m_opts = dataclasses.replace(
                opts, compact_after=cfg.compact_after,
                compact_lanes=batch // 4,
            )
        if mesh is not None:
            from qkd_ldpc_tpu.parallel.mesh import replicated
            from qkd_ldpc_tpu.parallel.sweep import make_point_dispatcher

            mesh_dispatch = make_point_dispatcher(si.code, batch, m_opts,
                                                  mesh)
            # Continuation points reuse a mesh-replicated code copy.
            code_dev = (
                jax.device_put(si.code, replicated(mesh))
                if cfg.continuation_qber > 0 else None
            )
        else:
            mesh_dispatch = None
            code_dev = si.code.to_device()  # upload adjacency once per matrix
        cont_entries = []  # (sim_number, qber, point_key) waterfall points
        for qber in si.qber:
            if sim_number in done:
                results[sim_number] = SimResult(**done[sim_number]["result"])
                bar.tick(cfg.trials_number)
                sim_number += 1
                continue

            point_key = jax.random.fold_in(master, sim_number)
            if cfg.continuation_qber > 0 and qber >= cfg.continuation_qber:
                # Deferred: all of this matrix's waterfall points run as
                # ONE cross-point continuation program below.
                cont_entries.append((sim_number, qber, point_key))
                sim_number += 1
                continue
            if mesh_dispatch is not None:
                futures, actual_qber = mesh_dispatch(
                    point_key, qber, cfg.trials_number
                )
            else:
                futures, actual_qber = _dispatch_point(
                    code_dev, point_key, qber, cfg.trials_number, batch,
                    m_opts,
                )
            pending.append((sim_number, si, actual_qber, futures))
            if len(pending) > 1:  # keep one point in flight
                _flush_one()

            sim_number += 1

        if cont_entries:
            # Cross-point continuation (single program, drained lanes of
            # point p host point p+1's trials; per-device lane pools on a
            # mesh).  Statistics bit-identical to every other runner path.
            from qkd_ldpc_tpu.sim.continuation import (
                dispatch_sweep_continuation,
            )

            futs, actuals = dispatch_sweep_continuation(
                code_dev, [k for _, _, k in cont_entries],
                [q for _, q, _ in cont_entries], cfg.trials_number,
                batch, m_opts, mesh=mesh,
            )
            for (num, _, _), f, aq in zip(cont_entries, futs, actuals):
                pending.append((num, si, aq, f))
                if len(pending) > 1:
                    _flush_one()
    while pending:
        _flush_one()
    bar.close()
    return [results[i] for i in sorted(results)]


def simulate_directory(cfg: Config, matrix_dir: str | Path, progress: bool = True):
    """Convenience: load every matrix in a directory and run the sweep."""
    paths = list_matrix_files(matrix_dir)
    if not paths:
        raise FileNotFoundError(f"Matrix folder is empty: {matrix_dir}")
    sim_inputs = prepare_sim_inputs(paths, cfg)
    return batch_simulation(sim_inputs, cfg, progress=progress)
