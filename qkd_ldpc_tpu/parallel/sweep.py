"""Sharded Monte-Carlo sweep: trial-grid data parallelism over a mesh.

The device step is identical math to the single-chip runner
(``qkd_ldpc_tpu.sim.runner``): generate trials from global trial ids,
decode, reduce to seven stat scalars.  Sharding the trial-id vector over
the ``trial`` mesh axis makes every per-trial tensor device-local; XLA
auto-partitions the whole program (all ops are batch-parallel) and inserts
a single all-reduce for the final scalar sums — the entire communication
cost of the sweep.

Dispatch discipline mirrors the single-chip runner
(``sim.runner._point_chunk`` / ``_dispatch_point``): sequential trial
batches are chained on-device with ``lax.scan`` so a whole sweep point
costs ONE dispatch + ONE scalar fetch regardless of trial count, and
points can be pipelined (dispatch point k+1 before fetching point k) —
on a multi-host run the per-dispatch host latency would otherwise
return per batch.

Determinism: trial t's keys depend only on (master seed, point index, t)
via ``fold_in`` — results are bit-identical across 1 device, 8 devices, or
several processes (the reference achieves the thread-count analog of this
with its ``seeds[k] + curr_sim`` scheme, ``src/simulation.cpp:247``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from qkd_ldpc_tpu.channel.keys import make_trials_from_ids, num_errors_for
from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu.decoder.bp import DecodeOptions
from qkd_ldpc_tpu.decoder.reconcile import reconcile
from qkd_ldpc_tpu.parallel.mesh import TRIAL_AXIS, trial_sharding, replicated
from qkd_ldpc_tpu.sim.stats import (
    PointPartials,
    partials_from_stacked,
    reduce_trials,
    stack_partials,
)


def _trials_per_shard(
    mesh: Mesh,
    point_key: jax.Array,
    n_bits: int,
    trial_ids: jax.Array,  # [B] uint32
    num_errors: jax.Array,  # scalar int32
) -> tuple[jax.Array, jax.Array]:
    """``make_trials_from_ids`` run shard by shard over the trial axis.

    On the GPU the channel's k-th-select kernel (channel.pallas_select) is
    a custom call that GSPMD cannot partition: left to it, every device
    would gather the global [B, N] scores and select every row.  Trials
    are independent, so each device makes its own shard of them; the
    streams are unchanged (a trial depends only on its global id).
    """
    return jax.shard_map(
        lambda key, ids, ne: make_trials_from_ids(key, n_bits, ids, ne),
        mesh=mesh,
        in_specs=(P(), P(TRIAL_AXIS), P()),
        out_specs=(P(TRIAL_AXIS), P(TRIAL_AXIS)),
        check_vma=False,
    )(point_key, trial_ids, num_errors)


def _batch_partials(
    code: LDPCCode,
    point_key: jax.Array,
    trial_ids: jax.Array,  # [B] uint32, sharded over the trial axis
    valid: jax.Array,  # [B] bool, same sharding
    num_errors: jax.Array,  # scalar int32
    n_bits: int,
    opts: DecodeOptions,
    mesh: Mesh,
) -> dict[str, jax.Array]:
    """One trial batch -> partial-sum dict (traceable, not jitted)."""
    alice, bob = _trials_per_shard(
        mesh, point_key, n_bits, trial_ids, num_errors
    )
    actual_qber = num_errors.astype(jnp.float32) / n_bits
    res = reconcile(code, alice, bob, actual_qber, opts)
    return reduce_trials(
        res.syndromes_match, res.keys_match, res.iterations,
        opts.max_iterations, valid,
    )


@partial(jax.jit, static_argnames=("n_bits", "n_batches", "opts", "mesh"))
def _sharded_chunk(
    code: LDPCCode,
    point_key: jax.Array,
    trial_lane: jax.Array,  # [B] uint32 = arange(batch), sharded over trial
    num_errors: jax.Array,  # scalar int32
    start_offset: jax.Array,  # scalar int32
    total_valid: jax.Array,  # scalar int32 (trials remaining in this chunk)
    n_bits: int,
    n_batches: int,
    opts: DecodeOptions,
    mesh: Mesh,
) -> jax.Array:
    """``n_batches`` sequential sharded trial batches scan-chained on device.

    The sharded counterpart of ``sim.runner._point_chunk``: one dispatch +
    one [7]-int32 fetch per chunk.  ``trial_lane`` carries the trial-axis
    sharding into the program; every derived per-trial tensor inherits it
    and GSPMD inserts a single all-reduce for the scalar sums.
    """
    batch = trial_lane.shape[0]

    def one(i):
        offset = start_offset + i * batch
        valid_count = jnp.clip(total_valid - i * batch, 0, batch)
        trial_ids = trial_lane + offset.astype(jnp.uint32)
        valid = trial_lane < valid_count.astype(jnp.uint32)
        return _batch_partials(
            code, point_key, trial_ids, valid, num_errors, n_bits, opts,
            mesh,
        )

    from qkd_ldpc_tpu.sim.runner import merge_partials_tree

    init = one(jnp.asarray(0, jnp.int32))
    if n_batches > 1:
        def body(carry, i):
            return merge_partials_tree(carry, one(i)), None

        init, _ = jax.lax.scan(
            body, init, jnp.arange(1, n_batches, dtype=jnp.int32)
        )
    return stack_partials(init)


def _check_int32_stats_bound(batch: int, opts: DecodeOptions) -> int:
    """Trials per device-merged chunk must keep Σ iters² under 2^31
    (device sums are exact int32; host merges are exact Python ints).
    Returns the max number of batches safe to merge in one chunk."""
    mi2 = max(opts.max_iterations, 1) ** 2
    if batch * mi2 > 2**31 - 1:
        raise ValueError(
            f"batch ({batch}) x max_iterations^2 ({opts.max_iterations}^2) "
            "overflows the int32 iteration statistics; lower batch_size"
        )
    return max(1, (2**31 - 1) // (batch * mi2))


def _dispatch_point_sharded(
    code_dev,
    point_key_dev,
    trial_lane,
    n_err: int,
    n_bits: int,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    max_batches_per_dispatch: int,
    mesh: Mesh,
) -> list:
    """Queue all chunks of one point WITHOUT fetching; returns futures.

    Separating dispatch from fetch lets a sweep pipeline point k+1's
    dispatch under point k's device compute (as ``sim.runner``'s
    ``batch_simulation`` does single-chip)."""
    safe_batches = _check_int32_stats_bound(batch, opts)
    futures = []
    offset = 0
    while offset < trials:
        remaining = trials - offset
        n_batches = min(
            -(-remaining // batch), max_batches_per_dispatch, safe_batches
        )
        valid = min(n_batches * batch, remaining)
        futures.append(
            _sharded_chunk(
                code_dev, point_key_dev, trial_lane,
                jnp.asarray(n_err, jnp.int32),
                jnp.asarray(offset, jnp.int32),
                jnp.asarray(valid, jnp.int32),
                n_bits, n_batches, opts, mesh,
            )
        )
        offset += valid
    return futures


def _collect(futures: list) -> PointPartials:
    total = PointPartials()
    for stacked in futures:
        total = total.merge(partials_from_stacked(jax.device_get(stacked)))
    return total


def _make_trial_lane(batch: int, mesh: Mesh) -> jax.Array:
    """[batch] uint32 arange sharded over the trial axis.

    ``make_array_from_callback`` builds each device's shard locally, so
    this path also works multi-host (jax.distributed), where a plain
    device_put of a host-local array onto a global sharding cannot.
    """
    shard = trial_sharding(mesh)
    return jax.make_array_from_callback(
        (batch,), shard, lambda idx: np.arange(batch, dtype=np.uint32)[idx]
    )


def make_point_dispatcher(
    code: LDPCCode,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    max_batches_per_dispatch: int = 64,
):
    """Bind a mesh-replicated code + trial lane once and return
    ``dispatch(point_key, qber, trials) -> (futures, actual_qber)`` — the
    sharded analog of ``sim.runner._dispatch_point``, so
    ``batch_simulation`` can pipeline points over all devices with the
    same futures protocol it uses single-chip.

    ``batch`` is per-device; the global batch is ``batch x trial-axis``.
    """
    n_shards = mesh.shape[TRIAL_AXIS]
    gbatch = batch * n_shards
    repl = replicated(mesh)
    code_dev = jax.device_put(code, repl)
    trial_lane = _make_trial_lane(gbatch, mesh)

    def dispatch(point_key: jax.Array, qber: float, trials: int):
        n_err = num_errors_for(code.n_vars, qber)
        if n_err == 0:
            raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
        futures = _dispatch_point_sharded(
            code_dev, jax.device_put(point_key, repl), trial_lane,
            n_err, code.n_vars, trials, gbatch, opts,
            max_batches_per_dispatch, mesh,
        )
        return futures, n_err / code.n_vars

    return dispatch


def run_point_sharded(
    code: LDPCCode,
    point_key: jax.Array,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
) -> tuple[PointPartials, float]:
    """All trials of one (matrix, QBER) point, sharded over ``mesh``.

    ``batch`` is the *global* batch (rounded up to a multiple of the trial
    axis size); the tail is masked out, so partial sums are exactly those
    of the unsharded runner.  Batches are scan-chained on device: one
    dispatch + one [7]-scalar fetch per ~64-batch chunk.
    """
    n_err = num_errors_for(code.n_vars, qber)
    if n_err == 0:
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    actual_qber = n_err / code.n_vars

    n_shards = mesh.shape[TRIAL_AXIS]
    batch = -(-batch // n_shards) * n_shards  # round up to shard multiple
    repl = replicated(mesh)

    code_dev = jax.device_put(code, repl)
    point_key_dev = jax.device_put(point_key, repl)
    trial_lane = _make_trial_lane(batch, mesh)

    futures = _dispatch_point_sharded(
        code_dev, point_key_dev, trial_lane, n_err, code.n_vars,
        trials, batch, opts, max_batches_per_dispatch, mesh,
    )
    total = _collect(futures)
    if tick is not None:
        tick(total.n_trials)
    return total, actual_qber


def run_sweep_sharded(
    code: LDPCCode,
    master_key: jax.Array,
    qbers: list[float],
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
) -> list[tuple[PointPartials, float]]:
    """A full QBER sweep on the mesh with PIPELINED points: point k+1's
    chunk is dispatched before point k's scalars are fetched, hiding the
    per-dispatch host latency under device compute (the sharded analog of
    ``sim.runner.batch_simulation``'s pipeline; results are unchanged —
    every point's trials depend only on its own key)."""
    n_err_list = [num_errors_for(code.n_vars, q) for q in qbers]
    for q, n_err in zip(qbers, n_err_list):
        if n_err == 0:
            raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")

    n_shards = mesh.shape[TRIAL_AXIS]
    batch = -(-batch // n_shards) * n_shards
    repl = replicated(mesh)
    code_dev = jax.device_put(code, repl)
    trial_lane = _make_trial_lane(batch, mesh)

    results: list[tuple[PointPartials, float]] = []
    pending: list[tuple[list, float]] = []

    def flush_one():
        futures, actual = pending.pop(0)
        total = _collect(futures)
        if tick is not None:
            tick(total.n_trials)
        results.append((total, actual))

    for i, (qber, n_err) in enumerate(zip(qbers, n_err_list)):
        point_key_dev = jax.device_put(jax.random.fold_in(master_key, i), repl)
        futures = _dispatch_point_sharded(
            code_dev, point_key_dev, trial_lane, n_err, code.n_vars,
            trials, batch, opts, max_batches_per_dispatch, mesh,
        )
        pending.append((futures, n_err / code.n_vars))
        if len(pending) > 1:  # keep one point in flight
            flush_one()
    while pending:
        flush_one()
    return results


# ---------------------------------------------------------------------------
# Node-sharded sweep point (2-D trial x node mesh)


@partial(
    jax.jit, static_argnames=("n_bits", "batch", "n_batches", "opts", "mesh")
)
def _node_sharded_chunk(
    code: LDPCCode,
    point_key: jax.Array,
    num_errors: jax.Array,
    start_offset: jax.Array,
    total_valid: jax.Array,
    n_bits: int,
    batch: int,
    n_batches: int,
    opts: DecodeOptions,
    mesh: Mesh,
) -> jax.Array:
    """Scan-chained chunk of node-sharded trial batches (module-level jit:
    a per-call closure would retrace every invocation — the pitfall
    ``node_sharded.py``'s own comment warns about)."""
    from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu.decoder.syndrome import syndrome as syndrome_fn
    from qkd_ldpc_tpu.parallel.node_sharded import bp_decode_node_sharded
    from qkd_ldpc_tpu.parallel.qc_node_sharded import bp_decode_qc_node_sharded
    from qkd_ldpc_tpu.sim.runner import merge_partials_tree

    # Mirror DecodeOptions.routing="auto" for the intra-frame axis: a QC
    # code shards by whole circulant blocks (block rolls, no segment
    # ops — parallel.qc_node_sharded); anything else takes the general
    # adjacency decoder.  routing="gather" forces the general path;
    # "roll" insists on QC (and raises inside the QC decoder otherwise).
    use_qc = opts.routing == "roll" or (
        opts.routing == "auto" and code.qc is not None
    )
    decode_sharded = bp_decode_qc_node_sharded if use_qc else bp_decode_node_sharded

    def one(i):
        offset = start_offset + i * batch
        valid_count = jnp.clip(total_valid - i * batch, 0, batch)
        lane = jnp.arange(batch, dtype=jnp.uint32)
        trial_ids = lane + offset.astype(jnp.uint32)
        valid = lane < valid_count.astype(jnp.uint32)
        alice, bob = _trials_per_shard(
            mesh, point_key, n_bits, trial_ids, num_errors)
        aq = num_errors.astype(jnp.float32) / n_bits
        llr = apriori_llr(bob, aq)
        syn = syndrome_fn(code, alice)
        z, iters, ok = decode_sharded(code, llr.T, syn.T, opts, mesh)
        keys_match = jnp.all(z.T.astype(jnp.int8) == alice.astype(jnp.int8), axis=-1)
        return reduce_trials(ok, keys_match, iters, opts.max_iterations, valid)

    init = one(jnp.asarray(0, jnp.int32))
    if n_batches > 1:
        def body(carry, i):
            return merge_partials_tree(carry, one(i)), None

        init, _ = jax.lax.scan(
            body, init, jnp.arange(1, n_batches, dtype=jnp.int32)
        )
    return stack_partials(init)


def run_point_node_sharded(
    code: LDPCCode,
    point_key: jax.Array,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
) -> tuple[PointPartials, float]:
    """One sweep point on a 2-D (trial, node) mesh: the batch shards over
    ``trial`` while every frame's variable nodes shard over ``node`` —
    the sweep-level composition of data parallelism with intra-frame
    model parallelism, for frames too large (or too latency-critical)
    for one chip.  QC codes dispatch to the block-roll decoder
    (:func:`parallel.qc_node_sharded.bp_decode_qc_node_sharded`) under
    ``opts.routing`` "auto"/"roll"; others take the general adjacency
    decoder (:func:`parallel.node_sharded.bp_decode_node_sharded`).

    Statistics: exactly the single-chip runner's for min-sum (its
    distributed reductions are associative); for sum-product the
    distributed log-sum matches the single-chip product formulation to
    f32 rounding — an extended randomized soak found ~1 boundary frame
    in a few thousand converging one iteration earlier/later, which
    shifts Σiters by ±1 without changing any FER/verdict statistic.
    """
    n_err = num_errors_for(code.n_vars, qber)
    if n_err == 0:
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    actual_qber = n_err / code.n_vars

    n_trial_shards = mesh.shape.get(TRIAL_AXIS, 1)
    batch = -(-batch // n_trial_shards) * n_trial_shards
    safe_batches = _check_int32_stats_bound(batch, opts)

    futures = []
    offset = 0
    while offset < trials:
        remaining = trials - offset
        n_batches = min(
            -(-remaining // batch), max_batches_per_dispatch, safe_batches
        )
        valid = min(n_batches * batch, remaining)
        futures.append(
            _node_sharded_chunk(
                code, point_key,
                jnp.asarray(n_err, jnp.int32),
                jnp.asarray(offset, jnp.int32),
                jnp.asarray(valid, jnp.int32),
                code.n_vars, batch, n_batches, opts, mesh,
            )
        )
        offset += valid
    total = _collect(futures)
    if tick is not None:
        tick(total.n_trials)
    return total, actual_qber
