"""Continuation batching: refill converged lanes with fresh trials.

Near the decoding threshold (QBER ~0.085-0.09 for the flagship R=0.49
code) per-frame residency spans ~10-100 iterations, so the plain batched
runner — whose whole batch runs until its LAST frame converges or hits
``max_iterations`` — wastes most of its lanes on the barrier: with FER
~0.2+, essentially every batch contains a frame that runs to the cap, so
every trial costs ~``max_iterations`` iterations of device time even when
its own decode finished after 30.

This runner keeps the batch full instead: the decode runs in segments of
``segment`` iterations inside one jitted program; after each segment,
lanes whose trial finished (converged, or hit the iteration cap) bank
their statistics and are refilled with fresh trials (key generation +
exact-weight channel + syndrome, generated on device from the SAME
per-trial keys the plain runner derives).  One dispatch + one [7]-scalar
fetch per sweep point.

**Statistics are bit-identical to the plain runner** (tested exactly in
tests/test_continuation.py):

- a trial's decode trajectory depends only on its own (llr, syndrome) —
  lanes are independent, so lane placement and neighbors cannot change it;
- a refilled lane's first fused update carries a ``fresh`` flag that
  skips the bit-update clip, making it exactly the peeled first
  iteration of ``decoder.bp`` (a-priori LLRs are never clipped,
  reference qkd_ldpc_algorithm.cpp:10-18);
- per-trial iteration counts are banked when the trial finishes, and all
  reductions (integer sums, min/max) are order-independent.

Where it wins: only where residency VARIANCE is high (the waterfall).
On the plateau (low QBER) every frame converges in ~the same few
iterations and the refill's keygen overhead loses — use the plain runner
there (Config.continuation_qber selects the crossover per sweep).  Deep
in the waterfall (FER -> 1) almost every trial runs to the cap anyway and
there is nothing to reclaim.  The reasoning: benchmarks/waterfall.md.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from qkd_ldpc_tpu.channel.keys import make_trials_from_ids, num_errors_for
from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu.decoder.bp import DecodeOptions, _DecodeCore
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu.decoder.syndrome import syndrome as syndrome_fn
from qkd_ldpc_tpu.sim.stats import PointPartials, partials_from_stacked


def _continuation_core(
    code: LDPCCode,
    point_keys: jax.Array,  # [P, ...] one PRNG key per sweep point
    num_errors: jax.Array,  # [P] int32
    trials: jax.Array,  # scalar int32: trials per point in THIS pool
    trial_offset: jax.Array,  # scalar int32: first global trial id
    batch: int,
    segment: int,
    refill_min: int,
    opts: DecodeOptions,
) -> jax.Array:
    """Trials [trial_offset, trial_offset + trials) of P consecutive
    sweep points with CROSS-POINT lane continuation; returns the stacked
    [7, P] int32 stat matrix.

    Points are consumed in order; as point p's ids run out, drained
    lanes start hosting point p+1's trials immediately (round 3 —
    previously each point's program paid a 12-18% tail drain while its
    last stragglers ran with mostly-empty lanes).  Each lane is tagged
    with its point, statistics bank into per-point accumulators with
    order-independent scatter adds/mins/maxes, and a trial's trajectory
    depends only on its own (llr, syndrome) — so the per-point
    statistics are bit-identical to running each point alone
    (tests/test_continuation.py).

    ``trial_offset`` exists for the sharded composition: trial ids are
    global (the determinism contract keys every trial's data to
    fold_in(point_key, id), so a pool's statistics depend only on WHICH
    ids it owns, not where they run)."""
    N, M = code.n_vars, code.n_checks
    P = point_keys.shape[0]
    dtype = jnp.float32
    core = _DecodeCore(code, opts, dtype, batch)
    mdt = core.mdt
    max_it = opts.max_iterations
    S = batch  # staging-block size: keygen amortizes exactly as the
    # plain runner's per-batch keygen (one generation per `batch` trials)
    K = refill_min
    assert S % K == 0, "refill quantum must divide the staging block"

    # Carried state:
    #   tot, Lr                 [dc, M, B]  decode state (message dtype)
    #   llr, alice, z           [N, B]      per-lane trial data
    #   syn, syn_sign           [M, B]
    #   age, done, live, fresh  [B]
    #   lane_p                  [B]  sweep-point index of each lane's trial
    #   stage = (llr_s [N,S], syn_s [M,S], alice_s [N,S], base, pos, sp)
    #     staged fresh trials OF POINT sp: slot i holds trial id base+i;
    #     slots pos..S-1 are unconsumed.  Key generation runs once per S
    #     trials (generation has a fixed per-event cost regardless of
    #     size); refills then consume contiguous
    #     K-slices — two cheap dynamic-slice + gather blends.
    #   next_id: ids consumed of the stage's CURRENT point
    #   acc: seven [P] per-point accumulators

    def regen(st):
        """Generate the next S staged trials — of the next point once the
        current one's ids are exhausted."""
        stage = st[12]
        llr_s, syn_s, alice_s, base, pos, sp = stage
        next_id = st[13]
        new_base = base + S
        adv = new_base >= trials  # current point exhausted -> advance
        new_base = jnp.where(adv, 0, new_base)
        sp = jnp.where(adv, jnp.minimum(sp + 1, P - 1), sp)
        next_id = jnp.where(adv, 0, next_id)
        ids = (
            trial_offset + new_base + jnp.arange(S, dtype=jnp.int32)
        ).astype(jnp.uint32)
        # ids >= trials are generated but never consumed (tail waste of at
        # most one block per point, amortized across the whole point).
        ne = num_errors[sp]
        a_new, b_new = make_trials_from_ids(
            jnp.take(point_keys, sp, axis=0), N, ids, ne
        )
        aq = ne.astype(jnp.float32) / N
        stage = (
            apriori_llr(b_new, aq).T.astype(dtype),
            syndrome_fn(code, a_new).T.astype(jnp.int32),
            a_new.T.astype(jnp.int8),
            new_base,
            jnp.asarray(0, jnp.int32),
            sp,
        )
        return st[:12] + (stage, next_id) + st[14:]

    def refill(st):
        """Move K staged trials into the first K empty lanes.

        Blend via a sentinel GATHER over the lane axis (inv maps lane ->
        its slot in the K new trials, or K for untouched lanes): a
        dynamic-index column *scatter* of the big tensors was far slower
        where first measured.  The refill predicate guarantees
        >= K empty lanes, so ``nonzero(size=K)`` never duplicates a lane.
        """
        (tot, Lr, llr, syn, syn_sign, alice, z, age, done, live, fresh,
         lane_p, stage, next_id, acc) = st
        llr_s, syn_s, alice_s, base, pos, sp = stage
        idx = jnp.nonzero(~live, size=K, fill_value=0)[0]  # first K empty
        ids = base + pos + jnp.arange(K, dtype=jnp.int32)
        sel = ids < trials  # [K]; tail of the point may start fewer

        def slice_s(arr):  # contiguous [.., K] slice of the staging block
            return jax.lax.dynamic_slice_in_dim(arr, pos, K, axis=-1)

        llr_new = slice_s(llr_s)
        syn_new = slice_s(syn_s)
        alice_new = slice_s(alice_s)
        tot_new = jnp.take(
            core.to_storage(llr_new), core.chk_adj_T.reshape(-1), axis=0
        ).reshape(code.dc_max, M, K)

        inv = jnp.full((batch,), K, jnp.int32).at[idx].set(
            jnp.where(sel, jnp.arange(K, dtype=jnp.int32), K)
        )
        pick = inv < K  # [B] lanes actually refilled

        def expand(new):  # [..., K] -> [..., B]
            pad = jnp.concatenate(
                [new, jnp.zeros(new.shape[:-1] + (1,), new.dtype)], axis=-1
            )
            return jnp.take(pad, inv, axis=-1)

        llr = jnp.where(pick[None, :], expand(llr_new), llr)
        syn = jnp.where(pick[None, :], expand(syn_new), syn)
        syn_sign = jnp.where(
            pick[None, :],
            expand(jnp.where(syn_new == 1, -1.0, 1.0).astype(dtype)),
            syn_sign,
        )
        alice = jnp.where(pick[None, :], expand(alice_new), alice)
        tot = jnp.where(pick[None, None, :], expand(tot_new), tot)
        Lr = jnp.where(pick[None, None, :], jnp.zeros((), mdt), Lr)
        age = jnp.where(pick, 0, age)
        done = jnp.where(pick, False, done)
        live = live | pick
        lane_p = jnp.where(pick, sp, lane_p)
        # Accumulate (|=): several K-sized refills can run back-to-back
        # in one outer step when many lanes retired at once.
        fresh = fresh | pick
        next_id = next_id + jnp.sum(sel.astype(jnp.int32))
        stage = (llr_s, syn_s, alice_s, base, pos + K, sp)
        return (tot, Lr, llr, syn, syn_sign, alice, z, age, done, live,
                fresh, lane_p, stage, next_id, acc)

    def _more_ids(st):
        sp, next_id = st[12][5], st[13]
        return (sp < P - 1) | (next_id < trials)

    def want_lanes(st):
        live = st[9]
        empty_n = jnp.sum((~live).astype(jnp.int32))
        live_n = jnp.sum(live.astype(jnp.int32))
        return _more_ids(st) & ((empty_n >= K) | (live_n == 0))

    def regen_or_refill(st):
        pos = st[12][4]
        return jax.lax.cond(pos >= S, regen, refill, st)

    def outer_body(st):
        # 1. refill empty lanes, K at a time, while enough have retired
        # (or none are live at all); regenerate the staging block when
        # it runs dry — advancing to the next point's ids as needed
        st = jax.lax.while_loop(want_lanes, regen_or_refill, st)
        (tot, Lr, llr, syn, syn_sign, alice, z, age, done, live, fresh,
         lane_p, stage, next_id, acc) = st

        # 2. decode `segment` iterations (per-lane bookkeeping as in
        # decoder.bp: frozen lanes keep computing, masked out of stats)
        def ibody(_, ist):
            tot, Lr, fresh, z, age, done = ist
            Lr_new = core.check_update_fused(tot, Lr, syn_sign, fresh=fresh)
            tot_new, z_new, ok = core.after_check(Lr_new, llr, syn)
            act = live & ~done & (age < max_it)
            z = jnp.where(act[None, :], z_new, z)
            age = jnp.where(act, age + 1, age)
            done = done | (ok & act)
            return (tot_new, Lr_new, jnp.zeros((batch,), bool), z, age, done)

        tot, Lr, fresh, z, age, done = jax.lax.fori_loop(
            0, segment, ibody, (tot, Lr, fresh, z, age, done)
        )

        # 3. bank statistics for finished trials into their POINT's
        # accumulators (scatter add/min/max — order-independent), mark
        # lanes empty
        finished = live & (done | (age >= max_it))
        sp_r = finished & done
        keys = jnp.all(z == alice, axis=0)  # keys_match (only used when sp)
        it_sp = jnp.where(sp_r, age, 0)
        i32 = jnp.int32
        (n_trials, n_sp, n_ldpc, sum_it, sum_it2, min_it, max_acc) = acc
        acc = (
            n_trials.at[lane_p].add(finished.astype(i32)),
            n_sp.at[lane_p].add(sp_r.astype(i32)),
            n_ldpc.at[lane_p].add((sp_r & keys).astype(i32)),
            sum_it.at[lane_p].add(it_sp),
            sum_it2.at[lane_p].add(it_sp * it_sp),
            # Unfinished/dead lanes contribute the neutral elements.
            min_it.at[lane_p].min(jnp.where(sp_r, age, max_it)),
            max_acc.at[lane_p].max(jnp.where(sp_r, age, 0)),
        )
        live = live & ~finished
        return (tot, Lr, llr, syn, syn_sign, alice, z, age, done, live,
                fresh, lane_p, stage, next_id, acc)

    def outer_cond(st):
        return _more_ids(st) | jnp.any(st[9])

    i32 = jnp.int32
    init = (
        jnp.zeros((code.dc_max, M, batch), mdt),  # tot
        jnp.zeros((code.dc_max, M, batch), mdt),  # Lr
        jnp.ones((N, batch), dtype),  # llr (pinned positive while dead)
        jnp.zeros((M, batch), i32),  # syn
        jnp.ones((M, batch), dtype),  # syn_sign
        jnp.zeros((N, batch), jnp.int8),  # alice
        jnp.zeros((N, batch), jnp.int8),  # z
        jnp.zeros((batch,), i32),  # age
        jnp.zeros((batch,), bool),  # done
        jnp.zeros((batch,), bool),  # live
        jnp.zeros((batch,), bool),  # fresh
        jnp.zeros((batch,), i32),  # lane_p
        (  # staging block: empty (pos == S forces a regen; base starts
           # at -S so the first regenerated block holds trials 0..S-1
           # of point 0)
            jnp.zeros((N, S), dtype),
            jnp.zeros((M, S), i32),
            jnp.zeros((N, S), jnp.int8),
            jnp.asarray(-S, i32),
            jnp.asarray(S, i32),
            jnp.asarray(0, i32),
        ),
        jnp.asarray(0, i32),  # next_id
        (jnp.zeros((P,), i32), jnp.zeros((P,), i32), jnp.zeros((P,), i32),
         jnp.zeros((P,), i32), jnp.zeros((P,), i32),
         jnp.full((P,), max_it, i32), jnp.zeros((P,), i32)),
    )
    final = jax.lax.while_loop(outer_cond, outer_body, init)
    return jnp.stack(final[14])


@partial(jax.jit,
         static_argnames=("batch", "segment", "refill_min", "opts"))
def _continuation_point(
    code: LDPCCode,
    point_key: jax.Array,
    num_errors: jax.Array,  # scalar int32
    trials: jax.Array,  # scalar int32
    batch: int,
    segment: int,
    refill_min: int,
    opts: DecodeOptions,
) -> jax.Array:
    """Single-device continuation point (stacked [7] int32 stats)."""
    return _continuation_sweep(
        code, point_key[None], num_errors[None], trials,
        batch, segment, refill_min, opts,
    )[:, 0]


@partial(jax.jit,
         static_argnames=("batch", "segment", "refill_min", "opts"))
def _continuation_sweep(
    code: LDPCCode,
    point_keys: jax.Array,  # [P, ...] PRNG keys
    num_errors: jax.Array,  # [P] int32
    trials: jax.Array,  # scalar int32 (per point)
    batch: int,
    segment: int,
    refill_min: int,
    opts: DecodeOptions,
) -> jax.Array:
    """Single-device cross-point continuation sweep ([7, P] stats)."""
    return _continuation_core(
        code, point_keys, num_errors, trials, jnp.asarray(0, jnp.int32),
        batch, segment, refill_min, opts,
    )


@partial(jax.jit, static_argnames=("batch", "segment", "refill_min", "opts",
                                   "mesh"))
def _continuation_sweep_mesh(
    code: LDPCCode,
    point_keys: jax.Array,  # [P, ...] PRNG keys
    num_errors: jax.Array,  # [P] int32
    trials: jax.Array,  # scalar int32 (GLOBAL trial count per point)
    batch: int,  # lanes PER DEVICE
    segment: int,
    refill_min: int,
    opts: DecodeOptions,
    mesh,
) -> jax.Array:
    """Cross-point continuation sweep sharded over the ``trial`` axis.

    Each device runs an independent lane pool over a contiguous global
    trial-id range of EVERY point (balanced split); the per-point
    partials merge with one psum/pmin/pmax.  Because a trial's data and
    trajectory depend only on its (point key, global id) and all
    reductions are order-independent, the merged statistics are
    BIT-IDENTICAL to the plain runner's and to single-device
    continuation (tests/test_continuation.py::test_sharded_*).
    """
    from jax.sharding import PartitionSpec as P

    from qkd_ldpc_tpu.parallel.mesh import TRIAL_AXIS

    n_shards = mesh.shape[TRIAL_AXIS]

    def shard_fn(code, point_keys, num_errors, trials):
        s = jax.lax.axis_index(TRIAL_AXIS)
        q, r = trials // n_shards, trials % n_shards
        lo = s * q + jnp.minimum(s, r)
        n_local = q + (s < r).astype(jnp.int32)
        stacked = _continuation_core(
            code, point_keys, num_errors, n_local, lo,
            batch, segment, refill_min, opts,
        )
        sums = jax.lax.psum(stacked[:5], TRIAL_AXIS)
        mn = jax.lax.pmin(stacked[5], TRIAL_AXIS)
        mx = jax.lax.pmax(stacked[6], TRIAL_AXIS)
        return jnp.concatenate([sums, mn[None], mx[None]])

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(code, point_keys, num_errors, trials)


class _SweepSlice:
    """Per-point view of a [7, P] continuation-sweep future; the device
    fetch happens ONCE for the whole group (runner._collect_point calls
    ``fetch()``)."""

    def __init__(self, holder: dict, idx: int):
        self._holder, self._idx = holder, idx

    def fetch(self):
        h = self._holder
        if h.get("host") is None:
            h["host"] = jax.device_get(h["future"])
        return h["host"][:, self._idx]


def dispatch_sweep_continuation(
    code: LDPCCode,
    point_keys: list,
    qbers: list[float],
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh=None,
    segment: int = 4,
    refill_frac: float = 0.25,
) -> tuple[list[list], list[float]]:
    """Dispatch P consecutive waterfall points as ONE cross-point
    continuation program (drained lanes of point p host point p+1's
    trials).  Returns per-point futures lists (sim.runner's dispatch
    protocol — each is a single shared-fetch slice) and actual QBERs.
    """
    n_errs = [num_errors_for(code.n_vars, q) for q in qbers]
    if any(n == 0 for n in n_errs):
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    mi2 = max(opts.max_iterations, 1) ** 2
    if trials * mi2 > 2**31 - 1:
        raise ValueError(
            f"trials ({trials}) x max_iterations^2 ({opts.max_iterations}^2) "
            "overflows the int32 iteration statistics accumulated on device; "
            "lower continuation_qber or trials_number"
        )
    want = max(1, int(batch * refill_frac))
    refill_min = next(d for d in range(want, 0, -1) if batch % d == 0)
    keys = jnp.stack(list(point_keys))
    ne = jnp.asarray(n_errs, jnp.int32)
    tr = jnp.asarray(trials, jnp.int32)
    if mesh is not None:
        future = _continuation_sweep_mesh(
            code, keys, ne, tr, batch, segment, refill_min, opts, mesh
        )
    else:
        future = _continuation_sweep(
            code, keys, ne, tr, batch, segment, refill_min, opts
        )
    holder = {"future": future, "host": None}
    futures = [[_SweepSlice(holder, i)] for i in range(len(qbers))]
    return futures, [n / code.n_vars for n in n_errs]


def run_point_continuation_sharded(
    code: LDPCCode,
    point_key: jax.Array,
    qber: float,
    trials: int,
    batch: int,  # lanes per device
    opts: DecodeOptions,
    mesh,
    segment: int = 4,
    refill_frac: float = 0.25,
    tick: Callable[[int], None] | None = None,
) -> tuple[PointPartials, float]:
    """All trials of one point with per-device continuation lane pools.

    Statistics bit-identical to :func:`run_point_continuation` and to the
    plain (sharded or single-device) runner.
    """
    futures, actual = dispatch_point_continuation_sharded(
        code, point_key, qber, trials, batch, opts, mesh,
        segment=segment, refill_frac=refill_frac,
    )
    total = PointPartials().merge(partials_from_stacked(futures[0].fetch()))
    if tick is not None:
        tick(total.n_trials)
    return total, actual


def dispatch_point_continuation_sharded(
    code: LDPCCode,
    point_key: jax.Array,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh,
    segment: int = 4,
    refill_frac: float = 0.25,
) -> tuple[list, float]:
    """Dispatch-without-fetch form (futures protocol of
    sim.runner._dispatch_point, so batch_simulation pipelines it)."""
    futures, actuals = dispatch_sweep_continuation(
        code, [point_key], [qber], trials, batch, opts, mesh=mesh,
        segment=segment, refill_frac=refill_frac,
    )
    return futures[0], actuals[0]


def run_point_continuation(
    code: LDPCCode,
    point_key: jax.Array,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    segment: int = 4,
    refill_frac: float = 0.25,
    tick: Callable[[int], None] | None = None,
) -> tuple[PointPartials, float]:
    """All trials of one (matrix, QBER) point with lane continuation.

    Bit-identical statistics to :func:`sim.runner.run_point`; faster
    wherever per-frame iteration residency varies widely (the waterfall).
    """
    n_err = num_errors_for(code.n_vars, qber)
    if n_err == 0:
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    mi2 = max(opts.max_iterations, 1) ** 2
    if trials * mi2 > 2**31 - 1:
        raise ValueError(
            f"trials ({trials}) x max_iterations^2 ({opts.max_iterations}^2) "
            "overflows the int32 iteration statistics accumulated on device; "
            "split the point or use the plain runner"
        )
    # Refill quantum: largest divisor of batch not exceeding the requested
    # fraction (contiguous staging slices must tile the staging block).
    want = max(1, int(batch * refill_frac))
    refill_min = next(d for d in range(want, 0, -1) if batch % d == 0)
    stacked = _continuation_point(
        code, point_key, jnp.asarray(n_err, jnp.int32),
        jnp.asarray(trials, jnp.int32), batch, segment, refill_min, opts,
    )
    # Merging into an empty PointPartials applies the n_sp == 0 min/max
    # convention, so partials compare bit-equal with the plain runner.
    total = PointPartials().merge(partials_from_stacked(jax.device_get(stacked)))
    if tick is not None:
        tick(total.n_trials)
    return total, n_err / code.n_vars
