"""QC-structured intra-frame node-sharded BP decoding (round 4).

The general node-sharded decoder (:mod:`parallel.node_sharded`) pays for
its generality: arbitrary adjacency forces variable-major segment-sums
and row gathers and, worse, the cross-shard check product forces a
log/exp formulation.  This module is the QC-structured variant: for a
quasi-cyclic
code (codes.qc) sharded by WHOLE circulant blocks, every routing step
is a block roll and every reduction is a short static-slot reduction —
no segment ops, no gathers, no logs.

Design:

- Shard ``s`` owns a CONTIGUOUS range of base columns (``nb_s = ceil(nb
  / n_node)`` blocks, ``Nl = nb_s * z`` variables).  Contiguity matters:
  a check row's cells within one shard's column range are CONSECUTIVE
  in its check-major slot order, so each shard holds a compact slot
  range of every check row — ``u = max`` cells any (shard, row) pair
  owns, with ``u * n_node`` a little above ``dc_max``.
- Per-shard state is the check-major mirror of the single-chip fused
  loop (decoder.bp._DecodeCore): carried ``(tot_chk, Lr)`` of shape
  ``[u, M, B]`` in the message storage dtype, ``Lq = clip(tot - Lr)``
  recomputed in-register — identical quantization points (f32 / bf16 /
  int8 fixed-point).
- Routing is traced-dynamic block rolls: the per-shard plan (which
  local block, which shift, per compact slot and base row) arrives as a
  node-sharded int32 array, and each cell is ONE ``dynamic_slice`` of a
  row-doubled block tensor — a contiguous copy at a dynamic offset (the
  doubling trick turns rotation into slicing), never a gather
  descriptor.  (The single-chip roll path unrolls STATIC shifts —
  shard_map traces one program for all shards, so the shifts here are
  data, not constants.)
- Sum-product leave-one-out WITHOUT logs: each shard computes exclusive
  prefix/suffix products over its ``u`` local slots (exactly the
  single-chip formulation, decoder/bp.py::_check_update_sum_product)
  plus its full local product ``P_s``; ONE ``all_gather`` over ``node``
  collects ``[n, M, B]`` partials and the complement product
  ``prod_{k != s} P_k`` closes the leave-one-out edge-locally — no
  division, no exp/log.  Factors have |t| <= 1 so every grouping stays
  in [-1, 1]; the grouping differs from the single-chip left-to-right
  cumprod only at shard boundaries, so sum-product agrees to f32
  rounding (decision/iteration equality asserted on the test fixtures,
  exactly the bar the general node-sharded decoder meets).
- Min-sum is BIT-IDENTICAL on any mesh: per-slot float-bits minima and
  integer sign counts are exactly associative; the tie rule (exclude
  the FIRST row-minimum occurrence in global slot order) is enforced
  with a per-cell static global-slot-rank tensor.
- Communication per iteration: one ``all_gather`` of the stacked check
  partials and one integer parity ``psum`` for the decision syndrome —
  same two-collective structure as the general decoder, but the
  sum-product payload is ``[n, M, B]`` raw products instead of log
  magnitudes (no transcendental pre/post-processing on the hot path).

Composes with trial-grid data parallelism on a 2-D ``(trial, node)``
mesh exactly like the general decoder.  Codes whose ``nb`` does not
divide the mesh pad with edgeless dummy blocks (LLR pinned positive).

Round 5 adds the LAYERED schedule on the same shard plan (verdict r4
item 4: the schedule that halves sweeps and the decoder that shards
giant frames were mutually exclusive).  Layers are base ROWS of the
lift; the shard plan is base COLUMNS — so one layer's check update
needs its row's ``dc`` cells, spread over the shards.  Per layer each
shard computes its local cells' bit->check messages and ONE
``all_gather`` of a [z, B]-sized partial (sum-product: the masked local
tanh product; min-sum: the packed local top-2/sign stats) closes the
leave-one-out exactly as the flooding path's full-matrix gather does —
then every shard updates its own total-LLR blocks immediately, so later
layers in the same sweep see earlier layers' corrections.  Traffic per
sweep: ``mb`` collectives of [n, z, B] vs flooding's one of [n, M, B] =
[n, mb*z, B] — the SAME bytes, ``mb``x the collective count (latency,
not bandwidth); at ~half the sweeps to converge (benchmarks/layered.md)
the composition moves ~half the bytes of flooding node-sharding
end-to-end.  Semantics match decoder/layered.py::layered_decode_batch_last
(same update order within a row = ascending global slot order, same
clip/storage-rounding points, no peeled unclipped first sweep); min-sum
is bit-identical on any mesh for the same reason the flooding path is.

Reference contrast: the reference decodes one frame per CPU thread with
cursor scatters (src/qkd_ldpc_algorithm.cpp:56-72,128-139) and has no
intra-frame parallelism at all (SURVEY.md §2); this axis is new here.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu.codes.qc import qc_cells
from qkd_ldpc_tpu.decoder.bp import DecodeOptions, _exclusive_cumprod
from qkd_ldpc_tpu.parallel.mesh import NODE_AXIS, TRIAL_AXIS

# Float-bits of +inf (monotonic cap).  A plain numpy scalar, NOT
# jnp.int32: a module-level jnp constant creates a device array at
# import time, which initializes the XLA backend and breaks any caller
# that must run jax.distributed.initialize() first (the rank-aware CLI
# imports qkd_ldpc_tpu.parallel before bringing up the process group).
_INF_BITS = np.int32(0x7F800000)


@dataclasses.dataclass(frozen=True)
class QCShardPlan:
    """Static shape info + per-shard routing tables for one (code, n_node).

    The arrays are stacked per shard on axis 0 (shard_map shards them
    over ``node``); inside the sharded program each shard sees only its
    own ``[1, ...]`` slice.
    """

    z: int
    nb: int  # real column blocks (before padding)
    mb: int
    nb_s: int  # column blocks per shard (after padding)
    u: int  # compact check-major slots per shard
    dv: int  # variable-side slots (== code.dv_max)
    # [n, u, mb]: local column block / circulant shift / global slot
    # rank of each shard's compact check cell (-1 / 0 / dc sentinel
    # when the (shard, row) pair owns fewer than u cells).
    chk_col: np.ndarray
    chk_shift: np.ndarray
    chk_gslot: np.ndarray
    # [n, dv, nb_s]: compact slot / base row / shift of each local
    # variable block's k-th edge in ascending check order (-1 padded).
    var_t: np.ndarray
    var_i: np.ndarray
    var_shift: np.ndarray


def build_qc_shard_plan(qc: tuple, n_node: int) -> QCShardPlan:
    """Partition a QC layout into ``n_node`` contiguous column-block
    shards; see the module docstring for why contiguity matters."""
    z, nb, mb, cells = qc_cells(qc)
    nb_s = -(-nb // n_node)

    row_cols: dict[int, list[int]] = {}
    col_rows: dict[int, list[int]] = {}
    for (i, j) in cells:
        row_cols.setdefault(i, []).append(j)
        col_rows.setdefault(j, []).append(i)
    row_cols = {i: sorted(js) for i, js in row_cols.items()}
    col_rows = {j: sorted(rs) for j, rs in col_rows.items()}
    dv = max(len(rs) for rs in col_rows.values())

    counts = np.zeros((n_node, mb), np.int64)
    slot_of: dict[tuple[int, int], int] = {}
    for i, js in row_cols.items():
        for j in js:  # ascending j => compact slots keep global order
            s = j // nb_s
            slot_of[(i, j)] = int(counts[s, i])
            counts[s, i] += 1
    u = int(counts.max())

    chk_col = np.full((n_node, u, mb), -1, np.int32)
    chk_shift = np.zeros((n_node, u, mb), np.int32)
    chk_gslot = np.full((n_node, u, mb), max(len(js) for js in row_cols.values()),
                        np.int32)
    for i, js in row_cols.items():
        for rank, j in enumerate(js):
            s, t = j // nb_s, slot_of[(i, j)]
            chk_col[s, t, i] = j - s * nb_s
            chk_shift[s, t, i] = cells[(i, j)]
            chk_gslot[s, t, i] = rank

    var_t = np.full((n_node, dv, nb_s), -1, np.int32)
    var_i = np.zeros((n_node, dv, nb_s), np.int32)
    var_shift = np.zeros((n_node, dv, nb_s), np.int32)
    for j, rs in col_rows.items():
        s, jl = j // nb_s, j % nb_s
        for k, i in enumerate(rs):
            var_t[s, k, jl] = slot_of[(i, j)]
            var_i[s, k, jl] = i
            var_shift[s, k, jl] = cells[(i, j)]

    return QCShardPlan(z=z, nb=nb, mb=mb, nb_s=nb_s, u=u, dv=dv,
                       chk_col=chk_col, chk_shift=chk_shift,
                       chk_gslot=chk_gslot, var_t=var_t, var_i=var_i,
                       var_shift=var_shift)


def bp_decode_qc_node_sharded(
    code: LDPCCode,
    llr: jax.Array,  # [N, B] a-priori LLRs (batch last)
    syndrome: jax.Array,  # [M, B] target syndrome (batch last)
    opts: DecodeOptions,
    mesh: Mesh,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """QC node-sharded decode; returns (z [N,B] int8, iters [B], ok [B]).

    ``code`` must carry a QC layout (``code.qc is not None``); ``mesh``
    must carry a ``node`` axis (a ``trial`` axis additionally shards the
    batch).  Semantics match :func:`decoder.bp.bp_decode_batch_last` on
    the same schedule: ``opts.schedule='flooding'`` mirrors the fused
    flooding loop (update order, early-exit bookkeeping, clamp
    placement, peeled unclipped first iteration, storage-dtype
    quantization points); ``opts.schedule='layered'`` mirrors
    :func:`decoder.layered.layered_decode_batch_last` (serial per-layer
    total-LLR updates, no peeled unclipped first sweep — see the module
    docstring for the per-layer collective structure).  The
    residency-compaction fields are ignored — they re-schedule batch
    lanes of the single-program loop and do not apply to the
    node-sharded program (results are bit-identical with or without
    compaction by construction, so nothing observable differs).
    """
    if code.qc is None:
        raise ValueError("QC node-sharding requires a QC code (codes.qc)")
    if opts.schedule == "layered":
        return _bp_decode_qc_node_sharded_layered(
            code, llr, syndrome, opts, mesh
        )
    n_node = mesh.shape[NODE_AXIS]
    has_trial = TRIAL_AXIS in mesh.axis_names
    trial = TRIAL_AXIS if has_trial else None

    plan = build_qc_shard_plan(code.qc, n_node)
    z, mb, nb_s, u, dv = plan.z, plan.mb, plan.nb_s, plan.u, plan.dv
    N, M = code.n_vars, code.n_checks
    B = llr.shape[1]
    dtype = llr.dtype
    n_pad = nb_s * n_node * z - N  # edgeless dummy variable blocks

    if opts.message_dtype == "bfloat16":
        mdt, scale = jnp.bfloat16, None
    elif opts.message_dtype == "int8":
        mdt, scale = jnp.int8, opts.int8_scale
    else:
        mdt, scale = dtype, None

    def to_storage(x):
        if scale is None:
            return x.astype(mdt)
        return jnp.clip(jnp.round(x / scale), -127.0, 127.0).astype(jnp.int8)

    def from_storage(q):
        if scale is None:
            return q.astype(dtype)
        return q.astype(dtype) * scale

    llr_p = jnp.concatenate(
        [llr, jnp.full((n_pad, B), 1.0, dtype)]
    ) if n_pad else llr
    syndrome = syndrome.astype(jnp.int32)
    threshold = jnp.asarray(opts.message_threshold, dtype)

    def clip_msgs(x):
        if opts.clip_messages:
            return jnp.clip(x, -threshold, threshold)
        return x

    chk_valid = jnp.asarray(plan.chk_col >= 0)  # [n, u, mb]
    var_valid = jnp.asarray(plan.var_t >= 0)  # [n, dv, nb_s]
    dc_sentinel = jnp.int32(int(plan.chk_gslot.max()))

    def shard_fn(llr_s, syn, chk_col, chk_shift, chk_gslot, chk_ok,
                 var_t, var_i, var_sh, var_ok):
        """One node shard: llr_s [Nl, B]; syn [M, B] node-replicated;
        plan tables [1, ...] (this shard's slice)."""
        chk_col, chk_shift, chk_gslot = chk_col[0], chk_shift[0], chk_gslot[0]
        chk_ok, var_t_, var_i_, var_sh_, var_ok = (
            chk_ok[0], var_t[0], var_i[0], var_sh[0], var_ok[0]
        )
        Bl = llr_s.shape[1]
        syn_sign = jnp.where(syn == 1, -1.0, 1.0).astype(llr_s.dtype)
        # Compact-slot validity lifted to lifted-row resolution:
        # [u, mb] -> [u, M] (each base row spans z lifted rows).
        mask_rows = jnp.repeat(chk_ok, z, axis=1)  # [u, M]
        mask3 = mask_rows[:, :, None]
        gslot3 = jnp.repeat(chk_gslot, z, axis=1)[:, :, None]  # [u, M, 1]
        vmask3 = jnp.repeat(var_ok, z, axis=1)[:, :, None]  # [dv, Nl, 1]

        def gather_chk(x):
            """[Nl, B] variable rows -> [u, M, B] compact check-major
            slots, one dynamic-offset contiguous slice per base cell."""
            xb = x.reshape(nb_s, z, Bl)
            xd = jnp.concatenate([xb, xb], axis=1)  # rotation via slicing
            slabs = []
            for t in range(u):
                per_i = []
                for i in range(mb):
                    sl = jax.lax.dynamic_slice(
                        xd, (chk_col[t, i], chk_shift[t, i], 0), (1, z, Bl)
                    )[0]
                    per_i.append(sl)
                slabs.append(jnp.concatenate(per_i, axis=0))
            out = jnp.stack(slabs, axis=0)  # [u, M, Bl]
            return jnp.where(mask3, out, jnp.zeros((), x.dtype))

        def route_var(Lr):
            """[u, M, B] compact check-major -> [dv, Nl, B] variable-major
            (inverse rotations of the blocks the forward direction rolled)."""
            Lrb = Lr.reshape(u, mb, z, Bl)
            Lrd = jnp.concatenate([Lrb, Lrb], axis=2)  # [u, mb, 2z, Bl]
            outs = []
            for k in range(dv):
                per_j = []
                for jl in range(nb_s):
                    start_r = jnp.remainder(z - var_sh_[k, jl], z)
                    sl = jax.lax.dynamic_slice(
                        Lrd, (var_t_[k, jl], var_i_[k, jl], start_r, 0),
                        (1, 1, z, Bl),
                    )[0, 0]
                    per_j.append(sl)
                outs.append(jnp.concatenate(per_j, axis=0))
            out = jnp.stack(outs, axis=0)  # [dv, Nl, Bl]
            return jnp.where(vmask3, out, jnp.zeros((), Lr.dtype))

        def check_to_var_sum_product(Lq):
            """Tanh-rule leave-one-out: local prefix/suffix products +
            one all_gather of full local products (no logs, no division)."""
            t = jnp.where(mask3, jnp.tanh(Lq * 0.5), 1.0)
            pre, suf = _exclusive_cumprod(t)
            P_loc = pre[-1] * t[-1]  # full local product, [M, B]
            allP = jax.lax.all_gather(P_loc, NODE_AXIS)  # [n, M, B]
            me = jax.lax.axis_index(NODE_AXIS)
            others = jnp.prod(
                jnp.where(
                    (jnp.arange(n_node) == me)[:, None, None],
                    jnp.ones((), t.dtype), allP,
                ),
                axis=0,
            )
            x = pre * suf * (others * syn_sign)[None]
            return jnp.log1p(2.0 * x / (1.0 - x))

        def check_to_var_min_sum(Lq):
            """Normalized min-sum: float-bits top-2 over local compact
            slots, global merge after one all_gather; tie rule = first
            row-minimum occurrence in GLOBAL slot order (bit-identical
            to the single-chip kernel on any mesh)."""
            absL = jnp.where(mask3, jnp.abs(Lq), jnp.inf)
            bits = jax.lax.bitcast_convert_type(absL, jnp.int32)
            neg = jnp.where(mask3 & (Lq < 0), jnp.int32(1), jnp.int32(0))

            min1_l = jnp.minimum(jnp.min(bits, axis=0), _INF_BITS)
            at1 = bits == min1_l[None]
            slot1_l = jnp.min(
                jnp.where(at1, gslot3, dc_sentinel), axis=0
            )
            own_l = at1 & (gslot3 == slot1_l[None])
            min2_l = jnp.minimum(
                jnp.min(jnp.where(own_l, _INF_BITS, bits), axis=0), _INF_BITS
            )
            local = jnp.stack(
                [min1_l, slot1_l, min2_l, jnp.sum(neg, axis=0)]
            )
            allc = jax.lax.all_gather(local, NODE_AXIS)  # [n, 4, M, B]
            c_min1, c_slot1, c_min2, c_neg = (
                allc[:, 0], allc[:, 1], allc[:, 2], allc[:, 3]
            )
            min1_g = jnp.min(c_min1, axis=0)
            slot1_g = jnp.min(
                jnp.where(c_min1 == min1_g, c_slot1, dc_sentinel), axis=0
            )
            ex1 = (c_min1 == min1_g) & (c_slot1 == slot1_g)
            min2_g = jnp.minimum(
                jnp.min(jnp.where(ex1, _INF_BITS, c_min1), axis=0),
                jnp.min(c_min2, axis=0),
            )
            row_neg = jnp.sum(c_neg, axis=0)

            own_g = at1 & (gslot3 == slot1_g[None])
            loo_bits = jnp.where(own_g, min2_g[None], min1_g[None])
            loo = jax.lax.bitcast_convert_type(loo_bits, jnp.float32).astype(
                llr_s.dtype
            )
            loo_neg = (row_neg[None] - neg) & 1
            sign = jnp.where(loo_neg == 1, -1.0, 1.0) * syn_sign[None]
            if opts.min_sum_beta:
                loo = jnp.maximum(loo - opts.min_sum_beta, 0.0)
            return opts.min_sum_alpha * sign * loo

        check_to_var = (
            check_to_var_min_sum
            if opts.algorithm == "min-sum"
            else check_to_var_sum_product
        )

        def check_update(Lq):
            return to_storage(clip_msgs(check_to_var(Lq)))

        def after_check(Lr):
            """Route -> totals -> decisions -> syndrome -> gathered totals
            (the compact-slot mirror of _DecodeCore.after_check)."""
            Lr_var = route_var(from_storage(Lr))
            total = to_storage(llr_s + jnp.sum(Lr_var, axis=0))
            zdec = (total <= 0).astype(jnp.int8)
            tot_chk = gather_chk(total)
            z_chk = jnp.where(
                mask3, (tot_chk <= 0).astype(jnp.int32), 0
            )
            syn_hat = jax.lax.psum(jnp.sum(z_chk, axis=0), NODE_AXIS) & 1
            ok = jnp.all(syn_hat == syn, axis=0)  # [B], shard-replicated
            return tot_chk, zdec, ok

        # Peeled iteration 1: check inputs are the storage-rounded but
        # UNCLIPPED a-priori LLRs (reference qkd_ldpc_algorithm.cpp:10-18).
        Lq0 = from_storage(gather_chk(to_storage(llr_s)))
        Lr1 = check_update(Lq0)
        tot1, z1, ok1 = after_check(Lr1)
        init = (tot1, Lr1, z1, jnp.ones((Bl,), jnp.int32), ok1,
                jnp.asarray(1, jnp.int32))

        def body(carry):
            tot_chk, Lr, z_out, iters, done, it = carry
            Lq = clip_msgs(from_storage(tot_chk) - from_storage(Lr))
            Lr_new = check_update(Lq)
            tot_new, zdec, ok = after_check(Lr_new)
            active = jnp.logical_not(done)
            z_out = jnp.where(active[None, :], zdec, z_out)
            iters = jnp.where(active, it + 1, iters)
            done = jnp.logical_or(done, ok)
            return tot_new, Lr_new, z_out, iters, done, it + 1

        def cond(carry):
            *_, done, it = carry
            return jnp.logical_and(it < opts.max_iterations, ~jnp.all(done))

        *_, z_out, iters, done, _ = jax.lax.while_loop(cond, body, init)
        iters = jnp.where(done, iters, opts.max_iterations)
        return z_out, iters, done

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(NODE_AXIS, trial),  # llr
            P(None, trial),  # syndrome
            P(NODE_AXIS), P(NODE_AXIS), P(NODE_AXIS), P(NODE_AXIS),  # chk plan
            P(NODE_AXIS), P(NODE_AXIS), P(NODE_AXIS), P(NODE_AXIS),  # var plan
        ),
        out_specs=(P(NODE_AXIS, trial), P(trial), P(trial)),
        check_vma=False,
    )
    zdec, iters, ok = sharded(
        llr_p, syndrome,
        jnp.asarray(plan.chk_col), jnp.asarray(plan.chk_shift),
        jnp.asarray(plan.chk_gslot), chk_valid,
        jnp.asarray(plan.var_t), jnp.asarray(plan.var_i),
        jnp.asarray(plan.var_shift), var_valid,
    )
    return zdec[:N], iters, ok


def _bp_decode_qc_node_sharded_layered(
    code: LDPCCode,
    llr: jax.Array,  # [N, B] a-priori LLRs (batch last)
    syndrome: jax.Array,  # [M, B] target syndrome (batch last)
    opts: DecodeOptions,
    mesh: Mesh,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Layered schedule on the QC column-block shard plan.

    One sweep = ``mb`` serial layers; per layer ONE all_gather of a
    [z, B] partial closes the row's leave-one-out across shards, then
    each shard applies the delta to its own total-LLR blocks
    immediately.  Trajectory family = decoder/layered.py (min-sum
    bit-identical on any mesh; sum-product decision/iteration-equal,
    its cross-shard product grouping differing only at shard
    boundaries).
    """
    n_node = mesh.shape[NODE_AXIS]
    has_trial = TRIAL_AXIS in mesh.axis_names
    trial = TRIAL_AXIS if has_trial else None

    plan = build_qc_shard_plan(code.qc, n_node)
    z, mb, nb_s, u = plan.z, plan.mb, plan.nb_s, plan.u
    N = code.n_vars
    B = llr.shape[1]
    dtype = llr.dtype
    n_pad = nb_s * n_node * z - N

    if opts.message_dtype == "bfloat16":
        mdt, scale = jnp.bfloat16, None
    elif opts.message_dtype == "int8":
        mdt, scale = jnp.int8, opts.int8_scale
    else:
        mdt, scale = dtype, None

    def to_storage(x):
        if scale is None:
            return x.astype(mdt)
        return jnp.clip(jnp.round(x / scale), -127.0, 127.0).astype(jnp.int8)

    def from_storage(q):
        if scale is None:
            return q.astype(dtype)
        return q.astype(dtype) * scale

    llr_p = jnp.concatenate(
        [llr, jnp.full((n_pad, B), 1.0, dtype)]
    ) if n_pad else llr
    syndrome = syndrome.astype(jnp.int32)
    threshold = jnp.asarray(opts.message_threshold, dtype)

    def clip_msgs(x):
        if opts.clip_messages:
            return jnp.clip(x, -threshold, threshold)
        return x

    chk_valid = jnp.asarray(plan.chk_col >= 0)  # [n, u, mb]
    dc_sentinel = jnp.int32(int(plan.chk_gslot.max()))
    lr_zero = to_storage(jnp.zeros((), dtype)).dtype

    def shard_fn(llr_s, syn, chk_col, chk_shift, chk_gslot, chk_ok):
        """One node shard: llr_s [Nl, B]; syn [M, B] node-replicated;
        plan tables [1, u, mb] (this shard's slice)."""
        chk_col, chk_shift, chk_gslot, chk_ok = (
            chk_col[0], chk_shift[0], chk_gslot[0], chk_ok[0]
        )
        Bl = llr_s.shape[1]
        syn_rows = syn.reshape(mb, z, Bl)
        sgn_rows = jnp.where(syn_rows == 1, -1.0, 1.0).astype(dtype)
        me = jax.lax.axis_index(NODE_AXIS)
        not_me = (jnp.arange(n_node) != me)[:, None, None]

        def gather_layer(x3, i):
            """[nb_s, z, Bl] local blocks -> this shard's [u, z, Bl]
            compact cells of layer i, each a rotation realized as two
            contiguous dynamic slices (block pick + doubled-block
            slice) — never a gather descriptor.  Invalid slots (col
            sentinel -1 clamps to block 0) carry garbage; every
            consumer masks on ``chk_ok[:, i]``."""
            outs = []
            for t in range(u):
                blk = jax.lax.dynamic_slice(
                    x3, (chk_col[t, i], 0, 0), (1, z, Bl)
                )[0]
                bd = jnp.concatenate([blk, blk], axis=0)
                outs.append(jax.lax.dynamic_slice(
                    bd, (chk_shift[t, i], 0), (z, Bl)
                ))
            return jnp.stack(outs)  # [u, z, Bl]

        def layer_check_update(Lq, i, v3):
            """Cross-shard leave-one-out for layer i's local cells.
            Lq [u, z, Bl]; v3 [u, 1, 1] validity; returns Lr_new
            [u, z, Bl] (garbage at invalid slots — callers mask)."""
            sgn = sgn_rows[i]
            if opts.algorithm == "min-sum":
                gslot3 = chk_gslot[:, i][:, None, None]
                absL = jnp.where(v3, jnp.abs(Lq), jnp.inf)
                bits = jax.lax.bitcast_convert_type(
                    absL.astype(jnp.float32), jnp.int32
                )
                neg = jnp.where(v3 & (Lq < 0), jnp.int32(1), jnp.int32(0))
                min1_l = jnp.minimum(jnp.min(bits, axis=0), _INF_BITS)
                at1 = bits == min1_l[None]
                slot1_l = jnp.min(
                    jnp.where(at1, gslot3, dc_sentinel), axis=0
                )
                own_l = at1 & (gslot3 == slot1_l[None])
                min2_l = jnp.minimum(
                    jnp.min(jnp.where(own_l, _INF_BITS, bits), axis=0),
                    _INF_BITS,
                )
                local = jnp.stack(
                    [min1_l, slot1_l, min2_l, jnp.sum(neg, axis=0)]
                )  # [4, z, Bl]
                allc = jax.lax.all_gather(local, NODE_AXIS)  # [n, 4, z, Bl]
                c_min1, c_slot1, c_min2, c_neg = (
                    allc[:, 0], allc[:, 1], allc[:, 2], allc[:, 3]
                )
                min1_g = jnp.min(c_min1, axis=0)
                slot1_g = jnp.min(
                    jnp.where(c_min1 == min1_g, c_slot1, dc_sentinel), axis=0
                )
                ex1 = (c_min1 == min1_g) & (c_slot1 == slot1_g)
                min2_g = jnp.minimum(
                    jnp.min(jnp.where(ex1, _INF_BITS, c_min1), axis=0),
                    jnp.min(c_min2, axis=0),
                )
                row_neg = jnp.sum(c_neg, axis=0)
                own_g = at1 & (gslot3 == slot1_g[None])
                loo_bits = jnp.where(own_g, min2_g[None], min1_g[None])
                loo = jax.lax.bitcast_convert_type(
                    loo_bits, jnp.float32
                ).astype(dtype)
                loo_neg = (row_neg[None] - neg) & 1
                sign = jnp.where(loo_neg == 1, -1.0, 1.0) * sgn[None]
                if opts.min_sum_beta:
                    loo = jnp.maximum(loo - opts.min_sum_beta, 0.0)
                return opts.min_sum_alpha * sign * loo
            t_ = jnp.where(v3, jnp.tanh(Lq * 0.5), 1.0)
            pre, suf = _exclusive_cumprod(t_)
            P_loc = pre[-1] * t_[-1]  # [z, Bl]
            allP = jax.lax.all_gather(P_loc, NODE_AXIS)  # [n, z, Bl]
            others = jnp.prod(
                jnp.where(not_me, allP, jnp.ones((), t_.dtype)), axis=0
            )
            x = pre * suf * (others * sgn)[None]
            return jnp.log1p(2.0 * x / (1.0 - x))

        def sweep(t_loc, Lr, act_b):
            """One serial pass over all mb layers (static unroll, like
            decoder/layered.py); act_b [Bl] bool gates every update."""
            for i in range(mb):
                v3 = chk_ok[:, i][:, None, None]
                gact = v3 & act_b[None, None, :]
                tot_cells = gather_layer(t_loc, i)
                Lr_i = from_storage(Lr[:, i])
                Lq = clip_msgs(tot_cells - Lr_i)
                Lr_new_q = to_storage(clip_msgs(layer_check_update(Lq, i, v3)))
                delta = jnp.where(gact, from_storage(Lr_new_q) - Lr_i,
                                  jnp.zeros((), dtype))
                for t in range(u):
                    dd = jnp.concatenate([delta[t], delta[t]], axis=0)
                    start = jnp.remainder(z - chk_shift[t, i], z)
                    inv = jax.lax.dynamic_slice(dd, (start, 0), (z, Bl))
                    cur = jax.lax.dynamic_slice(
                        t_loc, (chk_col[t, i], 0, 0), (1, z, Bl)
                    )
                    # Invalid/inactive slots carry delta 0; the clamped
                    # sentinel block index then adds zero to block 0.
                    t_loc = jax.lax.dynamic_update_slice(
                        t_loc, cur + inv[None], (chk_col[t, i], 0, 0)
                    )
                Lr = Lr.at[:, i].set(jnp.where(gact, Lr_new_q, Lr[:, i]))
            return t_loc, Lr

        def syndrome_ok(t_loc):
            """Decision syndrome == target, per frame ([Bl] bool): local
            slot counts per layer, ONE integer psum, parity compare."""
            zdec = (t_loc <= 0).astype(jnp.int32)  # [nb_s, z, Bl]
            counts = []
            for i in range(mb):
                cells = gather_layer(zdec, i)  # [u, z, Bl]
                cells = jnp.where(chk_ok[:, i][:, None, None], cells, 0)
                counts.append(jnp.sum(cells, axis=0))
            parity = jax.lax.psum(jnp.stack(counts), NODE_AXIS) & 1
            return jnp.all(parity == syn_rows, axis=(0, 1))

        t0 = llr_s.reshape(nb_s, z, Bl)
        Lr0 = jnp.zeros((u, mb, z, Bl), lr_zero)

        def body(carry):
            t_loc, Lr, it, iters, done = carry
            act = jnp.logical_not(done)
            t_loc, Lr = sweep(t_loc, Lr, act)
            it = it + 1
            newly = act & syndrome_ok(t_loc)
            iters = jnp.where(newly, it, iters)
            done = jnp.logical_or(done, newly)
            return t_loc, Lr, it, iters, done

        def cond(carry):
            _, _, it, _, done = carry
            return jnp.logical_and(
                it < opts.max_iterations, ~jnp.all(done)
            )

        init = (
            t0, Lr0, jnp.asarray(0, jnp.int32),
            jnp.zeros((Bl,), jnp.int32), jnp.zeros((Bl,), bool),
        )
        t_loc, _, _, iters, done = jax.lax.while_loop(cond, body, init)
        z_out = (t_loc <= 0).astype(jnp.int8).reshape(nb_s * z, Bl)
        iters = jnp.where(
            done, jnp.maximum(iters, 1), opts.max_iterations
        )
        return z_out, iters, done

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(NODE_AXIS, trial),  # llr
            P(None, trial),  # syndrome
            P(NODE_AXIS), P(NODE_AXIS), P(NODE_AXIS), P(NODE_AXIS),
        ),
        out_specs=(P(NODE_AXIS, trial), P(trial), P(trial)),
        check_vma=False,
    )
    zdec, iters, ok = sharded(
        llr_p, syndrome,
        jnp.asarray(plan.chk_col), jnp.asarray(plan.chk_shift),
        jnp.asarray(plan.chk_gslot), chk_valid,
    )
    return zdec[:N], iters, ok


@partial(jax.jit, static_argnames=("opts", "mesh"))
def _decode_qc_node_sharded_jit(code, llr_t, syn_t, opts, mesh):
    return bp_decode_qc_node_sharded(code, llr_t, syn_t, opts, mesh)


def decode_qc_node_sharded(
    code: LDPCCode,
    llr: jax.Array,  # [B, N] or [N]
    syndrome: jax.Array,  # [B, M] or [M]
    opts: DecodeOptions,
    mesh: Mesh,
):
    """Batch-first convenience wrapper (mirrors ``decoder.bp.decode``).

    Pads the batch to a multiple of the mesh's ``trial`` axis (inert
    all-zero frames, sliced off on return) so any request size works —
    the sweep runners round their own batches; this is for direct use.
    """
    from qkd_ldpc_tpu.decoder.bp import DecodeResult

    single = llr.ndim == 1
    if single:
        llr = llr[None, :]
        syndrome = syndrome[None, :]
    syndrome = jnp.asarray(syndrome)
    B = llr.shape[0]
    n_trial = mesh.shape.get(TRIAL_AXIS, 1)
    pad = (-B) % n_trial
    if pad:
        llr = jnp.concatenate(
            [llr, jnp.full((pad, llr.shape[1]), 1.0, llr.dtype)])
        syndrome = jnp.concatenate(
            [syndrome, jnp.zeros((pad, syndrome.shape[1]), syndrome.dtype)])
    z, iters, ok = _decode_qc_node_sharded_jit(
        code, llr.T, syndrome.T, opts, mesh
    )
    res = DecodeResult(bits=z.T[:B], iterations=iters[:B],
                       syndromes_match=ok[:B])
    if single:
        res = DecodeResult(res.bits[0], res.iterations[0],
                           res.syndromes_match[0])
    return res
