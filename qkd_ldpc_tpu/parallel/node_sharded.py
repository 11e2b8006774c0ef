"""Intra-frame node-sharded BP decoding: one frame split across devices.

The reference decodes each frame on a single CPU thread — there is no
intra-frame parallelism at all (SURVEY.md §2 "Parallelism strategies").
This module adds the axis the reference lacks: the **variable nodes of
one frame are partitioned into contiguous blocks across the ``node``
mesh axis**, so frames far larger than one device's memory (or latency
targets tighter than one device's decode) scale over the interconnect.

Design (the sharding recipe, scaling-book style):

- All per-variable state lives on the owning shard in **variable-major**
  layout: a-priori LLRs ``llr[Nl, B]``, check->bit messages
  ``Lr[Nl, dv_max, B]``, totals, hard decisions.  There is no
  check-major message tensor at all.  The loop carries ``(total, Lr)``
  and recomputes ``Lq = clip(total - Lr)`` in-register (round 3) — the
  same fused-update treatment the single-device loop uses
  (decoder.bp), so the bit-to-check messages are never stored *and*
  the storage-dtype rounding points
  (totals and Lr round through ``message_dtype``; Lq never does) are
  exactly the single-chip loop's.
- A check node's update needs a product over *all* its incident edges,
  which straddle shards.  Each shard reduces its local edges into
  per-check partial sums — log|tanh| sums, sign-bit counts, and (for the
  decision syndrome) bit parities — with a segment-sum, and one
  ``psum`` over the ``node`` axis completes the global per-check rows.
  Leave-one-out then happens edge-locally: global row minus the edge's own
  contribution (the numerically-safe form of the reference's
  ``row_prod / tanh_j`` division, ``src/qkd_ldpc_algorithm.cpp:67``).
- **Min-sum** needs the global top-2 |message| minima per check (not a
  sum): each shard computes its local top-2 candidates (value as
  monotonic int32 float-bits, plus the check-major slot index of the
  minimum for the single-chip tie rule) with segment-mins, one
  ``all_gather`` over ``node`` collects all shards' candidates, and the
  global (min1, first-slot, min2) merge is then shard-local.  Because
  min and integer sign-counts are exactly associative, node-sharded
  min-sum is bit-identical to the single-device decoder on any mesh.
- Communication per iteration: exactly two collectives of ``[M, B]``-row
  tensors (one fused stack for the check update — a ``psum`` for
  sum-product, an ``all_gather`` for min-sum — and one int parity
  ``psum`` for the decision syndrome).  Everything else is
  shard-local.

Composes with trial-grid data parallelism: on a 2-D ``(trial, node)``
mesh the batch axis shards over ``trial`` while each frame's variable
nodes shard over ``node`` (DP x "tensor parallel" in scaling-book terms).

Semantics are identical to the single-chip decoder
(:func:`qkd_ldpc_tpu.decoder.bp.bp_decode_batch_last`): same update
order, same early-exit iteration bookkeeping (reference
``src/qkd_ldpc_algorithm.cpp:105-126``), same clamp placement
(``:74-77,141-144``), same peeled unclipped first iteration, and —
since the round-3 ``(total, Lr)`` carry — the same storage-dtype
quantization points for bfloat16 messages.  Min-sum is bit-identical
on any mesh (its reductions are exactly associative and its inputs now
round identically); sum-product's distributed log-sum matches the
single-chip product formulation to f32 rounding, with decision/
iteration equality asserted on the test fixtures.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu.decoder.bp import DecodeOptions
from qkd_ldpc_tpu.parallel.mesh import NODE_AXIS, TRIAL_AXIS

_TINY = 1e-30


def _pad_rows(a, n_pad, fill):
    if n_pad == 0:
        return a
    pad = jnp.full((n_pad,) + a.shape[1:], fill, a.dtype)
    return jnp.concatenate([a, pad], axis=0)


def bp_decode_node_sharded(
    code: LDPCCode,
    llr: jax.Array,  # [N, B] a-priori LLRs (batch last)
    syndrome: jax.Array,  # [M, B] target syndrome (batch last)
    opts: DecodeOptions,
    mesh: Mesh,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Node-sharded decode; returns (z [N,B] int8, iters [B], ok [B]).

    ``mesh`` must carry a ``node`` axis; a ``trial`` axis, if present,
    shards the batch dimension as well.  N is padded internally to a
    multiple of the node-axis size with isolated dummy variables (no
    edges, strongly-biased LLR), so any code works on any mesh.
    Flooding schedule only (``schedule='layered'`` raises — the layered
    sweep runs on the single-device/trial-sharded paths); the residency-
    compaction fields are ignored, as in the QC node-sharded decoder.
    """
    if opts.schedule != "flooding":
        raise ValueError(
            "node-sharded decoding implements the flooding schedule only; "
            f"schedule={opts.schedule!r} runs on the single-device or "
            "trial-sharded paths (decoder/layered.py)"
        )
    n_node = mesh.shape[NODE_AXIS]
    has_trial = TRIAL_AXIS in mesh.axis_names
    trial = TRIAL_AXIS if has_trial else None

    N, M = code.n_vars, code.n_checks
    dc = code.dc_max
    B = llr.shape[1]
    n_pad = (-N) % n_node
    dtype = llr.dtype
    # Storage dtype of the carried state (decoder.bp's message_dtype
    # contract): totals and Lr round through the storage dtype, compute
    # stays in `dtype`, Lq is recomputed in-register and never stored —
    # the exact quantization points of the single-chip fused loop
    # (decoder.bp._DecodeCore), for bf16 AND int8 fixed-point.
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

    var_adj = jnp.asarray(code.var_adj)
    var_mask = jnp.asarray(code.var_mask)
    # Check-major slot index j of each variable-side edge (static):
    # var_slot stores the flat slot c*dc_max + j, so j = var_slot % dc_max.
    # Min-sum's tie rule needs it (single-chip kernel excludes the FIRST
    # occurrence of the row minimum in check-major slot order).
    var_jslot = jnp.asarray(code.var_slot) % jnp.int32(dc)
    # Dummy variables: no edges, LLR pinned positive -> decision bit 0,
    # zero contribution to every check row.
    var_adj_p = _pad_rows(var_adj, n_pad, 0)
    var_mask_p = _pad_rows(var_mask, n_pad, False)
    var_jslot_p = _pad_rows(var_jslot, n_pad, 0)
    llr_p = _pad_rows(llr, n_pad, jnp.asarray(1.0, llr.dtype))

    syndrome = syndrome.astype(jnp.int32)
    threshold = jnp.asarray(opts.message_threshold, llr.dtype)

    def clip_msgs(x):
        if opts.clip_messages:
            return jnp.clip(x, -threshold, threshold)
        return x

    _INF_BITS = jnp.int32(0x7F800000)  # float-bits of +inf (monotonic cap)

    def shard_fn(llr_s, var_adj_s, var_mask_s, var_jslot_s, syn):
        """Runs on one node shard: llr_s [Nl, B], syn [M, B] (replicated
        over node, sharded over trial)."""
        Nl, dv = var_adj_s.shape
        seg = jnp.where(var_mask_s, var_adj_s, M).reshape(-1)  # [Nl*dv]
        mask3 = var_mask_s[:, :, None]
        syn_sign = jnp.where(syn == 1, -1.0, 1.0).astype(llr_s.dtype)

        def seg_sum(x):  # [Nl, dv, B] -> [M, B] local partial
            flat = x.reshape(Nl * dv, -1)
            return jax.ops.segment_sum(flat, seg, num_segments=M + 1)[:M]

        def seg_min(x):  # [Nl, dv, B] int32 -> [M, B] local min partial
            flat = x.reshape(Nl * dv, -1)
            return jax.ops.segment_min(flat, seg, num_segments=M + 1)[:M]

        def gather_rows(rows):  # [M, B] -> [Nl, dv, B] per local edge
            return jnp.take(rows, var_adj_s.reshape(-1), axis=0).reshape(
                Nl, dv, -1
            )

        def check_to_var_sum_product(Lq):
            """Check update distributed over shards: local partials ->
            psum -> edge-local leave-one-out."""
            t = jnp.tanh(Lq * 0.5)
            t = jnp.where(mask3, t, 1.0)
            mag = jnp.maximum(jnp.abs(t), _TINY)
            logmag = jnp.where(mask3, jnp.log(mag), 0.0)
            neg = jnp.where(mask3, (t < 0).astype(llr_s.dtype), 0.0)

            partial_rows = jnp.stack([seg_sum(logmag), seg_sum(neg)])
            global_rows = jax.lax.psum(partial_rows, NODE_AXIS)
            row_log, row_neg = global_rows[0], global_rows[1]

            loo_neg = (gather_rows(row_neg) - neg).astype(jnp.int32) & 1
            sign = jnp.where(loo_neg == 1, -1.0, 1.0) * gather_rows(syn_sign)

            # Log-magnitude leave-one-out: q = exp(row)/own-mag, capped
            # at 1; 2 atanh(q) = log1p(2q/(1-q)).  The single-chip kernel
            # (decoder.bp) computes the same quantity via prefix/suffix
            # PRODUCTS (no cross-shard product exists without logs), so
            # the two formulations agree to f32 rounding — decision/
            # iteration equality is asserted on the test fixtures.
            q = jnp.minimum(gather_rows(jnp.exp(row_log)) / mag, 1.0)
            return sign * jnp.log1p(2.0 * q / (1.0 - q))

        def check_to_var_min_sum(Lq):
            """Normalized min-sum check update distributed over shards.

            |message| is compared as its int32 float-bits (monotonic for
            non-negative floats), so min reductions are exact; the global
            top-2 per check merges each shard's local (min1, first-slot,
            min2) candidates after ONE all_gather.  Tie rule matches the
            single-chip kernel: the excluded edge is the first occurrence
            of the row minimum in check-major slot order.
            """
            absL = jnp.where(mask3, jnp.abs(Lq), jnp.inf)
            bits = jax.lax.bitcast_convert_type(absL, jnp.int32)
            neg = jnp.where(mask3 & (Lq < 0), jnp.int32(1), jnp.int32(0))
            jslot = var_jslot_s[:, :, None]
            big_slot = jnp.int32(dc)

            min1_l = jnp.minimum(seg_min(bits), _INF_BITS)
            at_min1 = bits == gather_rows(min1_l)
            slot1_l = seg_min(jnp.where(at_min1, jslot, big_slot))
            own = at_min1 & (jslot == gather_rows(slot1_l))
            min2_l = jnp.minimum(seg_min(jnp.where(own, _INF_BITS, bits)), _INF_BITS)

            # One collective: stack local candidates + the sign partial.
            local = jnp.stack([min1_l, slot1_l, min2_l, seg_sum(neg)])
            allc = jax.lax.all_gather(local, NODE_AXIS)  # [n, 4, M, B]
            c_min1, c_slot1, c_min2, c_neg = (
                allc[:, 0], allc[:, 1], allc[:, 2], allc[:, 3]
            )

            min1_g = jnp.min(c_min1, axis=0)
            slot1_g = jnp.min(
                jnp.where(c_min1 == min1_g, c_slot1, big_slot), axis=0
            )
            # Exclude exactly the global first-occurrence edge (unique:
            # (check, slot) identifies one edge on one shard), then the
            # global second minimum is the min over all remaining
            # candidates from both candidate ranks.
            ex1 = (c_min1 == min1_g) & (c_slot1 == slot1_g)
            min2_g = jnp.minimum(
                jnp.min(jnp.where(ex1, _INF_BITS, c_min1), axis=0),
                jnp.min(c_min2, axis=0),
            )
            row_neg = jnp.sum(c_neg, axis=0)

            own_g = at_min1 & (jslot == gather_rows(slot1_g))
            loo_bits = jnp.where(own_g, gather_rows(min2_g), gather_rows(min1_g))
            loo_min = jax.lax.bitcast_convert_type(loo_bits, jnp.float32).astype(
                llr_s.dtype
            )
            loo_neg = (gather_rows(row_neg) - neg) & 1
            sign = jnp.where(loo_neg == 1, -1.0, 1.0) * gather_rows(syn_sign)
            if opts.min_sum_beta:
                loo_min = jnp.maximum(loo_min - opts.min_sum_beta, 0.0)
            return opts.min_sum_alpha * sign * loo_min

        check_to_var = (
            check_to_var_min_sum
            if opts.algorithm == "min-sum"
            else check_to_var_sum_product
        )

        def check_update(Lq):
            """f32 bit->check messages -> storage-rounded check->bit."""
            return to_storage(clip_msgs(check_to_var(Lq)))

        def after_check(Lr):
            """Totals (storage-rounded), decisions, decision syndrome —
            the var-major mirror of decoder.bp._DecodeCore.after_check."""
            Lr_f = from_storage(Lr)
            total = to_storage(
                llr_s + jnp.sum(jnp.where(mask3, Lr_f, 0.0), axis=1)
            )
            z = (total <= 0).astype(jnp.int8)
            # Decision syndrome: local parity partials -> psum.
            z_edge = jnp.where(mask3, z[:, None, :].astype(jnp.int32), 0)
            syn_hat = jax.lax.psum(seg_sum(z_edge), NODE_AXIS) & 1
            ok = jnp.all(syn_hat == syn, axis=0)  # [B], identical on shards
            return total, z, ok

        # Peeled iteration 1: check inputs are the storage-rounded but
        # UNCLIPPED a-priori LLRs (reference qkd_ldpc_algorithm.cpp:10-18;
        # same peel as the single-chip loop).
        Bl = llr_s.shape[1]
        Lq0 = jnp.broadcast_to(
            from_storage(to_storage(llr_s))[:, None, :], (Nl, dv, Bl)
        )
        Lr1 = check_update(Lq0)
        tot1, z1, ok1 = after_check(Lr1)
        init = (tot1, Lr1, z1, jnp.ones((Bl,), jnp.int32), ok1,
                jnp.asarray(1, jnp.int32))

        def body(carry):
            total, Lr, z_out, iters, done, it = carry
            # Fused bit-node update: Lq recomputed in-register, clipped at
            # consumption (identical math to materializing it).
            Lq = clip_msgs(
                from_storage(total)[:, None, :] - from_storage(Lr)
            )
            Lr_new = check_update(Lq)
            tot_new, z, ok = after_check(Lr_new)

            active = jnp.logical_not(done)
            z_out = jnp.where(active[None, :], z, z_out)
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
            P(NODE_AXIS, None),  # var_adj
            P(NODE_AXIS, None),  # var_mask
            P(NODE_AXIS, None),  # var_jslot
            P(None, trial),  # syndrome
        ),
        out_specs=(P(NODE_AXIS, trial), P(trial), P(trial)),
        check_vma=False,
    )
    z, iters, ok = sharded(llr_p, var_adj_p, var_mask_p, var_jslot_p, syndrome)
    return z[:N], iters, ok


# Module-level jit keyed on (opts, mesh): a per-call `jax.jit(lambda ...)`
# would recompile on every invocation (the cache is keyed by the function
# object).  DecodeOptions is frozen/hashable and Mesh hashes by devices+axes.
@partial(jax.jit, static_argnames=("opts", "mesh"))
def _decode_node_sharded_jit(code, llr_t, syn_t, opts, mesh):
    return bp_decode_node_sharded(code, llr_t, syn_t, opts, mesh)


def decode_node_sharded(
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
    z, iters, ok = _decode_node_sharded_jit(
        code, llr.T, syndrome.T, opts, mesh
    )
    res = DecodeResult(bits=z.T[:B], iterations=iters[:B],
                       syndromes_match=ok[:B])
    if single:
        res = DecodeResult(res.bits[0], res.iterations[0], res.syndromes_match[0])
    return res
