"""Batched syndrome-target belief-propagation decoding.

Batched re-design of the reference's hot kernel
(``sum_product_decoding_regular`` / ``_irregular``, reference
``src/qkd_ldpc_algorithm.cpp:3-345``) as plain ``jax.numpy`` that XLA
fuses.  Differences from the reference, all deliberate (see SURVEY.md
§3.5/§7):

- **One code path** for regular and irregular codes: padded index tensors +
  masks instead of two hand-specialized scalar loops.
- **Scatter-free message routing**: the reference moves messages between
  check-major and variable-major layouts with sequential cursor scatters
  (``check_pos_idx`` / ``bit_pos_idx``, qkd_ldpc_algorithm.cpp:56-72,
  128-139).  Here both directions are permutation *gathers* with
  precomputed static index tensors.
- **dc-first edge layout** ``[dc_max, M, B]``: slot index as a static
  leading axis so every elementwise op is a 2-D ``[M, B]`` array with the
  batch contiguous, and row reductions are dc-1 elementwise adds.
- **Leave-one-out by prefix/suffix products** of tanh values — exact,
  division-free (the reference's ``row_prod / tanh_j`` at
  qkd_ldpc_algorithm.cpp:67 is numerically fragile), zero-safe, |loo| <= 1
  by construction; saturation clips through the message threshold exactly
  where the reference clips (call sites qkd_ldpc_algorithm.cpp:74-77,
  141-144).
- **Fused bit-node update**: the loop carries ``(tot_chk, Lr)`` instead of
  the bit-to-check messages; ``Lq = clip(tot_chk - Lr)`` is recomputed
  inside the check update, so the bit update, clip and storage round
  fuse into the check update's XLA fusions.  The first iteration is
  peeled so
  its check inputs are the *unclipped* a-priori LLRs, exactly as the
  reference initializes (qkd_ldpc_algorithm.cpp:10-18).
- **Batch ("frame") axis last**: every routing gather indexes leading
  axes with static indices and moves contiguous rows of frames at once.
- **Early exit inside `lax.while_loop`** with per-frame convergence masks:
  frame b records ``iterations = it + 1`` on the iteration where its
  decision syndrome first equals the target (the reference's semantics at
  qkd_ldpc_algorithm.cpp:105-126).

The decision rule is the reference's: ``total <= 0 -> bit = 1``
(qkd_ldpc_algorithm.cpp:87-94).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu.decoder.qc_routing import (
    qc_gather_chk,
    qc_route_var,
)


class DecodeResult(NamedTuple):
    """Per-frame decode outcome (batch-first).

    Fields mirror the reference's ``SP_result``
    (``src/qkd_ldpc_algorithm.hpp:14-18``) plus the hard decisions.
    """

    bits: jax.Array  # [B, N] int8 hard decisions
    iterations: jax.Array  # [B] int32; == max_iters when not converged
    syndromes_match: jax.Array  # [B] bool


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Static decoder knobs (compiled into the jitted program).

    In the reference these live in the global ``CFG`` and are read inside
    the hot loop (``src/config.hpp:23-65``); here they are explicit and
    static.
    """

    max_iterations: int = 100
    clip_messages: bool = True  # ENABLE_SUM_PRODUCT_MSG_LLR_THRESHOLD
    message_threshold: float = 100.0  # SUM_PRODUCT_MSG_LLR_THRESHOLD
    algorithm: str = "sum-product"  # "sum-product" | "min-sum"
    min_sum_alpha: float = 0.8  # normalized min-sum scaling
    # Offset min-sum: |message| -> max(|message| - beta, 0) before the
    # alpha scaling (the other standard hardware variant; 0 disables).
    min_sum_beta: float = 0.0
    # Storage dtype of the edge-message state (Lr and the gathered totals).
    # "bfloat16" halves the device-memory traffic of the decode loop; all
    # transcendentals and totals still compute in float32.  Hard-decision/
    # iteration parity vs float32 is validated in
    # tests/test_decoder.py::test_bf16_messages_match_f32_decisions, and
    # the FER bias at the waterfall is quantified in benchmarks/.
    # "int8" stores messages as uniformly quantized fixed-point
    # (int8_scale LLR units per LSB, saturating at +-127*scale — the
    # classic 8-bit hardware-LDPC operating point), quartering the f32
    # traffic; FER impact is measured in benchmarks/int8.md.
    message_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"
    # LLR units per int8 LSB (range +-31.75 at the 0.25 default).  Only
    # used when message_dtype == "int8".
    int8_scale: float = 0.25
    # Message routing between the check- and variable-major layouts:
    # "roll" uses static block-rolls (only valid for QC codes, codes.qc),
    # "gather" and "auto" the general permutation gathers (faster on the
    # H100 at the z=512 flagship, decoder.qc_routing).  Bit-identical
    # trajectories either way.
    routing: str = "auto"  # "auto" | "gather" | "roll"
    # Residency compaction (round 4).  A batch pays its MAX iteration
    # count — every lane keeps computing until the slowest converges
    # (the early-exit barrier; at QBER 0.05 the mean is ~6.6 iterations
    # and the batch max ~11).  With compact_after=k > 0,
    # the loop runs k iterations, gathers the unconverged minority into
    # ``compact_lanes`` lanes, and finishes only those; a full-batch
    # fallback loop covers the (rare) case of more unconverged lanes
    # than compact_lanes, so trajectories, decisions and iteration
    # counts are BIT-IDENTICAL to the plain loop for every lane on
    # every input (tests/test_decoder.py::test_compaction_bit_identical)
    # — compaction changes the schedule, never the math.  Applies to
    # the plain batched loop (sim runner, bench, serve) under BOTH
    # schedules (the layered loop has the same phase A/B/C structure,
    # decoder/layered.py); the continuation and node-sharded runners
    # have their own loop structures and ignore it.
    compact_after: int = 0  # iterations before compaction (0 = off)
    compact_lanes: int = 0  # compacted batch width (e.g. B // 4)
    # Message-passing schedule (round 4).  "flooding" is the reference's
    # two-phase schedule (all checks, then all variables — the parity
    # contract; src/qkd_ldpc_algorithm.cpp:40-158).  "layered" is the
    # serial check-layered schedule (Hocevar 2004) for QC codes only:
    # one layer = one base row = z lifted checks; the total LLR updates
    # IMMEDIATELY after each layer, so information propagates within a
    # sweep and convergence takes roughly half the iterations at equal
    # FER (decoder/layered.py; FER evidence in benchmarks/layered.md).
    # A layered "iteration" sweeps every layer once — the same edge
    # work as one flooding iteration.  Trajectories differ from
    # flooding by construction (no reference-parity claim; statistics
    # validated against the flooding curve).  Composes with residency
    # compaction (layered converges in ~half the sweeps, so pick a
    # correspondingly earlier compact_after).
    schedule: str = "flooding"  # "flooding" | "layered"

    def __post_init__(self):
        if self.max_iterations < 1:
            # The first iteration is peeled (it always runs), so a cap
            # below 1 would report iterations=1 > cap.  Config validates
            # this bound too; direct DecodeOptions users get it here.
            raise ValueError("max_iterations must be >= 1")
        if self.algorithm not in ("sum-product", "min-sum"):
            raise ValueError(f"Unknown algorithm {self.algorithm!r}")
        if self.message_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"Unknown message_dtype {self.message_dtype!r}")
        if self.message_dtype == "int8" and self.int8_scale <= 0:
            raise ValueError("int8_scale must be > 0")
        if self.routing not in ("auto", "gather", "roll"):
            raise ValueError(f"Unknown routing {self.routing!r}")
        if self.compact_after < 0 or self.compact_lanes < 0:
            raise ValueError("compaction parameters must be >= 0")
        if (self.compact_after > 0) != (self.compact_lanes > 0):
            raise ValueError(
                "compact_after and compact_lanes must be set together"
            )
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"Unknown schedule {self.schedule!r}")


def _exclusive_cumprod(t: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(prefix, suffix) exclusive products along axis 0 (dc is small/static)."""
    ones = jnp.ones_like(t[:1])
    pre = jnp.concatenate([ones, jnp.cumprod(t[:-1], axis=0)], axis=0)
    suf = jnp.concatenate(
        [jnp.flip(jnp.cumprod(jnp.flip(t[1:], 0), axis=0), 0), ones], axis=0
    )
    return pre, suf


def _check_update_sum_product(
    Lq: jax.Array, chk_mask: jax.Array, syn_sign: jax.Array
) -> jax.Array:
    """Tanh-rule check-node update, leave-one-out by prefix/suffix products.

    Lq: [dc, M, B] bit->check messages (f32); chk_mask: [dc, M] bool;
    syn_sign: [M, B] in {+1, -1}.  Returns check->bit messages, same shape.

    loo_j = prod_{k != j} tanh(Lq_k / 2) carries the sign parity inside
    the product; |loo| <= 1 by construction (factors have |t| <= 1, and a
    rounded product of such factors cannot exceed 1), and
    2 atanh(x) = log1p(2x / (1 - x)) handles signed x directly.
    Saturation |loo| == 1 -> +/-inf is then clipped by the message
    threshold exactly as the reference clips its atanh overflow
    (qkd_ldpc_algorithm.cpp:74-77).
    """
    t = jnp.where(chk_mask[:, :, None], jnp.tanh(Lq * 0.5), 1.0)
    pre, suf = _exclusive_cumprod(t)
    x = pre * suf * syn_sign[None]
    return jnp.log1p(2.0 * x / (1.0 - x))


def _check_update_min_sum(
    Lq: jax.Array, chk_mask: jax.Array, syn_sign: jax.Array, alpha: float,
    beta: float = 0.0,
) -> jax.Array:
    """Normalized min-sum check-node update ([dc, M, B] layout).

    Leave-one-out min via the top-2 minima; the excluded edge is the
    FIRST occurrence of the row minimum in slot order (``argmin`` axis-0
    semantics), matching the node-sharded decoders.
    """
    dc = Lq.shape[0]
    mask3 = chk_mask[:, :, None]
    absL = jnp.where(mask3, jnp.abs(Lq), jnp.inf)
    neg = jnp.where(mask3, (Lq < 0).astype(jnp.int32), 0)

    min1 = jnp.min(absL, axis=0)  # [M, B]
    s1 = jnp.argmin(absL, axis=0).astype(jnp.int32)  # first occurrence
    slot = jnp.arange(dc, dtype=jnp.int32)[:, None, None]
    is_first = slot == s1[None]
    min2 = jnp.min(jnp.where(is_first, jnp.inf, absL), axis=0)
    loo_min = jnp.where(is_first, min2[None], min1[None])

    neg_row = jnp.sum(neg, axis=0)
    loo_neg = (neg_row[None] - neg) & 1
    sign = jnp.where(loo_neg == 1, -1.0, 1.0) * syn_sign[None]
    if beta:
        loo_min = jnp.maximum(loo_min - beta, 0.0)
    return alpha * sign * loo_min


def dc_first_maps(code: LDPCCode) -> tuple[jax.Array, jax.Array, jax.Array]:
    """dc-first static index tensors, derived from the code's canonical
    fields (a [N, dv]-sized integer pass — negligible next to one decode
    iteration).  var_slot stores flat check-major slots c*dc + j
    (sentinel M*dc); the dc-first flat layout is j*M + c.

    Returns (chk_adj_T [dc, M], chk_mask_T [dc, M] bool,
    var_slot_T [dv, N] -> flat [dc*M] index with sentinel dc*M).
    """
    M, dc = code.n_checks, code.dc_max
    chk_adj_T = jnp.asarray(code.chk_adj).T
    chk_mask_T = jnp.asarray(code.chk_mask).T
    vs = jnp.asarray(code.var_slot)
    vmask = jnp.asarray(code.var_mask)
    var_slot_T = jnp.where(
        vmask, (vs % dc) * M + jnp.minimum(vs // dc, M - 1), M * dc
    ).T
    return chk_adj_T, chk_mask_T, var_slot_T


class _DecodeCore:
    """Shared pieces of the dc-first decode iteration, parameterized over
    the per-batch tensors so both the plain loop and the continuation
    runner (sim.continuation) compose them."""

    def __init__(self, code: LDPCCode, opts: DecodeOptions, dtype, B: int):
        self.code, self.opts, self.dtype, self.B = code, opts, dtype, B
        self.N, self.M = code.n_vars, code.n_checks
        self.dv, self.dc = code.dv_max, code.dc_max
        if opts.message_dtype == "bfloat16":
            self.mdt = jnp.bfloat16
        elif opts.message_dtype == "int8":
            self.mdt = jnp.int8
        else:
            self.mdt = dtype
        self.scale = opts.int8_scale if opts.message_dtype == "int8" else None
        self.chk_adj_T, self.chk_mask_T, self.var_slot_T = dc_first_maps(code)
        self.threshold = jnp.asarray(opts.message_threshold, dtype)
        # Roll routing: static block-rolls instead of permutation gathers
        # (QC codes only; bit-identical trajectories), when asked for.
        if opts.routing == "roll" and code.qc is None:
            raise ValueError("routing='roll' requires a QC code (codes.qc)")
        self.qc = code.qc if opts.routing == "roll" else None

    def clip_msgs(self, x):
        if self.opts.clip_messages:
            return jnp.clip(x, -self.threshold, self.threshold)
        return x

    def to_storage(self, x):
        """Float compute value -> message storage dtype."""
        if self.scale is None:
            return x.astype(self.mdt)
        q = jnp.clip(jnp.round(x / self.scale), -127.0, 127.0)
        return q.astype(jnp.int8)

    def from_storage(self, q):
        """Message storage dtype -> float compute value."""
        if self.scale is None:
            return q.astype(self.dtype)
        return q.astype(self.dtype) * self.scale

    def gather_chk(self, x):
        """[N, B] -> [dc, M, B] via the check adjacency."""
        if self.qc is not None:
            return qc_gather_chk(x, self.qc, self.dc, self.B)
        return jnp.take(x, self.chk_adj_T.reshape(-1), axis=0).reshape(
            self.dc, self.M, self.B
        )

    def route_var(self, Lr):
        """[dc, M, B] check messages -> [dv, N, B] variable-major."""
        if self.qc is not None:
            return qc_route_var(Lr, self.qc, self.dv, self.B)
        flat = jnp.concatenate(
            [Lr.reshape(self.dc * self.M, self.B),
             jnp.zeros((1, self.B), Lr.dtype)], axis=0
        )
        return jnp.take(flat, self.var_slot_T.reshape(-1), axis=0).reshape(
            self.dv, self.N, self.B
        )

    def check_update_first(self, Lq, syn_sign):
        """Iteration-1 check update on the (unclipped) a-priori gathers."""
        opts = self.opts
        Lq_f = self.from_storage(Lq)
        if opts.algorithm == "min-sum":
            lr = _check_update_min_sum(
                Lq_f, self.chk_mask_T, syn_sign, opts.min_sum_alpha,
                opts.min_sum_beta,
            )
        else:
            lr = _check_update_sum_product(Lq_f, self.chk_mask_T, syn_sign)
        return self.to_storage(self.clip_msgs(lr))

    def check_update_fused(self, tot_chk, Lr_prev, syn_sign, fresh=None):
        """Bit-node update (Lq = clip(tot - Lr), in-register) + check update.

        ``fresh`` ([B] bool, optional) marks lanes whose (tot, Lr=0) state
        encodes a FIRST iteration: their recomputed Lq skips the clip, so a
        fresh lane's trajectory is identical to the peeled first iteration
        (the a-priori LLRs are never clipped, qkd_ldpc_algorithm.cpp:10-18).
        Used by the continuation runner, where refilled lanes restart
        mid-batch.
        """
        opts = self.opts
        Lq_raw = self.from_storage(tot_chk) - self.from_storage(Lr_prev)
        Lq = self.clip_msgs(Lq_raw)
        if fresh is not None:
            Lq = jnp.where(fresh[None, None, :], Lq_raw, Lq)
        if opts.algorithm == "min-sum":
            lr = _check_update_min_sum(
                Lq, self.chk_mask_T, syn_sign, opts.min_sum_alpha,
                opts.min_sum_beta,
            )
        else:
            lr = _check_update_sum_product(Lq, self.chk_mask_T, syn_sign)
        return self.to_storage(self.clip_msgs(lr))

    def after_check(self, Lr, llr, syndrome):
        """Route -> totals -> decision -> decision syndrome -> gathered totals.

        Decisions and the syndrome derive from the SAME message-dtype-
        rounded totals (z on the variable side, parities on the gathered
        check side), so they are exactly consistent.
        """
        Lr_var = self.route_var(Lr)
        total = self.to_storage(llr + jnp.sum(self.from_storage(Lr_var), axis=0))
        z = (total <= 0).astype(jnp.int8)  # total <= 0 -> bit 1
        tot_chk = self.gather_chk(total)
        z_chk = jnp.where(
            self.chk_mask_T[:, :, None], (tot_chk <= 0).astype(jnp.int32), 0
        )
        syn_hat = jnp.sum(z_chk, axis=0) & 1
        ok = jnp.all(syn_hat == syndrome, axis=0)  # [B]
        return tot_chk, z, ok

    def first_state(self, llr):
        """(tot_chk0, Lr0) encoding 'iteration 1 pending' for every lane."""
        tot0 = self.gather_chk(self.to_storage(llr))
        Lr0 = jnp.zeros((self.dc, self.M, self.B), self.mdt)
        return tot0, Lr0


def _decode_loop(core, llr, syndrome, syn_sign, init, limit, frozen=None):
    """The shared early-exit iteration loop from a prepared carry.

    ``frozen`` ([B] bool, optional) marks lanes whose bookkeeping must
    never change (their z/iters/done are final) even though their stale
    message state is recomputed — the full-batch fallback phase of the
    compaction schedule runs with the compacted lanes frozen.
    """

    def body(carry):
        tot_chk, Lr, z_out, iters, done, it = carry
        Lr_new = core.check_update_fused(tot_chk, Lr, syn_sign)
        tot_new, z, ok = core.after_check(Lr_new, llr, syndrome)

        active = jnp.logical_not(done)
        if frozen is not None:
            active = active & jnp.logical_not(frozen)
        z_out = jnp.where(active[None, :], z, z_out)
        iters = jnp.where(active, it + 1, iters)
        done = jnp.where(active, jnp.logical_or(done, ok), done)
        return tot_new, Lr_new, z_out, iters, done, it + 1

    def cond(carry):
        *_, done, it = carry
        not_done = jnp.logical_not(done)
        if frozen is not None:
            not_done = not_done & jnp.logical_not(frozen)
        return jnp.logical_and(it < limit, jnp.any(not_done))

    return jax.lax.while_loop(cond, body, init)


def _take_lanes(x, idx, axis):
    return jnp.take(x, idx, axis=axis)


def bp_decode_batch_last(
    code: LDPCCode,
    llr: jax.Array,  # [N, B] a-priori LLRs (batch last)
    syndrome: jax.Array,  # [M, B] int target syndrome (batch last)
    opts: DecodeOptions,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Core batched decode loop; returns (z [N,B] int8, iters [B], ok [B])."""
    if opts.schedule == "layered":
        from qkd_ldpc_tpu.decoder.layered import layered_decode_batch_last

        return layered_decode_batch_last(code, llr, syndrome, opts)
    B = llr.shape[1]
    core = _DecodeCore(code, opts, llr.dtype, B)
    syndrome = syndrome.astype(jnp.int32)
    syn_sign = jnp.where(syndrome == 1, -1.0, 1.0).astype(llr.dtype)  # [M, B]

    # ---- peeled iteration 1: check inputs are the raw a-priori LLRs
    # (never clipped — reference qkd_ldpc_algorithm.cpp:10-18).
    Lq0 = core.gather_chk(core.to_storage(llr))
    Lr1 = core.check_update_first(Lq0, syn_sign)
    tot1, z1, ok1 = core.after_check(Lr1, llr, syndrome)
    init = (
        tot1, Lr1, z1,
        jnp.ones((B,), jnp.int32),  # every frame ran iteration 1
        ok1,
        jnp.asarray(1, jnp.int32),
    )

    B2 = opts.compact_lanes
    if not (0 < B2 < B and opts.compact_after < opts.max_iterations):
        *_, z_out, iters, done, _ = _decode_loop(
            core, llr, syndrome, syn_sign, init, opts.max_iterations
        )
        # Frames that never converged report max_iterations, as the
        # reference returns {max_num_iterations, false}
        # (qkd_ldpc_algorithm.cpp:172).
        iters = jnp.where(done, iters, opts.max_iterations)
        return z_out, iters, done

    # ---- residency-compaction schedule (round 4): the plain loop pays
    # the batch's MAX iteration count on every lane.  Phase A runs
    # compact_after iterations on the full batch; phase B gathers the
    # unconverged minority into compact_lanes lanes and finishes only
    # those; phase C (a full-batch fallback that executes ZERO
    # iterations unless more than compact_lanes lanes were unconverged)
    # continues any overflow lanes from their phase-A state with the
    # compacted lanes' bookkeeping frozen.  Every lane's trajectory is
    # the plain loop's, merely re-scheduled.
    tot_a, Lr_a, z_a, it_a, done_a, itc_a = _decode_loop(
        core, llr, syndrome, syn_sign, init, opts.compact_after
    )

    # Unconverged lanes first (argsort is stable: ties keep lane order);
    # when fewer than compact_lanes are unconverged the tail picks
    # already-done lanes, which the loop's masks keep inert.
    idx = jnp.argsort(done_a.astype(jnp.int32), stable=True)[:B2]
    core_c = _DecodeCore(code, opts, llr.dtype, B2)
    llr_c = _take_lanes(llr, idx, 1)
    syn_c = _take_lanes(syndrome, idx, 1)
    sgn_c = _take_lanes(syn_sign, idx, 1)
    init_c = (
        _take_lanes(tot_a, idx, 2), _take_lanes(Lr_a, idx, 2),
        _take_lanes(z_a, idx, 1), _take_lanes(it_a, idx, 0),
        _take_lanes(done_a, idx, 0), itc_a,
    )
    _, _, z_b, it_b, done_b, _ = _decode_loop(
        core_c, llr_c, syn_c, sgn_c, init_c, opts.max_iterations
    )

    z_full = z_a.at[:, idx].set(z_b)
    it_full = it_a.at[idx].set(it_b)
    done_full = done_a.at[idx].set(done_b)
    frozen = jnp.zeros((B,), bool).at[idx].set(True)

    overflow = jnp.any(jnp.logical_not(done_full) & jnp.logical_not(frozen))

    def phase_c(args):
        z_f, it_f, done_f = args
        carry = (tot_a, Lr_a, z_f, it_f, done_f, itc_a)
        *_, z_o, it_o, done_o, _ = _decode_loop(
            core, llr, syndrome, syn_sign, carry, opts.max_iterations,
            frozen=frozen,
        )
        return z_o, it_o, done_o

    z_out, iters, done = jax.lax.cond(
        overflow, phase_c, lambda args: args, (z_full, it_full, done_full)
    )
    iters = jnp.where(done, iters, opts.max_iterations)
    return z_out, iters, done


# DecodeOptions is frozen/hashable -> a static jit argument; LDPCCode is a
# pytree whose shape metadata is static, so each (code shape, batch, opts)
# combination compiles once and is cached.
_bp_decode_jit = jax.jit(bp_decode_batch_last, static_argnames=("opts",))


def decode(
    code: LDPCCode,
    llr: jax.Array,  # [B, N] or [N]
    syndrome: jax.Array,  # [B, M] or [M]
    opts: DecodeOptions = DecodeOptions(),
) -> DecodeResult:
    """Decode a batch of frames toward target syndromes (batch-first API)."""
    single = llr.ndim == 1
    if single:
        llr = llr[None, :]
        syndrome = syndrome[None, :]
    z, iters, ok = _bp_decode_jit(code, llr.T, syndrome.T, opts)
    res = DecodeResult(bits=z.T, iterations=iters, syndromes_match=ok)
    if single:
        res = DecodeResult(res.bits[0], res.iterations[0], res.syndromes_match[0])
    return res
