"""Serial check-layered BP schedule for quasi-cyclic codes (round 4).

The reference (and this framework's default path) uses the two-phase
*flooding* schedule: every check node updates from the previous
iteration's variable messages, then every variable node updates
(src/qkd_ldpc_algorithm.cpp:40-158).  The *layered* (serial,
"turbo-decoding message passing") schedule instead sweeps check nodes
in groups, updating the total LLRs IMMEDIATELY after each group — later
layers in the same sweep see earlier layers' corrections, so
information propagates through the graph roughly twice as fast:
layered LDPC decoding converges in about half the iterations of
flooding at equal FER (Hocevar, "A reduced complexity decoder
architecture via layered decoding of LDPC codes", SIPS 2004 — standard
hardware-LDPC practice).

The QC structure makes layers dense tensor work: one layer = one base
row of the lift = z independent lifted checks.  Per layer and per base cell
(i, j, shift s):

    Lq  = clip(roll(t[j], s) - Lr_cell)            # bit -> check
    Lr' = check_update(all Lq of the row, syn_i)   # leave-one-out
    t[j] += roll^-1(Lr' - Lr_cell)                 # immediate update

Every routing step is a static circulant block-roll (the same
primitive as decoder/qc_routing), the leave-one-out runs over the row's <= dc_max slots
(reusing the flooding check-update rules on [d, z, B] stacks), and the
per-layer tensors are [z, B] slabs.

Semantics:

- One "iteration" = one full sweep over all mb layers: the same edge
  work as one flooding iteration, so iteration statistics are
  comparable work-wise.  Early exit checks the decision syndrome after
  each sweep; converged frames freeze (active-mask), failures run to
  ``max_iterations`` and report it (reference convention,
  qkd_ldpc_algorithm.cpp:172).
- Trajectories DIFFER from flooding by construction — this is a new
  schedule, not a reference-parity path.  Statistical equivalence
  (FER/iteration curves) is the validation bar: tests/test_layered.py
  on CPU ensembles, benchmarks/layered.md on hardware.
- Message storage dtype, clip placement (bit->check and check->bit both
  clip; layered has no flooding-style "unclipped first iteration"
  because there is no first full-graph message exchange), min-sum
  alpha/beta, and the int8 fixed-point quantization points follow
  DecodeOptions exactly as the flooding loop does.
- Residency compaction (``compact_after``/``compact_lanes``) composes
  with the layered schedule exactly as with flooding (decoder/bp.py
  phase A/B/C): per-sweep cost scales with the batch width (every
  [z, B] slab op runs on all lanes, converged or not), so gathering the
  unconverged minority into fewer lanes after ``compact_after`` sweeps
  removes the early-exit barrier here too.  Frame trajectories are
  lane-independent, so compaction is bit-identical to the plain loop
  (tests/test_layered.py::test_layered_compaction_bit_identical).
  Layered converges in roughly half the sweeps of flooding, so the
  compaction point is correspondingly earlier (e.g. 4 instead of 8).
- Console tracing (sim/tracing.py) runs on the f64 FLOODING oracle by
  design (the compiled path carries no trace code); a traced
  interactive run therefore shows flooding trajectories even when the
  sweep itself is configured layered.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu.codes.qc import qc_cells
from qkd_ldpc_tpu.decoder.bp import (
    DecodeOptions,
    _check_update_min_sum,
    _check_update_sum_product,
)
from qkd_ldpc_tpu.decoder.qc_routing import _rot


def _row_tables(qc) -> tuple[int, int, int, list[list[tuple[int, int, int]]]]:
    """Static per-layer cell tables: row i -> [(cell_index, j, shift)].

    Cell indices order the flat [ncells, z, B] message store by (i, j)
    — ascending j within a row matches the check-major slot order of
    the flooding layout (codes/qc.py check_adjacency_from_cells).
    """
    z, nb, mb, cells = qc_cells(qc)
    order = sorted(cells)  # (i, j) lexicographic
    index = {ij: ci for ci, ij in enumerate(order)}
    rows: list[list[tuple[int, int, int]]] = [[] for _ in range(mb)]
    for (i, j) in order:
        rows[i].append((index[(i, j)], j, cells[(i, j)]))
    return z, nb, mb, rows


def layered_decode_batch_last(
    code: LDPCCode,
    llr: jax.Array,  # [N, B] a-priori LLRs (batch last)
    syndrome: jax.Array,  # [M, B] int target syndrome (batch last)
    opts: DecodeOptions,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Layered decode; returns (z [N,B] int8, iters [B], ok [B])."""
    if code.qc is None:
        raise ValueError(
            "schedule='layered' requires a QC code (codes.qc; generate "
            "with make_qc_code or cli generate --qc)"
        )
    z, nb, mb, rows = _row_tables(code.qc)
    ncells = sum(len(r) for r in rows)
    B = llr.shape[1]
    dtype = llr.dtype

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

    threshold = jnp.asarray(opts.message_threshold, dtype)

    def clip_msgs(x):
        if opts.clip_messages:
            return jnp.clip(x, -threshold, threshold)
        return x

    syndrome = syndrome.astype(jnp.int32)
    syn_rows = syndrome.reshape(mb, z, B)
    sgn_rows = jnp.where(syn_rows == 1, -1.0, 1.0).astype(dtype)

    t0 = llr.reshape(nb, z, B)
    Lr0 = jnp.zeros((ncells, z, B), to_storage(jnp.zeros((), dtype)).dtype)

    ones_masks = {
        d: jnp.ones((d, z), bool) for d in {len(r) for r in rows}
    }

    def make_loop(syn_rows_l, sgn_rows_l, frozen=None):
        """Early-exit sweep loop over a (possibly compacted) batch.

        ``frozen`` ([Bl] bool, optional) marks lanes whose state and
        bookkeeping must never change — the full-batch fallback phase
        of the compaction schedule runs with the compacted lanes
        frozen (mirrors decoder/bp._decode_loop; here the frozen lanes'
        t must ALSO stay put because decisions derive from the final t,
        which already holds their scattered phase-B result).
        """
        Bl = syn_rows_l.shape[2]

        def sweep(t, Lr, act_f):
            """One serial pass over all layers; act_f [Bl] gates updates."""
            for i, row in enumerate(rows):
                d = len(row)
                Lq = jnp.stack([
                    clip_msgs(_rot(t[j], s) - from_storage(Lr[ci]))
                    for (ci, j, s) in row
                ])  # [d, z, Bl]
                if opts.algorithm == "sum-product":
                    Lr_new = _check_update_sum_product(
                        Lq, ones_masks[d], sgn_rows_l[i]
                    )
                else:
                    Lr_new = _check_update_min_sum(
                        Lq, ones_masks[d], sgn_rows_l[i],
                        opts.min_sum_alpha, opts.min_sum_beta,
                    )
                Lr_new_q = to_storage(clip_msgs(Lr_new))
                for k, (ci, j, s) in enumerate(row):
                    delta = from_storage(Lr_new_q[k]) - from_storage(Lr[ci])
                    t = t.at[j].add(
                        _rot(delta, (z - s) % z) * act_f[None, :]
                    )
                    Lr = Lr.at[ci].set(
                        jnp.where(act_f[None, :] > 0, Lr_new_q[k], Lr[ci])
                    )
            return t, Lr

        def syndrome_ok(t):
            """Decision syndrome == target, per frame ([Bl] bool)."""
            zdec = (t <= 0).astype(jnp.int32)  # [nb, z, Bl]; total<=0 -> 1
            bad = jnp.zeros((Bl,), jnp.int32)
            for i, row in enumerate(rows):
                p = jnp.zeros((z, Bl), jnp.int32)
                for (_, j, s) in row:
                    p = p ^ _rot(zdec[j], s)
                bad = bad + jnp.sum(p ^ syn_rows_l[i], axis=0)
            return bad == 0

        def body(carry):
            t, Lr, it, iters, done = carry
            act = jnp.logical_not(done)
            if frozen is not None:
                act = act & jnp.logical_not(frozen)
            t, Lr = sweep(t, Lr, act.astype(dtype))
            it = it + 1
            newly = act & syndrome_ok(t)
            iters = jnp.where(newly, it, iters)
            done = jnp.logical_or(done, newly)
            return t, Lr, it, iters, done

        def run(init, limit):
            def cond(carry):
                _, _, it, _, done = carry
                not_done = jnp.logical_not(done)
                if frozen is not None:
                    not_done = not_done & jnp.logical_not(frozen)
                return jnp.logical_and(it < limit, jnp.any(not_done))

            return jax.lax.while_loop(cond, body, init)

        return run

    def finalize(t, iters, done):
        # Iteration counting matches the flooding loop's reference
        # convention: a converged frame reports the sweep at which its
        # decision syndrome first matched (state frozen afterwards by
        # the active mask); failures report max_iterations.
        z_out = (t <= 0).astype(jnp.int8).reshape(nb * z, t.shape[2])
        iters = jnp.where(done, jnp.maximum(iters, 1), opts.max_iterations)
        return z_out, iters, done

    run_full = make_loop(syn_rows, sgn_rows)
    init = (
        t0, Lr0, jnp.asarray(0, jnp.int32),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), bool),
    )

    B2 = opts.compact_lanes
    if not (0 < B2 < B and opts.compact_after < opts.max_iterations):
        t, _, _, iters, done = run_full(init, opts.max_iterations)
        return finalize(t, iters, done)

    # ---- residency-compaction schedule: same phase A/B/C structure as
    # the flooding loop (decoder/bp.bp_decode_batch_last).  Frame
    # trajectories are lane-independent ([z, B] slab ops elementwise
    # along B), so re-scheduling lanes is exact.
    t_a, Lr_a, it_a, iters_a, done_a = run_full(init, opts.compact_after)

    # Unconverged lanes first (argsort is stable: ties keep lane order);
    # when fewer than compact_lanes are unconverged the tail picks
    # already-done lanes, which the loop's masks keep inert.
    idx = jnp.argsort(done_a.astype(jnp.int32), stable=True)[:B2]
    run_b = make_loop(
        jnp.take(syn_rows, idx, axis=2), jnp.take(sgn_rows, idx, axis=2)
    )
    init_b = (
        jnp.take(t_a, idx, axis=2), jnp.take(Lr_a, idx, axis=2), it_a,
        jnp.take(iters_a, idx, axis=0), jnp.take(done_a, idx, axis=0),
    )
    t_b, Lr_b, _, iters_b, done_b = run_b(init_b, opts.max_iterations)

    # Scatter phase-B results back; decisions derive from t, so the
    # compacted lanes' final t must land in the full slab (phase C's
    # frozen mask then keeps it untouched).
    t_full = t_a.at[:, :, idx].set(t_b)
    Lr_full = Lr_a.at[:, :, idx].set(Lr_b)
    iters_full = iters_a.at[idx].set(iters_b)
    done_full = done_a.at[idx].set(done_b)
    frozen = jnp.zeros((B,), bool).at[idx].set(True)

    overflow = jnp.any(jnp.logical_not(done_full) & jnp.logical_not(frozen))
    run_c = make_loop(syn_rows, sgn_rows, frozen=frozen)

    def phase_c(args):
        t_f, Lr_f, iters_f, done_f = args
        t_o, Lr_o, _, iters_o, done_o = run_c(
            (t_f, Lr_f, it_a, iters_f, done_f), opts.max_iterations
        )
        return t_o, Lr_o, iters_o, done_o

    t, _, iters, done = jax.lax.cond(
        overflow, phase_c, lambda args: args,
        (t_full, Lr_full, iters_full, done_full),
    )
    return finalize(t, iters, done)
