"""Roll-based message routing for quasi-cyclic codes.

The decode loop's two routing permutations (check-major gather of the
totals, variable-major gather of the check messages — the device-side
replacement for the reference's cursor scatters,
``src/qkd_ldpc_algorithm.cpp:56-72,128-139``) are general row gathers
for an unstructured code.  For a QC code (codes.qc) every routed row
lives in a contiguous ``[z, B]`` circulant slab at a static offset with
a static rotation, so both directions can instead be written as static
block-rolls.

Bit-exactness: rolls are permutations of exactly the rows the gather
path reads, assembled into identically-shaped tensors and consumed by
identical arithmetic, so the decode trajectory is bit-identical to the
gather path on the same code (tests/test_qc.py asserts decisions and
iteration counts for both algorithms and all message dtypes).  Rolls
run only where asked for (``DecodeOptions.routing="roll"``, and the
layered schedule): on the H100 the gathers time faster at the z=512
flagship (CHANGES.md), so ``routing="auto"`` gathers.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

def _rot(block, s: int):
    """[z, B] slab rotated so row r reads input row (r + s) mod z, as a
    static-index gather of the permutation.  (Slice-copies time slower on
    the H100, CHANGES.md, and XLA:CPU's codegen for the repeated
    concat-of-slices pattern crashed in long test runs.)"""
    if s == 0:
        return block
    z = block.shape[0]
    idx = np.concatenate([np.arange(s, z), np.arange(s)])
    return jnp.take(block, jnp.asarray(idx), axis=0)


def qc_gather_chk(x, qc, dc: int, B: int):
    """[N, B] variable-major rows -> [dc, M, B] check-major slots.

    Equivalent to ``jnp.take(x, chk_adj_T)``: slot j of check i*z + r
    reads variable col*z + (r + s) mod z.  Padded slots (base rows
    shorter than dc_max) are zero-filled — they are masked everywhere
    downstream, exactly like the gather path's sentinel reads.
    """
    z, chk_plan, _ = qc
    nb = x.shape[0] // z
    xb = x.reshape(nb, z, B)
    zeros = None
    slabs = []
    # Per-slot concat + stack (one [M, B] slab per slot), the same
    # [dc, M, B] layout the gather path produces.
    for j in range(dc):
        per_i = []
        for (col, s) in chk_plan[j]:
            if col < 0:
                if zeros is None:
                    zeros = jnp.zeros((z, B), x.dtype)
                per_i.append(zeros)
            else:
                per_i.append(_rot(xb[col], s))
        slabs.append(jnp.concatenate(per_i, axis=0))
    return jnp.stack(slabs, axis=0)


def qc_route_var(Lr, qc, dv: int, B: int):
    """[dc, M, B] check-major messages -> [dv, N, B] variable-major.

    Equivalent to the gather path's ``jnp.take(flat, var_slot_T)``:
    variable jb*z + q's k-th message (ascending check order) reads slot
    ``slot_k`` of check i_k*z + (q - s_k) mod z — the inverse rotation
    of the slab the forward direction rolled.
    """
    z, _, var_plan = qc
    dc, M, _ = Lr.shape
    mb = M // z
    Lrb = Lr.reshape(dc, mb, z, B)
    zeros = None
    outs = []
    for k in range(dv):
        per_j = []
        for (slot, i, s) in var_plan[k]:
            if slot < 0:
                if zeros is None:
                    zeros = jnp.zeros((z, B), Lr.dtype)
                per_j.append(zeros)
            else:
                per_j.append(_rot(Lrb[slot, i], (z - s) % z))
        outs.append(jnp.concatenate(per_j, axis=0))
    return jnp.stack(outs, axis=0)
