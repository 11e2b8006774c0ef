"""Quasi-cyclic (QC / protograph-lifted) LDPC code construction.

The reference ships unstructured random codes and walks their adjacency
with scalar cursor loops (``src/qkd_ldpc_algorithm.cpp:56-72``), so code
structure buys it nothing.  Here structure lets the decode loop's two
message-routing permutations be written as static block-rolls instead
of general row gathers (``DecodeOptions.routing="roll"``;
decoder/qc_routing).

A QC-LDPC code is a ``[mb, nb]`` base matrix lifted by circulant
permutation matrices of size ``z``: base cell (i, j) with shift ``s``
connects check block i to variable block j with the permutation
``r -> (r + s) mod z``.  Both routing directions then become **static
block-rolls**: pick a contiguous ``[z, B]`` slab, rotate its rows by a
compile-time shift (``decoder.qc_routing``).  QC codes are also what deployed QKD/5G/WiFi
LDPC systems actually use, for the same reason (hardware-friendly
routing).

Construction here: a random column-weight-``dv`` base graph with
balanced row degrees (the same 5/6-row-split profile family as the
reference's shipped code when nb*dv does not divide mb) and random
circulant shifts, repaired until the lifted graph is 4-cycle-free
(girth >= 6): a 4-cycle exists iff some 2x2 base submatrix satisfies
``s[i1,j1] - s[i1,j2] + s[i2,j2] - s[i2,j1] == 0 (mod z)``
(Fossorier 2004, thm. 2.1).

The built code is a perfectly ordinary :class:`LDPCCode` — every other
subsystem (syndrome, channel, parsers, oracle, node-sharding, export)
sees the standard padded tensors — plus a static ``qc`` layout tuple
that the decoder uses to swap its routing gathers for rolls.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qkd_ldpc_tpu.codes.ldpc_code import LDPCCode, from_check_adjacency


def _balanced_base_rows(nb: int, mb: int, dv: int, rng) -> list[list[int]]:
    """Assign each of nb base columns dv distinct rows, keeping row
    degrees within 1 of each other (the reference code's balanced
    row-weight profile, SURVEY.md §2 'Code-matrix data')."""
    if dv > mb:
        raise ValueError("column weight dv cannot exceed mb base rows")
    deg = np.zeros(mb, dtype=np.int64)
    cols: list[list[int]] = []
    for _ in range(nb):
        # dv lowest-degree rows, random tie-break.
        order = np.lexsort((rng.permutation(mb), deg))
        rows = sorted(order[:dv].tolist())
        for r in rows:
            deg[r] += 1
        cols.append(rows)
    return cols


def _four_cycle_conflicts(cells: dict[tuple[int, int], int], z: int):
    """All (i1,i2,j1,j2) base quadruples whose shifts close a 4-cycle."""
    by_row: dict[int, list[int]] = {}
    for (i, j) in cells:
        by_row.setdefault(i, []).append(j)
    rows = sorted(by_row)
    out = []
    for a in range(len(rows)):
        for b in range(a + 1, len(rows)):
            i1, i2 = rows[a], rows[b]
            common = sorted(set(by_row[i1]) & set(by_row[i2]))
            for x in range(len(common)):
                for y in range(x + 1, len(common)):
                    j1, j2 = common[x], common[y]
                    d = (
                        cells[(i1, j1)] - cells[(i1, j2)]
                        + cells[(i2, j2)] - cells[(i2, j1)]
                    ) % z
                    if d == 0:
                        out.append((i1, i2, j1, j2))
    return out


def make_qc_code(
    z: int,
    nb: int,
    mb: int,
    dv: int = 3,
    seed: int = 0,
    name: str = "",
    max_repair_rounds: int = 200,
) -> LDPCCode:
    """Build a girth->=6 QC-LDPC code with N = nb*z, M = mb*z, column
    weight ``dv`` and balanced row weights.

    ``z`` is the circulant (lift) size; larger z means fewer, larger
    roll slabs in the decoder (z >= 8 keeps slabs sublane-aligned).
    """
    if z < 1 or nb < 2 or mb < 1:
        raise ValueError("need z >= 1, nb >= 2, mb >= 1")
    if mb >= nb:
        raise ValueError("mb must be < nb (rate must be positive)")
    rng = np.random.default_rng(seed)
    cols = _balanced_base_rows(nb, mb, dv, rng)

    cells: dict[tuple[int, int], int] = {}
    for j, rows in enumerate(cols):
        for i in rows:
            cells[(i, j)] = int(rng.integers(0, z))

    # Re-randomize one shift of each closing quadruple until girth >= 6
    # (always reachable for z comfortably above the base degrees).
    for _ in range(max_repair_rounds):
        bad = _four_cycle_conflicts(cells, z)
        if not bad:
            break
        for (i1, i2, j1, j2) in bad:
            pick = [(i1, j1), (i1, j2), (i2, j1), (i2, j2)][rng.integers(0, 4)]
            cells[pick] = int(rng.integers(0, z))
    else:
        raise RuntimeError(
            "could not remove all 4-cycles; use a larger z or another seed"
        )

    # Expand to per-check neighbor lists.  Within a check row the
    # variable indices sort by base column (block ranges are disjoint),
    # so the check-major slot of base cell (i, j) is the rank of j among
    # row i's columns — identical for every r in the block, which is
    # what makes slot-major [dc, M, B] tensors roll-addressable.
    check_neighbors = check_adjacency_from_cells(cells, z, nb, mb)

    if not name:
        r = 1.0 - mb / nb
        name = f"(N={nb * z},M={mb * z},R={r:.2f},CW={dv},QC z={z},SEED={seed}).txt"
    code = from_check_adjacency(check_neighbors, n_vars=nb * z, name=name)
    return dataclasses.replace(
        code, qc=qc_layout_from_cells(cells, z, nb, mb, code.dc_max, code.dv_max)
    )


def check_adjacency_from_cells(
    cells: dict[tuple[int, int], int], z: int, nb: int, mb: int
) -> list[np.ndarray]:
    """Per-check neighbor lists of the lifted graph defined by base
    ``cells`` {(row, col): shift}: check i*z + r connects variable
    j*z + (r + s) mod z for every cell (i, j, s), slots in ascending
    base-column order."""
    row_cols = _row_cols(cells, mb)
    check_neighbors = []
    for i in range(mb):
        js = row_cols[i]
        shifts = [cells[(i, j)] for j in js]
        for r in range(z):
            check_neighbors.append(
                np.array([j * z + (r + s) % z for j, s in zip(js, shifts)],
                         dtype=np.int64)
            )
    return check_neighbors


def _row_cols(cells, mb) -> dict[int, list[int]]:
    by_row: dict[int, list[int]] = {}
    for (i, j) in cells:
        by_row.setdefault(i, []).append(j)
    row_cols = {i: sorted(js) for i, js in by_row.items()}
    if len(row_cols) != mb:
        raise RuntimeError("empty base row; raise nb*dv/mb above 1")
    return row_cols


def qc_layout_from_cells(
    cells: dict[tuple[int, int], int], z: int, nb: int, mb: int,
    dc_max: int, dv_max: int,
) -> tuple:
    """The static ``(z, chk_plan, var_plan)`` layout tuple driving the
    decoder's unrolled roll routing, from the base cells alone — shared
    by construction (:func:`make_qc_code`) and reload (the ``.qc.json``
    sidecar path in ``codes.alist._attach_qc_sidecar``), so a serialized
    QC code reconstructs the exact in-memory layout.
    """
    row_cols = _row_cols(cells, mb)
    cols: dict[int, list[int]] = {}
    for (i, j) in cells:
        cols.setdefault(j, []).append(i)
    cols = {j: sorted(rows) for j, rows in cols.items()}

    # chk_plan[j][i] = (base col, shift) of slot j in check block i, or
    # (-1, 0) when row i has fewer than j+1 cells (padded slot).
    chk_plan = tuple(
        tuple(
            (row_cols[i][j], cells[(i, row_cols[i][j])])
            if j < len(row_cols[i]) else (-1, 0)
            for i in range(mb)
        )
        for j in range(dc_max)
    )
    # var_plan[k][jb] = (check-major slot, base row, shift) of variable
    # block jb's k-th neighbor in ascending check order (the var-major
    # edge order from_check_adjacency produces), or (-1, -1, 0).
    var_plan = tuple(
        tuple(
            (
                row_cols[cols[jb][k]].index(jb),
                cols[jb][k],
                cells[(cols[jb][k], jb)],
            )
            if k < len(cols.get(jb, ())) else (-1, -1, 0)
            for jb in range(nb)
        )
        for k in range(dv_max)
    )
    return (z, chk_plan, var_plan)


def qc_cells(qc: tuple) -> tuple[int, int, int, dict[tuple[int, int], int]]:
    """Recover ``(z, nb, mb, cells)`` from a code's static qc layout —
    the serializable description of the lift (codes.alist sidecar)."""
    z, chk_plan, var_plan = qc
    mb = len(chk_plan[0])
    nb = len(var_plan[0])
    cells: dict[tuple[int, int], int] = {}
    for slot in chk_plan:
        for i, (col, s) in enumerate(slot):
            if col >= 0:
                cells[(i, col)] = int(s)
    return z, nb, mb, cells
