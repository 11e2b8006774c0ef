"""LDPC code representation for batched device decoding.

The reference keeps the parity-check matrix H as ragged C arrays of
per-node neighbor lists (``H_matrix``, reference
``src/array_and_matrix_operations.hpp:16-27``) and walks them with scalar
cursor loops.  Here the same bipartite graph is encoded as **dense padded
index tensors plus masks** — one layout for regular *and* irregular codes
(the reference's "regular" layout generalized with masks, so there is a
single decode path instead of the reference's duplicated
``*_regular`` / ``*_irregular`` pair):

- ``chk_adj[M, dc_max]``  : j-th variable adjacent to check c (0-padded)
- ``var_adj[N, dv_max]``  : k-th check adjacent to variable v (0-padded)
- ``chk_mask`` / ``var_mask`` : validity masks for the padded slots

Message routing between the check-major and variable-major layouts is done
with precomputed **permutation gathers** instead of the reference's
sequential scatter cursors (``check_pos_idx`` / ``bit_pos_idx``,
reference ``src/qkd_ldpc_algorithm.cpp:56-72,128-139``), which are
inherently serial and do not map to the VPU:

- ``var_slot[N, dv_max]`` : flat check-major slot (c*dc_max + j) of each
  variable-side edge; padded slots point at a sentinel (M*dc_max) so a
  gather from a 1-appended flat array reads a neutral value.
- ``chk_slot[M, dc_max]`` : flat variable-major slot (v*dv_max + k) of each
  check-side edge; sentinel N*dv_max.

With these, *both* directions of message exchange are gathers with static
index tensors — scatter-free, batchable, and shardable.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Sequence

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """A parity-check code as dense padded tensors (a JAX pytree).

    Array fields are pytree leaves; scalar shape metadata is static so the
    code can be passed straight through ``jax.jit`` boundaries.
    """

    # --- static metadata (hashable, baked into compiled programs) --------
    n_vars: int = dataclasses.field(metadata=dict(static=True))
    n_checks: int = dataclasses.field(metadata=dict(static=True))
    dv_max: int = dataclasses.field(metadata=dict(static=True))
    dc_max: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))
    is_regular: bool = dataclasses.field(metadata=dict(static=True))
    name: str = dataclasses.field(default="", metadata=dict(static=True))
    # Quasi-cyclic layout (codes.qc): (z, chk_plan, var_plan) nested int
    # tuples, or None for unstructured codes.  Static — it selects the
    # decoder's routing *program* (unrolled compile-time rolls), so it
    # must key the jit cache.
    qc: tuple | None = dataclasses.field(default=None, metadata=dict(static=True))

    # --- adjacency tensors (leaves) ---------------------------------------
    chk_adj: np.ndarray = None  # [M, dc_max] int32, var index per check slot
    chk_mask: np.ndarray = None  # [M, dc_max] bool
    var_adj: np.ndarray = None  # [N, dv_max] int32, check index per var slot
    var_mask: np.ndarray = None  # [N, dv_max] bool
    var_slot: np.ndarray = None  # [N, dv_max] int32 -> flat check-major slot
    chk_slot: np.ndarray = None  # [M, dc_max] int32 -> flat var-major slot
    var_deg: np.ndarray = None  # [N] int32  (bit_nodes_weight)
    chk_deg: np.ndarray = None  # [M] int32  (check_nodes_weight)

    @cached_property
    def fingerprint(self) -> str:
        """Content hash of the parity-check graph (shape + every edge).

        Two codes with equal fingerprints define the same H, regardless
        of provenance (alist file, generator, device copy).  Serving
        endpoints bind adapters to codes by this — a shape-only check
        would accept a different code of the same size and silently
        garble keys.
        """
        import hashlib

        h = hashlib.sha256()
        h.update(f"{self.n_vars},{self.n_checks},{self.dc_max}".encode())
        h.update(np.ascontiguousarray(np.asarray(self.chk_deg)).tobytes())
        adj = np.asarray(self.chk_adj)
        h.update(np.ascontiguousarray(
            np.where(np.asarray(self.chk_mask), adj, -1)
        ).tobytes())
        return h.hexdigest()[:16]

    @property
    def code_rate(self) -> float:
        """R = 1 - M/N, as derived throughout the reference
        (e.g. ``src/simulation.cpp:96,155,234``)."""
        return 1.0 - self.n_checks / self.n_vars

    @property
    def n_info_bits(self) -> int:
        """K = N - M information bits per frame."""
        return self.n_vars - self.n_checks

    def to_device(self, sharding=None) -> "LDPCCode":
        """Copy of this code with device-resident array leaves.

        Adjacency tensors ingest as host numpy; passing them to a jitted
        function re-transfers them every call (costly over a remote-device
        link).  Hot paths place the code once and reuse it.
        """
        import jax

        put = (lambda x: jax.device_put(x, sharding)) if sharding else jax.numpy.asarray
        return dataclasses.replace(
            self,
            **{
                f.name: put(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if not f.metadata.get("static") and getattr(self, f.name) is not None
            },
        )

    @cached_property
    def dense(self) -> np.ndarray:
        """Materialize H as a dense uint8 [M, N] matrix (tests/small codes)."""
        H = np.zeros((self.n_checks, self.n_vars), dtype=np.uint8)
        rows = np.repeat(np.arange(self.n_checks), self.dc_max).reshape(
            self.n_checks, self.dc_max
        )
        H[rows[self.chk_mask], self.chk_adj[self.chk_mask]] = 1
        return H

    def __repr__(self) -> str:  # keep small: frozen dataclass default is huge
        return (
            f"LDPCCode(name={self.name!r}, N={self.n_vars}, M={self.n_checks}, "
            f"R={self.code_rate:.3f}, E={self.n_edges}, dv_max={self.dv_max}, "
            f"dc_max={self.dc_max}, regular={self.is_regular})"
        )


def from_check_adjacency(
    check_neighbors: Sequence[np.ndarray],
    n_vars: int,
    name: str = "",
    native: bool | None = None,
) -> LDPCCode:
    """Build an :class:`LDPCCode` from per-check neighbor lists.

    ``check_neighbors[c]`` is the array of variable indices adjacent to
    check ``c`` (0-based, unique).  The variable-side adjacency is derived
    by bucketing edges in ascending check order — the same edge ordering the
    reference decoder produces implicitly with its running scatter cursors
    (``src/qkd_ldpc_algorithm.cpp:56-72``).

    Large graphs route through the native C++ graph-builder when it is
    available (``native`` forces either path); both builders produce
    bit-identical tensors (tests/test_native.py).
    """
    n_checks = len(check_neighbors)
    chk_deg = np.array([len(nb) for nb in check_neighbors], dtype=np.int32)
    if n_checks == 0 or n_vars == 0:
        raise ValueError("Empty parity-check matrix")
    if np.any(chk_deg == 0):
        bad = int(np.argmax(chk_deg == 0))
        raise ValueError(f"Row '{bad + 1}' weight cannot be equal to or less than zero.")

    # Flat edge list, check-major order.
    e_chk = np.repeat(np.arange(n_checks, dtype=np.int64), chk_deg)
    e_var = np.concatenate([np.asarray(nb, dtype=np.int64) for nb in check_neighbors])
    n_edges = e_var.size

    if native or (native is None and n_edges >= 100_000):
        from qkd_ldpc_tpu.codes._native import build_graph_native

        code = build_graph_native(chk_deg, e_var.astype(np.int32), n_vars, name)
        if code is not None:
            return code
        if native:
            raise RuntimeError("Native graph builder unavailable")
    if e_var.min() < 0 or e_var.max() >= n_vars:
        raise ValueError("Variable index out of range in adjacency list")

    # Per-check slot position j of each edge.
    offsets = np.concatenate([[0], np.cumsum(chk_deg)])
    e_j = np.arange(n_edges, dtype=np.int64) - offsets[e_chk]

    # Detect duplicate edges (v appearing twice in one check row).
    key = e_chk * n_vars + e_var
    if np.unique(key).size != n_edges:
        raise ValueError("Duplicate edge in parity-check matrix")

    var_deg = np.bincount(e_var, minlength=n_vars).astype(np.int32)
    if np.any(var_deg == 0):
        bad = int(np.argmax(var_deg == 0))
        raise ValueError(
            f"Column '{bad + 1}' weight cannot be equal to or less than zero."
        )

    dc_max = int(chk_deg.max())
    dv_max = int(var_deg.max())

    # Check-major padded tensors.
    chk_adj = np.zeros((n_checks, dc_max), dtype=np.int32)
    chk_mask = np.zeros((n_checks, dc_max), dtype=bool)
    chk_adj[e_chk, e_j] = e_var
    chk_mask[e_chk, e_j] = True

    # Variable-major ordering: sort edges by (var, check).  This reproduces
    # the order a column-scan of H produces (ascending check index per
    # variable), matching the reference's bit_nodes construction
    # (``src/array_and_matrix_operations.cpp:4-24``).
    order = np.lexsort((e_chk, e_var))
    f_var, f_chk = e_var[order], e_chk[order]
    f_offsets = np.concatenate([[0], np.cumsum(var_deg)])
    f_k = np.arange(n_edges, dtype=np.int64) - f_offsets[f_var]

    var_adj = np.zeros((n_vars, dv_max), dtype=np.int32)
    var_mask = np.zeros((n_vars, dv_max), dtype=bool)
    var_adj[f_var, f_k] = f_chk
    var_mask[f_var, f_k] = True

    # Permutation maps between the two flat layouts (sentinel-padded).
    var_slot = np.full((n_vars, dv_max), n_checks * dc_max, dtype=np.int32)
    var_slot[f_var, f_k] = (e_chk * dc_max + e_j)[order]
    chk_slot = np.full((n_checks, dc_max), n_vars * dv_max, dtype=np.int32)
    chk_slot[e_chk[order], e_j[order]] = f_var * dv_max + f_k

    # Regularity: all column weights equal AND all row weights equal
    # (reference ``src/array_and_matrix_operations.cpp:188-206,395-410``).
    is_regular = bool(np.all(var_deg == var_deg[0]) and np.all(chk_deg == chk_deg[0]))

    return LDPCCode(
        n_vars=int(n_vars),
        n_checks=int(n_checks),
        dv_max=dv_max,
        dc_max=dc_max,
        n_edges=int(n_edges),
        is_regular=is_regular,
        name=name,
        chk_adj=chk_adj,
        chk_mask=chk_mask,
        var_adj=var_adj,
        var_mask=var_mask,
        var_slot=var_slot,
        chk_slot=chk_slot,
        var_deg=var_deg,
        chk_deg=chk_deg.astype(np.int32),
    )


def from_dense(H: np.ndarray, name: str = "") -> LDPCCode:
    """Build an :class:`LDPCCode` from a dense 0/1 matrix [M, N]."""
    H = np.asarray(H)
    if H.ndim != 2:
        raise ValueError("Dense parity-check matrix must be 2-D")
    if not np.isin(H, (0, 1)).all():
        raise ValueError("Parity check matrix can only take values 0 or 1.")
    neighbors = [np.flatnonzero(row) for row in H]
    return from_check_adjacency(neighbors, n_vars=H.shape[1], name=name)
