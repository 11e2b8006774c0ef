"""Per-sweep-point statistics aggregation.

Reproduces the reference's aggregation semantics
(``src/simulation.cpp:252-313``) in a *mergeable partial-sums* form so that
statistics can be reduced on device (two scalars instead of per-trial
round-trips), combined across device shards with a ``psum``, and across
sequential batches by addition:

- ``n_sp``    : trials whose decision syndrome converged (SP success)
- ``n_ldpc``  : of those, trials whose key matched Alice's (LDPC success;
  the reference counts keys_match only *inside* the syndromes_match branch,
  simulation.cpp:273-276)
- ``sum_it`` / ``sum_it2`` : Σ iters, Σ iters² over SP-successful trials —
  mean and *population* std-dev (÷n, as the reference computes at
  simulation.cpp:282-295) are reconstructed from these
- ``min_it`` / ``max_it``  : over SP-successful trials; the reference
  reports min as 0 when it never moved off its max_iterations initializer
  (simulation.cpp:306) — including the corner case where every successful
  trial took exactly max_iterations; reproduced bug-for-bug.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class PointPartials:
    """Mergeable sufficient statistics for one (matrix, QBER) point."""

    n_trials: int = 0
    n_sp: int = 0
    n_ldpc: int = 0
    sum_it: float = 0.0
    sum_it2: float = 0.0
    min_it: int = 0  # valid only when n_sp > 0
    max_it: int = 0

    def merge(self, other: "PointPartials") -> "PointPartials":
        if other.n_sp == 0:
            min_it, max_it = self.min_it, self.max_it
        elif self.n_sp == 0:
            min_it, max_it = other.min_it, other.max_it
        else:
            min_it = min(self.min_it, other.min_it)
            max_it = max(self.max_it, other.max_it)
        return PointPartials(
            n_trials=self.n_trials + other.n_trials,
            n_sp=self.n_sp + other.n_sp,
            n_ldpc=self.n_ldpc + other.n_ldpc,
            sum_it=self.sum_it + other.sum_it,
            sum_it2=self.sum_it2 + other.sum_it2,
            min_it=min_it,
            max_it=max_it,
        )


def reduce_trials(
    syndromes_match: jax.Array,  # [B] bool
    keys_match: jax.Array,  # [B] bool
    iterations: jax.Array,  # [B] int32
    max_iterations: int,
    valid: jax.Array | None = None,  # [B] bool — mask for padded trials
) -> dict[str, jax.Array]:
    """Device-side reduction of a trial batch to scalar partial sums.

    ``valid`` masks out padding trials (the runner always launches
    full-size batches so one compiled program serves every batch; the tail
    batch marks its excess trials invalid).
    """
    if valid is None:
        valid = jnp.ones(syndromes_match.shape, bool)
    sp = syndromes_match & valid
    it = iterations.astype(jnp.int32)
    it_sp = jnp.where(sp, it, 0)
    # All-int32 sums: exact, and the whole reduction ships home as ONE
    # stacked array (see stack_partials) — a single device->host transfer
    # per batch instead of seven.  Σ iters² per device-merged chunk must stay
    # under 2^31: the runner bounds trials-per-dispatch accordingly
    # (run_point's safe_batches guard); host-side merges are exact ints.
    return dict(
        n_trials=jnp.sum(valid.astype(jnp.int32)),
        n_sp=jnp.sum(sp.astype(jnp.int32)),
        n_ldpc=jnp.sum((sp & keys_match).astype(jnp.int32)),
        sum_it=jnp.sum(it_sp),
        sum_it2=jnp.sum(it_sp * it_sp),
        min_it=jnp.min(jnp.where(sp, iterations, max_iterations)),
        max_it=jnp.max(jnp.where(sp, iterations, 0)),
    )


# Canonical field order of the single-transfer stacked form.
STAT_KEYS = ("n_trials", "n_sp", "n_ldpc", "sum_it", "sum_it2", "min_it", "max_it")


def stack_partials(reduced: dict) -> jax.Array:
    """Device-side [7] int32 stack of a reduction, for one-fetch readback."""
    return jnp.stack([reduced[k].astype(jnp.int32) for k in STAT_KEYS])


def partials_from_stacked(stacked) -> PointPartials:
    """Host conversion of a fetched ``stack_partials`` array."""
    v = [int(x) for x in stacked]
    d = dict(zip(STAT_KEYS, v))
    return PointPartials(
        n_trials=d["n_trials"],
        n_sp=d["n_sp"],
        n_ldpc=d["n_ldpc"],
        sum_it=float(d["sum_it"]),
        sum_it2=float(d["sum_it2"]),
        min_it=d["min_it"],
        max_it=d["max_it"],
    )


def partials_from_device(reduced: dict, max_iterations: int) -> PointPartials:
    """Convert a device reduction (possibly already psum-merged) to host."""
    # Fetch the dict as one pytree: device_get issues async copies for all
    # leaves before blocking, so the round-trips overlap.
    host = jax.device_get(reduced)
    return PointPartials(
        n_trials=int(host["n_trials"]),
        n_sp=int(host["n_sp"]),
        n_ldpc=int(host["n_ldpc"]),
        sum_it=float(host["sum_it"]),
        sum_it2=float(host["sum_it2"]),
        min_it=int(host["min_it"]),
        max_it=int(host["max_it"]),
    )


@dataclasses.dataclass
class SimResult:
    """One CSV row; field meanings mirror the reference's ``sim_result``
    (``src/simulation.hpp:29-43``)."""

    sim_number: int
    matrix_filename: str
    is_regular: bool
    num_bit_nodes: int
    num_check_nodes: int
    initial_qber: float
    iterations_successful_sp_mean: float
    iterations_successful_sp_std_dev: float
    iterations_successful_sp_min: int
    iterations_successful_sp_max: int
    ratio_trials_successful_sp: float
    ratio_trials_successful_ldpc: float

    @property
    def code_rate(self) -> float:
        return 1.0 - self.num_check_nodes / self.num_bit_nodes

    @property
    def fer(self) -> float:
        # FER = 1 - ratio_trials_successful_ldpc (reference simulation.cpp:35).
        return 1.0 - self.ratio_trials_successful_ldpc


def finalize_point(
    partials: PointPartials,
    *,
    sim_number: int,
    matrix_filename: str,
    is_regular: bool,
    num_bit_nodes: int,
    num_check_nodes: int,
    initial_qber: float,
    max_iterations: int,
) -> SimResult:
    """Reference aggregation (simulation.cpp:252-313) from partial sums."""
    n = partials.n_trials
    n_sp = partials.n_sp
    if n_sp > 0:
        mean = partials.sum_it / n_sp
        var = max(partials.sum_it2 / n_sp - mean * mean, 0.0)
        std = math.sqrt(var)
        min_it = 0 if partials.min_it == max_iterations else partials.min_it
        max_it = partials.max_it
    else:
        mean = std = 0.0
        min_it = max_it = 0
    return SimResult(
        sim_number=sim_number,
        matrix_filename=matrix_filename,
        is_regular=is_regular,
        num_bit_nodes=num_bit_nodes,
        num_check_nodes=num_check_nodes,
        initial_qber=initial_qber,
        iterations_successful_sp_mean=mean,
        iterations_successful_sp_std_dev=std,
        iterations_successful_sp_min=min_it,
        iterations_successful_sp_max=max_it,
        ratio_trials_successful_sp=n_sp / n,
        ratio_trials_successful_ldpc=partials.n_ldpc / n,
    )
