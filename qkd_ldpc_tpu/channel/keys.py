"""Sifted-key generation and the exact-weight binary channel.

Device-side counterpart of the reference's PRNG + channel layer:

- Alice's key: uniform i.i.d. bits (reference ``generate_random_bit_array``,
  ``src/array_and_matrix_operations.cpp:424-431``, Xoshiro256++ based).
  Here: counter-based ``jax.random`` (threefry) bits — generated on device,
  reproducible regardless of batch sharding.
- Bob's key: **exact-weight** error injection — exactly ``floor(N * qber)``
  bit flips at uniformly random positions, returning the *actual* QBER
  ``floor(N*q)/N`` (reference ``introduce_errors``,
  ``src/array_and_matrix_operations.cpp:434-460``, which Fisher-Yates
  shuffles all N indices and flips the first k).  Here the same
  distribution is sampled scatter-free: the k lowest of N i.i.d. uniform
  scores flip (selection by an exact k-th-smallest threshold).  A rank
  permutation of i.i.d. scores is exactly a uniform random permutation,
  so the flip-set law matches the reference's shuffle.

Determinism contract (the analog of the reference's ``seeds[k] + curr_sim``
scheme, ``src/simulation.cpp:222-228,247``): the master seed and the sweep
point index derive a point key via ``fold_in``; trial t within the point
uses ``fold_in(point_key, t)``.  Results are bit-for-bit reproducible for a
given seed, independent of batch size, device count, sharding or platform
— the equivalent of the reference's thread-schedule independence.  This
threefry stream is the only one; no other PRNG contract exists.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qkd_ldpc_tpu.channel import pallas_select


def master_key(seed: int, impl: str = "threefry") -> jax.Array:
    """Master PRNG key of the threefry determinism contract (``impl`` is
    validated so a request for any other stream raises)."""
    if impl != "threefry":
        raise ValueError(
            f"Unknown prng impl {impl!r}: only 'threefry' exists"
        )
    return jax.random.PRNGKey(seed)


def derive_point_key(master_seed: int, sweep_index: int) -> jax.Array:
    """PRNG key for one (matrix, QBER) sweep point."""
    return jax.random.fold_in(master_key(master_seed), sweep_index)


def num_errors_for(n_bits: int, qber: float) -> int:
    """Exact error count floor(N * q) — 0 means the key is too small for
    this QBER, which the reference treats as fatal (simulation.cpp:170-175)."""
    return int(n_bits * qber)


def generate_random_bits(key: jax.Array, n_bits: int, batch: int) -> jax.Array:
    """Alice's sifted keys: [batch, n_bits] uint8 i.i.d. uniform bits."""
    return jax.random.bernoulli(key, 0.5, (batch, n_bits)).astype(jnp.uint8)


def _kth_smallest(scores: jax.Array, k) -> jax.Array:
    """k-th smallest value along the last axis of uint32 ``scores``,
    found by a 32-pass bitwise prefix search (greedy largest prefix P
    with count(s < P) < k, refined one bit per pass).

    Each pass is one vectorized compare + row-sum over [..., N]; exact,
    and no sort.  The plain reference of channel.pallas_select.
    """
    k = jnp.asarray(k, jnp.int32)

    def step(j, prefix):
        test = prefix | (jnp.uint32(1) << jnp.uint32(31 - j))
        cnt = jnp.sum((scores < test[..., None]).astype(jnp.int32), axis=-1)
        return jnp.where(cnt >= k, prefix, test)

    prefix = jax.lax.fori_loop(
        0, 32, step, jnp.zeros(scores.shape[:-1], jnp.uint32)
    )
    return prefix[..., None]


def kth_threshold_impl(shape: tuple[int, ...], k_ndim: int,
                       platform: str | None = None) -> str:
    """Which implementation computes the k-th-smallest threshold.

    "kernel" (channel.pallas_select, one program per row, the row held
    on chip across all 32 passes) for [B, N] scores on the GPU whose rows
    fit one program; "xla" (:func:`_kth_smallest`) everywhere else: on
    the CPU, for 1-D scores, and for rows wider than the kernel's block
    (the 65k/262k frames of benchmarks/frame_scale.py).  Both are exact
    and bit-identical.
    """
    platform = platform or jax.default_backend()
    if (platform == "gpu" and len(shape) == 2 and k_ndim <= 1
            and pallas_select.fits_kernel(shape[-1])):
        return "kernel"
    return "xla"


def kth_smallest(scores: jax.Array, k) -> jax.Array:
    """k-th smallest per row of uint32 ``scores`` -> [..., 1] (dispatch)."""
    k = jnp.asarray(k, jnp.int32)
    if kth_threshold_impl(scores.shape, k.ndim) == "kernel":
        return pallas_select.kth_smallest_kernel(scores, k)
    return _kth_smallest(scores, k)


def _exact_weight_mask(scores: jax.Array, num_errors, tie_scores_fn=None) -> jax.Array:
    """Boolean mask with exactly ``num_errors`` True per row, uniformly
    placed, from i.i.d. uint32 ``scores`` [..., N].

    Selection-by-threshold instead of rank-by-double-argsort: find the
    k-th smallest score (bitwise search, no sort), flip everything
    strictly below it, and complete the count from the threshold ties.

    Tie handling: a genuine collision *at the threshold value* — the only
    case where a choice exists — occurs with probability ≈(N-1)/2^32 per
    frame (~2.4e-6 for N=10240).  When ``tie_scores_fn`` is given (a
    thunk returning an independent uint32 tensor shaped like ``scores``),
    such ties are completed by a second-word ranking instead of index
    order, making the flip-set law *exactly* the reference's Fisher-Yates
    uniform (``src/array_and_matrix_operations.cpp:434-460``) up to a
    ~2^-64 double-collision residue.  The second word is generated and
    ranked inside a ``lax.cond`` that fires only when some row actually
    has excess ties, so the common path's cost is unchanged.  Without
    ``tie_scores_fn``, ties complete in index order (uniform up to the
    same ~2.4e-6 event).
    """
    k = jnp.asarray(num_errors, jnp.int32)
    # k >= 1 is validated by callers (floor(N*q)==0 is fatal upstream);
    # a zero k yields an all-False mask via the final where.
    thresh = kth_smallest(scores, jnp.maximum(k, 1))
    below = scores < thresh
    at = scores == thresh
    n_below = jnp.sum(below, axis=-1, keepdims=True)
    tie_rank = jnp.cumsum(at.astype(jnp.int32), axis=-1) - 1
    need = jnp.asarray(k, jnp.int32) - n_below
    index_mask = below | (at & (tie_rank < need))

    if tie_scores_fn is None:
        return jnp.where(k > 0, index_mask, False)

    n_at = jnp.sum(at, axis=-1, keepdims=True)
    # A choice among ties exists only when more scores sit at the
    # threshold than are needed; rows where n_at == need take all ties in
    # both branches, so batching cannot change any trial's outcome.
    has_excess = jnp.any((n_at > need) & (k > 0))

    def uniform_ties(_):
        s2 = jnp.where(at, tie_scores_fn(), jnp.uint32(0xFFFFFFFF))
        t2 = kth_smallest(s2, jnp.maximum(need[..., 0], 1))
        below2 = at & (s2 < t2)
        at2 = at & (s2 == t2)
        rank2 = jnp.cumsum(at2.astype(jnp.int32), axis=-1) - 1
        need2 = need - jnp.sum(below2, axis=-1, keepdims=True)
        return below | below2 | (at2 & (rank2 < need2))

    mask = jax.lax.cond(has_excess, uniform_ties, lambda _: index_mask, None)
    return jnp.where(k > 0, mask, False)


def introduce_errors(
    key: jax.Array,
    bits: jax.Array,  # [B, N] uint8
    num_errors,  # scalar int (may be traced)
) -> jax.Array:
    """Flip exactly ``num_errors`` uniformly random positions per frame."""
    B, N = bits.shape
    scores = jax.random.bits(key, (B, N), jnp.uint32)
    tie_key = jax.random.fold_in(key, 1)
    flip = _exact_weight_mask(
        scores, num_errors,
        tie_scores_fn=lambda: jax.random.bits(tie_key, (B, N), jnp.uint32),
    )
    return jnp.where(flip, bits ^ 1, bits).astype(jnp.uint8)


def make_trials_from_ids(
    point_key: jax.Array,
    n_bits: int,
    trial_ids: jax.Array,  # [B] uint32 global trial indices
    num_errors,
    prng: str = "threefry",
) -> tuple[jax.Array, jax.Array]:
    """Generate (alice, bob) key batches for explicit global trial indices.

    Each trial gets its own derived key so the stream depends only on
    (master seed, sweep point, trial index) — independent of how trials are
    chunked into batches *or sharded across devices* (a sweep chunked as
    2x512, 1x1024, or split over 8 devices sees identical trials).
    ``prng`` must be "threefry", the only stream: anything else raises
    rather than silently producing a stream the caller did not ask for.
    """
    if prng != "threefry":
        raise ValueError(
            f"Unknown prng contract {prng!r}: only 'threefry' exists"
        )
    trial_keys = jax.vmap(lambda t: jax.random.fold_in(point_key, t))(trial_ids)
    error_keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(trial_keys)
    tie_keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(error_keys)
    alice_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(trial_keys)
    alice = jax.vmap(
        lambda k: jax.random.bernoulli(k, 0.5, (n_bits,)).astype(jnp.uint8)
    )(alice_keys)
    # The flip mask is computed OUTSIDE the per-trial vmap so the rare
    # tie-break branch stays a real `lax.cond` (vmap would turn it into a
    # select that always pays for the second score word).  Each trial's
    # scores still depend only on its own derived key, so determinism is
    # independent of batching.
    scores = jax.vmap(
        lambda k: jax.random.bits(k, (n_bits,), jnp.uint32)
    )(error_keys)
    flip = _exact_weight_mask(
        scores, num_errors,
        tie_scores_fn=lambda: jax.vmap(
            lambda k: jax.random.bits(k, (n_bits,), jnp.uint32)
        )(tie_keys),
    )
    bob = jnp.where(flip, alice ^ 1, alice).astype(jnp.uint8)
    return alice, bob


def make_trial_batch(
    point_key: jax.Array,
    n_bits: int,
    batch: int,
    num_errors,
    trial_offset=0,
) -> tuple[jax.Array, jax.Array]:
    """Generate (alice, bob) key batches for trials [offset, offset+batch)."""
    trial_ids = jnp.arange(batch, dtype=jnp.uint32) + jnp.asarray(
        trial_offset, jnp.uint32
    )
    return make_trials_from_ids(point_key, n_bits, trial_ids, num_errors)
