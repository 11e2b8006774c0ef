"""Channel-model tests: exact error weight, determinism contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_tpu.channel import (
    derive_point_key,
    generate_random_bits,
    introduce_errors,
    make_trial_batch,
    num_errors_for,
)


def test_num_errors_floor_semantics():
    # floor(N*q), the reference's exact-count rule (amo.cpp:436).
    assert num_errors_for(10240, 0.05) == 512
    assert num_errors_for(10240, 0.0005) == 5
    assert num_errors_for(6, 0.05) == 0  # too small -> fatal upstream


def test_exact_error_count():
    key = jax.random.PRNGKey(0)
    bits = generate_random_bits(key, 512, 8)
    bob = introduce_errors(jax.random.fold_in(key, 1), bits, 37)
    diff = (np.asarray(bits) ^ np.asarray(bob)).sum(axis=1)
    np.testing.assert_array_equal(diff, np.full(8, 37))


def test_zero_errors_copies():
    key = jax.random.PRNGKey(0)
    bits = generate_random_bits(key, 64, 4)
    bob = introduce_errors(jax.random.fold_in(key, 1), bits, 0)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(bob))


def test_error_positions_uniform():
    # Flip-set law: each position flipped with probability k/N.
    key = jax.random.PRNGKey(42)
    n, k, reps = 64, 8, 2000
    bits = generate_random_bits(key, n, reps)
    bob = introduce_errors(jax.random.fold_in(key, 1), bits, k)
    flips = (np.asarray(bits) ^ np.asarray(bob)).mean(axis=0)
    assert abs(flips.mean() - k / n) < 1e-9  # exact weight per frame
    assert flips.std() < 0.03  # roughly uniform across positions


def test_trial_batch_partition_independence():
    # The same trials arise whether generated as one batch or two chunks —
    # the analog of the reference's thread-schedule-independent seeding
    # (simulation.cpp:222-228,247).
    pk = derive_point_key(777, 3)
    a_full, b_full = make_trial_batch(pk, 128, 16, 6, trial_offset=0)
    a_lo, b_lo = make_trial_batch(pk, 128, 8, 6, trial_offset=0)
    a_hi, b_hi = make_trial_batch(pk, 128, 8, 6, trial_offset=8)
    np.testing.assert_array_equal(np.asarray(a_full[:8]), np.asarray(a_lo))
    np.testing.assert_array_equal(np.asarray(a_full[8:]), np.asarray(a_hi))
    np.testing.assert_array_equal(np.asarray(b_full[:8]), np.asarray(b_lo))
    np.testing.assert_array_equal(np.asarray(b_full[8:]), np.asarray(b_hi))


def test_trial_batch_error_weight():
    pk = derive_point_key(1, 0)
    a, b = make_trial_batch(pk, 256, 32, 13)
    diff = (np.asarray(a) ^ np.asarray(b)).sum(axis=1)
    np.testing.assert_array_equal(diff, np.full(32, 13))


def test_point_keys_distinct():
    k0, k1 = derive_point_key(7, 0), derive_point_key(7, 1)
    assert not np.array_equal(np.asarray(k0), np.asarray(k1))


def test_exact_count_with_forced_ties():
    """Tie completion in the threshold sampler still yields exactly k flips.

    Constant scores force every position to tie at the threshold — the
    worst case for the selection-by-threshold path."""
    from qkd_ldpc_tpu.channel.keys import _exact_weight_mask

    scores = jnp.full((4, 64), 7, dtype=jnp.uint32)  # all tied
    for k in (1, 3, 63, 64):
        mask = _exact_weight_mask(scores, jnp.asarray(k, jnp.int32))
        assert np.all(np.asarray(mask.sum(axis=-1)) == k)


def test_exact_count_full_and_zero_weight():
    from qkd_ldpc_tpu.channel.keys import _exact_weight_mask

    scores = jax.random.bits(jax.random.PRNGKey(0), (8, 128), jnp.uint32)
    assert np.all(np.asarray(_exact_weight_mask(scores, 128).sum(axis=-1)) == 128)
    assert np.all(np.asarray(_exact_weight_mask(scores, 0).sum(axis=-1)) == 0)


def test_forced_ties_uniform_no_index_bias():
    """With a second tie-break word, forced threshold collisions select
    uniformly among the tied positions — no index-order bias (the
    reference's Fisher-Yates shuffle is exactly uniform,
    amo.cpp:434-460).  Without it, the first k indices always win."""
    from qkd_ldpc_tpu.channel.keys import _exact_weight_mask

    n, k, reps = 16, 4, 400
    scores = jnp.full((n,), 7, dtype=jnp.uint32)  # all positions tied

    # Index-order fallback: deterministic first-k selection (the bias).
    legacy = np.asarray(_exact_weight_mask(scores, k))
    assert legacy[:k].all() and not legacy[k:].any()

    counts = np.zeros(n)
    for r in range(reps):
        key = jax.random.fold_in(jax.random.PRNGKey(123), r)
        mask = _exact_weight_mask(
            scores, k,
            tie_scores_fn=lambda: jax.random.bits(key, (n,), jnp.uint32),
        )
        m = np.asarray(mask)
        assert m.sum() == k
        counts += m
    # Each position expects reps*k/n = 100 hits; 5 sigma ~ +-46.
    expected = reps * k / n
    sigma = np.sqrt(reps * (k / n) * (1 - k / n))
    assert np.all(np.abs(counts - expected) < 5 * sigma), counts


def test_tie_break_changes_only_tie_frames():
    """The second-word tie path leaves collision-free frames bit-identical
    to the index-order path (so round-1 parity curves are unaffected)."""
    from qkd_ldpc_tpu.channel.keys import _exact_weight_mask

    scores = jax.random.bits(jax.random.PRNGKey(9), (16, 256), jnp.uint32)
    a = _exact_weight_mask(scores, 17)
    b = _exact_weight_mask(
        scores, 17,
        tie_scores_fn=lambda: jax.random.bits(
            jax.random.PRNGKey(10), (16, 256), jnp.uint32
        ),
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _kth_cases():
    """(name, scores) cases for the k-th-smallest kernel: random rows at
    several widths (N a power of two or not), forced threshold ties,
    extreme values."""
    rng = np.random.default_rng(0)
    cases = [
        (f"random-{B}x{N}",
         rng.integers(0, 2**32, (B, N), dtype=np.uint32))
        for B, N in [(4, 256), (3, 100), (8, 1000), (2, 1)]
    ]
    cases.append(("ties", rng.integers(0, 16, (4, 512), dtype=np.uint32) << 28))
    s = np.full((2, 128), 0xFFFFFFFF, np.uint32)
    s[0, 5] = 0
    s[1, :3] = [7, 7, 9]
    cases.append(("extremes", s))
    return cases


@pytest.mark.parametrize("name,scores", _kth_cases(),
                         ids=[c[0] for c in _kth_cases()])
def test_pallas_threshold_matches_xla(name, scores):
    """The Pallas-Triton k-th-smallest kernel (interpret mode here; the
    compiled card run is tests/test_gpu.py) returns bit-identical
    thresholds to the XLA search for k in {1, 2, N/2, N-1, N}."""
    from qkd_ldpc_tpu.channel.keys import _kth_smallest
    from qkd_ldpc_tpu.channel.pallas_select import kth_smallest_kernel

    scores = jnp.asarray(scores)
    n = scores.shape[1]
    for k in sorted({1, 2, n // 2, n - 1, n} - {0}):
        kk = jnp.asarray(k, jnp.int32)
        ref = _kth_smallest(scores, kk)
        out = kth_smallest_kernel(scores, kk, interpret=True)
        assert out.shape == ref.shape == (scores.shape[0], 1)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_kth_kernel_per_row_k():
    """A per-row k vector (the tie-completion path passes one) selects
    each row's own threshold."""
    from qkd_ldpc_tpu.channel.keys import _kth_smallest
    from qkd_ldpc_tpu.channel.pallas_select import kth_smallest_kernel

    rng = np.random.default_rng(1)
    scores = jnp.asarray(rng.integers(0, 2**32, (5, 300), dtype=np.uint32))
    k = jnp.asarray([1, 17, 150, 299, 300], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(kth_smallest_kernel(scores, k, interpret=True)),
        np.asarray(_kth_smallest(scores, k)),
    )


def test_kth_kernel_row_padding():
    """Rows are padded to a power-of-two block; pad columns must read as
    the maximal value whatever the block holds past N, so k = N still
    returns the row maximum."""
    from qkd_ldpc_tpu.channel.pallas_select import kth_smallest_kernel

    s = np.arange(1, 601, dtype=np.uint32)[None, :] * 1000  # N=600 -> 1024
    out = kth_smallest_kernel(jnp.asarray(s), jnp.asarray(600, jnp.int32),
                              interpret=True)
    assert int(out[0, 0]) == 600 * 1000


def test_kth_threshold_dispatch():
    """One explicit size/platform rule picks the kernel: [B, N] rows on
    the GPU that fit one program; the XLA search on the CPU, for 1-D
    scores, and for rows wider than the kernel block (262k frames)."""
    from qkd_ldpc_tpu.channel.keys import kth_threshold_impl
    from qkd_ldpc_tpu.channel.pallas_select import MAX_KERNEL_COLS

    assert kth_threshold_impl((512, 10240), 0, "gpu") == "kernel"
    assert kth_threshold_impl((512, 10240), 1, "gpu") == "kernel"
    assert kth_threshold_impl((512, MAX_KERNEL_COLS), 0, "gpu") == "kernel"
    assert kth_threshold_impl((8, MAX_KERNEL_COLS + 1), 0, "gpu") == "xla"
    assert kth_threshold_impl((8, 262144), 0, "gpu") == "xla"
    assert kth_threshold_impl((10240,), 0, "gpu") == "xla"
    assert kth_threshold_impl((512, 10240), 0, "cpu") == "xla"
    assert kth_threshold_impl((512, 10240), 0) == "xla"  # this suite: CPU


def test_kth_kernel_rejects_wide_rows():
    from qkd_ldpc_tpu.channel.pallas_select import (
        MAX_KERNEL_COLS,
        kth_smallest_kernel,
    )

    with pytest.raises(ValueError, match="exceeds"):
        kth_smallest_kernel(
            jnp.zeros((1, MAX_KERNEL_COLS + 1), jnp.uint32),
            jnp.asarray(1, jnp.int32),
        )


def test_master_key_impl_validation():
    from qkd_ldpc_tpu.channel import master_key

    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(master_key(777))),
        np.asarray(jax.random.key_data(jax.random.PRNGKey(777))),
    )
    for impl in ("rbg", "pallas"):
        with pytest.raises(ValueError, match="prng impl"):
            master_key(777, impl)


def test_unknown_prng_contract_rejected():
    # Anything but the threefry stream must raise at the lowest-level
    # entry, not silently fall back to it (the caller would believe they
    # measured another stream while running threefry).
    from qkd_ldpc_tpu.channel import make_trials_from_ids

    pk = derive_point_key(777, 0)
    ids = jnp.arange(4, dtype=jnp.uint32)
    for prng in ("Pallas", "pallas"):
        with pytest.raises(ValueError, match="Unknown prng contract"):
            make_trials_from_ids(
                pk, 64, ids, jnp.asarray(3, jnp.int32), prng=prng
            )
