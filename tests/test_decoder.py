"""Decoder tests: known-answer (Johnson ex. 2.5), f64-oracle parity,
batching consistency, min-sum sanity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_tpu.decoder import (
    DecodeOptions,
    decode,
    oracle_reconcile,
    oracle_syndrome,
    reconcile,
    syndrome,
    apriori_llr,
)
from tests import fixtures

OPTS = DecodeOptions(max_iterations=100, clip_messages=True, message_threshold=100.0)


def test_syndrome_matches_oracle(n10_code):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(16, n10_code.n_vars), dtype=np.uint8)
    s_dev = np.asarray(syndrome(n10_code, jnp.asarray(bits)))
    s_ref = np.stack([oracle_syndrome(n10_code, b) for b in bits])
    np.testing.assert_array_equal(s_dev, s_ref)


def test_syndrome_linear(johnson_code):
    # s(a ^ b) == s(a) ^ s(b) over GF(2).
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, size=6, dtype=np.uint8)
    b = rng.integers(0, 2, size=6, dtype=np.uint8)
    sa = np.asarray(syndrome(johnson_code, jnp.asarray(a)))
    sb = np.asarray(syndrome(johnson_code, jnp.asarray(b)))
    sab = np.asarray(syndrome(johnson_code, jnp.asarray(a ^ b)))
    np.testing.assert_array_equal(sab, sa ^ sb)


def test_johnson_known_answer(johnson_code):
    """The reference's golden walkthrough (example/qkd_ldpc_example.cpp):
    bob differs from alice in bit 0; decoding must recover alice's key."""
    alice = jnp.asarray(fixtures.JOHNSON_ALICE, jnp.uint8)
    bob = jnp.asarray(fixtures.JOHNSON_BOB, jnp.uint8)
    res = reconcile(johnson_code, alice, bob, fixtures.JOHNSON_QBER, OPTS)
    assert bool(res.syndromes_match)
    assert bool(res.keys_match)
    np.testing.assert_array_equal(np.asarray(res.bits), np.asarray(alice))
    # Oracle (f64) agreement on the iteration count.
    ores, okeys = oracle_reconcile(
        johnson_code,
        np.asarray(alice),
        np.asarray(bob),
        fixtures.JOHNSON_QBER,
    )
    assert okeys and ores.syndromes_match
    assert int(res.iterations) == ores.iterations
    assert int(res.iterations) <= 5


@pytest.mark.parametrize("code_name", ["johnson_code", "hamming_code", "n10_code"])
def test_oracle_parity_small_codes(code_name, request):
    """f32 device decoder vs f64 NumPy oracle on random trials: identical
    success verdicts and hard decisions (BASELINE.json parity criterion)."""
    code = request.getfixturevalue(code_name)
    rng = np.random.default_rng(3)
    n = code.n_vars
    agree = 0
    for trial in range(24):
        alice = rng.integers(0, 2, size=n, dtype=np.uint8)
        bob = alice.copy()
        bob[rng.integers(0, n)] ^= 1  # one error
        qber = 1.0 / n
        res = reconcile(
            code, jnp.asarray(alice), jnp.asarray(bob), qber, OPTS
        )
        ores, okeys = oracle_reconcile(code, alice, bob, qber)
        assert bool(res.syndromes_match) == ores.syndromes_match
        if ores.syndromes_match:
            np.testing.assert_array_equal(
                np.asarray(res.bits), ores.bits, err_msg=f"trial {trial}"
            )
            assert bool(res.keys_match) == okeys
        if int(res.iterations) == ores.iterations:
            agree += 1
    # Iteration counts may differ by a step in rare borderline cases
    # (f32 vs f64); they must agree overwhelmingly.
    assert agree >= 20


def test_oracle_parity_medium_code(medium_code):
    """Statistical parity on a 512-bit irregular code at moderate QBER."""
    rng = np.random.default_rng(9)
    code = medium_code
    n = code.n_vars
    n_err = 15  # ~3%
    mism = 0
    for _ in range(10):
        alice = rng.integers(0, 2, size=n, dtype=np.uint8)
        pos = rng.choice(n, size=n_err, replace=False)
        bob = alice.copy()
        bob[pos] ^= 1
        qber = n_err / n
        res = reconcile(code, jnp.asarray(alice), jnp.asarray(bob), qber, OPTS)
        ores, _ = oracle_reconcile(code, alice, bob, qber)
        assert bool(res.syndromes_match) == ores.syndromes_match
        if ores.syndromes_match and not np.array_equal(
            np.asarray(res.bits), ores.bits
        ):
            mism += 1
        assert abs(int(res.iterations) - ores.iterations) <= 1
    assert mism == 0


def test_batch_matches_single(n10_code):
    rng = np.random.default_rng(5)
    B, n = 8, n10_code.n_vars
    alice = rng.integers(0, 2, size=(B, n), dtype=np.uint8)
    bob = alice.copy()
    for i in range(B):
        bob[i, rng.integers(0, n)] ^= 1
    qber = 0.1
    batched = reconcile(n10_code, jnp.asarray(alice), jnp.asarray(bob), qber, OPTS)
    for i in range(B):
        single = reconcile(
            n10_code, jnp.asarray(alice[i]), jnp.asarray(bob[i]), qber, OPTS
        )
        np.testing.assert_array_equal(
            np.asarray(batched.bits[i]), np.asarray(single.bits)
        )
        assert int(batched.iterations[i]) == int(single.iterations)
        assert bool(batched.syndromes_match[i]) == bool(single.syndromes_match)


def test_failure_reports_max_iterations(johnson_code):
    # An impossible syndrome target at tiny max_iterations must report
    # iterations == max and syndromes_match == False.
    opts = DecodeOptions(max_iterations=3)
    llr = apriori_llr(jnp.zeros(6, jnp.uint8), 0.45)
    # All-ones syndrome is unreachable from near-zero LLRs in 3 iterations.
    res = decode(johnson_code, llr, jnp.ones(4, jnp.int8), opts)
    if not bool(res.syndromes_match):
        assert int(res.iterations) == 3


def test_min_sum_corrects_single_error(medium_code):
    rng = np.random.default_rng(11)
    code = medium_code
    n = code.n_vars
    opts = DecodeOptions(algorithm="min-sum", min_sum_alpha=0.8)
    for _ in range(5):
        alice = rng.integers(0, 2, size=n, dtype=np.uint8)
        pos = rng.choice(n, size=10, replace=False)
        bob = alice.copy()
        bob[pos] ^= 1
        res = reconcile(code, jnp.asarray(alice), jnp.asarray(bob), 10 / n, opts)
        assert bool(res.syndromes_match)
        assert bool(res.keys_match)


def test_irregular_and_regular_share_one_path(hamming_code, n10_code):
    # Smoke: both regularities run through the same decode function.  The
    # error goes on a max-degree variable: a single error on a degree-1
    # variable node is a BP fixed point (confirmed against the f64 oracle)
    # and no sum-product decoder corrects it.
    for code in (hamming_code, n10_code):
        pos = int(np.argmax(code.var_deg))
        alice = jnp.zeros(code.n_vars, jnp.uint8)
        bob = alice.at[pos].set(1)
        res = reconcile(code, alice, bob, 1.0 / code.n_vars, OPTS)
        assert bool(res.keys_match)


def test_bf16_messages_match_f32_decisions(medium_code):
    """bf16 message storage: same convergence verdicts and hard decisions
    as f32 on a comfortably-decodable operating point (full-sweep FER
    parity on the production code is in PARITY.md)."""
    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.decoder.reconcile import reconcile

    ne = num_errors_for(medium_code.n_vars, 0.03)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(11), medium_code.n_vars, 16,
        jnp.asarray(ne, jnp.int32),
    )
    r32 = reconcile(medium_code, alice, bob, ne / medium_code.n_vars,
                    DecodeOptions(message_dtype="float32"))
    r16 = reconcile(medium_code, alice, bob, ne / medium_code.n_vars,
                    DecodeOptions(message_dtype="bfloat16"))
    np.testing.assert_array_equal(
        np.asarray(r16.keys_match), np.asarray(r32.keys_match)
    )
    assert np.asarray(r32.keys_match).all()
    # Iteration counts may differ by rounding at most marginally.
    assert np.abs(
        np.asarray(r16.iterations) - np.asarray(r32.iterations)
    ).max() <= 1


def test_invalid_message_dtype_rejected():
    with pytest.raises(ValueError):
        DecodeOptions(message_dtype="float16")


def test_int8_messages_close_to_f32(medium_code):
    """int8 fixed-point message storage (0.25 LSB): decode trajectories
    quantize but plateau behavior must match f32 (all frames converge,
    keys match, iteration counts within quantization jitter)."""
    import jax.numpy as jnp

    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.decoder.reconcile import reconcile

    n_err = num_errors_for(medium_code.n_vars, 0.03)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(3), medium_code.n_vars, 16,
        jnp.asarray(n_err, jnp.int32),
    )
    q = n_err / medium_code.n_vars
    r32 = reconcile(medium_code, alice, bob, q, DecodeOptions(max_iterations=60))
    r8 = reconcile(
        medium_code, alice, bob, q,
        DecodeOptions(max_iterations=60, message_dtype="int8"),
    )
    assert np.asarray(r8.syndromes_match).all()
    assert np.asarray(r8.keys_match).all()
    d = np.abs(np.asarray(r8.iterations) - np.asarray(r32.iterations))
    assert d.max() <= 3, d

    # exact determinism: the quantized path is still bit-reproducible
    r8b = reconcile(
        medium_code, alice, bob, q,
        DecodeOptions(max_iterations=60, message_dtype="int8"),
    )
    np.testing.assert_array_equal(np.asarray(r8.bits), np.asarray(r8b.bits))
    np.testing.assert_array_equal(
        np.asarray(r8.iterations), np.asarray(r8b.iterations)
    )


def test_max_iterations_validated():
    """max_iterations < 1 must be rejected (the peeled first iteration
    always runs, so a cap of 0 would report iterations=1 > cap)."""
    with pytest.raises(ValueError):
        DecodeOptions(max_iterations=0)
    with pytest.raises(ValueError):
        DecodeOptions(max_iterations=-3)


def test_tight_message_threshold_matches_oracle(medium_code):
    """A small clip threshold changes decode trajectories; the device decoder
    must track the f64 oracle's clip placement exactly (reference clips
    check->bit after the check update and bit->check after the bit update,
    qkd_ldpc_algorithm.cpp:74-77,141-144)."""
    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.decoder.reconcile import apriori_llr, reconcile
    from qkd_ldpc_tpu.decoder.oracle import oracle_reconcile

    ne = num_errors_for(medium_code.n_vars, 0.04)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(21), medium_code.n_vars, 8, jnp.asarray(ne, jnp.int32)
    )
    opts = DecodeOptions(max_iterations=50, message_threshold=2.5)
    res = reconcile(medium_code, alice, bob, ne / medium_code.n_vars, opts)
    for t in range(8):
        ores, okeys = oracle_reconcile(
            medium_code, np.asarray(alice[t]), np.asarray(bob[t]),
            ne / medium_code.n_vars, max_iterations=50, message_threshold=2.5,
        )
        assert bool(res.syndromes_match[t]) == ores.syndromes_match
        if ores.syndromes_match:
            assert int(res.iterations[t]) == ores.iterations
            np.testing.assert_array_equal(
                np.asarray(res.bits[t]), ores.bits.astype(np.int8)
            )


def test_zero_error_converges_first_iteration(medium_code):
    """bob == alice: the decision syndrome matches immediately ->
    1 iteration, keys match (reference early-exit semantics,
    qkd_ldpc_algorithm.cpp:105-126)."""
    from qkd_ldpc_tpu.channel.keys import generate_random_bits
    from qkd_ldpc_tpu.decoder.reconcile import reconcile

    alice = generate_random_bits(jax.random.PRNGKey(5), medium_code.n_vars, 4)
    res = reconcile(medium_code, alice, alice, 0.01, DecodeOptions())
    assert np.asarray(res.syndromes_match).all()
    assert np.asarray(res.keys_match).all()
    np.testing.assert_array_equal(np.asarray(res.iterations), 1)


def test_no_clip_option(medium_code):
    """clip_messages=False disables the threshold entirely (the reference's
    ENABLE_SUM_PRODUCT_MSG_LLR_THRESHOLD=false path)."""
    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.decoder.reconcile import reconcile

    ne = num_errors_for(medium_code.n_vars, 0.03)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(9), medium_code.n_vars, 8, jnp.asarray(ne, jnp.int32)
    )
    res = reconcile(medium_code, alice, bob, ne / medium_code.n_vars,
                    DecodeOptions(clip_messages=False))
    assert int(res.keys_match.sum()) == 8


def test_offset_min_sum(medium_code):
    """Offset min-sum (beta > 0): decodes the plateau, differs from the
    normalized variant, and matches the node-sharded decoder bit-for-bit."""
    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.decoder.reconcile import reconcile

    n_err = num_errors_for(medium_code.n_vars, 0.03)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(3), medium_code.n_vars, 12,
        jnp.asarray(n_err, jnp.int32),
    )
    q = n_err / medium_code.n_vars
    o_norm = DecodeOptions(algorithm="min-sum", max_iterations=60)
    o_off = DecodeOptions(algorithm="min-sum", max_iterations=60,
                          min_sum_alpha=1.0, min_sum_beta=0.4)
    r_norm = reconcile(medium_code, alice, bob, q, o_norm)
    r_off = reconcile(medium_code, alice, bob, q, o_off)
    assert np.asarray(r_off.keys_match).all()
    assert not np.array_equal(
        np.asarray(r_norm.iterations), np.asarray(r_off.iterations)
    )

    from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu.decoder.syndrome import syndrome
    from qkd_ldpc_tpu.parallel import decode_node_sharded, make_mesh

    llr = apriori_llr(bob, q)
    syn = syndrome(medium_code, alice)
    ns = decode_node_sharded(medium_code, llr, syn, o_off,
                             make_mesh(n_trial=2, n_node=4))
    ref = decode(medium_code, llr, syn, o_off)
    np.testing.assert_array_equal(np.asarray(ns.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(ns.iterations), np.asarray(ref.iterations)
    )


def test_product_form_decodes_where_division_form_nans():
    """DELIBERATE divergence from the reference's numerics: its
    ``row_prod / tanh_j`` check update (qkd_ldpc_algorithm.cpp:67,
    faithfully mirrored by the f64 oracle) produces 0/0 = NaN whenever a
    message is exactly zero — e.g. an erasure LLR, or symmetric
    cancellation on weak codes — poisoning the frame, which then runs to
    max_iterations and fails.  The prefix/suffix product form computes
    the well-defined limit (a zero input zeroes the other extrinsics;
    the zero edge gets the product of the others) and decodes the frame.

    The reference's shipped configurations never measurably trigger this
    (dv=3 ensemble, clip 100, f64 — the 5000-trial parity tables match
    exactly); rate adaptation's punctured positions trigger it by
    construction, which is why the division form was rejected.
    """
    import numpy as np

    from qkd_ldpc_tpu.codes import make_code
    from qkd_ldpc_tpu.decoder.oracle import oracle_decode
    from qkd_ldpc_tpu.decoder.syndrome import syndrome as syndrome_fn

    code = make_code(n=64, m=33, dv=3, seed=2)
    alice = np.asarray(
        jax.random.bernoulli(jax.random.PRNGKey(2), 0.5, (code.n_vars,))
    ).astype(np.uint8)
    syn = np.asarray(syndrome_fn(code, jnp.asarray(alice[None])))[0]
    # Bob's LLRs: confident and correct except one flipped bit and one
    # erasure (LLR exactly 0) — a frame any sane decoder recovers.
    llr = np.where(alice == 1, -4.0, 4.0)
    flip = 3
    llr[flip] = -llr[flip]
    llr[7] = 0.0
    opts = DecodeOptions(max_iterations=30)

    r = decode(code, jnp.asarray(llr, jnp.float32)[None], jnp.asarray(syn)[None], opts)
    assert bool(r.syndromes_match[0])
    np.testing.assert_array_equal(np.asarray(r.bits[0]), alice)

    o = oracle_decode(code, llr, syn, max_iterations=30)
    assert not o.syndromes_match  # the division form NaNs out


def test_random_parity_vs_oracle_clipped_defaults():
    """Bounded random sweep of the DEFAULT (clipped) configuration space
    vs the f64 oracle: converged frames must agree exactly on decisions,
    iterations, and verdicts.  (Unconverged frames' final bits are
    chaotic under f32-vs-f64 and are compared on verdict/iterations
    only; the unclipped regime diverges by design — see the test above.)"""
    import numpy as np

    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.codes import make_code
    from qkd_ldpc_tpu.decoder.oracle import oracle_reconcile
    from qkd_ldpc_tpu.decoder.reconcile import reconcile

    rng = np.random.default_rng(7)
    done = 0
    while done < 10:
        n = int(rng.integers(32, 320))
        m = max(4, int(n * rng.uniform(0.3, 0.7)))
        try:
            code = make_code(n=n, m=m, dv=int(rng.choice([3, 4])),
                             seed=int(rng.integers(1e6)))
        except ValueError:
            continue
        qber = float(rng.uniform(1.5 / n, 0.09))
        ne = num_errors_for(n, qber)
        if ne == 0:
            continue
        mi = int(rng.integers(5, 50))
        thr = float(rng.choice([100.0, 25.0, 5.0]))
        opts = DecodeOptions(max_iterations=mi, message_threshold=thr)
        alice, bob = make_trial_batch(
            jax.random.PRNGKey(int(rng.integers(1e6))), n, 2,
            jnp.asarray(ne, jnp.int32),
        )
        q = ne / n
        res = reconcile(code, alice, bob, q, opts)
        for b in range(2):
            ores, _ = oracle_reconcile(
                code, np.asarray(alice[b]), np.asarray(bob[b]), q,
                max_iterations=mi, message_threshold=thr,
            )
            assert int(res.iterations[b]) == ores.iterations, (n, m, qber, mi, thr)
            assert bool(res.syndromes_match[b]) == ores.syndromes_match
            if ores.syndromes_match:
                np.testing.assert_array_equal(
                    np.asarray(res.bits[b]), ores.bits
                )
        done += 1


def test_high_row_degree_code():
    """High-rate codes have large dc_max (~30 here): the dc-first check
    update and routing must handle them."""
    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.codes import make_code
    from qkd_ldpc_tpu.decoder.reconcile import reconcile

    code = make_code(n=1024, m=103, dv=3, seed=6, name="high-rate")
    assert code.dc_max >= 25
    ne = num_errors_for(code.n_vars, 0.005)
    a, b = make_trial_batch(jax.random.PRNGKey(3), code.n_vars, 16,
                            jnp.asarray(ne, jnp.int32))
    r = reconcile(code, a, b, ne / code.n_vars,
                  DecodeOptions(max_iterations=60))
    assert int(np.asarray(r.keys_match).sum()) >= 12  # near threshold


@pytest.mark.parametrize("algorithm,dtype", [
    ("sum-product", "float32"),
    ("sum-product", "bfloat16"),
    ("min-sum", "bfloat16"),
    ("sum-product", "int8"),
])
def test_compaction_bit_identical(medium_code, algorithm, dtype):
    """Residency compaction (round 4) is a SCHEDULE change only: for
    every lane — converged in phase A, finished compacted in phase B,
    or overflowed into the full-batch fallback phase C — decisions,
    iteration counts, and convergence flags equal the plain loop's."""
    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu.decoder.syndrome import syndrome as syndrome_fn

    B = 32
    # (qber, compact_after, compact_lanes): the 0.09 x 4-lane case forces
    # the overflow fallback (far more than 4 unconverged lanes at k1);
    # 0.02 converges almost entirely inside phase A; 0.05 exercises the
    # intended phase-B schedule.
    cases = [(0.02, 4, 8), (0.05, 4, 8), (0.09, 3, 4)]
    for qber, k1, b2 in cases:
        n_err = num_errors_for(medium_code.n_vars, qber)
        alice, bob = make_trial_batch(
            jax.random.PRNGKey(hash((algorithm, qber)) % (2**31)),
            medium_code.n_vars, B, jnp.asarray(n_err, jnp.int32),
        )
        llr = apriori_llr(bob, n_err / medium_code.n_vars)
        syn = syndrome_fn(medium_code, alice)
        base = dict(max_iterations=40, algorithm=algorithm,
                    message_dtype=dtype)
        plain = decode(medium_code, llr, syn, DecodeOptions(**base))
        comp = decode(
            medium_code, llr, syn,
            DecodeOptions(**base, compact_after=k1, compact_lanes=b2),
        )
        np.testing.assert_array_equal(
            np.asarray(plain.bits), np.asarray(comp.bits),
            err_msg=f"{algorithm}/{dtype} qber={qber}",
        )
        np.testing.assert_array_equal(
            np.asarray(plain.iterations), np.asarray(comp.iterations),
            err_msg=f"{algorithm}/{dtype} qber={qber}",
        )
        np.testing.assert_array_equal(
            np.asarray(plain.syndromes_match),
            np.asarray(comp.syndromes_match),
        )


def test_compaction_validation():
    with pytest.raises(ValueError):
        DecodeOptions(compact_after=4)  # lanes missing
    with pytest.raises(ValueError):
        DecodeOptions(compact_lanes=8)
    with pytest.raises(ValueError):
        DecodeOptions(compact_after=-1, compact_lanes=8)
