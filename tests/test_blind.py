"""Blind reconciliation (no-QBER-estimate interactive protocol) tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_tpu.channel.keys import introduce_errors, num_errors_for
from qkd_ldpc_tpu.codes import make_code
from qkd_ldpc_tpu.decoder import DecodeOptions
from qkd_ldpc_tpu.decoder.blind import blind_reconcile_sim
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter


@pytest.fixture(scope="module")
def mother():
    return make_code(n=1024, m=523, dv=3, seed=3, name="mother-1024")


def _keys(mother, d, qber, batch, seed):
    l = mother.n_vars - d
    kk = jax.random.PRNGKey(seed)
    alice = jax.random.bernoulli(kk, 0.5, (batch, l)).astype(jnp.uint8)
    n_err = num_errors_for(l, qber)
    bob = introduce_errors(jax.random.fold_in(kk, 1), alice, n_err)
    return alice, bob, n_err / l


def test_blind_good_channel_finishes_round_zero(mother):
    """At a QBER well inside the punctured rate's reach, frames verify in
    round 0 — leakage is M - d with no reveals and no estimate."""
    d = 128
    alice, bob, _ = _keys(mother, d, 0.02, 8, 5)
    res, km = blind_reconcile_sim(
        mother, alice, bob, n_punctured=d, qber_hint=0.05,
        opts=DecodeOptions(max_iterations=60), reveal_step=32,
    )
    assert res.ok.all() and km.all()
    assert (res.rounds == 0).all()
    np.testing.assert_array_equal(res.leak_bits, mother.n_checks - d)
    np.testing.assert_array_equal(res.key, np.asarray(alice))


def test_blind_adapts_to_bad_channel(mother):
    """At a QBER beyond the punctured rate (but inside the mother code's),
    frames fail round 0 and succeed after reveals; leakage grows by
    2 bits per revealed bit."""
    d = 256
    alice, bob, _ = _keys(mother, d, 0.06, 8, 9)
    res, km = blind_reconcile_sim(
        mother, alice, bob, n_punctured=d, qber_hint=0.06,
        opts=DecodeOptions(max_iterations=60), reveal_step=64,
    )
    assert res.ok.all() and km.all()
    assert (res.rounds > 0).any()  # the protocol actually adapted
    expect = mother.n_checks - d + 2 * np.minimum(res.rounds * 64, d)
    np.testing.assert_array_equal(res.leak_bits, expect)
    np.testing.assert_array_equal(res.key, np.asarray(alice))


def test_blind_hopeless_channel_flags_failures(mother):
    """Beyond even the mother code's reach, exhausting the reveal budget
    leaves ok=False — never a silently wrong key."""
    d = 64
    alice, bob, _ = _keys(mother, d, 0.14, 6, 2)
    res, km = blind_reconcile_sim(
        mother, alice, bob, n_punctured=d, qber_hint=0.12,
        opts=DecodeOptions(max_iterations=40), reveal_step=32,
    )
    assert not res.ok.any()
    assert not km.any()


def test_blind_frozen_frames_do_not_change(mother):
    """A frame that verified in an early round keeps its key and leakage
    through later rounds (per-frame freeze)."""
    d = 256
    # mix: half the frames see an easy channel, half a hard one
    l = mother.n_vars - d
    kk = jax.random.PRNGKey(31)
    alice = jax.random.bernoulli(kk, 0.5, (8, l)).astype(jnp.uint8)
    easy = introduce_errors(jax.random.fold_in(kk, 1), alice[:4], num_errors_for(l, 0.02))
    hard = introduce_errors(jax.random.fold_in(kk, 2), alice[4:], num_errors_for(l, 0.06))
    bob = jnp.concatenate([easy, hard], axis=0)
    res, km = blind_reconcile_sim(
        mother, alice, bob, n_punctured=d, qber_hint=0.05,
        opts=DecodeOptions(max_iterations=60), reveal_step=64,
    )
    assert km.all()
    assert (res.rounds[:4] == 0).all()
    assert (res.rounds[4:] > 0).any()
    assert (res.leak_bits[:4] < res.leak_bits[4:].max()).all()


def test_blind_validation(mother):
    from qkd_ldpc_tpu.decoder.blind import blind_reconcile

    ad_short = RateAdapter.make(mother, n_shortened=8)
    with pytest.raises(ValueError, match="all-punctured"):
        blind_reconcile(ad_short, np.zeros((1, ad_short.payload_bits)),
                        np.zeros((1, mother.n_checks)), lambda p: None)
    ad_none = RateAdapter.make(mother)
    with pytest.raises(ValueError, match="budget"):
        blind_reconcile(ad_none, np.zeros((1, mother.n_vars)),
                        np.zeros((1, mother.n_checks)), lambda p: None)


def test_blind_freeze_semantics(mother):
    """Round 3: verified frames are decoded from PINNED decisions in
    later rounds (they converge on the peeled first iteration instead of
    re-running their whole trajectory).  Results must be unchanged, and
    the final round's iteration count for an early-verified frame must
    be 1 — direct evidence the freeze engaged without touching the
    banked statistics."""
    d = 256
    l = mother.n_vars - d
    kk = jax.random.PRNGKey(77)
    alice = jax.random.bernoulli(kk, 0.5, (6, l)).astype(jnp.uint8)
    easy = introduce_errors(jax.random.fold_in(kk, 1), alice[:3],
                            num_errors_for(l, 0.02))
    hard = introduce_errors(jax.random.fold_in(kk, 2), alice[3:],
                            num_errors_for(l, 0.06))
    bob = jnp.concatenate([easy, hard], axis=0)
    res, km = blind_reconcile_sim(
        mother, alice, bob, n_punctured=d, qber_hint=0.05,
        opts=DecodeOptions(max_iterations=60), reveal_step=64, seed=0,
    )
    assert km.all()
    assert (res.rounds[:3] == 0).all() and (res.rounds[3:] > 0).any()
    # Banked iterations are the FIRST verifying round's (> 1 in general
    # for the easy frames — decoding real noise takes a few iterations).
    assert (res.iterations[:3] >= 1).all()
    # Leakage of early-verified frames unaffected by later reveals.
    assert (res.leak_bits[:3] == mother.n_checks - d).all()


def test_blind_session_endpoint_api(mother):
    """BlindSession (inverted-control serving API) reproduces the
    callback loop exactly — same keys, rounds, leakage."""
    from qkd_ldpc_tpu.decoder.blind import BlindSession, blind_reconcile

    d = 256
    alice, bob, _ = _keys(mother, d, 0.06, 6, 9)
    ad = RateAdapter.make(mother, n_punctured=d, seed=0)
    frames = ad.build_frames(alice, jax.random.PRNGKey(1))
    syn = ad.syndromes(frames)
    frames_np = np.asarray(frames)
    opts = DecodeOptions(max_iterations=60)

    ref = blind_reconcile(ad, bob, syn, lambda p: frames_np[:, p],
                          qber_hint=0.06, opts=opts, reveal_step=64)

    s = BlindSession(ad, bob, syn, qber_hint=0.06, opts=opts, reveal_step=64)
    pos = s.begin()
    n_messages = 0
    while pos is not None:
        n_messages += 1
        pos = s.provide(frames_np[:, pos])
    out = s.result()

    np.testing.assert_array_equal(out.key, ref.key)
    np.testing.assert_array_equal(out.ok, ref.ok)
    np.testing.assert_array_equal(out.rounds, ref.rounds)
    np.testing.assert_array_equal(out.leak_bits, ref.leak_bits)
    assert n_messages == int(ref.rounds.max())

    # protocol misuse is rejected
    import pytest as _pytest

    with _pytest.raises(RuntimeError):
        s.begin()
    with _pytest.raises(RuntimeError):
        s.provide(frames_np[:, :1])


def test_blind_secure_chain(mother):
    """One blind session yields verified,
    amplified key material with a per-frame ledger including reveals —
    the adaptive leakage finally reaches the stage that consumes it."""
    from qkd_ldpc_tpu.decoder.blind import BlindSession
    from qkd_ldpc_tpu.postprocess import privacy_amplify, verification_tags

    d = 256
    B = 6
    alice, bob, _ = _keys(mother, d, 0.06, B, 17)
    ad = RateAdapter.make(mother, n_punctured=d, seed=0)
    frames = ad.build_frames(alice, jax.random.PRNGKey(1))
    syn = ad.syndromes(frames)
    frames_np = np.asarray(frames)
    opts = DecodeOptions(max_iterations=60)

    s = BlindSession(ad, bob, syn, qber_hint=0.06, opts=opts, reveal_step=64)
    pos = s.begin()
    while pos is not None:
        pos = s.provide(frames_np[:, pos])

    tag_key = jax.random.PRNGKey(100)
    pa_key = jax.random.PRNGKey(200)
    a_tags = np.asarray(verification_tags(alice, tag_key, 64))
    sec = s.finalize(a_tags, tag_key, pa_key, tag_bits=64, security_bits=100)
    plain = s.result()

    # Ledger: reconciliation leakage (adaptive, includes 2x reveals) + tag.
    np.testing.assert_array_equal(sec.leak_bits, plain.leak_bits + 64)
    assert (sec.rounds == plain.rounds).all()
    # Frames that needed reveals leak more and keep SHORTER final keys.
    if (plain.rounds > 0).any() and (plain.rounds == 0).any():
        assert (sec.final_bits[sec.verified & (plain.rounds > 0)].max(initial=0)
                < sec.final_bits[sec.verified & (plain.rounds == 0)].min(
                    initial=1 << 30))

    # Per-frame length arithmetic; unverified frames yield nothing.
    payload = ad.payload_bits
    expect = np.maximum(payload - sec.leak_bits - 100, 0)
    np.testing.assert_array_equal(sec.final_bits[sec.verified],
                                  expect[sec.verified])
    np.testing.assert_array_equal(sec.final_bits[~sec.verified], 0)

    # Alice amplifies her own payload with the same seed: verified frames
    # agree bit-for-bit on their ragged prefixes; tails are zeroed.
    max_bits = sec.key.shape[1]
    a_key = np.asarray(privacy_amplify(jnp.asarray(alice), pa_key, max_bits))
    col = np.arange(max_bits)[None, :]
    for i in range(B):
        if sec.verified[i]:
            n = sec.final_bits[i]
            np.testing.assert_array_equal(sec.key[i, :n], a_key[i, :n])
    assert (sec.key[col >= sec.final_bits[:, None]] == 0).all()

    # Tag mismatch (corrupted channel) kills verification.
    bad = a_tags.copy()
    bad[0] ^= 1
    sec2 = s.finalize(bad, tag_key, pa_key)
    assert not sec2.verified[0]
    assert sec2.final_bits[0] == 0
    np.testing.assert_array_equal(sec2.verified[1:], sec.verified[1:])

    # Misuse: finalize before the session finished.
    s2 = BlindSession(ad, bob, syn, qber_hint=0.06, opts=opts, reveal_step=64)
    with pytest.raises(RuntimeError):
        s2.finalize(a_tags, tag_key, pa_key)
