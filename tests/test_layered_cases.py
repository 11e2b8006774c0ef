"""The XLA layered loop (decoder/layered.py): schedule-only invariances.

Residency compaction and batch width change how lanes are scheduled,
never any lane's result; offset min-sum, unclipped messages and a
z=128 lift run through the same loop.  The statistical validation of
the schedule itself is tests/test_layered.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu.codes import make_qc_code
from qkd_ldpc_tpu.decoder import DecodeOptions, decode
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu.decoder.syndrome import syndrome


@pytest.fixture(scope="module")
def qc_code():
    return make_qc_code(z=32, nb=10, mb=5, dv=3, seed=7)  # N=320, R=0.5


def _fixture(code, qber, batch, seed):
    n_err = num_errors_for(code.n_vars, qber)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(seed), code.n_vars, batch,
        jnp.asarray(n_err, jnp.int32),
    )
    return alice, apriori_llr(bob, n_err / code.n_vars), syndrome(code, alice)


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a.bits), np.asarray(b.bits))
    np.testing.assert_array_equal(np.asarray(a.iterations),
                                  np.asarray(b.iterations))
    np.testing.assert_array_equal(np.asarray(a.syndromes_match),
                                  np.asarray(b.syndromes_match))


@pytest.mark.parametrize("alg", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_layered_compaction_on_off_bit_identical(qc_code, alg, dtype):
    """Compaction (phase A/B/C) vs the plain layered loop, per lane, at a
    waterfall point where some lanes run long."""
    _, llr, syn = _fixture(qc_code, 0.075, batch=64, seed=7)
    base = DecodeOptions(algorithm=alg, message_dtype=dtype,
                         max_iterations=60, schedule="layered")
    plain = decode(qc_code, llr, syn, base)
    compact = decode(qc_code, llr, syn, dataclasses.replace(
        base, compact_after=3, compact_lanes=16))
    _assert_same(plain, compact)


def test_layered_ragged_batch_matches_larger_batch(qc_code):
    """A ragged batch (37 lanes) decodes each lane exactly as the same
    lanes inside a wider batch: lanes never interact."""
    _, llr, syn = _fixture(qc_code, 0.06, batch=64, seed=6)
    opts = DecodeOptions(max_iterations=60, schedule="layered")
    wide = decode(qc_code, llr, syn, opts)
    ragged = decode(qc_code, llr[:37], syn[:37], opts)
    np.testing.assert_array_equal(np.asarray(ragged.bits),
                                  np.asarray(wide.bits)[:37])
    np.testing.assert_array_equal(np.asarray(ragged.iterations),
                                  np.asarray(wide.iterations)[:37])


def test_layered_offset_min_sum(qc_code):
    """Offset min-sum (beta) through the layered loop: decodes the
    plateau to Alice, differs from the normalized variant, and stays
    bit-identical under compaction."""
    alice, llr, syn = _fixture(qc_code, 0.04, batch=32, seed=4)
    off = DecodeOptions(algorithm="min-sum", min_sum_alpha=1.0,
                        min_sum_beta=0.15, max_iterations=50,
                        schedule="layered")
    r_off = decode(qc_code, llr, syn, off)
    assert bool(jnp.all(r_off.syndromes_match))
    np.testing.assert_array_equal(np.asarray(r_off.bits), np.asarray(alice))
    r_norm = decode(qc_code, llr, syn, dataclasses.replace(
        off, min_sum_alpha=0.8, min_sum_beta=0.0))
    assert not np.array_equal(np.asarray(r_norm.iterations),
                              np.asarray(r_off.iterations))
    _assert_same(r_off, decode(qc_code, llr, syn, dataclasses.replace(
        off, compact_after=2, compact_lanes=8)))


def test_layered_no_clip_decodes_to_alice(qc_code):
    """clip_messages=False removes every clip site and still decodes."""
    alice, llr, syn = _fixture(qc_code, 0.04, batch=24, seed=5)
    res = decode(qc_code, llr, syn, DecodeOptions(
        clip_messages=False, max_iterations=50, schedule="layered"))
    assert bool(jnp.all(res.syndromes_match))
    np.testing.assert_array_equal(np.asarray(res.bits), np.asarray(alice))


def test_layered_z128_decodes_to_alice():
    """A z=128 lift (the production lift family's slab width) in bf16."""
    code = make_qc_code(z=128, nb=6, mb=3, dv=3, seed=11)  # N=768
    alice, llr, syn = _fixture(code, 0.03, batch=16, seed=8)
    res = decode(code, llr, syn, DecodeOptions(
        max_iterations=50, schedule="layered", message_dtype="bfloat16"))
    assert bool(jnp.all(res.syndromes_match))
    np.testing.assert_array_equal(np.asarray(res.bits), np.asarray(alice))
