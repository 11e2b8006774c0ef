"""Quasi-cyclic code family: construction invariants and the roll-based
routing's bit-identity with the general gather path.

Rolls can replace the general routing gathers for QC codes
(``DecodeOptions.routing="roll"``, decoder/qc_routing).
Correctness story here; throughput is measured on the card
(benchmarks/qc.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu.codes import make_qc_code, parse_alist, write_alist
from qkd_ldpc_tpu.codes.qc import _four_cycle_conflicts
from qkd_ldpc_tpu.decoder import DecodeOptions, decode
from qkd_ldpc_tpu.decoder.oracle import oracle_decode
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr, reconcile
from qkd_ldpc_tpu.decoder.syndrome import syndrome


@pytest.fixture(scope="module")
def qc_code():
    # z=32, 16x8 base, dv=3: N=512, M=256, row degrees 6 (regular rows).
    return make_qc_code(z=32, nb=16, mb=8, dv=3, seed=7)


@pytest.fixture(scope="module")
def qc_irregular():
    # nb*dv does not divide mb: mixed row degrees (5/6-style profile).
    return make_qc_code(z=16, nb=21, mb=11, dv=3, seed=3)


def _trial(code, qber, batch, seed):
    n_err = num_errors_for(code.n_vars, qber)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(seed), code.n_vars, batch,
        jnp.asarray(n_err, jnp.int32),
    )
    return alice, apriori_llr(bob, n_err / code.n_vars), syndrome(code, alice)


def test_construction_invariants(qc_code):
    assert qc_code.n_vars == 512 and qc_code.n_checks == 256
    assert qc_code.qc is not None and qc_code.qc[0] == 32
    # Column-regular weight 3; row weights balanced at 6.
    np.testing.assert_array_equal(qc_code.var_deg, 3)
    np.testing.assert_array_equal(qc_code.chk_deg, 6)
    # Girth >= 6: the dense H must contain no 2x2 all-ones submatrix.
    H = qc_code.dense.astype(np.int64)
    overlap = H @ H.T
    np.fill_diagonal(overlap, 0)
    assert overlap.max() <= 1, "4-cycle present in lifted graph"


def test_irregular_base_rows(qc_irregular):
    """21*3 = 63 base edges over 11 rows: degrees 5 and 6 mixed, the
    reference production code's row-profile family (SURVEY.md §2)."""
    assert qc_irregular.qc is not None
    degs = np.unique(qc_irregular.chk_deg)
    assert set(degs.tolist()) == {5, 6}
    assert not qc_irregular.is_regular


def test_four_cycle_checker_detects():
    """The repair loop's oracle must actually see a closing quadruple."""
    cells = {(0, 0): 0, (0, 1): 0, (1, 0): 0, (1, 1): 0}
    assert _four_cycle_conflicts(cells, 8)
    cells[(1, 1)] = 3
    assert not _four_cycle_conflicts(cells, 8)


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_roll_routing_bit_identical(qc_code, algorithm, dtype):
    """Roll routing is a re-layout of the same permutation: decisions and
    iteration counts must equal the gather path bit-for-bit."""
    _, llr, syn = _trial(qc_code, 0.04, batch=16, seed=5)
    roll = decode(
        qc_code, llr, syn,
        DecodeOptions(max_iterations=60, algorithm=algorithm,
                      message_dtype=dtype, routing="roll"),
    )
    gather = decode(
        qc_code, llr, syn,
        DecodeOptions(max_iterations=60, algorithm=algorithm,
                      message_dtype=dtype, routing="gather"),
    )
    np.testing.assert_array_equal(np.asarray(roll.bits), np.asarray(gather.bits))
    np.testing.assert_array_equal(
        np.asarray(roll.iterations), np.asarray(gather.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(roll.syndromes_match), np.asarray(gather.syndromes_match)
    )
    assert np.asarray(roll.syndromes_match).any()


def test_roll_routing_irregular_base(qc_irregular):
    """Padded check slots (mixed base row degrees) must not perturb the
    roll path."""
    _, llr, syn = _trial(qc_irregular, 0.05, batch=8, seed=2)
    roll = decode(qc_irregular, llr, syn,
                  DecodeOptions(max_iterations=60, routing="roll"))
    gather = decode(qc_irregular, llr, syn,
                    DecodeOptions(max_iterations=60, routing="gather"))
    np.testing.assert_array_equal(np.asarray(roll.bits), np.asarray(gather.bits))
    np.testing.assert_array_equal(
        np.asarray(roll.iterations), np.asarray(gather.iterations)
    )


def test_qc_decode_matches_oracle(qc_code):
    """The QC + roll path must still track the f64 reference oracle's
    hard decisions (same tanh-rule equations)."""
    _, llr, syn = _trial(qc_code, 0.04, batch=4, seed=9)
    res = decode(qc_code, llr, syn, DecodeOptions(max_iterations=50))
    for b in range(4):
        o = oracle_decode(
            qc_code, np.asarray(llr)[b].astype(np.float64),
            np.asarray(syn)[b], max_iterations=50,
        )
        assert bool(res.syndromes_match[b]) == o.syndromes_match
        if o.syndromes_match:
            np.testing.assert_array_equal(np.asarray(res.bits)[b], o.bits)


def test_qc_reconcile_end_to_end(qc_code):
    """Full protocol step on the QC code: everything downstream of the
    code object is code-structure-agnostic."""
    n_err = num_errors_for(qc_code.n_vars, 0.03)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(1), qc_code.n_vars, 8, jnp.asarray(n_err, jnp.int32)
    )
    res = reconcile(qc_code, alice, bob, n_err / qc_code.n_vars,
                    DecodeOptions(max_iterations=100))
    assert np.asarray(res.keys_match).all()


def test_qc_alist_round_trip(tmp_path, qc_code):
    """QC codes export as ordinary alist files; the parsed code has the
    identical graph.  The bare parser (no file context) cannot see the
    sidecar, so it returns an unstructured view of the same graph."""
    p = tmp_path / "qc.txt"
    write_alist(qc_code, p)
    back = parse_alist(p.read_text())
    np.testing.assert_array_equal(back.chk_adj, np.asarray(qc_code.chk_adj))
    np.testing.assert_array_equal(back.var_adj, np.asarray(qc_code.var_adj))
    assert back.qc is None  # text alone carries no structure metadata


def test_qc_sidecar_round_trip(tmp_path, qc_code):
    """write -> load reconstructs the QC roll layout exactly (without
    this, roll routing existed only for codes constructed in-process),
    with the fingerprint — a graph hash — unchanged."""
    from qkd_ldpc_tpu.codes import read_alist
    from qkd_ldpc_tpu.codes.alist import qc_sidecar_path

    p = tmp_path / "qc.txt"
    write_alist(qc_code, p)
    assert qc_sidecar_path(p).exists()
    back = read_alist(p)
    assert back.qc is not None
    assert back.qc == qc_code.qc  # identical static layout tuples
    assert back.fingerprint == qc_code.fingerprint

    # The reloaded code decodes with roll routing, bit-identically to
    # its own gather path (routing='auto' follows the platform's plan).
    _, llr, syn = _trial(back, 0.02, batch=4, seed=5)
    roll = decode(back, llr, syn,
                  DecodeOptions(max_iterations=25, routing="roll"))
    gather = decode(back, llr, syn,
                    DecodeOptions(max_iterations=25, routing="gather"))
    np.testing.assert_array_equal(np.asarray(roll.bits),
                                  np.asarray(gather.bits))
    np.testing.assert_array_equal(np.asarray(roll.iterations),
                                  np.asarray(gather.iterations))


def test_qc_sidecar_removed_on_non_qc_overwrite(tmp_path, qc_code):
    """Overwriting a previously-QC path with a non-QC code removes the
    stale sidecar, so the fresh file round-trips (the writer must never
    manufacture the mismatch the reader rejects)."""
    from qkd_ldpc_tpu.codes import from_dense, read_alist
    from qkd_ldpc_tpu.codes.alist import qc_sidecar_path
    from tests import fixtures

    p = tmp_path / "m.txt"
    write_alist(qc_code, p)
    assert qc_sidecar_path(p).exists()
    plain = from_dense(np.array(fixtures.H_JOHNSON), name="johnson-6")
    write_alist(plain, p)
    assert not qc_sidecar_path(p).exists()
    back = read_alist(p)
    assert back.qc is None
    np.testing.assert_array_equal(back.chk_adj, np.asarray(plain.chk_adj))


def test_qc_sidecar_mismatch_rejected(tmp_path, qc_code):
    """A sidecar that does not describe the stored graph raises instead
    of silently mis-routing messages."""
    from qkd_ldpc_tpu.codes import read_alist
    from qkd_ldpc_tpu.codes.alist import qc_sidecar_path

    other = make_qc_code(z=32, nb=16, mb=8, dv=3, seed=8)  # different seed
    p = tmp_path / "qc.txt"
    write_alist(qc_code, p)
    write_alist(other, tmp_path / "other.txt")
    qc_sidecar_path(p).write_text(
        qc_sidecar_path(tmp_path / "other.txt").read_text()
    )
    with pytest.raises(ValueError, match="does not describe the graph"):
        read_alist(p)


def test_qc_sidecar_corrupt_rejected(tmp_path, qc_code):
    from qkd_ldpc_tpu.codes import read_alist
    from qkd_ldpc_tpu.codes.alist import qc_sidecar_path

    p = tmp_path / "qc.txt"
    write_alist(qc_code, p)
    qc_sidecar_path(p).write_text('{"z": "junk"}')
    with pytest.raises(ValueError, match="Corrupt QC sidecar"):
        read_alist(p)
    # Wrong z (does not divide N): also rejected with a clear message.
    qc_sidecar_path(p).write_text('{"z": 31, "cells": [[0, 0, 1]]}')
    with pytest.raises(ValueError, match="does not divide"):
        read_alist(p)


def test_rejects_roll_on_unstructured():
    from qkd_ldpc_tpu.codes import make_code

    code = make_code(n=128, m=64, dv=3, seed=0)
    llr = jnp.ones((2, 128), jnp.float32)
    syn = jnp.zeros((2, 64), jnp.int8)
    with pytest.raises(ValueError):
        decode(code, llr, syn, DecodeOptions(routing="roll"))


def test_qc_layout_survives_device_put(qc_code):
    code_dev = qc_code.to_device()
    assert code_dev.qc == qc_code.qc
    code2 = dataclasses.replace(qc_code)
    assert code2.qc == qc_code.qc


def test_continuation_with_roll_routing(qc_code):
    """Continuation batching composes with roll routing (the
    production pairing: waterfall points on a QC code): statistics must
    equal the plain runner's with BOTH routings, bit-for-bit."""
    from qkd_ldpc_tpu.sim.continuation import run_point_continuation
    from qkd_ldpc_tpu.sim.runner import run_point

    key = jax.random.fold_in(jax.random.PRNGKey(777), 3)
    for routing in ("gather", "roll"):
        opts = DecodeOptions(max_iterations=30, routing=routing)
        p1, _ = run_point(qc_code, key, 0.07, trials=40, batch=40, opts=opts)
        p2, _ = run_point_continuation(
            qc_code, key, 0.07, trials=40, batch=12, opts=opts, segment=3,
        )
        assert p1 == p2, routing


def test_qc_construction_fuzz():
    """Randomized (z, nb, mb, dv, seed) constructions: degree profile,
    girth >= 6, and roll==gather decode identity must hold for every
    draw the builder accepts."""
    rng = np.random.default_rng(20260817)
    for trial in range(5):
        z = int(rng.choice([8, 16, 32, 64]))
        nb = int(rng.integers(6, 24))
        mb = int(rng.integers(3, max(4, nb // 2 + 1)))
        dv = int(rng.choice([2, 3]))
        if dv > mb:
            dv = mb
        seed = int(rng.integers(0, 1 << 16))
        try:
            code = make_qc_code(z=z, nb=nb, mb=mb, dv=dv, seed=seed)
        except RuntimeError:
            continue  # 4-cycle repair may fail for tiny z; that's allowed
        np.testing.assert_array_equal(code.var_deg, dv)
        assert code.n_edges == nb * z * dv
        H = code.dense.astype(np.int64)
        overlap = H @ H.T
        np.fill_diagonal(overlap, 0)
        assert overlap.max() <= 1, (z, nb, mb, dv, seed)

        qber = max(0.02, 2.0 / code.n_vars)
        _, llr, syn = _trial(code, qber, batch=4, seed=seed)
        roll = decode(code, llr, syn,
                      DecodeOptions(max_iterations=25, routing="roll"))
        gather = decode(code, llr, syn,
                        DecodeOptions(max_iterations=25, routing="gather"))
        np.testing.assert_array_equal(np.asarray(roll.bits),
                                      np.asarray(gather.bits))
        np.testing.assert_array_equal(np.asarray(roll.iterations),
                                      np.asarray(gather.iterations))


@pytest.mark.parametrize("s", [0, 1, 5, 31])
def test_rot_matches_np_roll(s):
    """_rot is the circulant permutation row r <- row (r + s) mod z."""
    from qkd_ldpc_tpu.decoder import qc_routing

    rng = np.random.default_rng(0)
    block = jnp.asarray(rng.normal(size=(32, 8)), jnp.float32)
    out = jax.jit(lambda b: qc_routing._rot(b, s))(block)
    np.testing.assert_array_equal(
        np.asarray(out), np.roll(np.asarray(block), -s, axis=0))


def test_routing_choice(qc_code):
    """Rolls run only under routing="roll"; "auto" and "gather" take the
    general gathers (faster on the H100 at the z=512 flagship)."""
    from qkd_ldpc_tpu.decoder.bp import _DecodeCore

    for routing, rolls in (("auto", False), ("gather", False),
                           ("roll", True)):
        core = _DecodeCore(qc_code, DecodeOptions(routing=routing),
                           jnp.float32, 4)
        assert (core.qc is not None) == rolls, routing
