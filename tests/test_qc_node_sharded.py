"""QC-structured node-sharded decoding vs the single-chip decoder.

Round 4: sharding a quasi-cyclic code by whole
circulant blocks makes every per-shard routing step a block roll and
every check reduction a short static-slot reduction — no segment sums,
no gathers, no log formulation (parallel.qc_node_sharded).  These tests
pin the semantics on the virtual 8-device CPU mesh: min-sum is
BIT-IDENTICAL to the single-chip kernel on any mesh (exactly
associative reductions + the global-slot tie rule); sum-product matches
decisions/iterations on the fixtures (its cross-shard product grouping
differs from the single-chip cumprod only at shard boundaries — the
same bar tests/test_node_sharded.py holds the general decoder to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu.codes.qc import make_qc_code
from qkd_ldpc_tpu.decoder import DecodeOptions, decode
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu.decoder.syndrome import syndrome
from qkd_ldpc_tpu.parallel import decode_qc_node_sharded, make_mesh


@pytest.fixture(scope="module")
def qc_code():
    # N=128, M=64: small enough for CPU, nb divides every tested shard
    # count (2, 4, 8).
    return make_qc_code(z=16, nb=8, mb=4, dv=3, seed=3)


def _trial_llr_syn(code, qber, batch, seed):
    n_err = num_errors_for(code.n_vars, qber)
    alice, bob = make_trial_batch(
        jax.random.PRNGKey(seed), code.n_vars, batch,
        jnp.asarray(n_err, jnp.int32),
    )
    llr = apriori_llr(bob, n_err / code.n_vars)
    syn = syndrome(code, alice)
    return llr, syn


@pytest.mark.parametrize("n_node", [2, 4, 8])
def test_qc_node_sharded_matches_single_chip(qc_code, n_node):
    mesh = make_mesh(n_trial=8 // n_node, n_node=n_node)
    opts = DecodeOptions(max_iterations=60)
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=16, seed=5)

    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)

    np.testing.assert_array_equal(
        np.asarray(out.syndromes_match), np.asarray(ref.syndromes_match)
    )
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    assert np.asarray(ref.syndromes_match).any()  # non-trivial case


def test_qc_node_sharded_block_padding():
    """nb=6 over 4 shards: nb_s=2 pads two edgeless dummy blocks on the
    last shard — results must match the unsharded decode exactly."""
    code = make_qc_code(z=16, nb=6, mb=3, dv=2, seed=1)
    mesh = make_mesh(n_trial=2, n_node=4)
    opts = DecodeOptions(max_iterations=40)
    llr, syn = _trial_llr_syn(code, 0.03, batch=8, seed=2)

    ref = decode(code, llr, syn, opts)
    out = decode_qc_node_sharded(code, llr, syn, opts, mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )


@pytest.mark.parametrize("n_node", [2, 8])
def test_qc_node_sharded_min_sum_bit_exact(qc_code, n_node):
    """Min-sum reductions (float-bits minima, integer sign counts) are
    exactly associative and the tie rule uses GLOBAL slot ranks, so the
    QC node-sharded decoder is bit-identical on any mesh."""
    mesh = make_mesh(n_trial=8 // n_node, n_node=n_node)
    opts = DecodeOptions(algorithm="min-sum", max_iterations=60)
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=16, seed=5)

    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(out.syndromes_match), np.asarray(ref.syndromes_match)
    )
    assert np.asarray(ref.syndromes_match).any()


def test_qc_node_sharded_min_sum_forced_tie(qc_code):
    """Quantized LLRs force |message| collisions inside check rows: the
    distributed global-slot tie rule must still match argmin slot order."""
    mesh = make_mesh(n_trial=1, n_node=8)
    opts = DecodeOptions(algorithm="min-sum", max_iterations=30)
    llr, syn = _trial_llr_syn(qc_code, 0.03, batch=8, seed=11)
    llr = jnp.round(llr * 4.0) / 4.0
    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_qc_node_sharded_quantized_messages(qc_code, algorithm, dtype):
    """bf16 / int8 storage: the (total, Lr) carry rounds through the
    storage dtype at the same points as the single-chip fused loop."""
    mesh = make_mesh(n_trial=2, n_node=4)
    opts = DecodeOptions(
        algorithm=algorithm, max_iterations=60, message_dtype=dtype
    )
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=16, seed=5)
    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )


def test_qc_node_sharded_requires_qc(medium_code):
    mesh = make_mesh(n_trial=1, n_node=8)
    llr, syn = _trial_llr_syn(medium_code, 0.03, batch=4, seed=0)
    with pytest.raises(ValueError, match="QC"):
        decode_qc_node_sharded(
            medium_code, llr, syn, DecodeOptions(max_iterations=5), mesh
        )


def test_general_node_sharded_rejects_layered_schedule(medium_code):
    """The GENERAL node-sharded decoder implements flooding only; a
    layered request must raise instead of silently decoding with a
    different schedule.  (The QC decoder composes layered since round 5
    — the tests below.)"""
    from qkd_ldpc_tpu.parallel.node_sharded import decode_node_sharded

    mesh = make_mesh(n_trial=1, n_node=8)
    opts = DecodeOptions(max_iterations=5, schedule="layered")
    llr_m, syn_m = _trial_llr_syn(medium_code, 0.03, batch=4, seed=0)
    with pytest.raises(ValueError, match="flooding schedule only"):
        decode_node_sharded(medium_code, llr_m, syn_m, opts, mesh)


# ---------------------------------------------------------------------------
# Layered schedule x QC node sharding (round 5)


@pytest.mark.parametrize("n_node", [2, 4, 8])
def test_qc_node_sharded_layered_matches_single_device(qc_code, n_node):
    """Sum-product layered on the column-block shard plan: decisions,
    iteration counts, and verdicts equal the single-device layered loop
    (decoder/layered.py) — the same bar the flooding path meets (its
    cross-shard product grouping differs only at shard boundaries)."""
    mesh = make_mesh(n_trial=8 // n_node, n_node=n_node)
    opts = DecodeOptions(max_iterations=60, schedule="layered")
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=16, seed=5)

    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)

    np.testing.assert_array_equal(
        np.asarray(out.syndromes_match), np.asarray(ref.syndromes_match)
    )
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    assert np.asarray(ref.syndromes_match).any()


@pytest.mark.parametrize("n_node", [2, 8])
def test_qc_node_sharded_layered_min_sum_bit_exact(qc_code, n_node):
    """Layered min-sum is BIT-IDENTICAL to the single-device layered
    loop on any mesh: per-layer float-bits minima and sign counts are
    exactly associative and the tie rule uses global slot ranks."""
    mesh = make_mesh(n_trial=8 // n_node, n_node=n_node)
    opts = DecodeOptions(
        algorithm="min-sum", max_iterations=60, schedule="layered"
    )
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=16, seed=5)

    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(out.syndromes_match), np.asarray(ref.syndromes_match)
    )
    assert np.asarray(ref.syndromes_match).any()


def test_qc_node_sharded_layered_block_padding():
    """nb=6 over 4 shards pads two edgeless dummy blocks: the layered
    path's clamped-sentinel scatter (delta 0 into block 0) and masked
    gathers must keep results equal to the unsharded layered decode."""
    code = make_qc_code(z=16, nb=6, mb=3, dv=2, seed=1)
    mesh = make_mesh(n_trial=2, n_node=4)
    opts = DecodeOptions(max_iterations=40, schedule="layered")
    llr, syn = _trial_llr_syn(code, 0.03, batch=8, seed=2)

    ref = decode(code, llr, syn, opts)
    out = decode_qc_node_sharded(code, llr, syn, opts, mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_qc_node_sharded_layered_quantized(qc_code, algorithm, dtype):
    """bf16 / int8 message storage rounds at the same points as the
    single-device layered loop (to_storage on Lr; t stays full dtype)."""
    mesh = make_mesh(n_trial=2, n_node=4)
    opts = DecodeOptions(
        algorithm=algorithm, max_iterations=60, message_dtype=dtype,
        schedule="layered",
    )
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=16, seed=5)
    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )


def test_qc_sweep_point_layered_node_sharded(qc_code):
    """run_point_node_sharded composes the layered schedule with the
    2-D (trial, node) mesh: min-sum partials equal the single-chip
    layered runner's exactly."""
    from qkd_ldpc_tpu.parallel import make_mesh, run_point_node_sharded
    from qkd_ldpc_tpu.sim.runner import run_point

    key = jax.random.fold_in(jax.random.PRNGKey(777), 3)
    opts = DecodeOptions(
        algorithm="min-sum", max_iterations=50, schedule="layered"
    )
    p1, q1 = run_point(qc_code, key, 0.03, trials=32, batch=32, opts=opts)
    mesh = make_mesh(n_trial=2, n_node=4)
    p2, q2 = run_point_node_sharded(
        qc_code, key, 0.03, trials=32, batch=32, opts=opts, mesh=mesh
    )
    assert q1 == q2 and p1.n_trials == p2.n_trials == 32
    assert (p1.n_sp, p1.n_ldpc, p1.sum_it, p1.sum_it2, p1.min_it, p1.max_it) == \
           (p2.n_sp, p2.n_ldpc, p2.sum_it, p2.sum_it2, p2.min_it, p2.max_it)


def test_qc_node_sharded_roll_parity(qc_code):
    """The sharded program must agree with the single-chip ROLL routing
    too (roll vs gather is already pinned bit-identical in test_qc.py;
    this closes the triangle on the sharded path)."""
    mesh = make_mesh(n_trial=2, n_node=4)
    opts = DecodeOptions(max_iterations=40, routing="roll")
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=8, seed=7)
    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn,
                                 DecodeOptions(max_iterations=40), mesh)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )


def test_qc_sweep_point_dispatches_to_block_rolls(qc_code, monkeypatch):
    """run_point_node_sharded auto-routes a QC code to the block-roll
    decoder (parallel/sweep.py dispatch on ``opts.routing`` x ``code.qc``)
    and its partials match the single-chip runner's (min-sum: exactly
    associative distributed reductions, so full stat equality holds on
    any mesh)."""
    import qkd_ldpc_tpu.parallel.node_sharded as general_ns
    from qkd_ldpc_tpu.parallel import make_mesh, run_point_node_sharded
    from qkd_ldpc_tpu.sim.runner import run_point

    def _boom(*a, **k):  # the general path must not be traced for QC
        raise AssertionError("general node-sharded decoder used for a QC code")

    monkeypatch.setattr(general_ns, "bp_decode_node_sharded", _boom)

    key = jax.random.fold_in(jax.random.PRNGKey(777), 3)
    opts = DecodeOptions(algorithm="min-sum", max_iterations=50)
    p1, q1 = run_point(qc_code, key, 0.03, trials=32, batch=32, opts=opts)
    mesh = make_mesh(n_trial=2, n_node=4)
    p2, q2 = run_point_node_sharded(
        qc_code, key, 0.03, trials=32, batch=32, opts=opts, mesh=mesh
    )
    assert q1 == q2 and p1.n_trials == p2.n_trials == 32
    assert (p1.n_sp, p1.n_ldpc, p1.sum_it, p1.sum_it2, p1.min_it, p1.max_it) == \
           (p2.n_sp, p2.n_ldpc, p2.sum_it, p2.sum_it2, p2.min_it, p2.max_it)


def test_qc_node_sharded_odd_batch_pads(qc_code):
    """The convenience wrapper pads any batch size to the mesh's trial
    multiple with inert frames and slices them back off (round-4 soak
    found B=17 on a trial=4 mesh rejected by shard_map)."""
    mesh = make_mesh(n_trial=4, n_node=2)
    opts = DecodeOptions(max_iterations=40)
    llr, syn = _trial_llr_syn(qc_code, 0.02, batch=17, seed=11)
    ref = decode(qc_code, llr, syn, opts)
    out = decode_qc_node_sharded(qc_code, llr, syn, opts, mesh)
    assert out.bits.shape[0] == 17
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )
