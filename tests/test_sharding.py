"""Sharded-sweep tests on a virtual 8-device CPU mesh.

This is the answer to "test multi-device without a cluster"
(SURVEY.md §4): ``xla_force_host_platform_device_count=8`` fakes 8 devices
(set in conftest.py before jax import).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_tpu.decoder import DecodeOptions
from qkd_ldpc_tpu.parallel import (
    TRIAL_AXIS,
    make_mesh,
    make_trial_mesh,
    run_point_sharded,
)
from qkd_ldpc_tpu.sim.runner import run_point

OPTS = DecodeOptions()


def test_virtual_devices_present():
    assert jax.device_count() == 8


def test_trial_mesh_shape():
    mesh = make_trial_mesh()
    assert mesh.shape[TRIAL_AXIS] == 8
    mesh2 = make_mesh(n_trial=4, n_node=2)
    assert mesh2.shape == {"trial": 4, "node": 2}
    with pytest.raises(ValueError):
        make_mesh(n_node=3)


def test_sharded_point_matches_single_device(medium_code):
    """Sharding over 8 devices must be bit-identical to the 1-chip runner
    (the determinism contract)."""
    key = jax.random.fold_in(jax.random.PRNGKey(777), 0)
    p_single, q1 = run_point(
        medium_code, key, 0.03, trials=64, batch=64, opts=OPTS
    )
    mesh = make_trial_mesh()
    p_shard, q2 = run_point_sharded(
        medium_code, key, 0.03, trials=64, batch=64, opts=OPTS, mesh=mesh
    )
    assert q1 == q2
    assert p_single.n_trials == p_shard.n_trials == 64
    assert p_single.n_sp == p_shard.n_sp
    assert p_single.n_ldpc == p_shard.n_ldpc
    assert p_single.sum_it == p_shard.sum_it
    assert p_single.sum_it2 == p_shard.sum_it2
    assert p_single.min_it == p_shard.min_it
    assert p_single.max_it == p_shard.max_it


def test_sharded_ragged_tail(medium_code):
    """Trials not divisible by (batch x devices) still count exactly."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    mesh = make_trial_mesh()
    # 50 trials, global batch 24 (rounds to 24; shards of 3): all batches
    # scan-chain into ONE dispatch.
    p, _ = run_point_sharded(
        medium_code, key, 0.03, trials=50, batch=24, opts=OPTS, mesh=mesh
    )
    assert p.n_trials == 50
    p_ref, _ = run_point(medium_code, key, 0.03, trials=50, batch=50, opts=OPTS)
    assert p.n_sp == p_ref.n_sp and p.sum_it == p_ref.sum_it


def test_sharded_point_single_dispatch(medium_code):
    """A sweep point scan-chains its batches on device: one dispatch + one
    scalar fetch per point, not one per batch (the multi-host dispatch
    latency the single-chip runner amortizes, sim/runner.py)."""
    from qkd_ldpc_tpu.parallel.mesh import replicated
    from qkd_ldpc_tpu.parallel.sweep import (
        _dispatch_point_sharded,
        _make_trial_lane,
    )

    mesh = make_trial_mesh()
    code_dev = jax.device_put(medium_code, replicated(mesh))
    key = jax.device_put(jax.random.PRNGKey(5), replicated(mesh))
    lane = _make_trial_lane(16, mesh)
    # 10 batches of 16 trials -> exactly ONE queued chunk (future).
    futures = _dispatch_point_sharded(
        code_dev, key, lane, n_err=3, n_bits=medium_code.n_vars,
        trials=160, batch=16, opts=OPTS, max_batches_per_dispatch=64,
        mesh=mesh,
    )
    assert len(futures) == 1
    # Respect the dispatch cap: 10 batches at cap 4 -> ceil(10/4) = 3.
    futures = _dispatch_point_sharded(
        code_dev, key, lane, n_err=3, n_bits=medium_code.n_vars,
        trials=160, batch=16, opts=OPTS, max_batches_per_dispatch=4,
        mesh=mesh,
    )
    assert len(futures) == 3


def test_trials_generated_per_shard(monkeypatch):
    """The sharded sweep makes each device's trials on that device: the
    k-th select (a custom call on the GPU, which GSPMD cannot partition)
    sees one shard's rows, and the trials equal the unsharded ones."""
    from qkd_ldpc_tpu.channel import keys
    from qkd_ldpc_tpu.parallel.sweep import _trials_per_shard

    mesh = make_trial_mesh()
    n_dev = mesh.devices.size
    seen = []
    real = keys.kth_smallest

    def spy(scores, k):
        seen.append(scores.shape)
        return real(scores, k)

    monkeypatch.setattr(keys, "kth_smallest", spy)
    key = jax.random.PRNGKey(9)
    ids = jnp.arange(4 * n_dev, dtype=jnp.uint32) + 100
    ne = jnp.asarray(5, jnp.int32)
    fn = jax.jit(lambda k, i, e: _trials_per_shard(mesh, k, 64, i, e))
    alice, bob = fn(key, ids, ne)
    assert seen and all(s == (4, 64) for s in seen)
    hlo = fn.lower(key, ids, ne).compile().as_text()
    assert "all-gather" not in hlo
    monkeypatch.setattr(keys, "kth_smallest", real)
    a_ref, b_ref = keys.make_trials_from_ids(key, 64, ids, ne)
    np.testing.assert_array_equal(np.asarray(alice), np.asarray(a_ref))
    np.testing.assert_array_equal(np.asarray(bob), np.asarray(b_ref))


def test_sharded_sweep_pipelined_matches_per_point(medium_code):
    """run_sweep_sharded (pipelined points) returns exactly the per-point
    results of run_point_sharded with the same keys."""
    from qkd_ldpc_tpu.parallel import run_sweep_sharded

    master = jax.random.PRNGKey(777)
    mesh = make_trial_mesh()
    qbers = [0.02, 0.03, 0.04]
    swept = run_sweep_sharded(
        medium_code, master, qbers, trials=40, batch=16, opts=OPTS, mesh=mesh
    )
    assert len(swept) == 3
    for i, (p_sweep, q_sweep) in enumerate(swept):
        key = jax.random.fold_in(master, i)
        p_one, q_one = run_point_sharded(
            medium_code, key, qbers[i], trials=40, batch=16,
            opts=OPTS, mesh=mesh,
        )
        assert q_sweep == q_one
        assert p_sweep == p_one


def test_batch_simulation_mesh_matches_single_device(medium_code):
    """batch_simulation auto-shards over all devices (use_mesh=True, the
    default); results must be bit-identical to the pinned single-device
    path (use_mesh=False)."""
    import dataclasses

    from qkd_ldpc_tpu.config import Config, RQBERParams
    from qkd_ldpc_tpu.sim.runner import SimInput, batch_simulation

    cfg = Config(
        trials_number=30, simulation_seed=7, sum_product_max_iterations=40,
        batch_size=8,
        r_qber_parameters=(RQBERParams(0.99, 0.02, 0.051, 0.015),),
    ).validate()
    si = [SimInput(code=medium_code, matrix_filename="m.alist",
                   qber=[0.02, 0.035, 0.05])]
    res_mesh = batch_simulation(si, cfg, progress=False)
    res_single = batch_simulation(
        si, dataclasses.replace(cfg, use_mesh=False), progress=False
    )
    assert len(res_mesh) == 3
    for a, b in zip(res_mesh, res_single):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_sharded_int32_stats_guard(medium_code):
    """The sharded paths refuse batch x max_iter^2 combinations that would
    silently wrap the int32 Σ iters² (same guard as the single-chip
    runner's safe_batches bound)."""
    mesh = make_trial_mesh()
    opts = DecodeOptions(max_iterations=100_000)
    with pytest.raises(ValueError, match="overflows the int32"):
        run_point_sharded(
            medium_code, jax.random.PRNGKey(0), 0.03, trials=8,
            batch=8 * 215, opts=opts, mesh=mesh,
        )
