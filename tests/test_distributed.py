"""Real multi-process jax.distributed tests on the CPU backend.

Coordinated processes (gloo collectives over localhost), each with
several virtual CPU devices, form a global 8-device ``trial`` mesh and
run the sharded Monte-Carlo sweep.  Results must be bit-identical across
ranks AND to the plain single-process runner — the framework's
determinism contract extends across process boundaries (the multi-host
analog of the reference's thread-schedule independence,
``src/simulation.cpp:222-247``).

Tested process topologies: 2 processes x 4 devices and 4 processes x 2
devices — the same 8-device mesh factored differently, standing in for
"multi-host pod slice" (SURVEY.md §7 step 6) without a cluster.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from qkd_ldpc_tpu.codes import make_code
from qkd_ldpc_tpu.decoder import DecodeOptions
from qkd_ldpc_tpu.sim.runner import run_point

_WORKER = r"""
import os, sys
port, pid, nproc, local = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={local}"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)
assert jax.device_count() == nproc * local and jax.local_device_count() == local
from qkd_ldpc_tpu.codes import make_code
from qkd_ldpc_tpu.decoder import DecodeOptions
from qkd_ldpc_tpu.parallel import make_trial_mesh, run_point_sharded
code = make_code(n=256, m=131, dv=3, seed=1)
p, q = run_point_sharded(code, jax.random.PRNGKey(777), 0.03, trials=64,
                         batch=32, opts=DecodeOptions(max_iterations=40),
                         mesh=make_trial_mesh())
print(f"RESULT {p.n_trials} {p.n_sp} {p.n_ldpc} {p.sum_it} {p.sum_it2} "
      f"{p.min_it} {p.max_it}", flush=True)
"""


def _run_distributed(n_procs: int, local_devices: int) -> list[list[str]]:
    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(port), str(i),
             str(n_procs), str(local_devices)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for i in range(n_procs)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    results = []
    for i, (out, err) in enumerate(outs):
        assert procs[i].returncode == 0, f"proc {i} failed:\n{err[-2000:]}"
        line = [l for l in out.splitlines() if l.startswith("RESULT")]
        assert line, out
        results.append(line[0].split()[1:])
    return results


def _expected_partials() -> list[str]:
    import jax

    code = make_code(n=256, m=131, dv=3, seed=1)
    p, _ = run_point(code, jax.random.PRNGKey(777), 0.03, trials=64, batch=64,
                     opts=DecodeOptions(max_iterations=40))
    return [str(x) for x in
            (p.n_trials, p.n_sp, p.n_ldpc, p.sum_it, p.sum_it2,
             p.min_it, p.max_it)]


@pytest.mark.slow
def test_two_process_distributed_sweep_matches_single():
    results = _run_distributed(2, 4)
    assert results[0] == results[1], "ranks disagree"
    assert results[0] == _expected_partials(), results[0]


@pytest.mark.slow
def test_four_process_distributed_sweep_matches_single():
    """Same 8-device mesh factored as 4 hosts x 2 devices: the chunk-scan
    dispatch and the make_array_from_callback shard construction must
    hold up when most shards are remote to each rank."""
    results = _run_distributed(4, 2)
    for r in results[1:]:
        assert r == results[0], "ranks disagree"
    assert results[0] == _expected_partials(), results[0]


@pytest.mark.slow
def test_two_process_cli_writes_one_artifact_set(tmp_path):
    """Round 3: the CLI itself is rank-aware — a 2-process CLI-driven
    sweep writes exactly ONE CSV and ONE checkpoint set (process 0's),
    with rows identical to a single-process run."""
    import json

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    mats = tmp_path / "m"
    mats.mkdir()
    code = make_code(n=256, m=131, dv=3, seed=1)
    from qkd_ldpc_tpu.codes import write_alist

    write_alist(code, mats / "code.txt")
    cfg = dict(
        threads_number=1, trials_number=32, use_config_simulation_seed=True,
        simulation_seed=7, interactive_mode=False,
        sum_product_max_iterations=30, use_dense_matrices=False,
        enable_sum_product_msg_llr_threshold=True,
        sum_product_msg_llr_threshold=100.0,
        trace_qkd_ldpc=False, trace_sum_product=False,
        trace_sum_product_llr=False,
        code_rate_QBER_parameters=[dict(code_rate=0.6, QBER_begin=0.03,
                                        QBER_end=0.05, QBER_step=0.01)],
    )

    def run_cli(tag, n_procs, extra):
        d = tmp_path / tag
        d.mkdir()
        c = dict(cfg, checkpoint_dir=str(d / "ckpt"), results_dir=str(d / "res"))
        cp = d / "config.json"
        cp.write_text(json.dumps(c))
        env = {
            **os.environ, "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "PYTHONPATH": str(Path(__file__).resolve().parent.parent),
            "QKD_LDPC_NO_COMPILE_CACHE": "1",
        }
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "qkd_ldpc_tpu", "--config", str(cp),
                 "--matrix-dir", str(mats), "--no-progress", *extra(i)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env,
            )
            for i in range(n_procs)
        ]
        outs = [p.communicate(timeout=240) for p in procs]
        for i, (out, err) in enumerate(outs):
            assert procs[i].returncode == 0, f"{tag} proc {i}:\n{err[-2000:]}"
        return d

    single = run_cli("single", 1, lambda i: [])
    multi = run_cli(
        "multi", 2,
        lambda i: ["--coordinator", f"localhost:{port}",
                   "--num-processes", "2", "--process-id", str(i)],
    )

    s_csv = sorted((single / "res").glob("*.csv"))
    m_csv = sorted((multi / "res").glob("*.csv"))
    assert len(s_csv) == 1 and len(m_csv) == 1  # exactly one CSV set
    assert s_csv[0].read_text() == m_csv[0].read_text()
    s_ck = sorted((single / "ckpt").glob("*.jsonl"))
    m_ck = sorted((multi / "ckpt").glob("*.jsonl"))
    assert len(s_ck) == 1 and len(m_ck) == 1  # only process 0 wrote one
    assert s_ck[0].read_text() == m_ck[0].read_text()


def test_package_import_does_not_initialize_backend():
    """jax.distributed.initialize() must run before ANY backend init, so
    importing the package (as the rank-aware CLI does) must not create
    device arrays.  Regression: a module-level ``jnp.int32`` constant in
    parallel/qc_node_sharded.py initialized the CPU backend at import
    and broke every multi-process CLI bring-up (round 4)."""
    script = (
        "import qkd_ldpc_tpu, qkd_ldpc_tpu.cli, qkd_ldpc_tpu.parallel\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, list(xla_bridge._backends)\n"
        "print('clean')\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]
