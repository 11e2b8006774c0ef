"""Multi-process scaling measurement on the CPU backend (no cluster).

Runs the SAME global sweep (fixed total trials) under 1, 2, and 4
coordinated jax.distributed processes on localhost, all forming an
8-device global ``trial`` mesh, and reports wall-clock per configuration.

Caveat: every process shares one host's cores, so
absolute wall-clock does NOT demonstrate speedup — what this measures is
the *overhead* of process decomposition (gloo coordination, per-process
dispatch, make_array_from_callback shard construction) at fixed global
device count.  On real separate devices the compute scales by
construction (trials are embarrassingly parallel) and the communication
is one all-reduce of seven scalars per chunk.

Usage: python benchmarks/scaling.py
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

_WORKER = r"""
import os, sys, time
port, pid, nproc, local = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={local}"
import jax
jax.config.update("jax_platforms", "cpu")
if nproc > 1:
    jax.distributed.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)
from qkd_ldpc_tpu.codes import make_code
from qkd_ldpc_tpu.decoder import DecodeOptions
from qkd_ldpc_tpu.parallel import make_trial_mesh, run_sweep_sharded
code = make_code(n=4096, m=2093, dv=3, seed=1)
opts = DecodeOptions(max_iterations=100)
qbers = [0.02, 0.03, 0.04, 0.05]
# warm-up (compile)
run_sweep_sharded(code, jax.random.PRNGKey(1), [0.03], trials=64, batch=64,
                  opts=opts, mesh=make_trial_mesh())
t0 = time.perf_counter()
res = run_sweep_sharded(code, jax.random.PRNGKey(777), qbers, trials=512,
                        batch=128, opts=opts, mesh=make_trial_mesh())
dt = time.perf_counter() - t0
tot = sum(p.n_trials for p, _ in res)
sig = [(p.n_sp, int(p.sum_it)) for p, _ in res]
print(f"RESULT {dt:.3f} {tot} {sig}", flush=True)
"""


def run_config(n_procs: int, local_devices: int) -> tuple[float, str]:
    with socket.socket() as s:
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
    outs = [p.communicate(timeout=600) for p in procs]
    for i, (out, err) in enumerate(outs):
        assert procs[i].returncode == 0, f"proc {i} failed:\n{err[-3000:]}"
    lines = [l for l in outs[0][0].splitlines() if l.startswith("RESULT")]
    parts = lines[0].split(maxsplit=3)
    return float(parts[1]), parts[3]


def main():
    results = {}
    for n_procs, local in ((1, 8), (2, 4), (4, 2)):
        dt, sig = run_config(n_procs, local)
        results[n_procs] = (dt, sig)
        print(f"{n_procs} process(es) x {local} devices: {dt:.2f}s  stats={sig}")
    sigs = {sig for _, sig in results.values()}
    assert len(sigs) == 1, f"configs disagree on statistics: {sigs}"
    print("all configurations produced BIT-IDENTICAL sweep statistics")


if __name__ == "__main__":
    main()
