"""Interactive simulation mode.

Counterpart of ``QKD_LDPC_interactive_simulation`` (reference
``src/simulation.cpp:73-137``): the user picks one matrix file from a
numbered console menu, then one trial runs per QBER sweep point with
per-point prints of the actual QBER, the error count, iterations, and the
reconciliation verdict.
"""

from __future__ import annotations

import builtins
from pathlib import Path
from typing import Sequence

import jax
import numpy as np

from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu.codes import list_matrix_files, load_code
from qkd_ldpc_tpu.config import Config
from qkd_ldpc_tpu.decoder.reconcile import reconcile
from qkd_ldpc_tpu.sim.planner import rate_based_qber_range
from qkd_ldpc_tpu.sim.runner import decode_options_from_config
from qkd_ldpc_tpu.sim.tracing import TraceFlags, traced_reconcile


def select_matrix_file(paths: Sequence[Path], input_fn=None, print_fn=print) -> Path:
    """Numbered console menu (reference ``select_matrix_file``,
    ``src/utils.cpp:50-66``)."""
    if input_fn is None:  # resolve at call time so tests can monkeypatch
        input_fn = builtins.input
    print_fn("Matrix files:")
    for i, p in enumerate(paths):
        print_fn(f"{i + 1}. {p.name}")
    while True:
        try:
            choice = int(input_fn("Select a matrix file: "))
            if 1 <= choice <= len(paths):
                return paths[choice - 1]
        except ValueError:
            pass  # EOFError propagates: closed stdin must not spin forever
        print_fn("Invalid selection. Try again.")


def interactive_simulation(
    cfg: Config, matrix_dir: str | Path, input_fn=None, print_fn=print
) -> None:
    paths = list_matrix_files(matrix_dir)
    if not paths:
        raise FileNotFoundError(f"Matrix folder is empty: {matrix_dir}")
    matrix_path = select_matrix_file(paths, input_fn, print_fn)
    code = load_code(matrix_path, dense=cfg.use_dense_matrices)
    print_fn(f"Matrix H is {'regular' if code.is_regular else 'irregular'}.")

    opts = decode_options_from_config(cfg)
    qber_range = rate_based_qber_range(code.code_rate, cfg.r_qber_parameters)
    master = jax.random.PRNGKey(cfg.simulation_seed)

    for i, qber in enumerate(qber_range):
        print_fn(f"№:{i + 1}")
        n_err = num_errors_for(code.n_vars, qber)
        if n_err == 0:
            raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
        actual_qber = n_err / code.n_vars
        print_fn(f"Actual QBER: {actual_qber}")

        point_key = jax.random.fold_in(master, i)
        alice, bob = make_trial_batch(point_key, code.n_vars, 1, n_err)
        n_diff = int((np.asarray(alice) ^ np.asarray(bob)).sum())
        print_fn(f"Number of errors in a key: {n_diff}")

        flags = TraceFlags.from_config(cfg)
        if flags.any:
            # Traced decode runs on the host f64 oracle — the compiled
            # device path never contains trace prints (SURVEY.md §5).
            ores, okeys = traced_reconcile(
                code,
                np.asarray(alice[0]),
                np.asarray(bob[0]),
                actual_qber,
                max_iterations=opts.max_iterations,
                clip_messages=opts.clip_messages,
                message_threshold=opts.message_threshold,
                flags=flags,
                print_fn=print_fn,
            )
            ok = bool(ores.syndromes_match) and okeys
            iters = ores.iterations
        else:
            res = reconcile(code, alice, bob, actual_qber, opts)
            ok = bool(res.syndromes_match[0]) and bool(res.keys_match[0])
            iters = int(res.iterations[0])
        print_fn(f"Iterations performed: {iters}")
        print_fn(
            "Error reconciliation SUCCESSFUL" if ok else "Error reconciliation FAILED"
        )
        print_fn("")
