"""Command-line entry point.

The reference's ``main()`` (``src/main.cpp:15-68``) takes no arguments and
hard-codes every path at compile time; this CLI keeps its behavior (config
JSON -> batch or interactive mode over a matrix directory -> CSV) but makes
paths proper arguments.

Usage:
    python -m qkd_ldpc_tpu --config config.json [--matrix-dir DIR]
                           [--results-dir DIR] [--interactive]
    python -m qkd_ldpc_tpu generate --n 10240 --m 5231 --dv 3 --seed 666 -o out.alist
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from qkd_ldpc_tpu.config import load_config
from qkd_ldpc_tpu.utils import print_error, print_mode, print_status


def _default_matrix_dir(cfg, base: Path) -> Path:
    # Mirrors the reference's directory dispatch (main.cpp:23).
    sub = "dense_matrices" if cfg.use_dense_matrices else "alist_sparse_matrices"
    return base / sub


def main(argv: list[str] | None = None) -> int:
    # allow_abbrev=False: with prefix matching on, the top-level parser
    # claims `generate --n ...` as an ambiguous abbreviation of its own
    # --no-progress / --num-processes before the subcommand sees it.
    parser = argparse.ArgumentParser(
        prog="qkd_ldpc_tpu",
        description="QKD LDPC error-reconciliation simulator",
        allow_abbrev=False,
    )
    sub = parser.add_subparsers(dest="command")

    run = sub.add_parser("run", help="run a simulation sweep (default)")
    for p in (parser, run):
        p.add_argument("--config", default="config.json", help="config JSON path")
        p.add_argument("--matrix-dir", default="", help="matrix directory")
        p.add_argument("--results-dir", default="", help="results directory")
        p.add_argument(
            "--interactive", action="store_true", help="interactive mode"
        )
        p.add_argument("--no-progress", action="store_true")
        p.add_argument(
            "--profile",
            metavar="DIR",
            default="",
            help="capture a jax.profiler device trace of the sweep to DIR "
            "(view with TensorBoard / xprof)",
        )
        # Multi-process (multi-host) bring-up: every process runs the
        # same CLI; only process 0 writes checkpoints/CSV/progress.
        p.add_argument(
            "--coordinator", default="",
            help="jax.distributed coordinator address host:port "
            "(multi-process runs; all processes pass the same value)",
        )
        p.add_argument("--num-processes", type=int, default=0)
        p.add_argument("--process-id", type=int, default=-1)

    gen = sub.add_parser("generate", help="generate a random LDPC code")
    gen.add_argument("--n", type=int, required=True)
    gen.add_argument("--m", type=int, required=True)
    gen.add_argument("--dv", type=int, default=3)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("-o", "--output", required=True)
    gen.add_argument("--dense", action="store_true", help="write dense format")
    gen.add_argument(
        "--qc", type=int, default=0, metavar="Z",
        help="build a girth>=6 quasi-cyclic code with lift size Z "
        "(n, m must be multiples of Z; decodes with roll routing)",
    )

    args = parser.parse_args(argv)

    if args.command == "generate":
        from qkd_ldpc_tpu.codes import (
            make_code,
            make_qc_code,
            write_alist,
            write_dense,
        )

        if args.qc:
            z = args.qc
            if args.n % z or args.m % z:
                print_error(f"ERROR: n and m must be multiples of Z={z}")
                return 1
            code = make_qc_code(z=z, nb=args.n // z, mb=args.m // z,
                                dv=args.dv, seed=args.seed)
        else:
            code = make_code(n=args.n, m=args.m, dv=args.dv, seed=args.seed)
        (write_dense if args.dense else write_alist)(code, args.output)
        print(f"Wrote {code} -> {args.output}")
        return 0

    try:
        from qkd_ldpc_tpu.utils import enable_compilation_cache

        enable_compilation_cache()  # fresh-process sweeps reuse compiles

        if args.coordinator:
            from qkd_ldpc_tpu.parallel.mesh import initialize_distributed

            kw = dict(coordinator_address=args.coordinator)
            if args.num_processes:
                kw["num_processes"] = args.num_processes
            if args.process_id >= 0:
                kw["process_id"] = args.process_id
            initialize_distributed(**kw)

        import jax

        is_coord = jax.process_index() == 0

        cfg = load_config(args.config)
        base = Path(args.config).resolve().parent
        # Paths from the CONFIG FILE resolve against the config's directory
        # (like the reference's SOURCE_DIR-rooted paths, main.cpp:8); paths
        # from CLI flags resolve against the CWD as users expect.
        if args.matrix_dir:
            matrix_dir = Path(args.matrix_dir)
        else:
            matrix_dir = Path(cfg.matrix_dir) if cfg.matrix_dir else _default_matrix_dir(cfg, base)
            if not matrix_dir.is_absolute():
                matrix_dir = base / matrix_dir
        if args.results_dir:
            results_dir = Path(args.results_dir)
        else:
            results_dir = Path(cfg.results_dir)
            if not results_dir.is_absolute():
                results_dir = base / results_dir

        if args.interactive or cfg.interactive_mode:
            print_mode("INTERACTIVE MODE")
            from qkd_ldpc_tpu.sim import interactive_simulation

            interactive_simulation(cfg, matrix_dir)
        else:
            if is_coord:
                print_mode("BATCH MODE")
            import contextlib

            from qkd_ldpc_tpu.sim import simulate_directory, write_results

            profile_ctx = contextlib.nullcontext()
            if args.profile:
                # Device-level tracing stands in for the reference's
                # (absent) profiler hooks — SURVEY.md §5.
                import jax

                profile_ctx = jax.profiler.trace(args.profile)
            with profile_ctx:
                results = simulate_directory(
                    cfg, matrix_dir,
                    progress=not args.no_progress and is_coord,
                )
            # Rank-aware IO: every process computes (collectives demand
            # it), exactly one writes the durable artifacts.
            if is_coord:
                path = write_results(
                    results,
                    results_dir,
                    cfg.trials_number,
                    cfg.sum_product_max_iterations,
                    cfg.simulation_seed,
                )
                print_status(f"The results have been written to: {path}")
    except Exception as e:  # match reference main()'s catch-all exit(1)
        print_error(f"ERROR: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
