"""Full FER/iteration parity sweep vs BASELINE.md (manual tool, not pytest).

Run on any backend (the GPU for speed): ``python tests/parity_sweep.py``.
Produces the PARITY.md table.  Uses the reference alist code when mounted;
otherwise a generated same-profile code (FER curve is then expected to be
close but not identical — it is a different random code of the same
ensemble).
"""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qkd_ldpc_tpu.codes import make_code, read_alist
from qkd_ldpc_tpu.decoder.bp import DecodeOptions
from qkd_ldpc_tpu.sim.runner import run_point
from qkd_ldpc_tpu.sim.stats import finalize_point

REFERENCE_ALIST = (
    "/root/reference/alist_sparse_matrices/"
    "(N=10240,M=5231,R=0.49,CW=3,SEED=666).txt"
)

# BASELINE.md measured reference table: qber -> (FER, mean iters).
BASELINE = {
    0.010: (0.00, 2.27), 0.020: (0.00, 3.08), 0.030: (0.00, 4.03),
    0.040: (0.00, 5.21), 0.050: (0.00, 6.47), 0.060: (0.00, 8.31),
    0.065: (0.00, 9.74), 0.070: (0.00, 11.64), 0.075: (0.00, 14.61),
    0.080: (0.00, 20.58), 0.085: (0.22, 43.10), 0.090: (0.99, 93.00),
    0.095: (1.00, None), 0.100: (1.00, None), 0.105: (1.00, None),
}


def main(trials: int = 1000, batch: int = 250, generated: bool = False,
         dtype: str = "float32", which: str = "",
         alg: str = "sum-product") -> None:
    if which == "qc":
        # Round-3 structured family at matched N and profile (R=0.50 vs
        # the reference's 0.489): benchmarks/qc_parity.md compares this
        # curve against `random-r50` (same rate, unstructured) so rate
        # effects don't confound structure effects.
        from qkd_ldpc_tpu.codes import make_qc_code

        code = make_qc_code(z=512, nb=20, mb=10, dv=3, seed=666)
        print(f"QC code {code}")
    elif which == "qc-ref":
        # Round 4: the QC family at the reference's
        # own rate profile — z=128, nb=80, mb=41 gives N=10240, M=5248,
        # R=0.4875 with mixed degree-5/6 base rows (the closest QC point
        # to the reference alist's R=0.489, 666x5/4565x6 histogram;
        # /root/reference/alist_sparse_matrices header lines 1-4).
        from qkd_ldpc_tpu.codes import make_qc_code

        code = make_qc_code(z=128, nb=80, mb=41, dv=3, seed=666)
        print(f"QC reference-profile code {code}")
    elif which == "random-r50":
        code = make_code(n=10240, m=5120, dv=3, seed=667, name="random-r50")
        print(f"matched-rate random code {code}")
    elif os.path.exists(REFERENCE_ALIST) and not generated:
        code = read_alist(REFERENCE_ALIST)
    else:
        code = make_code(n=10240, m=5231, dv=3, seed=666, name="flagship-n10240")
        print("generated same-profile code (benchmarks/parity_generated.md "
              "pins its curve; a different random code of the same ensemble, "
              "so FER is close to but not identical with the reference's)")
    opts = DecodeOptions(max_iterations=100, clip_messages=True,
                         message_threshold=100.0, message_dtype=dtype,
                         algorithm=alg)
    print(f"{'QBER':>6} {'FER':>6} {'refFER':>7} {'iters':>7} {'refIt':>6} "
          f"{'min-max':>9} {'time':>6}")
    for i, (q, (rf, ri)) in enumerate(BASELINE.items()):
        key = jax.random.fold_in(jax.random.PRNGKey(777), i)
        t0 = time.perf_counter()
        p, aq = run_point(code, key, q, trials, batch, opts)
        dt = time.perf_counter() - t0
        r = finalize_point(
            p, sim_number=i, matrix_filename=code.name, is_regular=False,
            num_bit_nodes=code.n_vars, num_check_nodes=code.n_checks,
            initial_qber=aq, max_iterations=opts.max_iterations,
        )
        print(f"{q:6.3f} {r.fer:6.3f} {rf:7.2f} "
              f"{r.iterations_successful_sp_mean:7.2f} {str(ri):>6} "
              f"{r.iterations_successful_sp_min:>4}-{r.iterations_successful_sp_max:<4} "
              f"{dt:5.1f}s")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=250)
    ap.add_argument("--generated", action="store_true",
                    help="force the generated same-profile code")
    ap.add_argument("--dtype", default="float32",
                    help="message_dtype: float32 | bfloat16 | int8")
    ap.add_argument("--code", default="", dest="which",
                    help="'' (reference/generated) | qc | qc-ref | random-r50")
    ap.add_argument("--alg", default="sum-product",
                    help="sum-product | min-sum")
    a = ap.parse_args()
    main(a.trials, a.batch, a.generated, a.dtype, a.which, a.alg)
