"""Smoke test of the reconciliation pipeline on the GPU.

    python chip_smoke.py           # one card: five phases, see below
    python chip_smoke.py --four    # four cards: the two mesh paths only

One card, in order; any failure exits non-zero:

1. device: JAX must run on a GPU (no CPU fallback); prints the card's
   name and power limit, the JAX versions, XLA_FLAGS and the compile cache;
2. kernels: the hand-written k-th-smallest kernel (channel.pallas_select)
   compiled at the sweep's width and compared bit for bit with its XLA
   reference, then the ``gpu``-marked tests (``pytest -m gpu``);
3. Monte-Carlo sweep through ``qkd_ldpc_tpu.cli.main`` on the committed
   N=10240 flagship alist (sum-product, bf16, auto batch, mesh on): FER
   and mean iterations at QBER 0.05 and 0.085 within 3 sigma of
   benchmarks/parity_generated.md, then one short point each for
   min-sum, the layered schedule on a generated z=512 QC code, and
   continuation batching (whose rows must equal the plain runner's);
4. served and secure path: ``Reconciler.reconcile_secure`` on the z=512
   QC code, four requests of 128 frames; every verified frame's key
   equals ``privacy_amplify`` of Alice's frame;
5. oracle parity: 8 flagship frames decoded in f32 on the card against
   the float64 host oracle (decoder/oracle.py).

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import math
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(
    ROOT, "data", "alist_sparse_matrices",
    "(N=10240,M=5231,R=0.49,CW=3,GEN=666).alist",
)
# benchmarks/parity_generated.md, 5000 trials per point, f32 sum-product:
# QBER -> (FER, mean iterations of successful frames).
PARITY_TABLE = {0.05: (0.0, 6.56), 0.085: (0.2156, 41.84)}
PARITY_TRIALS = 5000


def log(*args) -> None:
    print(*args, flush=True)


def phase(name: str) -> None:
    log(f"\n=== {name}")


# --------------------------------------------------------------- phase 1


def phase_device(n_devices: int):
    import jax
    import jaxlib

    phase("1. device")
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX runs on {dev.platform!r}, not on a GPU; "
            "this script measures nothing elsewhere"
        )
    if len(devs) < n_devices:
        raise SystemExit(
            f"chip_smoke: needs {n_devices} GPUs, JAX sees {len(devs)}"
        )
    from qkd_ldpc_tpu.utils import card_identity, enable_compilation_cache

    cache = enable_compilation_cache()
    log(f"card: {card_identity()}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; devices: "
        f"{len(devs)} x {dev.device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache: "
        f"{cache}")
    return dev


# --------------------------------------------------------------- phase 2


def phase_kernels(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qkd_ldpc_tpu.channel.keys import _kth_smallest, kth_threshold_impl
    from qkd_ldpc_tpu.channel.pallas_select import kth_smallest_kernel

    phase("2. kernels")
    B, N = 512, 10240  # the sweep's trial batch x frame width
    assert kth_threshold_impl((B, N), 0) == "kernel"
    rng = np.random.default_rng(0)
    scores = jnp.asarray(rng.integers(0, 2**32, (B, N), dtype=np.uint32))
    k0 = jnp.asarray(512, jnp.int32)
    compiled = jax.jit(kth_smallest_kernel).lower(scores, k0).compile()
    log(f"kth_smallest [{B}, {N}] memory_analysis: "
        f"{compiled.memory_analysis()}")
    reference = jax.jit(_kth_smallest)
    for k in (1, 2, N // 2, N - 1, N):
        kk = jnp.asarray(k, jnp.int32)
        got, want = np.asarray(compiled(scores, kk)), np.asarray(
            reference(scores, kk))
        if not np.array_equal(got, want):
            raise AssertionError(f"kth kernel != XLA search at k={k}")
    log(f"kth_smallest kernel == XLA search, bit for bit, k in "
        f"{{1, 2, N/2, N-1, N}} at [{B}, {N}]")

    import pytest

    env_before = dict(os.environ)
    os.environ["QKD_LDPC_TEST_GPU"] = "1"
    try:
        rc = pytest.main([
            os.path.join(ROOT, "tests", "test_gpu.py"), "-m", "gpu", "-q",
            "-p", "no:cacheprovider", "-p", "no:randomly",
            f"--junitxml={os.path.join(out_dir, 'gpu_tests.xml')}",
        ])
    finally:
        os.environ.clear()
        os.environ.update(env_before)
    if rc != 0:
        raise AssertionError(f"pytest -m gpu failed (exit {rc})")
    log("pytest -m gpu: passed")


# --------------------------------------------------------------- phase 3


def _write_config(path: str, **overrides) -> str:
    cfg = dict(
        threads_number=1, trials_number=PARITY_TRIALS,
        use_config_simulation_seed=True, simulation_seed=777,
        interactive_mode=False, sum_product_max_iterations=100,
        use_dense_matrices=False, trace_qkd_ldpc=False,
        trace_sum_product=False, trace_sum_product_llr=False,
        enable_sum_product_msg_llr_threshold=True,
        sum_product_msg_llr_threshold=100.0,
        decoder="sum-product", dtype="bfloat16", batch_size=0,
        use_mesh=True, checkpoint_dir="",
        code_rate_QBER_parameters=[dict(
            code_rate=0.58, QBER_begin=0.05, QBER_end=0.12, QBER_step=0.035,
        )],
    )
    cfg.update(overrides)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def _cli_sweep(tag: str, out_dir: str, matrix_dir: str, extra=(),
               **cfg) -> tuple[list[dict], float]:
    """One in-process CLI sweep; returns (CSV rows, wall seconds)."""
    from qkd_ldpc_tpu import cli

    d = os.path.join(out_dir, tag)
    os.makedirs(d, exist_ok=True)
    conf = _write_config(os.path.join(d, "config.json"), **cfg)
    t0 = time.perf_counter()
    rc = cli.main(["--config", conf, "--matrix-dir", matrix_dir,
                   "--results-dir", os.path.join(d, "results"),
                   "--no-progress", *extra])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main sweep {tag!r} exited {rc}")
    paths = glob.glob(os.path.join(d, "results", "*.csv"))
    if len(paths) != 1:
        raise AssertionError(f"{tag}: expected one CSV, found {paths}")
    with open(paths[0], newline="") as f:
        rows = list(csv.DictReader(f, delimiter=";"))
    if not rows:
        raise AssertionError(f"{tag}: CSV has no rows")
    for r in rows:
        log(f"  {tag}: QBER {r['QBER']} FER {r['FER']} mean iters "
            f"{r['ITERATIONS_SUCCESSFUL_SP_MEAN']} "
            f"(sd {r['ITERATIONS_SUCCESSFUL_SP_STD_DEV']}, "
            f"{r['ITERATIONS_SUCCESSFUL_SP_MIN']}-"
            f"{r['ITERATIONS_SUCCESSFUL_SP_MAX']})")
    log(f"  {tag}: {wall:.1f} s wall, compilation included")
    return rows, wall


def _check_parity(row: dict, trials: int) -> str:
    """FER and mean iterations within 3 sigma of the parity table."""
    q = round(float(row["QBER"]), 3)
    fer_ref, it_ref = PARITY_TABLE[q]
    fer = float(row["FER"])
    # Two-proportion z-test with the pooled FER.
    pool = (fer * trials + fer_ref * PARITY_TRIALS) / (trials + PARITY_TRIALS)
    s_fer = math.sqrt(pool * (1 - pool) * (1 / trials + 1 / PARITY_TRIALS))
    if abs(fer - fer_ref) > 3 * s_fer + 1e-12:
        raise AssertionError(
            f"QBER {q}: FER {fer} vs table {fer_ref} (3 sigma {3 * s_fer:.4g})")
    # The table has no spread; use this run's for both samples.
    it, sd = float(row["ITERATIONS_SUCCESSFUL_SP_MEAN"]), float(
        row["ITERATIONS_SUCCESSFUL_SP_STD_DEV"])
    n_ok, n_ref = trials * (1 - fer), PARITY_TRIALS * (1 - fer_ref)
    s_it = sd * math.sqrt(1 / n_ok + 1 / n_ref)
    if abs(it - it_ref) > 3 * s_it:
        raise AssertionError(
            f"QBER {q}: mean iterations {it} vs table {it_ref} "
            f"(3 sigma {3 * s_it:.4g})")
    return (f"QBER {q}: FER {fer:.4f} vs {fer_ref} (3 sigma "
            f"{3 * s_fer:.4f}); mean iters {it:.3f} vs {it_ref} (3 sigma "
            f"{3 * s_it:.3f})")


def _trace_summary(trace_dir: str) -> str:
    """Busy share of the GPU compute stream over the traced window, and
    the per-iteration time of the decode loop: the early-exit
    ``while_loop`` copies its predicate to the host once per iteration,
    so the median gap between device-to-host copies is one iteration."""
    import jax
    import numpy as np

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = jax.profiler.ProfileData.from_file(paths[0])
    best = None
    for plane in pd.planes:
        if "/device:GPU:0" not in plane.name:
            continue
        for line in plane.lines:
            ev = [(e.name, e.start_ns, e.start_ns + e.duration_ns)
                  for e in line.events]
            if ev and (best is None or len(ev) > len(best)):
                best = ev
    if not best:
        raise AssertionError("trace holds no GPU events")
    iv = sorted((s, e) for _, s, e in best)
    busy, cs, ce = 0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    window = max(e for _, e in iv) - iv[0][0]
    d2h = sorted(s for n, s, _ in best if "D2H" in n or "DtoH" in n)
    per_it = float(np.median(np.diff(d2h))) / 1e3 if len(d2h) > 2 else 0.0
    return (f"{len(best)} device events over {window / 1e6:.1f} ms, busy "
            f"{busy / window:.3f} (idle {1 - busy / window:.3f}); "
            f"{len(d2h)} device-to-host copies, median gap {per_it:.1f} us "
            "(one decode iteration)")


def phase_sweep(out_dir: str) -> None:
    from qkd_ldpc_tpu import cli

    phase("3. Monte-Carlo sweep (qkd_ldpc_tpu.cli.main)")
    rows, _ = _cli_sweep("flagship", out_dir,
                         os.path.dirname(FLAGSHIP))
    if [round(float(r["QBER"]), 3) for r in rows] != [0.05, 0.085]:
        raise AssertionError(f"unexpected QBER points {rows}")
    for r in rows:
        log("  parity " + _check_parity(r, PARITY_TRIALS))

    one_point = [dict(code_rate=0.58, QBER_begin=0.05, QBER_end=0.06,
                      QBER_step=0.01)]
    rows, _ = _cli_sweep("min-sum", out_dir, os.path.dirname(FLAGSHIP),
                         decoder="min-sum", trials_number=1024,
                         code_rate_QBER_parameters=one_point)
    if float(rows[0]["FER"]) > 0.01:
        raise AssertionError(f"min-sum FER {rows[0]['FER']} at QBER 0.05")

    qc_dir = os.path.join(out_dir, "qc_code")
    os.makedirs(qc_dir, exist_ok=True)
    rc = cli.main(["generate", "--n", "10240", "--m", "5120", "--qc", "512",
                   "--seed", "666", "-o", os.path.join(qc_dir, "qc.alist")])
    if rc != 0:
        raise AssertionError(f"cli generate exited {rc}")
    rows, _ = _cli_sweep("layered", out_dir, qc_dir, schedule="layered",
                         trials_number=1024,
                         code_rate_QBER_parameters=[dict(
                             code_rate=0.6, QBER_begin=0.05,
                             QBER_end=0.06, QBER_step=0.01)])
    if float(rows[0]["FER"]) > 0.01:
        raise AssertionError(f"layered FER {rows[0]['FER']} at QBER 0.05")

    # Continuation batching: statistics bit-identical to the plain runner.
    # The plain point runs again, warm, under the profiler.
    waterfall = [dict(code_rate=0.58, QBER_begin=0.085, QBER_end=0.095,
                      QBER_step=0.01)]
    flag_dir = os.path.dirname(FLAGSHIP)
    plain, _ = _cli_sweep("plain-0.085", out_dir, flag_dir,
                          trials_number=1024,
                          code_rate_QBER_parameters=waterfall)
    cont, _ = _cli_sweep("continuation-0.085", out_dir, flag_dir,
                         trials_number=1024, continuation_qber=0.08,
                         code_rate_QBER_parameters=waterfall)
    if cont != plain:
        raise AssertionError(f"continuation rows {cont} != plain {plain}")
    log("  continuation rows == plain rows")
    trace_dir = os.path.join(out_dir, "trace")
    traced, _ = _cli_sweep("traced-0.085", out_dir, flag_dir,
                           ("--profile", trace_dir), trials_number=1024,
                           code_rate_QBER_parameters=waterfall)
    if traced != plain:
        raise AssertionError("traced rerun differs from the plain run")
    log("  decode-loop trace (warm rerun of the plain 0.085 point): "
        + _trace_summary(trace_dir))


# --------------------------------------------------------------- phase 4


def phase_serve() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.codes import make_qc_code
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu.postprocess import privacy_amplify
    from qkd_ldpc_tpu.serve import Reconciler

    phase("4. served and secure path (Reconciler.reconcile_secure)")
    code = make_qc_code(z=512, nb=20, mb=10, dv=3, seed=666)
    rec = Reconciler(code, DecodeOptions(message_dtype="bfloat16"), lanes=128)
    n_err = num_errors_for(code.n_vars, 0.05)
    qber = n_err / code.n_vars
    alice, bob = make_trial_batch(jax.random.PRNGKey(2024), code.n_vars, 512,
                                  jnp.asarray(n_err, jnp.int32))
    alice, bob = np.asarray(alice), np.asarray(bob)
    verified = 0
    for r in range(4):
        a, b = alice[r * 128:(r + 1) * 128], bob[r * 128:(r + 1) * 128]
        tag_key = jax.random.fold_in(jax.random.PRNGKey(7), r)
        pa_key = jax.random.fold_in(jax.random.PRNGKey(8), r)
        t0 = time.perf_counter()
        syn = rec.syndromes(a)
        a_tags = rec.tags(a, tag_key)
        sec = rec.reconcile_secure(b, syn, qber, alice_tags=a_tags,
                                   tag_key=tag_key, pa_key=pa_key)
        dt = time.perf_counter() - t0
        want = np.asarray(privacy_amplify(jnp.asarray(a), pa_key,
                                          sec.final_bits))
        v = sec.verified
        if not np.array_equal(sec.key[v], want[v]):
            raise AssertionError(f"request {r}: amplified keys differ")
        if v.sum() < 127:
            raise AssertionError(f"request {r}: only {v.sum()}/128 verified")
        verified += int(v.sum())
        log(f"  request {r}: {int(v.sum())}/128 verified, {sec.final_bits} "
            f"key bits/frame, mean iters {sec.iterations.mean():.2f}, "
            f"{dt * 1e3:.1f} ms (request {r} {'compiles' if r == 0 else 'warm'})")
    log(f"  {verified}/512 frames verified; every verified key == "
        "privacy_amplify(alice)")


# --------------------------------------------------------------- phase 5


def phase_oracle() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.codes import read_alist
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions, decode
    from qkd_ldpc_tpu.decoder.oracle import oracle_decode
    from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu.decoder.syndrome import syndrome

    phase("5. oracle parity (f32 on the card vs float64 on the host)")
    code = read_alist(FLAGSHIP)
    n_err = num_errors_for(code.n_vars, 0.05)
    alice, bob = make_trial_batch(jax.random.PRNGKey(31), code.n_vars, 8,
                                  jnp.asarray(n_err, jnp.int32))
    llr = apriori_llr(bob, n_err / code.n_vars)
    syn = syndrome(code, alice)
    res = decode(code, llr, syn, DecodeOptions(max_iterations=100))
    bits, its, ok = (np.asarray(res.bits), np.asarray(res.iterations),
                     np.asarray(res.syndromes_match))
    llr64, syn_h = np.asarray(llr, np.float64), np.asarray(syn)
    it_diffs, worst_bits = [], 0
    for t in range(8):
        o = oracle_decode(code, llr64[t], syn_h[t], max_iterations=100)
        if bool(ok[t]) != o.syndromes_match:
            raise AssertionError(f"frame {t}: syndromes_match differs")
        if o.syndromes_match:
            nd = int(np.sum(bits[t] != o.bits))
            worst_bits = max(worst_bits, nd)
            if nd:
                raise AssertionError(f"frame {t}: {nd} bits differ")
        it_diffs.append(abs(int(its[t]) - o.iterations))
    if max(it_diffs) > 1 or sum(d > 0 for d in it_diffs) > 1:
        raise AssertionError(f"iteration differences {it_diffs}")
    log(f"  8 frames: syndromes_match equal, bits equal on {int(ok.sum())} "
        f"converged frames; iteration differences {it_diffs}; worst: "
        f"{max(it_diffs)} iteration(s), {worst_bits} bits")


# ------------------------------------------------------------ --four


def phase_four() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.codes import make_qc_code, read_alist
    from qkd_ldpc_tpu.decoder.bp import DecodeOptions, decode
    from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu.decoder.syndrome import syndrome
    from qkd_ldpc_tpu.parallel import (
        decode_qc_node_sharded, make_mesh, make_trial_mesh, run_point_sharded)
    from qkd_ldpc_tpu.sim.runner import run_point

    devs = jax.devices()[:4]
    phase("four cards: trial-sharded sweep vs one card")
    code = read_alist(FLAGSHIP)
    opts = DecodeOptions(message_dtype="bfloat16")
    mesh = make_trial_mesh(devs)
    trials = 4096
    for qber in (0.05, 0.085):
        key = jax.random.fold_in(jax.random.PRNGKey(777), int(qber * 1000))
        t0 = time.perf_counter()
        p4, q4 = run_point_sharded(code, key, qber, trials=trials, batch=2048,
                                   opts=opts, mesh=mesh)
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        p1, q1 = run_point(code, key, qber, trials=trials, batch=512,
                           opts=opts)
        t1 = time.perf_counter() - t0
        if (p4, q4) != (p1, q1):
            raise AssertionError(f"QBER {qber}: 4-card {p4} != 1-card {p1}")
        log(f"  QBER {qber}: {trials} trials, all seven partials equal "
            f"({p4}); wall 4 cards {t4:.1f} s, 1 card {t1:.1f} s "
            "(compilation included)")

    phase("four cards: QC node-sharded decode (z=512) vs one device")
    qc = make_qc_code(z=512, nb=20, mb=10, dv=3, seed=666)
    mesh_node = make_mesh(n_trial=1, n_node=4, devices=devs)
    # Min-sum is bit-identical by construction on any input; sum-product's
    # distributed leave-one-out rounds differently, so it is held to equal
    # decisions and iterations where every frame converges (QBER 0.05).
    legs = ((DecodeOptions(algorithm="min-sum", message_dtype="bfloat16"),
             (0.05, 0.07)),
            (DecodeOptions(), (0.05,)))
    for o, qbers in legs:
        for qber in qbers:
            n_err = num_errors_for(qc.n_vars, qber)
            alice, bob = make_trial_batch(
                jax.random.PRNGKey(5), qc.n_vars, 128,
                jnp.asarray(n_err, jnp.int32))
            llr = apriori_llr(bob, n_err / qc.n_vars)
            syn = syndrome(qc, alice)
            sharded = decode_qc_node_sharded(qc, llr, syn, o, mesh_node)
            single = decode(qc, llr, syn, o)
            same = [np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
                    zip(sharded, single)]
            if not all(same):
                raise AssertionError(
                    f"{o.algorithm} QBER {qber}: node-sharded decode differs "
                    f"(bits, iterations, verdicts equal: {same})")
            log(f"  {o.algorithm} ({o.message_dtype}) QBER {qber}: "
                "decisions, iterations and verdicts equal on 128 frames "
                f"({int(np.asarray(single.syndromes_match).sum())} converged)")


# ------------------------------------------------------------------ main


_OUT_MARK = ".chip_smoke_output"


def fresh_out_dir(path: str) -> None:
    """Empty ``path`` for this run.  Only a directory this script made
    (it holds the marker file) is cleared; any other non-empty directory
    is refused, so ``--out`` can never delete files it did not write."""
    if os.path.isdir(path) and os.listdir(path):
        if not os.path.isfile(os.path.join(path, _OUT_MARK)):
            raise SystemExit(
                f"chip_smoke: --out {path} is not empty and was not made by "
                "chip_smoke.py; give a new or empty directory")
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    open(os.path.join(path, _OUT_MARK), "w").close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh paths")
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "chip_smoke"),
                    help="directory for CSVs, configs and the trace")
    args = ap.parse_args(argv)

    n = 4 if args.four else 1
    if n == 1:
        # One card: the process sees (and reserves memory on) only the
        # first visible GPU, whatever else the host has.
        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
    dev = phase_device(n)
    fresh_out_dir(args.out)
    if args.four:
        phase_four()
    else:
        phase_kernels(args.out)
        phase_sweep(args.out)
        phase_serve()
        phase_oracle()
    import jax

    log("\nall phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n if args.four else len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
