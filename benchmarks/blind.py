"""Blind reconciliation measured: leakage / rounds / throughput vs QBER
(round 3).

Blind reconciliation (decoder/blind.py) needs no QBER estimate: it
starts all-punctured and reveals punctured bits on failure, so leakage
adapts per frame.  The comparison that justifies it: against
rate-adaptation-with-KNOWN-QBER at equal FER, how much leakage does
blindness cost (and how much throughput do the extra decode rounds
cost)?  Both legs use the same mother code, the same d = p + s = 1024
modulated positions (equal payload l = N - 1024), and the same channel
draws.

Usage (on the GPU): python benchmarks/blind.py [--trials 256]
Findings: benchmarks/blind.md.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ALIST = (
    "/root/reference/alist_sparse_matrices/"
    "(N=10240,M=5231,R=0.49,CW=3,SEED=666).txt"
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=256)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--step", type=int, default=128)
    ap.add_argument("--hint", type=float, default=0.05)
    args = ap.parse_args()

    from qkd_ldpc_tpu.channel.keys import introduce_errors, num_errors_for
    from qkd_ldpc_tpu.codes import make_code, read_alist
    from qkd_ldpc_tpu.decoder import DecodeOptions
    from qkd_ldpc_tpu.decoder.blind import blind_reconcile_sim
    from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter
    from qkd_ldpc_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    code = (read_alist(REFERENCE_ALIST) if os.path.exists(REFERENCE_ALIST)
            else make_code(n=10240, m=5231, dv=3, seed=666)).to_device()
    opts = DecodeOptions(max_iterations=100, message_dtype="bfloat16")
    d, B, M = args.d, args.trials, code.n_checks
    l = code.n_vars - d
    qbers = [0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08]
    # Known-QBER ladder: same payload (p + s = d), decreasing rate.
    ladder = [(p, d - p) for p in (1024, 768, 512, 256, 0)]
    adapters = {
        (p, s): RateAdapter.make(code, n_punctured=p, n_shortened=s, seed=1)
        for p, s in ladder
    }

    print(f"device: {jax.devices()[0]}  {code.name}  d={d} step={args.step} "
          f"hint={args.hint}  trials={B}", file=sys.stderr)
    print(f"{'QBER':>6} | {'blind: FER':>10} {'rounds':>7} {'leak':>7} "
          f"{'Mb/s':>7} | {'known: (p,s)':>12} {'FER':>6} {'leak':>6} "
          f"{'Mb/s':>7} | {'leak ratio':>10}")

    for q in qbers:
        n_err = num_errors_for(l, q)
        kk = jax.random.fold_in(jax.random.PRNGKey(777), int(q * 1e4))
        alice = jax.random.bernoulli(kk, 0.5, (B, l)).astype(jnp.uint8)
        bob = introduce_errors(jax.random.fold_in(kk, 1), alice, n_err)

        # --- blind leg (timed end-to-end; warm once for compile at the
        # TIMED batch shape) ------------------------------------------
        blind_reconcile_sim(code, alice, bob, n_punctured=d,
                            qber_hint=args.hint, opts=opts,
                            reveal_step=args.step, seed=2)
        t0 = time.perf_counter()
        res, km = blind_reconcile_sim(
            code, alice, bob, n_punctured=d, qber_hint=args.hint,
            opts=opts, reveal_step=args.step, seed=2,
        )
        bt = time.perf_counter() - t0
        b_fer = 1 - km.mean()
        b_leak = float(res.leak_bits.mean())
        b_rate = B * l / bt / 1e6

        # --- known-QBER leg: highest-rate ladder rung with FER == 0 ----
        best = None
        for (p, s) in ladder:
            ad = adapters[(p, s)]
            fr = ad.build_frames(alice, jax.random.fold_in(kk, 2))
            syn = ad.syndromes(fr)
            ad.reconcile(bob, syn, n_err / l, opts=opts)  # warm/compile
            t0 = time.perf_counter()
            kh, it, ok = ad.reconcile(bob, syn, n_err / l, opts=opts)
            at = time.perf_counter() - t0
            good = np.asarray(ok) & np.all(
                np.asarray(kh) == np.asarray(alice), axis=1
            )
            fer = 1 - good.mean()
            if fer == 0.0:
                best = (p, s, fer, M - p, B * l / at / 1e6)
                break
        if best is None:
            best = (0, d, fer, M, B * l / at / 1e6)
        p, s, k_fer, k_leak, k_rate = best

        print(f"{q:6.3f} | {b_fer:10.3f} {res.rounds.mean():7.2f} "
              f"{b_leak:7.0f} {b_rate:7.1f} | ({p:>4},{s:>4}) "
              f"{k_fer:6.3f} {k_leak:6.0f} {k_rate:7.1f} | "
              f"{b_leak / k_leak:10.3f}")


if __name__ == "__main__":
    main()
