"""Fixed-seed decoder regression pins (no reference mount required).

The statistical parity evidence lives in PARITY.md (5000
trials/point) and tests/test_parity.py (needs the reference alist).  A
clone without /root/reference still needs a cheap guard that catches
decoder drift: these tests pin the EXACT per-point iteration statistics
of the *generated* flagship-profile code (same 666x5/4565x6 degree
histogram as the reference's shipped alist) for fixed seeds at three
QBER points on the CPU backend.

Any change to the decoder's numerics (update order, clip placement,
leave-one-out formulation, PRNG derivation) shows up here as an exact
mismatch, without Monte-Carlo statistics.  If an *intentional* numeric
change shifts these values, re-pin them and re-run the statistical
parity sweep (tests/parity_sweep.py) to show the FER curves still match
BASELINE.md.
"""

import jax
import pytest

from qkd_ldpc_tpu.decoder.bp import DecodeOptions
from qkd_ldpc_tpu.sim.runner import run_point

OPTS = DecodeOptions(max_iterations=100, clip_messages=True, message_threshold=100.0)

# (point index, QBER) -> exact partials (n_sp, n_ldpc, sum_it, sum_it2,
# min_it, max_it) for 8 trials with master seed 777 on the CPU backend.
PINS = [
    (4, 0.03, (8, 8, 33, 137, 4, 5)),
    (6, 0.05, (8, 8, 50, 314, 6, 7)),
    (8, 0.07, (8, 8, 98, 1208, 11, 14)),
]


@pytest.fixture(scope="module")
def flagship_code():
    from qkd_ldpc_tpu.codes import make_code

    return make_code(n=10240, m=5231, dv=3, seed=666, name="flagship-n10240")


@pytest.mark.slow
@pytest.mark.parametrize("point,qber,expected", PINS)
def test_pinned_iteration_counts(flagship_code, point, qber, expected):
    key = jax.random.fold_in(jax.random.PRNGKey(777), point)
    p, _ = run_point(flagship_code, key, qber, trials=8, batch=8, opts=OPTS)
    got = (p.n_sp, p.n_ldpc, int(p.sum_it), int(p.sum_it2), p.min_it, p.max_it)
    assert got == expected, (
        f"decoder drift at QBER {qber}: {got} != pinned {expected} — "
        "if intentional, re-pin and re-run tests/parity_sweep.py"
    )
