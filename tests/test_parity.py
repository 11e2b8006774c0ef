"""Statistical FER/iteration parity vs the measured reference baseline.

Two tiers:

- Reference-alist tests (skipped without the /root/reference mount):
  a fast two-point subset of the full sweep against BASELINE.md.
- Generated-code tests (ALWAYS run): the same-profile generated flagship
  code against its own committed 5000-trial baseline
  (benchmarks/parity_generated.md), so a standalone clone still has a
  statistical parity guard.  Exact fixed-seed pins live in
  tests/test_regression.py.

tests/parity_sweep.py runs all 15 points; PARITY.md records the full runs.
"""

import os

import jax
import pytest

from qkd_ldpc_tpu.decoder.bp import DecodeOptions
from qkd_ldpc_tpu.sim.runner import run_point
from tests import fixtures

OPTS = DecodeOptions(max_iterations=100, clip_messages=True, message_threshold=100.0)

needs_reference = pytest.mark.skipif(
    not os.path.exists(fixtures.REFERENCE_ALIST), reason="reference data absent"
)


@pytest.fixture(scope="module")
def ref_code():
    from qkd_ldpc_tpu.codes import read_alist

    return read_alist(fixtures.REFERENCE_ALIST)


@pytest.fixture(scope="module")
def gen_code():
    from qkd_ldpc_tpu.codes import make_code

    return make_code(n=10240, m=5231, dv=3, seed=666, name="flagship-n10240")


@needs_reference
def test_plateau_point_qber05(ref_code):
    """QBER 0.05: reference FER 0.00, mean iterations 6.47 +- MC noise."""
    key = jax.random.fold_in(jax.random.PRNGKey(777), 4)
    p, aq = run_point(ref_code, key, 0.05, trials=100, batch=100, opts=OPTS)
    assert aq == pytest.approx(512 / 10240)
    assert p.n_sp == 100 and p.n_ldpc == 100  # FER 0.00
    mean = p.sum_it / p.n_sp
    assert 5.8 <= mean <= 7.2  # ref 6.47
    assert p.min_it >= 4 and p.max_it <= 12  # ref range 5-9


@needs_reference
def test_waterfall_point_qber09(ref_code):
    """QBER 0.09: reference FER 0.99 — deep in the waterfall."""
    key = jax.random.fold_in(jax.random.PRNGKey(777), 11)
    p, _ = run_point(ref_code, key, 0.09, trials=50, batch=50, opts=OPTS)
    assert p.n_sp <= 5  # FER ~0.99


@pytest.mark.slow
def test_generated_plateau_qber05(gen_code):
    """Generated flagship code vs its committed baseline
    (benchmarks/parity_generated.md: FER 0.0000, mean 6.56 at 5000
    trials).  Runs WITHOUT the reference mount."""
    key = jax.random.fold_in(jax.random.PRNGKey(777), 4)
    p, _ = run_point(gen_code, key, 0.05, trials=100, batch=100, opts=OPTS)
    assert p.n_sp == 100 and p.n_ldpc == 100
    mean = p.sum_it / p.n_sp
    assert 5.9 <= mean <= 7.3  # committed 6.56 +- MC noise


@pytest.mark.slow
def test_generated_waterfall_qber09(gen_code):
    """Generated code deep waterfall (committed baseline FER 0.9926)."""
    key = jax.random.fold_in(jax.random.PRNGKey(777), 11)
    p, _ = run_point(gen_code, key, 0.09, trials=50, batch=50, opts=OPTS)
    assert p.n_sp <= 5
