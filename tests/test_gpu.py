"""Card-only tests: compiled kernels and platform choices on the GPU.

Every test here carries the ``gpu`` marker and the ``gpu_device``
fixture, so it skips on the CPU test mesh; ``python chip_smoke.py`` runs
them on the card (``pytest -m gpu``).  Their CPU counterparts (interpret
mode, dispatch rules) live in tests/test_channel.py and tests/test_qc.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("B,N", [(512, 10240), (64, 32768), (8, 1000),
                                 (3, 100)])
def test_kth_kernel_bit_identical_on_card(gpu_device, B, N):
    """The compiled Triton kernel == the XLA search, bit for bit, for k
    in {1, 2, N/2, N-1, N}, random rows and N not a power of two."""
    from qkd_ldpc_tpu.channel.keys import _kth_smallest
    from qkd_ldpc_tpu.channel.pallas_select import kth_smallest_kernel

    rng = np.random.default_rng(N)
    scores = jnp.asarray(rng.integers(0, 2**32, (B, N), dtype=np.uint32))
    for k in (1, 2, N // 2, N - 1, N):
        kk = jnp.asarray(k, jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(kth_smallest_kernel(scores, kk)),
            np.asarray(jax.jit(_kth_smallest)(scores, kk)))


def test_kth_kernel_ties_and_extremes_on_card(gpu_device):
    from qkd_ldpc_tpu.channel.keys import _kth_smallest
    from qkd_ldpc_tpu.channel.pallas_select import kth_smallest_kernel

    rng = np.random.default_rng(3)
    ties = jnp.asarray(rng.integers(0, 16, (64, 10240), dtype=np.uint32) << 28)
    ext = np.full((2, 1000), 0xFFFFFFFF, np.uint32)
    ext[0, 5], ext[1, :3] = 0, [7, 7, 9]
    for scores, ks in ((ties, (1, 7, 200, 5120, 10240)),
                       (jnp.asarray(ext), (1, 2, 3, 1000))):
        for k in ks:
            kk = jnp.asarray(k, jnp.int32)
            np.testing.assert_array_equal(
                np.asarray(kth_smallest_kernel(scores, kk)),
                np.asarray(_kth_smallest(scores, kk)))


def test_channel_uses_kernel_on_card(gpu_device):
    """On the card the channel's threshold runs the kernel, and the trial
    stream is the same threefry stream as everywhere (exact weights)."""
    from qkd_ldpc_tpu.channel.keys import (
        kth_threshold_impl,
        make_trial_batch,
    )

    assert kth_threshold_impl((512, 10240), 0) == "kernel"
    alice, bob = make_trial_batch(jax.random.PRNGKey(1), 10240, 512,
                                  jnp.asarray(512, jnp.int32))
    flips = (np.asarray(alice) ^ np.asarray(bob)).sum(axis=1)
    np.testing.assert_array_equal(flips, np.full(512, 512))


def test_roll_and_gather_agree_on_card(gpu_device):
    """Gather and roll routing decode a QC code to the same decisions and
    iterations on the card."""
    from qkd_ldpc_tpu.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu.codes import make_qc_code
    from qkd_ldpc_tpu.decoder import DecodeOptions, decode
    from qkd_ldpc_tpu.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu.decoder.syndrome import syndrome

    code = make_qc_code(z=64, nb=20, mb=10, dv=3, seed=3)
    ne = num_errors_for(code.n_vars, 0.06)
    alice, bob = make_trial_batch(jax.random.PRNGKey(4), code.n_vars, 64,
                                  jnp.asarray(ne, jnp.int32))
    llr, syn = apriori_llr(bob, ne / code.n_vars), syndrome(code, alice)
    outs = []
    for routing in ("gather", "roll"):
        r = decode(code, llr, syn, DecodeOptions(
            routing=routing, message_dtype="bfloat16"))
        outs.append((np.asarray(r.bits), np.asarray(r.iterations)))
    for bits, its in outs[1:]:
        np.testing.assert_array_equal(bits, outs[0][0])
        np.testing.assert_array_equal(its, outs[0][1])
