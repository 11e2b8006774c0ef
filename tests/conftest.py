"""Test harness setup: force the CPU backend with a virtual 8-device mesh
BEFORE jax is imported, so sharding tests run without an accelerator.

Tests that need the GPU carry the ``gpu`` marker and request the
``gpu_device`` fixture, which skips them here; ``python chip_smoke.py``
runs them on the card (``pytest -m gpu``)."""

import os

# Unless the card run asks for the GPU (chip_smoke.py sets
# QKD_LDPC_TEST_GPU=1 and runs only the gpu-marked tests), tests run on
# the virtual CPU mesh: force it both through the environment and
# through jax.config after import.
_ON_GPU = os.environ.get("QKD_LDPC_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# No default persistent compile cache inside pytest: in-process CLI tests
# would otherwise enable it for the whole pytest process, and concurrent
# cache writes from parallel workers have produced segfaults inside
# jax's cache-put path.  Subprocess tests set their own environment.
os.environ["QKD_LDPC_NO_COMPILE_CACHE"] = "1"
_flags = os.environ.get("XLA_FLAGS", "")
if not _ON_GPU and "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tests import fixtures  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_executables():
    """Drop jax's in-process executable caches between test modules.

    Every compiled XLA:CPU executable pins JIT code pages for the life
    of the process; across the full suite the accumulated memory
    mappings exceeded the kernel's default vm.max_map_count (65530) at
    ~70% of the run, and the next LLVM mmap failure surfaced as a
    nondeterministic SIGSEGV inside backend_compile_and_load (observed
    five times, always late-run, at varying tests).  Per-module cache
    clearing keeps the map count bounded; modules re-jit their own
    programs anyway.
    """
    yield
    import jax as _jax

    _jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The GPU for ``gpu``-marked tests; skips where JAX finds none.

    Decided here, at run time, never at import or collection: every
    xdist worker must collect the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs the GPU (JAX runs on {dev.platform}); run "
                    "`python chip_smoke.py` on the card")
    return dev


@pytest.fixture(scope="session")
def johnson_code():
    """The 6-bit toy code from Johnson, 'Introducing LDPC Codes', ex. 2.5."""
    from qkd_ldpc_tpu.codes import from_dense

    return from_dense(np.array(fixtures.H_JOHNSON), name="johnson-6")


@pytest.fixture(scope="session")
def hamming_code():
    from qkd_ldpc_tpu.codes import from_dense

    return from_dense(np.array(fixtures.H_HAMMING74), name="hamming-7-4")


@pytest.fixture(scope="session")
def n10_code():
    from qkd_ldpc_tpu.codes import from_dense

    return from_dense(np.array(fixtures.H_N10), name="n10")


@pytest.fixture(scope="session")
def medium_code():
    """A mid-size random irregular code for statistical tests (fast on CPU)."""
    from qkd_ldpc_tpu.codes import make_code

    return make_code(n=512, m=262, dv=3, seed=7, name="n512")
