"""Test env: 8 simulated devices on the CPU backend (SURVEY.md §4.2).

Must run before any jax import: forces the CPU platform with 8 virtual
devices so all shard_map / pjit distribution tests exercise real collective
lowering without a GPU. The same code runs unchanged on real cards; only
the mesh constructor sees different devices.

Tests marked ``gpu`` need an NVIDIA GPU. The decision is made in a fixture
at run time, never at import: here they skip. On a machine with a card,
run them on the real backend with

    CVDB_TEST_GPU=1 python -m pytest tests -m gpu -q
"""

import os

_ON_CARD = os.environ.get("CVDB_TEST_GPU") == "1"

if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX runs on a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (CVDB_TEST_GPU=1 pytest -m gpu)")


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_jit_accumulation():
    """The full suite once crashed INSIDE an XLA:CPU compile near its end
    (accumulated JIT executables in one long-lived process). Clearing
    JAX's caches per test MODULE bounds the accumulation; modules keep
    their internal compile sharing, so the wall-clock cost is small."""
    yield
    import jax as _jax

    _jax.clear_caches()
