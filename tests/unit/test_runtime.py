"""The one compile-cache decision (utils/runtime.py): JAX_COMPILATION_CACHE_DIR
wins when set; otherwise the fixed in-checkout path."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
_PROBE = (
    "import jax, jax.numpy as jnp\n"
    "from cloudvectordb_tpu.utils.runtime import enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
)


def _probe(env_cache):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_cache)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("use_env", [True, False])
def test_compile_cache_location(tmp_path, use_env):
    from cloudvectordb_tpu.utils.runtime import DEFAULT_CACHE_DIR

    if use_env:
        cache = tmp_path / "cache"
        assert _probe(cache) == str(cache)
        assert any(cache.iterdir()), "the compile landed in the env dir"
    else:
        before = (set(DEFAULT_CACHE_DIR.iterdir())
                  if DEFAULT_CACHE_DIR.exists() else set())
        assert _probe(None) == str(DEFAULT_CACHE_DIR)
        assert DEFAULT_CACHE_DIR == REPO / ".jax_cache"
        assert DEFAULT_CACHE_DIR.exists() and (
            set(DEFAULT_CACHE_DIR.iterdir()) - before or before)
