"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when it is set, the
fixed in-checkout directory otherwise (rtm_tpu/utils/cache.py)."""
import os
import pathlib
import subprocess
import sys

import pytest

from rtm_tpu.utils.cache import CACHE_DIR

ROOT = pathlib.Path(__file__).resolve().parents[1]

# enable the cache, compile one small program, report where the cache is
_PROBE = """
import jax, jax.numpy as jnp
from rtm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.arange(7.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _run(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=str(ROOT))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("variable_set", [True, False])
def test_cache_directory(tmp_path, variable_set):
    if variable_set:
        where = tmp_path / "jax_cache"
        assert _run(where) == str(where)
        assert where.is_dir() and any(where.iterdir())
    else:
        assert _run(None) == str(CACHE_DIR)
        assert CACHE_DIR.is_dir() and any(CACHE_DIR.iterdir())
        assert CACHE_DIR.parent == ROOT
