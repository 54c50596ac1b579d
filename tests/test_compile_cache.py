"""Placement of the persistent XLA compile cache, which the package sets
when it is imported (so each case runs in a fresh interpreter)."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROBE = "import jax, genestrip_tpu; print(jax.config.jax_compilation_cache_dir)"


def _cache_dir(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_env_var_is_honoured(tmp_path):
    # JAX reads the variable itself; the package must not override it
    assert _cache_dir(str(tmp_path / "xla")) == str(tmp_path / "xla")


def test_default_is_fixed_path_in_checkout():
    assert _cache_dir(None) == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
