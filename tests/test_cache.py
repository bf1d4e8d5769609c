"""Where the package keeps its caches: the XLA compile cache follows
JAX_COMPILATION_CACHE_DIR when it is set and is `<checkout>/.cache/xla`
otherwise; host-built tables live in `<checkout>/.cache`."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_PROBE = (
    "import akari_render, jax;"
    "print(jax.config.jax_compilation_cache_dir or '');"
    "print(akari_render.cache_dir())"
)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "AKR_CACHE_DIR")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    # a set AKR_CACHE_DIR must not move any cache
    env["AKR_CACHE_DIR"] = str(tmp_path / "ignored")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120, check=True)
    xla_dir, tables = r.stdout.strip().splitlines()
    expect = tmp_path / env_dir if env_dir else REPO / ".cache" / "xla"
    assert Path(xla_dir) == expect
    assert Path(tables) == REPO / ".cache"
