"""The GPU entry points refuse to run without a GPU, and the compile-cache
helper's choice of directory."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from bundleadjustment_jl_tpu.utils import cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_ok_line(proc):
    return '"ok": true' not in proc.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    if where == "repo":
        cwd = _REPO
    else:
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _run(["chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert _no_ok_line(proc), proc.stdout


def test_bench_refuses_without_gpu():
    proc = _run(["bench.py"], _REPO)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert "metric" not in proc.stdout


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_checkout_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.configure_compile_cache()
    assert got == os.path.join(_REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_cache_dir_independent_of_cwd(monkeypatch, tmp_path,
                                      restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert cache.configure_compile_cache() == os.path.join(
        _REPO, ".jax_cache")
