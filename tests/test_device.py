"""Accelerator set-up: the compile-cache location, and the refusal of the
CLI and the benchmark to fall back to the CPU without being asked."""
import os
import subprocess
import sys
import types

import jax
import pytest

from tlab_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert device.enable_compile_cache() == "/some/cache"
    # JAX read the variable itself; nothing else was set
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_repo_path(monkeypatch,
                                                   cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = device.enable_compile_cache()
    assert first == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    assert device.enable_compile_cache() == first


def test_require_gpu_refuses_cpu(monkeypatch):
    cpu = types.SimpleNamespace(platform="cpu", device_kind="cpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [cpu])
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def _env_without_platform():
    """No platform named and no GPU visible: JAX falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_cli_without_gpu_needs_cpu_flag(tmp_path):
    ini = os.path.join(REPO, "tests", "data", "case01_small.ini")
    cmd = [sys.executable, "-m", "tlab_tpu.tools.cli", "inigrid",
           "--ini", ini, "--outdir", str(tmp_path)]
    r = subprocess.run(cmd, cwd=REPO, env=_env_without_platform(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no GPU" in r.stderr
    r = subprocess.run(cmd + ["--cpu"], cwd=REPO,
                       env=_env_without_platform(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert os.path.exists(tmp_path / "grid")


def test_bench_without_gpu_exits_nonzero():
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no GPU" in r.stderr
    assert r.stdout.strip() == ""
