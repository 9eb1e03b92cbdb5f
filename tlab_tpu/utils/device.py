"""Accelerator set-up shared by the CLI, the benchmark and the chip smoke run.

enable_compile_cache() keeps XLA's compiled programs across processes.
require_gpu() and card_line() name the card every measurement runs on.
"""
from __future__ import annotations

import os
import subprocess

import jax

# fixed, repo-local: the cache directory is part of the cache key, so a
# path that moves between runs would never hit
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX has already read it and
    nothing else is set here; otherwise the cache goes to <repo>/.jax_cache.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu() -> dict:
    """The first device as JAX reports it; SystemExit unless it is a GPU."""
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {d.platform} "
                         f"({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def card_line() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
