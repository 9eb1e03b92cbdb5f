"""Startup self-test + micro-benchmark (reference OPR_CHECK,
src/operators/opr_check.f90:6-136).

Validates the runtime's operator round-trips on the actual device(s) and
reports timings: derivative consistency, FFT round-trip residual, Poisson
residual. Called by the dns tool at startup; results go to the run log.
"""
from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp


def opr_check(sim) -> dict:
    nx, ny, nz = sim.grid.shape
    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, (nx, ny, nz), sim.dtype)

    out = {}

    # FFT round-trip (reference checks forward+backward transpose/FFT)
    t0 = time.perf_counter()
    u_hat = jnp.fft.rfft(u, axis=0)
    u_back = jnp.fft.irfft(u_hat, n=nx, axis=0)
    jax.block_until_ready(u_back)
    out["fft_roundtrip_residual"] = float(jnp.max(jnp.abs(u_back - u)))
    out["fft_time_s"] = time.perf_counter() - t0

    # matmul-DFT round-trip (the alternative f32 transform, ops/rdft.py)
    if sim.grid.x.periodic and nx % 2 == 0:
        from tlab_tpu.ops import rdft
        t0 = time.perf_counter()
        plan = rdft.device_rdft_plan(nx, nz, sim.dtype)
        re, im = rdft.forward_parts(plan, u)
        back = rdft.backward_parts(plan, re, im)
        jax.block_until_ready(back)
        out["rdft_roundtrip_residual"] = float(jnp.max(jnp.abs(back - u)))
        out["rdft_time_s"] = time.perf_counter() - t0

    # derivative of a linear function is exact
    X = jnp.asarray(sim.grid.x.nodes, sim.dtype)[:, None, None]
    from tlab_tpu.dycore import incompressible as dyn
    if sim.grid.x.periodic:
        k0 = 2 * np.pi / sim.grid.x.scale
        f = jnp.sin(k0 * X) * jnp.ones((nx, ny, nz), sim.dtype)
        df = dyn._d1(sim.P, "x", 0, f)
        ref = k0 * jnp.cos(k0 * X)
        out["d1x_mode1_error"] = float(jnp.max(jnp.abs(df - ref)))

    # Poisson residual on a smooth manufactured field
    t0 = time.perf_counter()
    from tlab_tpu.ops import elliptic
    Y = jnp.asarray(sim.grid.y.nodes, sim.dtype)[None, :, None]
    ly = sim.grid.y.scale
    p_exact = jnp.cos(2 * np.pi * X / sim.grid.x.scale) * jnp.cos(np.pi * Y / ly)
    lap = (-(2 * np.pi / sim.grid.x.scale) ** 2 - (np.pi / ly) ** 2) * p_exact
    p = elliptic.poisson(sim.P["ell"], lap * jnp.ones((nx, ny, nz), sim.dtype))
    jax.block_until_ready(p)
    out["poisson_time_s"] = time.perf_counter() - t0
    pm = p - jnp.mean(p)
    pe = p_exact - jnp.mean(p_exact)
    out["poisson_error"] = float(jnp.max(jnp.abs(pm - pe)))
    return out


def format_report(results: dict) -> str:
    lines = ["# OPR_CHECK startup self-test"]
    for k, v in results.items():
        lines.append(f"#   {k}: {v:.6e}" if isinstance(v, float)
                     else f"#   {k}: {v}")
    return "\n".join(lines)


def transpose_check(mesh, shape, dtype=jnp.float32, n_rep: int = 3):
    """Multi-device all-to-all round-trip check + micro-benchmark, the
    pencil analog of the reference's startup transpose test
    (opr_check.f90:46-100): forward+backward gather/scatter along x and
    z under shard_map, reporting max residual, wall time and an
    aggregate bandwidth estimate.

    shape is the GLOBAL (nx, ny, nz); fields are sharded P('x', None,
    'z') on the ('x','z') mesh."""
    import functools
    from jax.sharding import NamedSharding, PartitionSpec as PSpec
    from jax import shard_map
    from tlab_tpu.parallel import pencil

    nx, ny, nz = shape
    key = jax.random.PRNGKey(1)
    a = jax.random.normal(key, shape, dtype)
    sh = NamedSharding(mesh, PSpec("x", None, "z"))
    a = jax.device_put(a, sh)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=PSpec("x", None, "z"),
                       out_specs=PSpec("x", None, "z"))
    def roundtrip(blk):
        gx = pencil.gather_x(blk)
        bx = pencil.scatter_x(gx)
        gz = pencil.gather_z(bx)
        return pencil.scatter_z(gz)

    out = {}
    r = roundtrip(a)
    jax.block_until_ready(r)
    out["transpose_roundtrip_residual"] = float(jnp.max(jnp.abs(r - a)))
    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        r = roundtrip(a)
        jax.block_until_ready(r)
        best = min(best, time.perf_counter() - t0)
    out["transpose_roundtrip_time_s"] = best
    # 4 all-to-alls, each moving ~the full field (P-1)/P of bytes twice
    # (send+receive); report the aggregate moved volume per second
    nbytes = np.prod(shape) * np.dtype(jnp.dtype(dtype)).itemsize
    ndev = len(mesh.devices.flat)
    moved = 4 * nbytes * (ndev - 1) / ndev * 2
    out["transpose_bandwidth_GBps"] = moved / best / 1e9
    out["mesh"] = f"{mesh.devices.shape[0]}x{mesh.devices.shape[1]}"
    out["shape"] = tuple(int(s) for s in shape)
    return out
