"""Headline benchmark: grid-points/s/card per RK substep on the 3-D shear layer.

    python bench.py

Runs on one GPU and refuses to run without one.  The last line of stdout
is ONE JSON object; every other line goes to stderr.  Every line names the
card and its power limit (nvidia-smi), since a card held below its limit
runs slower under load.  Any failure exits non-zero.

Baseline: the reference's JUWELS strong-scaling table (BASELINE.md) gives
0.49-0.8 M grid-points/s per 48-core CPU node per RK substep (fp64, full
physics-off shear layer, RK4-5).  vs_baseline compares one card against
0.8 M pts/s/node (the reference's best per-node figure, 1536^3 @ 8 nodes).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE = 0.8e6                                # pts/s/node/substep (ref best)
N_SUB = 5                                       # RK4-5 substeps per step


def _timed(fn, *args, reps=2):
    """Best wall time of `reps` calls after a warm-up call (compilation)."""
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _shear_state(grid, dtype, seed):
    """Tanh shear layer + wall-clean noise, one scalar."""
    import jax
    import jax.numpy as jnp
    from tlab_tpu.dycore.state import State
    nx, ny, nz = grid.shape
    ku, kv, kw = jax.random.split(jax.random.PRNGKey(seed), 3)
    y1d = jnp.asarray(grid.y.nodes, dtype)[None, :, None]
    prof = 0.5 * jnp.tanh(-0.5 * (y1d - 0.5) / 0.05)
    env = jnp.sin(jnp.pi * y1d).astype(dtype)

    def noise(k):
        return 0.01 * env * jax.random.normal(k, (nx, ny, nz), dtype)

    return State(u=prof + noise(ku), v=noise(kv), w=noise(kw),
                 s=(0.5 - prof)[None] * jnp.ones((1, nx, ny, nz), dtype))


def _factorize_plans(grid, nsp, bcs, dtype):
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.ops import elliptic_factorize as fac
    fdm = build_fdm_plan(grid)
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=dtype)
    P["ell_fac"] = fac.device_factorize_plan(fac.build_factorize_plan(fdm),
                                             dtype)
    return P


def main():
    import jax
    import jax.numpy as jnp
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.grid import uniform_grid
    from tlab_tpu.ops import elliptic_factorize as fac
    from tlab_tpu.physics.params import NSParams
    from tlab_tpu.utils.device import card_line, enable_compile_cache, \
        require_gpu

    dev = require_gpu()
    card = card_line()
    enable_compile_cache()

    def report(text):
        print(f"bench [{card}]: {text}", file=sys.stderr, flush=True)

    nx, ny, nz = 512, 256, 256
    dtype = jnp.float32
    n_steps = 5
    grid = uniform_grid(nx, ny, nz, 2.0 * np.pi, 1.0, np.pi)
    nsp = NSParams(reynolds=5000.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    P = _factorize_plans(grid, nsp, bcs, dtype)
    tables = fac.materialize_tables(P["ell_fac"])
    state0 = _shear_state(grid, dtype, 0)

    @jax.jit
    def step_n(st, tb):
        return jax.lax.fori_loop(
            0, n_steps, lambda i, s: dyn.rk_step(
                P, s, 5e-4, aux={"fac_tables": tb})[0], st)

    out = step_n(state0, tables)
    if not np.isfinite(float(jnp.sum(out.u))):
        raise SystemExit("bench: non-finite state after the warm-up steps")
    dt_wall = _timed(step_n, state0, tables, reps=3) / n_steps
    npts = nx * ny * nz
    rate = npts / (dt_wall / N_SUB)
    report(f"factorized-Poisson step 512x256x256 fp32: "
           f"{dt_wall * 1e3:.2f} ms/step, {rate:.4e} pts/s/card/substep")

    _bench_extras(grid, nsp, bcs, dtype, state0, report)

    print(json.dumps({
        "metric": "grid-points/s/card per RK substep (512x256x256 shear "
                  "layer, fp32, RK4-5)",
        "value": round(rate, 1),
        "unit": "points/s/card/substep",
        "vs_baseline": round(rate / BASELINE, 3),
        "device": dev,
        "card": card,
    }))


def _bench_extras(grid, nsp, bcs, dtype, state0, report):
    """Secondary cells at the same card: compressible core, dense vs
    banded D1 at N=4096, device-side stats tables, the long-line full
    step, the pencil step on a 1x1 mesh, and the stretched-y SMR91 step."""
    import jax
    import jax.numpy as jnp
    from tlab_tpu.dycore import compressible as comp
    from tlab_tpu.dycore import implicit as impl
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.grid import Grid, make_axis, uniform_grid
    from tlab_tpu.ops.derivative import op_precision
    from tlab_tpu.ops.pallas_thomas import banded_der1, banded_plan
    from tlab_tpu.parallel import pencil as pcl
    from tlab_tpu.parallel.mesh import make_mesh

    nx, ny, nz = grid.shape
    npts = nx * ny * nz
    n_steps = 3

    def rate_line(name, seconds, points, n_sub):
        rate = points / (seconds / n_steps / n_sub)
        report(f"{name}: {rate:.4e} pts/s/card/substep "
               f"({rate / BASELINE:.0f}x baseline)")

    # compressible internal-energy core (acoustic CFL, no Poisson)
    Pc = dyn.build_device_plans(build_fdm_plan(grid), nsp, bcs, dtype=dtype,
                                with_elliptic=False)
    one = jnp.ones_like(state0.u)
    U0 = comp.from_primitive(one, state0.u, state0.v, state0.w, one,
                             1.4, 0.3, s=state0.s)

    @jax.jit
    def comp_n(U):
        return jax.lax.fori_loop(
            0, n_steps, lambda i, u: comp.rk_step_compressible(
                Pc, u, 1e-5, 1.4, 0.3, nsp.visc, 0.7, energy="internal"), U)

    rate_line("compressible-internal 512x256x256 fp32 RK4-5",
              _timed(comp_n, U0), npts, 5)

    # dense vs banded D1 on 4096 lines of length 4096
    nl = m = 4096
    A = np.zeros((nl, nl))
    B = np.zeros((nl, nl))
    i = np.arange(nl)
    A[i, i] = 1.0
    A[i[1:], i[:-1]] = A[i[:-1], i[1:]] = 1.0 / 3.0
    for k_, c_ in ((1, 14.0 / 9.0 / 2.0), (2, 1.0 / 9.0 / 4.0)):
        B[i[:-k_], i[:-k_] + k_] = c_
        B[i[k_:], i[k_:] - k_] = -c_
    A[0, 1] = A[-1, -2] = 2.0
    B[0, :3] = [-2.5, 2.0, 0.5]
    B[-1, -3:] = [-0.5, -2.0, 2.5]
    d1m = jnp.asarray(np.linalg.solve(A, B), dtype)
    uu = jnp.asarray(np.random.default_rng(1).standard_normal((m, nl)), dtype)
    prec = op_precision(dtype)
    bp = banded_plan(A, B, dtype)
    reps = 10

    @jax.jit
    def dense_chain(x):
        return jax.lax.fori_loop(0, reps, lambda i, y: jnp.einsum(
            "ab,mb->ma", d1m, y, precision=prec) * 1e-3, x)

    @jax.jit
    def banded_chain(x):
        return jax.lax.fori_loop(
            0, reps, lambda i, y: banded_der1(bp, y, 1) * 1e-3, x)

    for name, fn in (("dense-D1 N=4096", dense_chain),
                     ("banded-D1 N=4096 (partitioned)", banded_chain)):
        t = _timed(fn, uu, reps=1) / reps
        report(f"{name}: {t * 1e3:.3f} ms ({m * nl / t / 1e9:.2f} Gpt/s)")

    # device-side stats tables: the avg flow+scalar tables as ONE jitted
    # stacked computation, fetching (ncols, ny) only
    from types import SimpleNamespace
    from tlab_tpu.stats import averages as avg
    sim_sh = SimpleNamespace(
        case=SimpleNamespace(equations="incompressible"), nsp=nsp,
        P=dyn.build_device_plans(build_fdm_plan(grid), nsp, bcs,
                                 dtype=dtype),
        grid=grid, dtype=dtype)
    fetch = avg.make_stats_tables_fn(sim_sh)
    flow, scals = fetch(state0, state0.u)                    # compile
    t0 = time.perf_counter()
    flow, scals = fetch(state0, state0.u)                    # host dicts
    t = time.perf_counter() - t0
    ncols = len(flow) + sum(len(s) for s in scals)
    report(f"device-side stats tables ({ncols} cols) at 512x256x256: "
           f"{t * 1e3:.1f} ms incl. the single (ncols, ny) fetch")

    # long-line full step: nx=4096 engages the partitioned circulant
    # banded path in the production RK step (thresholds 2304)
    gl = uniform_grid(4096, 192, 64, 16.0 * np.pi, 1.0, np.pi)
    stl = _shear_state(gl, dtype, 2)
    Pl = _factorize_plans(gl, nsp, bcs, dtype)

    @jax.jit
    def long_n(st):
        return jax.lax.fori_loop(
            0, n_steps, lambda i, s_: dyn.rk_step(Pl, s_, 2e-4)[0], st)

    rate_line("long-line 4096x192x64 banded-partitioned full step",
              _timed(long_n, stl), 4096 * 192 * 64, 5)

    # the production shard_map pencil step on a 1x1 mesh, timed per STEP
    # including the host dispatch, window 1 vs 4
    P1 = _factorize_plans(grid, nsp, bcs, dtype)
    n_disp = 3
    for inner in (1, 4):
        pstep = pcl.make_pencil_step(make_mesh(1, 1), P1, dyn.rk_step,
                                     return_p=True, inner_steps=inner)

        def run(st, pstep=pstep):
            for _ in range(n_disp):
                st, _p = pstep(st, 5e-4)
            return st

        per_step = _timed(run, state0) / (n_disp * inner)
        report(f"pencil 1x1 inner_steps={inner}: {per_step * 1e3:.1f} "
               f"ms/step incl. dispatch "
               f"({npts / (per_step / 5):.4e} pts/s/card/substep)")

    # stretched y grid + SMR91 semi-implicit diffusion
    nxs, nys, nzs = 256, 192, 128
    sy = np.linspace(0.0, 1.0, nys)
    ynodes = sy + 0.25 * (1.0 - np.cos(2 * np.pi * sy)) / (2 * np.pi)
    gu = uniform_grid(nxs, nys, nzs, 2.0 * np.pi, 1.0, np.pi)
    gs = Grid(gu.x, make_axis(ynodes, False), gu.z)
    Ps = _factorize_plans(gs, nsp, bcs, dtype)
    z = jnp.zeros((nxs, nys, nzs), dtype)
    sts = state0._replace(
        u=jax.random.normal(jax.random.PRNGKey(1), (nxs, nys, nzs),
                            dtype) * 0.01,
        v=z, w=z, s=jnp.zeros((1, nxs, nys, nzs), dtype))

    @jax.jit
    def impl_n(st):
        return jax.lax.fori_loop(
            0, n_steps,
            lambda i, s_: impl.rk_step_implicit(Ps, s_, 5e-4)[0], st)

    rate_line("stretched-y semi-implicit 256x192x128 fp32 SMR91",
              _timed(impl_n, sts), nxs * nys * nzs, 3)


if __name__ == "__main__":
    main()
