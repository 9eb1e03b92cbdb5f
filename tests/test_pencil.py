"""Explicit shard_map pencil engine: decomposition invariance vs 1 device.

The transpose-engine analog of the reference's valid/mpi programs: the same
RK step through explicit all-to-all pencil gathers must match the
single-device step to round-off.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tlab_tpu.dycore import incompressible as dyn
from tlab_tpu.dycore.state import State
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.parallel import make_mesh, field_sharding
from tlab_tpu.parallel.mesh import scalar_field_sharding
from tlab_tpu.parallel import pencil
from tlab_tpu.physics.params import NSParams


def _setup(nx=32, ny=24, nz=16):
    grid = uniform_grid(nx, ny, nz, 2 * np.pi, np.pi, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=100.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    state = State(u=jnp.asarray(rng.standard_normal((nx, ny, nz))),
                  v=jnp.asarray(rng.standard_normal((nx, ny, nz))),
                  w=jnp.asarray(rng.standard_normal((nx, ny, nz))),
                  s=jnp.asarray(rng.standard_normal((1, nx, ny, nz))))
    return P, state


@pytest.mark.parametrize("px,pz", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_pencil_step_matches_single_device(px, pz):
    assert len(jax.devices()) >= 8
    P, state = _setup()
    mesh = make_mesh(px, pz)
    step_p = pencil.make_pencil_step(mesh, P, dyn.rk_step)
    sh = field_sharding(mesh)
    sh4 = scalar_field_sharding(mesh)
    state_sh = State(u=jax.device_put(state.u, sh),
                     v=jax.device_put(state.v, sh),
                     w=jax.device_put(state.w, sh),
                     s=jax.device_put(state.s, sh4))
    out_p = step_p(state_sh, 1e-3)
    out_1 = jax.jit(lambda st: dyn.rk_step(P, st, 1e-3)[0])(state)
    for a, b in zip(out_p, out_1):
        if a is None:
            continue
        err = np.max(np.abs(np.asarray(a) - np.asarray(b)))
        assert err < 1e-12, err


@pytest.mark.parametrize("px,pz", [(4, 2), (2, 4)])
def test_pencil_step_compressible_matches(px, pz):
    """The COMPRESSIBLE core through the explicit pencil engine (the
    [D1;D2] viscous stacks gather/scatter, NSCBC tangential planes and
    Mach drift mesh-global) matches the single-device step to
    round-off."""
    from tlab_tpu.dycore import compressible as comp
    from tlab_tpu.dycore.nscbc import NSCBCSpec
    assert len(jax.devices()) >= 8
    nx, ny, nz = 32, 24, 16
    grid = uniform_grid(nx, ny, nz, 2 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=500.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=jnp.float64,
                               with_elliptic=False)
    P["y_periodic"] = False
    rng = np.random.default_rng(3)
    gamma, mach = 1.4, 0.5

    def f():
        return jnp.asarray(1.0 + 0.05 * rng.standard_normal((nx, ny, nz)))
    U = comp.from_primitive(f(), 0.1 * (f() - 1.0), 0.1 * (f() - 1.0),
                            0.1 * (f() - 1.0), f(), gamma, mach,
                            s=0.5 * f()[None])
    spec = NSCBCSpec(ymin="outflow", ymax="outflow", sigma=0.25,
                     ctan=0.25, p_inf=1.0 / (gamma * mach ** 2))

    def step_fn(Pl, Ul, dtime):
        return comp.rk_step_compressible(Pl, Ul, dtime, gamma, mach,
                                         nsp.visc, 0.7, nscbc=spec,
                                         ly=1.0)
    mesh = make_mesh(px, pz)
    step_p = pencil.make_pencil_step_compressible(mesh, P, step_fn)
    sh = field_sharding(mesh)
    sh4 = scalar_field_sharding(mesh)
    U_sh = comp.CompState(
        rho=jax.device_put(U.rho, sh), rhou=jax.device_put(U.rhou, sh),
        rhov=jax.device_put(U.rhov, sh), rhow=jax.device_put(U.rhow, sh),
        rhoE=jax.device_put(U.rhoE, sh), rhos=jax.device_put(U.rhos, sh4))
    out_p = step_p(U_sh, 1e-4)
    out_1 = jax.jit(lambda Ul: step_fn(P, Ul, 1e-4))(U)
    for a, b in zip(out_p, out_1):
        if a is None:
            continue
        err = np.max(np.abs(np.asarray(a) - np.asarray(b)))
        assert err < 1e-11, err


def test_pencil_poisson_matches():
    from tlab_tpu.ops import elliptic
    P, state = _setup()
    mesh = make_mesh(4, 2)
    # single-device reference
    f = state.u
    p_ref = np.asarray(elliptic.poisson(P["ell"], f))

    px, pz = 4, 2
    ell = dict(P["ell"])
    lam_x = np.asarray(ell["lam_xz"][:, 0])
    nkx = lam_x.shape[0]
    nkx_pad = -(-nkx // (px * pz)) * (px * pz)
    ell["lam_x_pad"] = jnp.asarray(
        np.concatenate([lam_x, np.full(nkx_pad - nkx, 1e6)]))
    ell["nkx_pad"] = nkx_pad
    ell["lam_z"] = jnp.asarray(np.asarray(ell["lam_xz"])[0, :] - lam_x[0])

    from jax.sharding import PartitionSpec as PSpec
    from jax import shard_map
    import functools

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(PSpec("x", None, "z"),),
                       out_specs=PSpec("x", None, "z"), check_vma=False)
    def solve(fl):
        return pencil.pencil_poisson(ell, fl, {"px": px, "pz": pz})

    sh = field_sharding(mesh)
    p_out = np.asarray(jax.jit(solve)(jax.device_put(f, sh)))
    assert np.max(np.abs(p_out - p_ref)) < 1e-11


def test_pencil_wire_precision_option():
    """fp32-on-the-wire: close to exact but not bitwise (reference
    TransposeTypeK=single analog)."""
    P, state = _setup()
    mesh = make_mesh(4, 2)
    step32 = pencil.make_pencil_step(mesh, P, dyn.rk_step,
                                     wire_dtype=jnp.float32)
    sh = field_sharding(mesh)
    sh4 = scalar_field_sharding(mesh)
    state_sh = State(u=jax.device_put(state.u, sh),
                     v=jax.device_put(state.v, sh),
                     w=jax.device_put(state.w, sh),
                     s=jax.device_put(state.s, sh4))
    out32 = step32(state_sh, 1e-3)
    out = jax.jit(lambda st: dyn.rk_step(P, st, 1e-3)[0])(state)
    err = np.max(np.abs(np.asarray(out32.u) - np.asarray(out.u)))
    assert 1e-14 < err < 1e-4, err


def test_pencil_poisson_matmul_dft():
    """The distributed Poisson with matmul-DFT transforms matches the
    jnp.fft path to f32 accuracy on the 8-device mesh."""
    import os
    import functools
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as PSpec
    from tlab_tpu.constants import BC
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.grid import uniform_grid
    from tlab_tpu.ops import elliptic
    from tlab_tpu.parallel import make_mesh, pencil

    px, pz = 4, 2
    mesh = make_mesh(px, pz)
    grid = uniform_grid(32, 17, 16, 2 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    plan = elliptic.build_elliptic_plan(fdm, ibc=BC.NN)
    outs = {}
    rng = np.random.default_rng(0)
    f = jnp.asarray(rng.standard_normal((32, 17, 16)), jnp.float32)
    old = os.environ.get("TLAB_TPU_POISSON_TRANSFORM")
    try:
        for mode in ("fft", "matmul"):
            os.environ["TLAB_TPU_POISSON_TRANSFORM"] = mode
            dev = elliptic.device_elliptic_plan(plan, jnp.float32)
            # augment like make_pencil_step does
            lam_x = np.asarray(dev["lam_xz"][:, 0])
            nkx = lam_x.shape[0]
            nkx_pad = -(-nkx // (px * pz)) * (px * pz)
            dev = dict(dev)
            dev["lam_x_pad"] = jnp.asarray(np.concatenate(
                [lam_x, np.full(nkx_pad - nkx, 1e6, lam_x.dtype)]))
            dev["nkx_pad"] = nkx_pad
            dev["lam_z"] = jnp.asarray(np.asarray(dev["lam_xz"])[0, :]
                                       - lam_x[0])
            comm = {"px": px, "pz": pz, "wire": None}
            sh = NamedSharding(mesh, PSpec("x", None, "z"))
            fd = jax.device_put(f, sh)

            @functools.partial(shard_map, mesh=mesh,
                               in_specs=(PSpec("x", None, "z"),),
                               out_specs=PSpec("x", None, "z"),
                               check_vma=False)
            def solve(fl):
                return pencil.pencil_poisson(dev, fl, comm)

            outs[mode] = np.asarray(jax.jit(solve)(fd))
    finally:
        if old is None:
            os.environ.pop("TLAB_TPU_POISSON_TRANSFORM", None)
        else:
            os.environ["TLAB_TPU_POISSON_TRANSFORM"] = old
    scale = np.abs(outs["fft"]).max()
    assert np.abs(outs["matmul"] - outs["fft"]).max() < 3e-5 * max(scale, 1)


def test_pencil_factorize_matmul_dft():
    """The distributed FACTORIZE Poisson with matmul-DFT transforms (the
    same transform policy as the single-device path) matches the jnp.fft
    path to f32 accuracy on the 8-device mesh, for both p and dpdy."""
    import os
    import functools
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as PSpec
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.grid import uniform_grid
    from tlab_tpu.ops import elliptic_factorize as fac
    from tlab_tpu.parallel import make_mesh, pencil

    px, pz = 4, 2
    mesh = make_mesh(px, pz)
    grid = uniform_grid(32, 17, 16, 2 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    plan = fac.build_factorize_plan(fdm)
    rng = np.random.default_rng(1)
    f = jnp.asarray(rng.standard_normal((32, 17, 16)), jnp.float32)
    outs = {}
    old = os.environ.get("TLAB_TPU_POISSON_TRANSFORM")
    try:
        for mode in ("fft", "matmul"):
            os.environ["TLAB_TPU_POISSON_TRANSFORM"] = mode
            dev = fac.device_factorize_plan(plan, jnp.float32)
            assert (dev.get("dft") is not None) == (mode == "matmul")
            kapt = np.asarray(dev["kappa"])
            nkx = kapt.shape[0]
            nkx_pad = -(-nkx // (px * pz)) * (px * pz)
            dev = dict(dev)
            dev["kappa_pad"] = jnp.asarray(np.concatenate(
                [kapt, np.full((nkx_pad - nkx, kapt.shape[1]), 1e3,
                               kapt.dtype)]))
            dev["nkx_pad"] = nkx_pad
            comm = {"px": px, "pz": pz, "wire": None}
            sh = NamedSharding(mesh, PSpec("x", None, "z"))
            fd = jax.device_put(f, sh)

            @functools.partial(shard_map, mesh=mesh,
                               in_specs=(PSpec("x", None, "z"),),
                               out_specs=(PSpec("x", None, "z"),) * 2,
                               check_vma=False)
            def solve(fl):
                return pencil.pencil_poisson_factorize(dev, fl, comm)

            p, dpdy = jax.jit(solve)(fd)
            outs[mode] = (np.asarray(p), np.asarray(dpdy))
    finally:
        if old is None:
            os.environ.pop("TLAB_TPU_POISSON_TRANSFORM", None)
        else:
            os.environ["TLAB_TPU_POISSON_TRANSFORM"] = old
    for a, b in zip(outs["fft"], outs["matmul"]):
        scale = max(1.0, np.abs(a).max())
        assert np.abs(a - b).max() < 3e-5 * scale
