"""Factorized Poisson solver: accuracy + the round-off divergence-removal
property that makes it the reference's default formulation."""
import numpy as np
import jax.numpy as jnp
import pytest

from tlab_tpu.constants import BC
from tlab_tpu.dycore import incompressible as dyn
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.ops import elliptic_factorize as fac
from tlab_tpu.physics.params import NSParams


def _setup(nx=48, ny=64, nz=12):
    grid = uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5)
    fdm = build_fdm_plan(grid)
    plan = fac.build_factorize_plan(fdm)
    dev = fac.device_factorize_plan(plan, dtype=jnp.float64)
    return grid, fdm, dev


def test_factorize_manufactured():
    grid, fdm, dev = _setup()
    nx, ny, nz = grid.shape
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    Z = grid.z.nodes[None, None, :]
    kx = 2 * np.pi / grid.x.scale
    kz = 2 * np.pi / grid.z.scale
    p_exact = np.cos(kx * X) * np.cos(np.pi * Y) * np.cos(kz * Z)
    f = (-(kx ** 2) - kz ** 2 - np.pi ** 2) * p_exact
    p, dpdy = fac.poisson_factorize(dev, jnp.asarray(f))
    p = np.array(p)
    p -= p.mean()
    pe = p_exact - p_exact.mean()
    err = np.max(np.abs(p - pe))
    assert err < 5e-5, err
    dpdy_exact = -np.pi * np.cos(kx * X) * np.sin(np.pi * Y) * np.cos(kz * Z)
    errd = np.max(np.abs(np.asarray(dpdy) - dpdy_exact))
    assert errd < 5e-4, errd


def test_factorize_roundoff_divergence_removal():
    """THE defining property (reference opr_elliptic.f90:109 comment):
    projecting with the factorized solver and its stage-consistent dpdy
    removes divergence to near round-off in the interior, far below the
    direct solver's truncation-level residual."""
    grid, fdm, dev = _setup(nx=32, ny=48, nz=8)
    nx, ny, nz = grid.shape
    nsp = NSParams(reynolds=100.0, schmidt=())
    bcs = dyn.WallBCs.from_velocity_kind("freeslip", "freeslip", scalar_bcs=())
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((nx, ny, nz)))
    v = jnp.asarray(rng.standard_normal((nx, ny, nz)))
    w = jnp.asarray(rng.standard_normal((nx, ny, nz)))
    v = v.at[:, 0, :].set(0.0).at[:, -1, :].set(0.0)   # no-penetration

    div = dyn.divergence(P, u, v, w)
    # Neumann bc for phi from the wall-normal forcing (v_wall = 0 here)
    p, dpdy = fac.poisson_factorize(dev, div)
    u2 = u - dyn._d1(P, "x", 0, p)
    v2 = v - dpdy
    w2 = w - dyn._d1(P, "z", 2, p)
    div2 = np.asarray(dyn.divergence(P, u2, v2, w2))
    div0 = np.asarray(div)
    # interior rows (boundary rows involve the one-sided closures)
    red = np.max(np.abs(div2[:, 2:-2, :])) / np.max(np.abs(div0))
    assert red < 1e-9, red


def test_factorize_vs_direct_agree():
    """Both formulations solve the same PDE: solutions agree to truncation."""
    from tlab_tpu.ops import elliptic
    grid, fdm, dev = _setup(nx=32, ny=56, nz=1)
    plan_d = elliptic.build_elliptic_plan(fdm, ibc=BC.NN)
    dev_d = elliptic.device_elliptic_plan(plan_d, dtype=jnp.float64)
    nx, ny, nz = grid.shape
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    kx = 2 * np.pi / grid.x.scale
    f = np.cos(kx * X) * np.cos(2 * np.pi * Y) * np.ones((nx, ny, nz))
    p_f, _ = fac.poisson_factorize(dev, jnp.asarray(f))
    p_d = elliptic.poisson(dev_d, jnp.asarray(f))
    a = np.array(p_f)
    b = np.array(p_d)
    a -= a.mean()
    b -= b.mean()
    # the reference-exact ODE2 composition and the direct D2 pencil are
    # different discretizations of the same PDE: agreement to scheme
    # truncation (the old re-derived closure happened to sit at 5e-5)
    assert np.max(np.abs(a - b)) < 2e-4 * np.max(np.abs(b))


def test_materialize_tables_match_inline_build():
    """The tables built once on the device are the ones the solver
    rebuilds inline without them."""
    grid, fdm, dev = _setup(nx=16, ny=24, nz=8)
    f = jnp.asarray(np.random.default_rng(3).standard_normal(grid.shape))
    p1, d1 = fac.poisson_factorize(dev, f,
                                   tables=fac.materialize_tables(dev))
    p2, d2 = fac.poisson_factorize(dev, f)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-12)


@pytest.mark.parametrize("breakage", ["missing_key", "wrong_shape"])
def test_materialize_tables_raises_on_broken_plan(breakage):
    """A plan the tables cannot be built from raises; no silent fallback."""
    grid, fdm, dev = _setup(nx=16, ny=24, nz=8)
    broken = dict(dev)
    if breakage == "missing_key":
        del broken["Wmax"]
        err = KeyError
    else:
        broken["lam_max"] = dev["lam_max"][:-3]
        err = (TypeError, ValueError)
    with pytest.raises(err):
        fac.materialize_tables(broken)
