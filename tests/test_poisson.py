"""Poisson/Helmholtz solver validation (port of the reference's vpoisson)."""
import numpy as np
import jax.numpy as jnp
import pytest

from tlab_tpu.constants import BC
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.ops import elliptic
from tlab_tpu.ops.derivative import der1


def setup(nx=32, ny=48, nz=16, ibc=BC.NN):
    grid = uniform_grid(nx, ny, nz, 2.0, 1.0, 1.5)
    fdm = build_fdm_plan(grid)
    plan = elliptic.build_elliptic_plan(fdm, ibc=ibc)
    dev = elliptic.device_elliptic_plan(plan, dtype=jnp.float64)
    return grid, fdm, plan, dev


def test_eigen_matches_dense():
    """Eigendecomposition path == per-mode dense solve, to round-off."""
    grid, fdm, plan, dev = setup()
    rng = np.random.default_rng(0)
    nx, ny, nz = grid.shape
    f = rng.standard_normal((nx, ny, nz))
    f[:, 0, :] = 0.0
    f[:, -1, :] = 0.0
    f_hat = np.fft.fft(np.fft.rfft(f, axis=0), axis=2)
    u_dense = elliptic.solve_modal_dense(plan, f_hat)
    u_eig = np.asarray(elliptic.solve_modal(dev, jnp.asarray(f_hat)))
    assert np.max(np.abs(u_eig - u_dense)) < 1e-9 * max(1.0, np.max(np.abs(u_dense)))


@pytest.mark.parametrize("ibc", [BC.NN, BC.DD])
def test_poisson_manufactured(ibc):
    """Solve Lap p = f for an analytic p; recover p to truncation accuracy."""
    grid, fdm, plan, dev = setup(nx=48, ny=64, nz=12, ibc=ibc)
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    Z = grid.z.nodes[None, None, :]
    kx = 2 * np.pi / grid.x.scale
    kz = 2 * np.pi / grid.z.scale
    if ibc == BC.NN:
        fy = np.cos(np.pi * Y)         # p_y = 0 at y = 0, 1
        fyy = -np.pi ** 2 * np.cos(np.pi * Y)
    else:
        fy = np.sin(np.pi * Y)         # p = 0 at y = 0, 1
        fyy = -np.pi ** 2 * np.sin(np.pi * Y)
    p_exact = np.cos(kx * X) * fy * np.cos(kz * Z)
    f = (-(kx ** 2) - kz ** 2) * p_exact + np.cos(kx * X) * fyy * np.cos(kz * Z)
    p = np.array(elliptic.poisson(dev, jnp.asarray(f)))
    if ibc == BC.NN:
        p -= p.mean()
        p_exact = p_exact - p_exact.mean()
    err = np.max(np.abs(p - p_exact))
    assert err < 5e-5, err


def test_poisson_discrete_residual():
    """The modal equations are enforced: applying the discrete horizontal
    Laplacian (modified wavenumbers) + compact vertical relation recovers f
    on the interior rows to near round-off."""
    grid, fdm, plan, dev = setup(nx=32, ny=40, nz=8)
    rng = np.random.default_rng(1)
    nx, ny, nz = grid.shape
    f = rng.standard_normal((nx, ny, nz))
    f[:, 0, :] = 0.0
    f[:, -1, :] = 0.0
    p = np.asarray(elliptic.poisson(dev, jnp.asarray(f)))
    # verify per-mode: (B2 - lam A2) p_hat = A2 f_hat on interior rows
    p_hat = np.fft.fft(np.fft.rfft(p, axis=0), axis=2)
    f_hat = np.fft.fft(np.fft.rfft(f, axis=0), axis=2)
    M0, M1, R = plan.M0, plan.M1, plan.R
    lam = plan.lam_x[:, None] + plan.lam_z[None, :]
    res = np.einsum("ab,kbz->kaz", M0, p_hat) \
        - lam[:, None, :] * np.einsum("ab,kbz->kaz", M1, p_hat) \
        - np.einsum("ab,kbz->kaz", R, f_hat)
    res[0, :, 0] = 0.0                       # singular mode solved separately
    resmax = np.max(np.abs(res[:, 1:-1, :]))
    assert resmax < 1e-8, resmax


def test_poisson_neumann_bc_values():
    """Nonzero Neumann bc: dp/dy at walls equals the prescribed field."""
    grid, fdm, plan, dev = setup(nx=32, ny=64, nz=1)
    nx, ny, nz = grid.shape
    X = grid.x.nodes[:, None]
    kx = 2 * np.pi / grid.x.scale
    bcs_b = 0.3 * np.cos(kx * X) * np.ones((1, nz))
    bcs_t = -0.2 * np.sin(kx * X) * np.ones((1, nz))
    f = np.zeros((nx, ny, nz))
    p, dpdy = elliptic.poisson(dev, jnp.asarray(f), bcs_b=jnp.asarray(bcs_b),
                               bcs_t=jnp.asarray(bcs_t),
                               d1y=jnp.asarray(fdm.y.d1[BC.DD]))
    dpdy = np.asarray(dpdy)
    assert np.max(np.abs(dpdy[:, 0, :] - bcs_b)) < 2e-4
    assert np.max(np.abs(dpdy[:, -1, :] - bcs_t)) < 2e-4


def test_helmholtz_manufactured():
    grid, fdm, plan, dev = setup(nx=48, ny=64, nz=1, ibc=BC.DD)
    alpha = -37.0
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    kx = 2 * np.pi / grid.x.scale
    a_exact = np.sin(kx * X) * np.sin(2 * np.pi * Y) * np.ones((1, 1, 1))
    f = (-(kx ** 2) - (2 * np.pi) ** 2 + alpha) * a_exact
    a = np.asarray(elliptic.helmholtz(dev, jnp.asarray(f), alpha))
    err = np.max(np.abs(a - a_exact))
    assert err < 5e-5, err


def test_poisson_nonuniform_y():
    """Stretched vertical grid: the pencil switches to the direct compact
    system; manufactured solution recovered at high order."""
    import numpy as np
    from tlab_tpu.grid import make_axis, Grid
    from tlab_tpu.fdm.plan import build_fdm_plan
    nx, ny, nz = 48, 80, 1
    s = np.linspace(0.0, 1.0, ny)
    y_nodes = s + 0.15 * np.sin(np.pi * s)        # nonuniform
    grid = Grid(make_axis(np.arange(nx) * (2.0 / nx), True),
                make_axis(y_nodes, False),
                make_axis(np.zeros(1), False))
    fdm = build_fdm_plan(grid)
    assert not fdm.y.uniform
    plan = elliptic.build_elliptic_plan(fdm, ibc=BC.NN)
    dev = elliptic.device_elliptic_plan(plan, dtype=jnp.float64)
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    kx = 2 * np.pi / grid.x.scale
    p_exact = np.cos(kx * X) * np.cos(np.pi * Y) * np.ones((nx, ny, nz))
    f = (-(kx ** 2) - np.pi ** 2) * p_exact
    p = np.array(elliptic.poisson(dev, jnp.asarray(f)))
    p -= p.mean()
    pe = p_exact - p_exact.mean()
    err = np.max(np.abs(p - pe))
    assert err < 2e-4, err


def test_direct_schemes_convergence():
    """Direct nonuniform compact D2: ~5th-6th order on a stretched grid."""
    import numpy as np
    from tlab_tpu.fdm.schemes import build_2der_direct_system, \
        build_1der_direct_system

    def err2(n):
        s = np.linspace(0.0, 1.0, n)
        x = s + 0.15 * np.sin(np.pi * s)
        A, B = build_2der_direct_system(x)
        u = np.sin(2 * np.pi * x)
        d2 = np.linalg.solve(A, B @ u)
        return np.max(np.abs(d2 + (2 * np.pi) ** 2 * np.sin(2 * np.pi * x)))

    e1, e2 = err2(48), err2(96)
    assert np.log2(e1 / e2) > 2.5, (e1, e2)   # global: 3rd-order bc rows
    assert e2 < 5e-2

    def err1(n):
        s = np.linspace(0.0, 1.0, n)
        x = s + 0.15 * np.sin(np.pi * s)
        A, B = build_1der_direct_system(x)
        u = np.sin(2 * np.pi * x)
        d1 = np.linalg.solve(A, B @ u)
        return np.max(np.abs(d1 - 2 * np.pi * np.cos(2 * np.pi * x)))

    e1, e2 = err1(48), err1(96)
    assert np.log2(e1 / e2) > 3.5, (e1, e2)
    assert e2 < 1e-4


def test_matmul_dft_transform_path():
    """The DFT-as-matmul transform path (TLAB_TPU_POISSON_TRANSFORM=matmul)
    agrees with the XLA-FFT path to f32 roundoff."""
    import os
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.grid import uniform_grid

    grid = uniform_grid(32, 33, 16, 2 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    plan = elliptic.build_elliptic_plan(fdm, ibc=BC.NN)
    old = os.environ.get("TLAB_TPU_POISSON_TRANSFORM")
    try:
        os.environ["TLAB_TPU_POISSON_TRANSFORM"] = "matmul"
        dev_mm = elliptic.device_elliptic_plan(plan, jnp.float32)
        assert "dft" in dev_mm
        os.environ["TLAB_TPU_POISSON_TRANSFORM"] = "fft"
        dev_fft = elliptic.device_elliptic_plan(plan, jnp.float32)
        assert "dft" not in dev_fft
    finally:
        if old is None:
            os.environ.pop("TLAB_TPU_POISSON_TRANSFORM", None)
        else:
            os.environ["TLAB_TPU_POISSON_TRANSFORM"] = old
    rng = np.random.default_rng(0)
    f = jnp.asarray(rng.standard_normal((32, 33, 16)), jnp.float32)
    p1 = elliptic.poisson(dev_mm, f)
    p2 = elliptic.poisson(dev_fft, f)
    scale = float(jnp.max(jnp.abs(p2)))
    assert float(jnp.max(jnp.abs(p1 - p2))) < 2e-5 * max(scale, 1.0)
