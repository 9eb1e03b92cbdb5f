"""Dynamical-core validation: 2-D Taylor-Green decay with free-slip walls.

The TG vortex  u =  sin(kx x) cos(ky y) e^{-nu (kx^2+ky^2) t}
              v = -(kx/ky) cos(kx x) sin(ky y) e^{-nu (kx^2+ky^2) t}
is an exact Navier-Stokes solution; with ky = pi/Ly it satisfies free-slip
walls at y = 0, Ly. Equivalent of the reference's vburgers/vtgvortex valid
programs, exercising the full RK + Burgers + pressure-projection loop.
"""
import numpy as np
import jax
import jax.numpy as jnp

from tlab_tpu.constants import BC
from tlab_tpu.dycore import incompressible as dyn
from tlab_tpu.dycore.state import State
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.physics.params import NSParams


def make_tg_setup(nx=64, ny=65, reynolds=100.0):
    lx, ly = 2.0 * np.pi, np.pi
    grid = uniform_grid(nx, ny, 1, lx, ly, 1.0)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=reynolds, schmidt=())
    bcs = dyn.WallBCs.from_velocity_kind("freeslip", "freeslip", scalar_bcs=())
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=jnp.float64)
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    kx, ky = 1.0, 1.0
    u = np.sin(kx * X) * np.cos(ky * Y) * np.ones((nx, ny, 1))
    v = -(kx / ky) * np.cos(kx * X) * np.sin(ky * Y) * np.ones((nx, ny, 1))
    state = State(u=jnp.asarray(u), v=jnp.asarray(v),
                  w=jnp.zeros_like(jnp.asarray(u)),
                  s=jnp.zeros((0, nx, ny, 1)))
    return grid, nsp, P, state, (kx, ky)


def test_taylor_green_decay():
    grid, nsp, P, state, (kx, ky) = make_tg_setup()
    dt = 2e-3
    nsteps = 50
    step = jax.jit(lambda st: dyn.rk_step(P, st, dt)[0])
    for _ in range(nsteps):
        state = step(state)
    t = dt * nsteps
    decay = np.exp(-nsp.visc * (kx ** 2 + ky ** 2) * t)
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    u_exact = np.sin(kx * X) * np.cos(ky * Y) * decay
    err = np.max(np.abs(np.asarray(state.u) - u_exact))
    assert err < 2e-5, err


def test_divergence_stays_small():
    grid, nsp, P, state, _ = make_tg_setup()
    dt = 2e-3
    step = jax.jit(lambda st: dyn.rk_step(P, st, dt)[0])
    for _ in range(10):
        state = step(state)
    dmin, dmax = dyn.dilatation_minmax(P, state)
    # truncation-level residual: the divergence (D1-based) and the Poisson
    # operator (D2-based) differ at O(h^5); the reference's Case01 log shows
    # the same behavior at the 1e-2..1e-3 level on its coarser grid
    assert max(abs(float(dmin)), abs(float(dmax))) < 1e-4


def test_cfl_helpers():
    grid, nsp, P, state, _ = make_tg_setup()
    cmax = float(dyn.cfl_advective_max(P, state))
    assert cmax > 0
    dt = dyn.next_dt(P, cmax, cfla=1.2, cfld=0.3)
    assert 0 < dt < 1.0


def test_taylor_green_stretched_y():
    """Full dycore on a nonuniform vertical grid (Jacobian-corrected D2 +
    direct-scheme elliptic pencil)."""
    from tlab_tpu.grid import make_axis, Grid
    from tlab_tpu.fdm.plan import build_fdm_plan
    nx, ny = 48, 65
    lx, ly = 2.0 * np.pi, np.pi
    s = np.linspace(0.0, 1.0, ny)
    y_nodes = ly * (s + 0.10 * np.sin(np.pi * s))
    grid = Grid(make_axis(np.arange(nx) * (lx / nx), True),
                make_axis(y_nodes, False),
                make_axis(np.zeros(1), False))
    fdm = build_fdm_plan(grid)
    assert not fdm.y.uniform
    nsp = NSParams(reynolds=100.0, schmidt=())
    bcs = dyn.WallBCs.from_velocity_kind("freeslip", "freeslip", scalar_bcs=())
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=jnp.float64)
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    u = np.sin(X) * np.cos(Y) * np.ones((nx, ny, 1))
    v = -np.cos(X) * np.sin(Y) * np.ones((nx, ny, 1))
    state = State(u=jnp.asarray(u), v=jnp.asarray(v),
                  w=jnp.zeros((nx, ny, 1)), s=jnp.zeros((0, nx, ny, 1)))
    dt = 2e-3
    step = jax.jit(lambda st: dyn.rk_step(P, st, dt)[0])
    for _ in range(50):
        state = step(state)
    decay = np.exp(-nsp.visc * 2.0 * dt * 50)
    u_exact = np.sin(X) * np.cos(Y) * decay
    err = np.max(np.abs(np.asarray(state.u) - u_exact))
    assert err < 5e-4, err


def test_pressure_diagnostic_matches_projection():
    """Offline pressure recovery (FI_PRESSURE_BOUSSINESQ equivalent) agrees
    with the in-loop pressure up to the q/dte forcing split."""
    from tlab_tpu.dycore.pressure import pressure_boussinesq
    grid, nsp, P, state, _ = make_tg_setup()
    p = np.asarray(pressure_boussinesq(P, state))
    assert np.isfinite(p).all()
    # exact pressure for this TG phase (u = sin x cos y):
    # u . grad u = (sin 2x / 2, sin 2y / 2) => p = +1/4 (cos 2x + cos 2y)
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    p_exact = 0.25 * (np.cos(2 * X) + np.cos(2 * Y)) * np.ones(grid.shape)
    pc = p - p.mean()
    pe = p_exact - p_exact.mean()
    assert np.max(np.abs(pc - pe)) < 1e-4


def test_wall_value_enforcement():
    """IC noise deposited on Dirichlet wall rows is cleaned at the first
    step (reference re-imposes BC field values each substep)."""
    import numpy as np
    import jax.numpy as jnp
    from tlab_tpu.grid import uniform_grid
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.physics.params import NSParams
    from tlab_tpu.dycore.state import State

    grid = uniform_grid(16, 33, 8, 2 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=100.0, schmidt=())
    P = dyn.build_device_plans(fdm, nsp, dyn.WallBCs(s=()),
                               dtype=jnp.float64)
    rng = np.random.default_rng(0)
    st = State(u=jnp.asarray(rng.standard_normal((16, 33, 8)) * 0.01),
               v=jnp.asarray(rng.standard_normal((16, 33, 8)) * 0.01),
               w=jnp.asarray(rng.standard_normal((16, 33, 8)) * 0.01),
               s=jnp.zeros((0, 16, 33, 8)))
    assert float(jnp.max(jnp.abs(st.v[:, 0, :]))) > 1e-4
    st1, _ = dyn.rk_step(P, st, 1e-4)
    # no-penetration exact; no-slip u/w rows collapse to their plane mean
    assert float(jnp.max(jnp.abs(st1.v[:, 0, :]))) < 1e-15
    assert float(jnp.std(np.asarray(st1.u[:, 0, :]))) < 1e-15


def test_rk_loop_stacked_matches_rk_step():
    """The driver's dispatch window (rk_loop_stacked: one State<->stack
    conversion per window) is the same arithmetic as stepping rk_step
    twice; XLA forms FMAs differently, so agreement is to a few ulp."""
    import jax.numpy as jnp
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.dycore.state import State
    from tlab_tpu.fdm.plan import build_fdm_plan
    from tlab_tpu.grid import uniform_grid
    from tlab_tpu.physics.params import NSParams

    grid = uniform_grid(32, 24, 16, 2.0, 1.0, 1.0)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=500.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    st = State(u=jnp.asarray(rng.standard_normal(grid.shape)) * 0.01,
               v=jnp.asarray(rng.standard_normal(grid.shape)) * 0.01,
               w=jnp.asarray(rng.standard_normal(grid.shape)) * 0.01,
               s=jnp.asarray(rng.standard_normal((1,) + grid.shape)))
    a, pa = dyn.rk_step(P, dyn.rk_step(P, st, 1e-3)[0], 1e-3)
    b, pb_ = dyn.rk_loop_stacked(P, st, 1e-3, 2)
    for f in ("u", "v", "w", "s"):
        d = np.max(np.abs(np.asarray(getattr(a, f))
                          - np.asarray(getattr(b, f))))
        assert d < 1e-14, (f, d)
    assert np.max(np.abs(np.asarray(pa) - np.asarray(pb_))) < 1e-12


def test_f32_burgers_matches_f64_at_op_precision(monkeypatch):
    """The f32 [D1;D2] Burgers stack at the default operator precision
    (HIGHEST: plain fp32 products; TF32 would leave ~1e-3) against the
    same operator in f64: agreement to fp32 round-off."""
    from tlab_tpu.ops.derivative import op_precision
    monkeypatch.delenv("TLAB_TPU_MATMUL_PRECISION", raising=False)
    assert op_precision(jnp.float32) == jax.lax.Precision.HIGHEST

    grid = uniform_grid(64, 48, 32, 2.0 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=500.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    Z = grid.z.nodes[None, None, :]
    rng = np.random.default_rng(5)
    Q = np.stack([np.sin(k * X) * np.cos(np.pi * Y) * np.cos(2 * Z)
                  + 0.01 * rng.standard_normal(grid.shape)
                  for k in (1, 2, 3, 4)])
    out = {}
    for dt in (jnp.float32, jnp.float64):
        P = dyn.build_device_plans(fdm, nsp, bcs, dtype=dt)
        Qd = jnp.asarray(Q, dt)
        nu = jnp.asarray((P["visc"],) * 3 + P["diff"], dt)[:, None, None,
                                                           None]
        out[dt] = np.asarray(sum(
            dyn._burgers_all(P, name, ax, Qd, Qd[ax], nu)
            for ax, name in enumerate("xyz")), np.float64)
    err = (np.linalg.norm(out[jnp.float32] - out[jnp.float64])
           / np.linalg.norm(out[jnp.float64]))
    assert err < 1e-5, err


def _dot_precisions(jaxpr):
    """precision of every dot_general in a closed jaxpr, nested ones too."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.invars[0].aval.dtype, eqn.params["precision"]))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def test_every_f32_dot_of_the_step_names_its_precision(monkeypatch):
    """No dot of an f32 RK step is left at DEFAULT (TF32 on the GPU):
    wall rows, Burgers, projection and the singular mode all name one."""
    monkeypatch.delenv("TLAB_TPU_MATMUL_PRECISION", raising=False)
    grid = uniform_grid(16, 12, 8, 2.0 * np.pi, 1.0, np.pi)
    fdm = build_fdm_plan(grid)
    nsp = NSParams(reynolds=500.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    P = dyn.build_device_plans(fdm, nsp, bcs, dtype=jnp.float32)
    z = jnp.zeros(grid.shape, jnp.float32)
    st = State(u=z, v=z, w=z, s=z[None])
    dots = _dot_precisions(jax.make_jaxpr(
        lambda s: dyn.rk_step(P, s, 1e-3))(st).jaxpr)
    assert dots
    for dtype, prec in dots:
        assert prec is not None and prec[0] == jax.lax.Precision.HIGHEST, \
            (dtype, prec)
