"""Lagrangian point particles (reference src/particles/*).

JAX-native design: fixed-size SoA arrays (n_part, ...) advanced with the
same low-storage RK scheme as the flow; grid->particle interpolation is a
vectorized trilinear gather (reference FIELD_TO_PARTICLE,
particle_interpolate.f90, which is trilinear with halo exchanges), and
particle->grid scatter uses jnp scatter-add (reference PARTICLE_TO_FIELD).
No migration/sorting is needed on a single address space; the multi-chip
version keeps particles owner-sharded and exchanges via ppermute (round 2).

Particle types (reference particle_vars.f90:8-15):
  tracer:  dx/dt = u(x)
  inertia: dx/dt = v_p;  dv_p/dt = (u(x) - v_p)/St - settling e_y
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class ParticleState(NamedTuple):
    x: jax.Array          # (np, 3) positions
    v: jax.Array          # (np, 3) particle velocities (inertia type; else unused)
    props: jax.Array      # (np, n_props) extra properties
    tags: jax.Array       # (np,) int64 ids


@dataclasses.dataclass(frozen=True)
class ParticleProps:
    type: str = "tracer"   # tracer | inertia | bil_cloud_3 | bil_cloud_4 | tinia
    stokes: float = 0.0
    settling: float = 0.0
    bil_cloud: object = None      # BilCloudParams for the bil_cloud types
    # wall behavior: 'none' (clip) | 'stick' (freeze at the wall) --
    # reference part_bcs, PART_BCS_STICK forced for TINIA_1
    # (particle_procs.f90:67)
    bcs: str = "none"


# ---------------------------------------------------------------------------
# Interpolation grid -> particles (trilinear)
# ---------------------------------------------------------------------------

def _locate_uniform(x, x0, dx, n, periodic):
    xi = (x - x0) / dx
    if periodic:
        xi = jnp.mod(xi, n)
        i0 = jnp.floor(xi).astype(jnp.int32)
        frac = xi - i0
        i1 = jnp.mod(i0 + 1, n)
        i0 = jnp.mod(i0, n)
    else:
        xi = jnp.clip(xi, 0.0, n - 1.000001)
        i0 = jnp.clip(jnp.floor(xi).astype(jnp.int32), 0, n - 2)
        frac = xi - i0
        i1 = i0 + 1
    return i0, i1, frac


def _locate_nonuniform(xp, nodes):
    """Bisection cell search on a nonuniform axis (reference LOCATE_Y)."""
    n = nodes.shape[0]
    i0 = jnp.clip(jnp.searchsorted(nodes, xp, side="right") - 1, 0, n - 2)
    frac = (xp - nodes[i0]) / (nodes[i0 + 1] - nodes[i0])
    return i0, i0 + 1, jnp.clip(frac, 0.0, 1.0)


def make_locator(grid):
    """Returns locate(positions (np,3)) -> indices + weights, closed over
    static grid data."""
    gx, gy, gz = grid.x, grid.y, grid.z
    x_nodes = jnp.asarray(gy.nodes)

    def locate(pos):
        if gx.size > 1:
            dx = gx.nodes[1] - gx.nodes[0]
            i0, i1, fx = _locate_uniform(pos[:, 0], gx.nodes[0], dx,
                                         gx.size, gx.periodic)
        else:
            i0 = i1 = jnp.zeros(pos.shape[0], jnp.int32)
            fx = jnp.zeros(pos.shape[0])
        if gy.uniform and gy.size > 1:
            dy = gy.nodes[1] - gy.nodes[0]
            j0, j1, fy = _locate_uniform(pos[:, 1], gy.nodes[0], dy,
                                         gy.size, False)
        elif gy.size > 1:
            j0, j1, fy = _locate_nonuniform(pos[:, 1], x_nodes)
        else:
            j0 = j1 = jnp.zeros(pos.shape[0], jnp.int32)
            fy = jnp.zeros(pos.shape[0])
        if gz.size > 1:
            dz = gz.nodes[1] - gz.nodes[0]
            k0, k1, fz = _locate_uniform(pos[:, 2], gz.nodes[0], dz,
                                         gz.size, gz.periodic)
        else:
            k0 = k1 = jnp.zeros(pos.shape[0], jnp.int32)
            fz = jnp.zeros(pos.shape[0])
        return (i0, i1, fx), (j0, j1, fy), (k0, k1, fz)

    locate.y_bounds = (float(gy.nodes[0]), float(gy.nodes[-1]))
    return locate


def interpolate_to_particles(field, loc):
    """Trilinear gather of one (nx, ny, nz) field at located particles."""
    (i0, i1, fx), (j0, j1, fy), (k0, k1, fz) = loc
    f = field

    def g(ii, jj, kk):
        return f[ii, jj, kk]

    c000 = g(i0, j0, k0)
    c100 = g(i1, j0, k0)
    c010 = g(i0, j1, k0)
    c110 = g(i1, j1, k0)
    c001 = g(i0, j0, k1)
    c101 = g(i1, j0, k1)
    c011 = g(i0, j1, k1)
    c111 = g(i1, j1, k1)
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def particles_to_field(values, loc, shape):
    """Trilinear scatter-add of per-particle values onto the grid
    (reference PARTICLE_TO_FIELD, particle_to_field.f90)."""
    (i0, i1, fx), (j0, j1, fy), (k0, k1, fz) = loc
    out = jnp.zeros(shape, values.dtype)
    for ii, wx in ((i0, 1 - fx), (i1, fx)):
        for jj, wy in ((j0, 1 - fy), (j1, fy)):
            for kk, wz in ((k0, 1 - fz), (k1, fz)):
                out = out.at[ii, jj, kk].add(values * wx * wy * wz)
    return out


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------

def particle_rhs(props: ParticleProps, pstate: ParticleState, locate,
                 u, v, w):
    """(dx/dt, dv/dt) for the particle ensemble."""
    loc = locate(pstate.x)
    uf = jnp.stack([interpolate_to_particles(u, loc),
                    interpolate_to_particles(v, loc),
                    interpolate_to_particles(w, loc)], axis=1)
    if props.type == "tinia":
        # PART_TYPE_TINIA_1: the reference parses the type and forces
        # stick wall BCs, but its RHS is commented out
        # (rhs_part_1.f90:143-144) -- particles carry zero tendency.
        dx = jnp.zeros_like(pstate.x)
        return dx, jnp.zeros_like(pstate.v)
    if props.type == "tracer" or props.type.startswith("bil_cloud"):
        # bil_cloud droplets advect as tracers; their droplet scalars are
        # integrated separately (bil_cloud.droplet_rhs)
        dx, dv = uf, jnp.zeros_like(pstate.v)
    else:
        # inertia: Stokes drag + settling
        acc = (uf - pstate.v) / max(props.stokes, 1e-30)
        acc = acc.at[:, 1].add(-props.settling)
        dx, dv = pstate.v, acc
    if props.bcs == "stick":
        # stick BC (reference PART_BCS_STICK): particles that reached a
        # y wall stay there permanently
        y = pstate.x[:, 1]
        # y-extent bounds ride on the locate closure's grid; particles
        # are clipped to [y0, y1] by wrap_positions, so equality marks
        # "at the wall"
        at_wall = (y <= locate.y_bounds[0]) | (y >= locate.y_bounds[1]) \
            if hasattr(locate, "y_bounds") else jnp.zeros_like(y, bool)
        dx = jnp.where(at_wall[:, None], 0.0, dx)
        dv = jnp.where(at_wall[:, None], 0.0, dv)
    return dx, dv


def wrap_positions(grid, x):
    """Periodic wrap in x/z, clip in y (reference TIME_SUBSTEP_PARTICLE
    edge handling, time.f90:938-1011)."""
    out = x
    if grid.x.periodic and grid.x.size > 1:
        lx = grid.x.scale
        out = out.at[:, 0].set(jnp.mod(out[:, 0] - grid.x.nodes[0], lx)
                               + grid.x.nodes[0])
    if grid.z.periodic and grid.z.size > 1:
        lz = grid.z.scale
        out = out.at[:, 2].set(jnp.mod(out[:, 2] - grid.z.nodes[0], lz)
                               + grid.z.nodes[0])
    y0, y1 = grid.y.nodes[0], grid.y.nodes[-1]
    out = out.at[:, 1].set(jnp.clip(out[:, 1], y0, y1))
    return out


def init_particles(grid, n_part: int, seed: int = 7,
                   y_profile=None, ymean=None, diam=None,
                   mode: str = "default", scal=None, scal_mean=0.0,
                   scal_delta=1.0, dtype=jnp.float64) -> ParticleState:
    """Particle position ICs (reference inipart, particle_main.f90:198-254):
    default = uniform in x/z, uniform y slab [ymean - diam/2, ymean + diam/2];
    mode='hardcoded' pins all particles to the first node column;
    mode='scalar' rejection-samples the y slab weighted by
    |(s - mean)/delta + 0.5| of the reference scalar field;
    y_profile (our extension) draws y from an arbitrary density."""
    rng = np.random.default_rng(seed)
    lx = grid.x.scale if grid.x.size > 1 else 1.0
    lz = grid.z.scale if grid.z.size > 1 else 1.0
    x0 = grid.x.nodes[0]
    z0 = grid.z.nodes[0] if grid.z.size > 1 else 0.0
    if grid.z.size == 1:
        lz = 0.0                                  # 2-D (particle_main.f90:193)
    ya, yb = grid.y.nodes[0], grid.y.nodes[-1]
    if ymean is None:
        ymean = 0.5 * (ya + yb)
    if diam is None:
        diam = yb - ya
    if mode == "hardcoded":                       # PART_INITYPE_HARDCODED
        x = np.full(n_part, x0)
        z = np.full(n_part, z0)
        y = np.full(n_part, ymean)
    elif mode == "scalar" and scal is not None:   # PART_INITYPE_SCALAR
        s = np.asarray(scal)
        nx, ny, nz = s.shape
        ylo, yhi = ymean - 0.5 * diam, ymean + 0.5 * diam
        jlo = int(np.searchsorted(grid.y.nodes, ylo))
        jhi = max(jlo + 1, int(np.searchsorted(grid.y.nodes, yhi)))
        jhi = min(jhi, ny - 1)
        dy_loc = grid.y.nodes[jhi] - grid.y.nodes[jlo]
        xs, ys, zs = [], [], []
        need = n_part
        while need > 0:
            m = max(2 * need, 1024)
            r = rng.uniform(size=(m, 4))
            i = np.minimum((r[:, 0] * nx).astype(int), nx - 1)
            k = np.minimum((r[:, 2] * nz).astype(int), nz - 1)
            jf = r[:, 1] * (jhi - jlo + 1)
            j = jlo + np.minimum(jf.astype(int), jhi - jlo)
            w = np.abs((s[i, j, k] - scal_mean) / scal_delta + 0.5)
            keep = r[:, 3] <= w
            xs.append(x0 + r[keep, 0] * lx)
            zs.append(z0 + r[keep, 2] * lz)
            ys.append(grid.y.nodes[j[keep]] + (jf[keep] - jf[keep].astype(int)) * dy_loc)
            need = n_part - sum(a.size for a in xs)
        x = np.concatenate(xs)[:n_part]
        y = np.concatenate(ys)[:n_part]
        z = np.concatenate(zs)[:n_part]
    else:
        x = x0 + rng.uniform(0, 1, n_part) * lx
        z = z0 + rng.uniform(0, 1, n_part) * lz
        if y_profile is not None:
            # rejection-free inverse-cdf sampling on the grid
            pdf = np.maximum(y_profile(grid.y.nodes), 0.0)
            cdf = np.cumsum(pdf)
            cdf /= cdf[-1]
            y = np.interp(rng.uniform(0, 1, n_part), cdf, grid.y.nodes)
        else:
            y = ymean + (rng.uniform(0, 1, n_part) - 0.5) * diam
    y = np.clip(y, ya, yb)
    pos = jnp.asarray(np.stack([x, y, z], axis=1), dtype)
    return ParticleState(x=pos, v=jnp.zeros_like(pos),
                         props=jnp.zeros((n_part, 0), dtype),
                         tags=jnp.arange(n_part, dtype=jnp.int64))


def props_from_ini(ini) -> "ParticleProps | None":
    """[Particles] block (reference Particle_Initialize_Parameters,
    particle_procs.f90:25-157): Type=None/Tracer/Inertia/
    BilinearCloudThree/Four/TiniaOne, Parameters=(Stokes, Settling...).
    Returns None when Type is none."""
    t = ini.get("Particles", "Type", "none").lower()
    mapping = {"none": None, "tracer": "tracer", "inertia": "inertia",
               "bilinearcloudthree": "bil_cloud_3",
               "bilinearcloudfour": "bil_cloud_4",
               "tiniaone": "tinia"}
    if t not in mapping:
        raise ValueError(f"[Particles] Type={t!r} unknown")
    typ = mapping[t]
    if typ is None:
        return None
    pars = ini.get_floats("Particles", "Parameters", ())
    stokes = ini.get_float("Parameters", "Stokes",
                           pars[0] if pars else 0.0)
    settling = ini.get_float("Parameters", "Settling",
                             pars[1] if len(pars) > 1 else 0.0)
    # TINIA forces stick wall BCs (particle_procs.f90:67)
    bcs = "stick" if typ == "tinia" else \
        ini.get("Particles", "Bcs", "none").lower()
    props = ParticleProps(type=typ, stokes=stokes, settling=settling,
                          bcs=bcs)
    if typ.startswith("bil_cloud"):
        from tlab_tpu.particles.bil_cloud import BilCloudParams
        # droplet thermo constants = [Thermodynamics] Parameters(1:3)
        # (rhs_part_1.f90 thermo_param); the residence y-levels are
        # vestigial in the current reference (the l_y_lambda/l_y_base
        # assignments are commented out 'to be rewritten',
        # particle_procs.f90:235-240), so they stay at the default 0
        tp = tuple(ini.get_floats("Thermodynamics", "Parameters", ()))[:3]
        tp = tp + (1.0,) * (3 - len(tp))
        props = dataclasses.replace(props, bil_cloud=BilCloudParams(
            thermo=tp, variant=4 if typ.endswith("4") else 3))
    return props


def n_props(props: "ParticleProps") -> int:
    """Extra per-particle property columns for the type (reference
    inb_part: droplet scalars l_q(:,4:5), + residence clocks l_q(:,6:7)
    for bil_cloud_4)."""
    return {"bil_cloud_3": 2, "bil_cloud_4": 4}.get(props.type, 0)
