"""Immersed boundary method, direct-forcing v1 (reference src/ibm/*).

Geometry is a solid mask eps(x,y,z) in {0,1} built from generators
(xbars/box/hill families, reference ibm_generate_geometry*.f90). The state
is forced in solids after each RK substep (reference dns_main.f90:254-257);
the reference's cubic-spline fill of solid regions before derivatives
(ibm_spline.f90) is the round-2 refinement -- direct forcing alone is a
consistent first-order IBM.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def geometry_xbars(grid, nbars: int, height: int, width: int,
                   mirrored: bool = False) -> np.ndarray:
    """Streamwise-aligned square bars on the bottom wall, spanwise-periodic
    (reference ibm_generate_geometry_xbars); mirrored=True repeats the
    bars on the upper wall (ibm_generate_geometry_xbars.f90:124-136,
    [IBMParameter] Mirrored=yes)."""
    nx, ny, nz = grid.shape
    eps = np.zeros((nx, ny, nz), dtype=np.float64)
    if nz == 1:
        return eps
    period = nz // max(nbars, 1)
    for b in range(nbars):
        k0 = b * period
        eps[:, :height, k0:k0 + width] = 1.0
        if mirrored:
            eps[:, ny - height:, k0:k0 + width] = 1.0
    return eps


def geometry_box(grid, i0, i1, j0, j1, k0, k1) -> np.ndarray:
    nx, ny, nz = grid.shape
    eps = np.zeros((nx, ny, nz), dtype=np.float64)
    eps[i0:i1, j0:j1, k0:k1] = 1.0
    return eps


def geometry_hill(grid, height: float, width: float, center: float) -> np.ndarray:
    """Smooth 2-D hill on the bottom wall: y < h exp(-((x-c)/w)^2)."""
    nx, ny, nz = grid.shape
    X = grid.x.nodes[:, None, None]
    Y = grid.y.nodes[None, :, None]
    surface = height * np.exp(-(((X - center) / width) ** 2))
    return (Y < surface).astype(np.float64) * np.ones((nx, ny, nz))


def geometry_valley(grid, height_pts: int, slope: int = 1) -> np.ndarray:
    """Cosine valley/hill profile on the bottom wall (reference
    ibm_generate_geometry_valley.f90:  solid where
    j < (h/2^s)(1 + cos(2 pi x / Lx))^s)."""
    nx, ny, nz = grid.shape
    eps = np.zeros((nx, ny, nz), bool)
    dx = 2.0 * np.pi / nx
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    prof = (height_pts / 2 ** slope) * (1.0 + np.cos(dx * i)) ** slope
    eps2d = j < prof
    eps[:] = eps2d[:, :, None]
    return eps


def build_spline_fill(eps: np.ndarray, axis: int, nodes: np.ndarray,
                      periodic: bool = False, scale: float = None,
                      wall_values=(0.0, 0.0)):
    """Per-direction solid-region fill (reference IBM_SPLINE_XYZ,
    src/ibm/ibm_spline.f90): before taking derivatives along `axis`, solid
    points are replaced by a cubic Lagrange interpolant through the two
    fluid points on each side of the interval.

    Special cases matching the reference's interval taxonomy
    (ibm_spline.f90:155-260):
    - PERIODIC axis: a solid run touching the line's edge takes its
      support from the opposite end with wrapped abscissae (cases 2/5).
    - NON-periodic axis: a solid run touching the wall anchors the
      interpolant at the wall coordinate with the prescribed wall value
      (case 3: zero for velocity, ibmscaljmin/jmax for scalars); the
      anchor value enters through the additive `const` array.

    Returns (idx, w, const): filled = where(solid,
        sum_m w[..., m] * u[gather idx[..., m]] + const, u).
    """
    shape = eps.shape
    n = shape[axis]
    idx = np.zeros(shape + (4,), dtype=np.int32)
    w = np.zeros(shape + (4,))
    const = np.zeros(shape)
    solid = eps > 0.5
    if scale is None and periodic:
        scale = nodes[-1] - nodes[0] + (nodes[1] - nodes[0])

    lines = np.moveaxis(solid, axis, -1).reshape(-1, n)
    idx_l = np.moveaxis(idx, axis, -2).reshape(-1, n, 4)
    w_l = np.moveaxis(w, axis, -2).reshape(-1, n, 4)
    c_l = np.moveaxis(const, axis, -1).reshape(-1, n)
    for li in range(lines.shape[0]):
        s = lines[li]
        if not s.any():
            continue
        fluid = np.where(~s)[0]
        i = 0
        while i < n:
            if not s[i]:
                i += 1
                continue
            j = i
            while j < n and s[j]:
                j += 1
            # solid run [i, j); support = up to 2 fluid points per side,
            # plus wrap (periodic) or wall anchors (non-periodic)
            below = list(fluid[fluid < i][-2:])
            above = list(fluid[fluid >= j][:2])
            sup = below + above
            xs = list(nodes[below]) + list(nodes[above])
            anchors = []                       # (x, value) fixed points
            if not below:
                if periodic and len(fluid) >= 2:
                    wrap = fluid[-2:]
                    sup = list(wrap) + sup
                    xs = [nodes[kf] - scale for kf in wrap] + xs
                elif not periodic:
                    anchors.append((nodes[0], wall_values[0]))
            if not above:
                if periodic and len(fluid) >= 2:
                    wrap = fluid[:2]
                    sup = sup + list(wrap)
                    xs = xs + [nodes[kf] + scale for kf in wrap]
                elif not periodic:
                    anchors.append((nodes[-1], wall_values[1]))
            if not sup and not anchors:
                i = j                           # fully solid line -> 0
                continue
            all_x = xs + [a[0] for a in anchors]
            sup = sup[:4]
            for p in range(i, j):
                xp = nodes[p]
                for a in range(len(all_x)):
                    wa = 1.0
                    for b in range(len(all_x)):
                        if b != a:
                            wa *= (xp - all_x[b]) / (all_x[a] - all_x[b])
                    if a < len(sup):
                        w_l[li, p, a] = wa
                        idx_l[li, p, a] = sup[a]
                    elif a >= len(xs):
                        c_l[li, p] += wa * anchors[a - len(xs)][1]
            i = j
    return idx, w, const


def apply_spline_fill(u, fill, axis: int):
    """filled field: fluid points unchanged, solid points interpolated."""
    idx, w, solid = fill["idx"], fill["w"], fill["solid"]
    parts = fill.get("const", 0.0)
    for m in range(4):
        parts = parts + w[..., m] * jnp.take_along_axis(
            u, idx[..., m], axis=axis)
    return jnp.where(solid, parts, u)


def build_ibm_spline(eps: np.ndarray, grid, dtype=jnp.float64,
                     wall_values=(0.0, 0.0)) -> dict:
    """Fill plans for all three directions (consumed by the Burgers ops
    when ibm mode is 'spline'). wall_values anchors semi-immersed
    intervals on the non-periodic walls (velocity: 0)."""
    fills = {}
    for name, axis, ax in (("x", 0, grid.x), ("y", 1, grid.y),
                           ("z", 2, grid.z)):
        if ax.size == 1:
            continue
        idx, w, const = build_spline_fill(
            eps, axis, ax.nodes, periodic=ax.periodic, scale=ax.scale,
            wall_values=wall_values)
        fills[name] = {"idx": jnp.asarray(idx),
                       "w": jnp.asarray(w, dtype),
                       "const": jnp.asarray(const, dtype),
                       "solid": jnp.asarray(eps > 0.5)}
    return fills


# ---------------------------------------------------------------------------
# Device-local views for the pencil engine: inside shard_map the blocks
# are (nx/Px, ny, nz/Pz) and the x/z Burgers stacks are GATHERED to full
# lines with a further split of the other horizontal axis (parallel/
# pencil.py gather_x/gather_z) -- the global IBM tables must be sliced to
# exactly the coordinates each device holds.  This is the analog of
# the reference running its spline fill on the gathered MPI pencils
# (ibm_spline.f90:30 inside OPR_Burgers, opr_burgers.f90:468).
# ---------------------------------------------------------------------------

def _block_indices(comm):
    from jax import lax
    px = comm.get("px", 1)
    pz = comm.get("pz", 1)
    ix = lax.axis_index("x") if px > 1 else jnp.zeros((), jnp.int32)
    iz = lax.axis_index("z") if pz > 1 else jnp.zeros((), jnp.int32)
    return px, pz, ix, iz


def localize_fill(fill, axis_name: str, comm, gathered: bool) -> dict:
    """Slice a global fill plan to this device's view inside shard_map.

    gathered=True: the layout AFTER the pencil gather along axis_name
    (x: (nx, ny, nz/(Px Pz)); z: (nx/(Px Pz), ny, nz)).
    gathered=False: the plain local block (nx/Px, ny, nz/Pz) -- used for
    the y fill and for an x/z axis whose mesh extent is 1."""
    from jax import lax
    px, pz, ix, iz = _block_indices(comm)
    if px == 1 and pz == 1:
        return fill
    nx, ny, nz = fill["solid"].shape
    zero = jnp.zeros((), jnp.int32)
    if gathered and axis_name == "x":
        chunk = nz // (px * pz)
        x0, xs = zero, nx
        z0, zs = iz * (nz // pz) + ix * chunk, chunk
    elif gathered and axis_name == "z":
        chunk = nx // (px * pz)
        x0, xs = ix * (nx // px) + iz * chunk, chunk
        z0, zs = zero, nz
    else:
        x0, xs = ix * (nx // px), nx // px
        z0, zs = iz * (nz // pz), nz // pz

    def sl(a):
        starts = (x0, zero, z0) + (zero,) * (a.ndim - 3)
        sizes = (xs, ny, zs) + a.shape[3:]
        return lax.dynamic_slice(a, starts, sizes)

    return {k: sl(v) for k, v in fill.items()}


def localize_block(arr, comm):
    """Slice a global (nx, ny, nz) constant to the local block."""
    from jax import lax
    px, pz, ix, iz = _block_indices(comm)
    if px == 1 and pz == 1:
        return arr
    nx, ny, nz = arr.shape
    zero = jnp.zeros((), jnp.int32)
    return lax.dynamic_slice(arr, (ix * (nx // px), zero, iz * (nz // pz)),
                             (nx // px, ny, nz // pz))


def apply_ibm_state(ibm, state, comm=None):
    """Zero velocity and pin scalars inside solids (direct forcing).
    comm: pencil descriptor when called inside shard_map (local blocks)."""
    if ibm is None:
        return state
    from tlab_tpu.dycore.state import State
    fluid = ibm["fluid"]             # 1 - eps
    if comm is not None:
        fluid = localize_block(fluid, comm)
    s = state.s
    if s.shape[0]:
        sval = ibm.get("scalar_values")
        if sval is not None:
            s = s * fluid[None] + (1 - fluid)[None] * sval[:, None, None, None]
        else:
            s = s * fluid[None]
    return State(sfc=state.sfc,
                 u=state.u * fluid, v=state.v * fluid, w=state.w * fluid,
                 s=s)


def build_ibm(eps: np.ndarray, dtype=jnp.float64, scalar_values=None) -> dict:
    d = {"eps": jnp.asarray(eps, dtype),
         "fluid": jnp.asarray(1.0 - eps, dtype)}
    if scalar_values is not None:
        d["scalar_values"] = jnp.asarray(scalar_values, dtype)
    return d
