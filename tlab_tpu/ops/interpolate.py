"""Grid-to-grid remeshing (reference OPR_INTERPOLATE /
transgrid.x/transfields.x, src/operators/opr_interpolate.f90).

Per-direction interpolation collapses to a precomputed dense matrix
(new_nodes x old_nodes) applied with the same matmul machinery as the
derivatives. Cubic Lagrange (4-point local) interior, matching the
reference's cubic-spline remeshing accuracy class; periodic directions wrap.
"""
from __future__ import annotations

import numpy as np

from tlab_tpu.grid import Axis, Grid
from tlab_tpu.ops.derivative import apply_along


def interpolation_matrix(old: Axis, new_nodes: np.ndarray) -> np.ndarray:
    """(n_new, n_old) cubic-Lagrange interpolation matrix."""
    xo = old.nodes
    n_old = xo.shape[0]
    if n_old == 1:
        return np.ones((new_nodes.shape[0], 1))
    M = np.zeros((new_nodes.shape[0], n_old))
    if old.periodic:
        period = old.scale
        xo_ext = np.concatenate([xo, xo[:1] + period])
    for r, x in enumerate(new_nodes):
        if old.periodic:
            xr = np.mod(x - xo[0], period) + xo[0]
            i = np.searchsorted(xo_ext, xr, side="right") - 1
            idx = [(i - 1) % n_old, i % n_old, (i + 1) % n_old, (i + 2) % n_old]
            # unwrap stencil positions around xr
            pos = []
            for off, k in zip(range(-1, 3), idx):
                base = xo_ext[i] + (off) * 0  # anchor
                p = xo[k]
                # shift by period to be monotone around xr
                while p < xr - period / 2:
                    p += period
                while p > xr + period / 2:
                    p -= period
                pos.append(p)
            pos = np.asarray(pos)
        else:
            xr = np.clip(x, xo[0], xo[-1])
            i = np.clip(np.searchsorted(xo, xr, side="right") - 1, 1, n_old - 3)
            idx = [i - 1, i, i + 1, i + 2]
            pos = xo[idx]
        for a, ka in enumerate(idx):
            w = 1.0
            for b in range(4):
                if b != a:
                    w *= (xr - pos[b]) / (pos[a] - pos[b])
            M[r, ka] += w
    return M


def remesh_field(field, old_grid: Grid, new_grid: Grid):
    """Interpolate (nx,ny,nz) field onto a new grid (one matmul per axis)."""
    import jax.numpy as jnp
    a = jnp.asarray(field)
    for axis, (o, n) in enumerate(((old_grid.x, new_grid.x),
                                   (old_grid.y, new_grid.y),
                                   (old_grid.z, new_grid.z))):
        if o.size == n.size and np.allclose(o.nodes, n.nodes):
            continue
        M = jnp.asarray(interpolation_matrix(o, n.nodes), a.dtype)
        a = apply_along(M, a, axis)
    return a
