"""Owner-sharded particle ensembles on the ('x','z') pencil mesh.

JAX-native re-design of the reference's particle migration
(src/particles/particle_mpi_sort.f90 counting sort + point-to-point
exchange): each device owns a fixed-capacity slot array of the particles
inside its (x, z) block, tracked by a validity mask. After each step,
particles that crossed a block edge ride one lax.ppermute ring shift per
direction (x then z, so corner moves take the two passes), and the receiver
compacts them into free slots. Assumes at most one block crossed per step
(CFL-limited motion).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


class ShardedParticles(NamedTuple):
    x: jax.Array          # (cap, 3) positions (garbage where inactive)
    v: jax.Array          # (cap, 3)
    tags: jax.Array       # (cap,) int32; -1 marks a free slot
    mask: jax.Array       # (cap,) bool


def _block_bounds(grid, axis_name, n_dev):
    ax = {"x": grid.x, "z": grid.z}[axis_name]
    lo = ax.nodes[0]
    length = ax.scale
    edges = lo + length * np.arange(n_dev + 1) / n_dev
    return edges


def shard_particles(grid, pstate, px, pz, capacity):
    """Host-side initial distribution: returns per-device stacked arrays
    (n_dev, cap, ...) to be device_put with a ('x','z')-sharded leading
    dim.  Extra particle properties (bil_cloud droplet scalars +
    residence clocks) ride as columns 3: of the V slot array."""
    xs = np.asarray(pstate.x)
    vs = np.asarray(pstate.v)
    pr = np.asarray(pstate.props)
    if pr.shape[-1]:          # column count, NOT element count: a
        # 0-row bil_cloud state must keep its property schema
        vs = np.concatenate([vs, pr], axis=1)
    tags = np.asarray(pstate.tags).astype(np.int32)
    ex = _block_bounds(grid, "x", px)
    ez = _block_bounds(grid, "z", pz) if pz > 1 else None
    n_dev = px * pz
    X = np.zeros((n_dev, capacity, 3))
    V = np.zeros((n_dev, capacity, vs.shape[1]))
    T = np.full((n_dev, capacity), -1, np.int32)
    M = np.zeros((n_dev, capacity), bool)
    ix = np.clip(np.searchsorted(ex, xs[:, 0], side="right") - 1, 0, px - 1)
    if ez is not None:
        iz = np.clip(np.searchsorted(ez, xs[:, 2], side="right") - 1,
                     0, pz - 1)
    else:
        iz = np.zeros_like(ix)
    dev = ix * pz + iz
    for d in range(n_dev):
        sel = np.where(dev == d)[0][:capacity]
        X[d, : sel.size] = xs[sel]
        V[d, : sel.size] = vs[sel]
        T[d, : sel.size] = tags[sel]
        M[d, : sel.size] = True
    return X, V, T, M


def _compact(p: ShardedParticles) -> ShardedParticles:
    """Move active slots to the front (stable)."""
    order = jnp.argsort(~p.mask, stable=True)
    return ShardedParticles(x=p.x[order], v=p.v[order],
                            tags=p.tags[order], mask=p.mask[order])


def _exchange_dir(p: ShardedParticles, send: jax.Array, axis_name: str,
                  shift: int) -> ShardedParticles:
    """Ship `send`-marked particles one step along the mesh axis ring."""
    n_dev = lax.axis_size(axis_name)
    perm = [(i, (i + shift) % n_dev) for i in range(n_dev)]
    keep = p.mask & ~send
    buf_x = jnp.where(send[:, None], p.x, 0.0)
    buf_v = jnp.where(send[:, None], p.v, 0.0)
    buf_t = jnp.where(send, p.tags, -1)
    rx = lax.ppermute(buf_x, axis_name, perm)
    rv = lax.ppermute(buf_v, axis_name, perm)
    rt = lax.ppermute(buf_t, axis_name, perm)
    rmask = rt >= 0
    # compact the kept particles, then fill the tail with received ones
    kept = _compact(ShardedParticles(p.x, p.v, p.tags, keep))
    recv = _compact(ShardedParticles(rx, rv, rt, rmask))
    n_keep = jnp.sum(kept.mask)
    cap = p.mask.shape[0]
    idx = jnp.arange(cap)
    take = idx - n_keep                      # receive slot k fills from recv
    take_c = jnp.clip(take, 0, cap - 1)
    use_recv = (idx >= n_keep) & (take_c < jnp.sum(recv.mask)) & \
        recv.mask[take_c]
    out_x = jnp.where(use_recv[:, None], recv.x[take_c], kept.x)
    out_v = jnp.where(use_recv[:, None], recv.v[take_c], kept.v)
    out_t = jnp.where(use_recv, recv.tags[take_c], kept.tags)
    out_m = kept.mask | use_recv
    return ShardedParticles(out_x, out_v, out_t, out_m)


def migrate(p: ShardedParticles, grid, axis_name: str, n_dev: int
            ) -> ShardedParticles:
    """One direction's two ring passes (+1 then -1) inside shard_map."""
    if n_dev <= 1:
        return p
    ax = {"x": grid.x, "z": grid.z}[axis_name]
    comp = {"x": 0, "z": 2}[axis_name]
    me = lax.axis_index(axis_name)

    def dist(p):
        # destination block from the (periodic-wrapped) global coordinate;
        # ring distance decides the shift direction (handles the wrap)
        pos = p.x[:, comp]
        target = jnp.clip(
            ((pos - ax.nodes[0]) / ax.scale * n_dev).astype(jnp.int32),
            0, n_dev - 1)
        return jnp.mod(target - me, n_dev)

    # masks must be recomputed between passes: the first exchange reshuffles
    # the slot layout
    p = _exchange_dir(p, p.mask & (dist(p) == 1), axis_name, +1)
    p = _exchange_dir(p, p.mask & (dist(p) == n_dev - 1), axis_name, -1)
    return p


def to_mesh(grid, pstate, mesh, capacity=None, dtype=None):
    """ParticleState -> (X, V, T, M) device arrays with leading device
    dim (n_dev, cap, ...) sharded over BOTH mesh axes, for the pencil
    particle step.  Raises when the per-device capacity would drop
    particles (the reference's isize_part overflow abort,
    particle_mpi_send_recv.f90)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    import jax.numpy as jnp
    px = mesh.shape["x"]
    pz = mesh.shape["z"]
    n_dev = px * pz
    n = int(np.asarray(pstate.x).shape[0])
    if not capacity:
        # 4x the balanced load, slot-aligned (particles cluster)
        capacity = max(8, -(-n * 4 // n_dev) // 8 * 8 + 8)
    X, V, T, M = shard_particles(grid, pstate, px, pz, capacity)
    if int(M.sum()) != n:
        raise ValueError(
            f"mesh particle capacity {capacity}/device dropped "
            f"{n - int(M.sum())} of {n} particles; raise [Particles] "
            f"MeshCapacity")
    sh = NamedSharding(mesh, PartitionSpec(("x", "z")))
    dt = dtype if dtype is not None else jnp.asarray(pstate.x).dtype
    return (jax.device_put(jnp.asarray(X, dt), sh),
            jax.device_put(jnp.asarray(V, dt), sh),
            jax.device_put(jnp.asarray(T), sh),
            jax.device_put(jnp.asarray(M), sh))


def from_mesh(parts):
    """(X, V, T, M) sharded arrays -> host ParticleState with the active
    rows tag-sorted (for trajectories, PDFs and restart writes); V
    columns 3: are the extra particle properties."""
    import jax.numpy as jnp
    from tlab_tpu.particles.core import ParticleState
    X, V, T, M = (np.asarray(a) for a in parts)
    m = M.reshape(-1)
    x = X.reshape(-1, 3)[m]
    vall = V.reshape(-1, V.shape[-1])[m]
    v, pr = vall[:, :3], vall[:, 3:]
    t = T.reshape(-1)[m]
    order = np.argsort(t, kind="stable")
    return ParticleState(x=jnp.asarray(x[order]), v=jnp.asarray(v[order]),
                         props=jnp.asarray(pr[order]),
                         tags=jnp.asarray(t[order].astype(np.int64)))


# ---------------------------------------------------------------------------
# Field -> particle interpolation on the mesh (reference
# particle_interpolate.f90 Create_Halo_K/I_IK: one-sided halo layers so the
# trilinear stencil of edge-cell particles can close; here the halo plane
# rides one lax.ppermute per sharded direction)
# ---------------------------------------------------------------------------

def halo_exchange(f, axes=("x", "z")):
    """Append the neighbor's first plane along each sharded axis:
    (nxl, ny, nzl) -> (nxl+1, ny, nzl+1). Periodic ring.  Leading batch
    dims are allowed ((K, nxl, ny, nzl) exchanges all K fields in ONE
    ppermute pair -- the bil_cloud source stack uses this)."""
    off = f.ndim - 3
    if "x" in axes:
        n = lax.axis_size("x")
        perm = [(i, (i - 1) % n) for i in range(n)]
        halo = lax.ppermute(lax.slice_in_dim(f, 0, 1, axis=off),
                            "x", perm)
        f = jnp.concatenate([f, halo], axis=off)
    if "z" in axes:
        n = lax.axis_size("z")
        perm = [(i, (i - 1) % n) for i in range(n)]
        halo = lax.ppermute(lax.slice_in_dim(f, 0, 1, axis=off + 2),
                            "z", perm)
        f = jnp.concatenate([f, halo], axis=off + 2)
    return f


def make_block_locator(grid, px: int, pz: int):
    """Locator for a device's (x, z) block with +1 halo: positions ->
    (i0, i1, fx, j0, j1, fy, k0, k1, fz) with indices LOCAL to the
    halo-extended block. y handled as in the global locator."""
    from tlab_tpu.particles.core import _locate_nonuniform
    nx_l = grid.x.size // px
    nz_l = grid.z.size // pz if grid.z.size > 1 else 1
    dx = grid.x.scale / grid.x.size
    dz = grid.z.scale / max(grid.z.size, 1)
    x0_g = grid.x.nodes[0]
    z0_g = grid.z.nodes[0] if grid.z.size > 1 else 0.0
    y_nodes = jnp.asarray(grid.y.nodes)

    def locate(pos):
        ix_blk = lax.axis_index("x")
        iz_blk = lax.axis_index("z") if pz > 1 else 0
        xl = pos[:, 0] - (x0_g + ix_blk * nx_l * dx)
        xi = jnp.clip(xl / dx, 0.0, nx_l - 1e-6)
        i0 = jnp.floor(xi).astype(jnp.int32)
        fx = xi - i0
        j0, j1, fy = _locate_nonuniform(pos[:, 1], y_nodes)
        if grid.z.size > 1:
            zl = pos[:, 2] - (z0_g + iz_blk * nz_l * dz)
            zi = jnp.clip(zl / dz, 0.0, nz_l - 1e-6)
            k0 = jnp.floor(zi).astype(jnp.int32)
            fz = zi - k0
        else:
            k0 = jnp.zeros_like(i0)
            fz = jnp.zeros_like(fx)
        return (i0, i0 + 1, fx, j0, j1, fy, k0, k0 + 1, fz)

    return locate


def interpolate_block(f_halo, loc):
    """Trilinear gather on the halo-extended block (same weights layout as
    particles.core.interpolate_to_particles)."""
    i0, i1, fx, j0, j1, fy, k0, k1, fz = loc

    def g(ii, jj, kk):
        return f_halo[ii, jj, kk]

    return ((1 - fx) * ((1 - fy) * ((1 - fz) * g(i0, j0, k0)
                                    + fz * g(i0, j0, k1))
                        + fy * ((1 - fz) * g(i0, j1, k0)
                                + fz * g(i0, j1, k1)))
            + fx * ((1 - fy) * ((1 - fz) * g(i1, j0, k0)
                                + fz * g(i1, j0, k1))
                    + fy * ((1 - fz) * g(i1, j1, k0)
                            + fz * g(i1, j1, k1))))
