"""Device mesh and sharding layouts for the 2-D pencil decomposition.

JAX-native mapping of the reference's x-z processor grid
(src/base/tlab_mpi_procs.f90:76-94): a 2-D jax mesh with axes ('x', 'z');
fields (nx, ny, nz) live block-sharded P('x', None, 'z') -- y is never
decomposed, exactly like the reference.

Two parallel execution paths:
- GSPMD auto-parallel: jit the single-device step with sharded inputs plus
  the elliptic solver's internal sharding constraints (this module's
  gspmd_shardings). Zero custom communication code; XLA inserts
  all-gathers/all-to-alls.
- Explicit shard_map pencil engine (tlab_tpu.parallel.pencil): the
  reference-faithful all-to-all transpose engine with full control of the
  collective schedule.
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(px: int, pz: int, devices=None) -> Mesh:
    """2-D ('x', 'z') device mesh; px*pz must equal the device count used.

    Axes are Auto-typed so both GSPMD constraint-steering and shard_map work.
    """
    auto = (jax.sharding.AxisType.Auto,) * 2
    if devices is not None:
        import numpy as np
        devs = np.asarray(devices).reshape(px, pz)
        return Mesh(devs, ("x", "z"), axis_types=auto)
    return jax.make_mesh((px, pz), ("x", "z"), axis_types=auto)


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Default block sharding of (nx, ny, nz) fields."""
    return NamedSharding(mesh, P("x", None, "z"))


def scalar_field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of stacked scalars (ns, nx, ny, nz)."""
    return NamedSharding(mesh, P(None, "x", None, "z"))


def gspmd_shardings(mesh: Mesh) -> dict:
    """Sharding constraints steering GSPMD through the Poisson dataflow.

    Stage requirements: x-FFT -> x local (shard y over 'x', z over 'z');
    z-FFT -> z local (shard y over both); modal solve -> y local (shard
    kz over 'z'; kx replicated over 'x' because nx/2+1 is odd).
    Divisibility: ny % (px*pz) == 0, nz % pz == 0, nx % px == 0.
    """
    return {
        "default": NamedSharding(mesh, P("x", None, "z")),
        "fft_x": NamedSharding(mesh, P(None, "x", "z")),
        "fft_z": NamedSharding(mesh, P(None, ("x", "z"), None)),
        "modal": NamedSharding(mesh, P(None, "x", "z")),
    }
