"""Explicit pencil-transpose engine: shard_map + all-to-all collectives.

The JAX-native re-design of the reference's global transpose engine
(src/base/tlab_mpi_transpose.f90): fields live block-sharded (nx/Px, ny,
nz/Pz) on the ('x','z') mesh; an x- or z-derivative gathers full lines with
ONE lax.all_to_all over the corresponding mesh axis, applies the dense
operator locally, and scatters back. Unlike the reference (one transpose
round-trip per field), the advected fields and the advecting velocity ride
the SAME all-to-all as a stacked tensor: 2 collectives per direction per
substep for the whole Burgers batch.

The Poisson chain (cf. reference OPR_Fourier + OPR_Poisson):
  x-gather -> rfft_x -> kx re-split over 'x' -> kx re-split over 'z' with
  full-z gather -> fft_z -> per-mode vertical eigen solve (y local by
  construction) -> inverse chain.
kx is zero-padded to a multiple of Px*Pz to keep the all-to-alls tiled.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as PSpec
from jax import shard_map

from tlab_tpu.dycore.state import State


# ---------------------------------------------------------------------------
# all_to_all helpers (operate on the LOCAL block inside shard_map)
# ---------------------------------------------------------------------------

def gather_x(a, field_axis_offset=0):
    """(.., nxl, ny, nzl) -> (.., nx, ny, nzl/Px) over mesh axis 'x'."""
    o = field_axis_offset
    return lax.all_to_all(a, "x", split_axis=2 + o, concat_axis=0 + o,
                          tiled=True)


def scatter_x(a, field_axis_offset=0):
    o = field_axis_offset
    return lax.all_to_all(a, "x", split_axis=0 + o, concat_axis=2 + o,
                          tiled=True)


def gather_z(a, field_axis_offset=0):
    """(.., nxl, ny, nzl) -> (.., nxl/Pz, ny, nz) over mesh axis 'z'."""
    o = field_axis_offset
    return lax.all_to_all(a, "z", split_axis=0 + o, concat_axis=2 + o,
                          tiled=True)


def scatter_z(a, field_axis_offset=0):
    o = field_axis_offset
    return lax.all_to_all(a, "z", split_axis=2 + o, concat_axis=0 + o,
                          tiled=True)


GATHER = {"x": gather_x, "z": gather_z}
SCATTER = {"x": scatter_x, "z": scatter_z}


def cast_on_wire(fn, a, off, wire_dtype):
    """Optionally move the all-to-all at reduced precision, the ICI analog
    of the reference's fp32-compressed fp64 transposes
    (tlab_mpi_transpose.f90:362-376, TransposeTypeK=single)."""
    if wire_dtype is None or a.dtype == wire_dtype:
        return fn(a, off)
    return fn(a.astype(wire_dtype), off).astype(a.dtype)


# ---------------------------------------------------------------------------
# Pencil Poisson
# ---------------------------------------------------------------------------

def _kx_offset(nkx_pad, px, pz):
    ix = lax.axis_index("x")
    iz = lax.axis_index("z")
    return ix * (nkx_pad // px) + iz * (nkx_pad // (px * pz))


def pencil_poisson(plan_dev, f, comm, bcs_b=None, bcs_t=None, d1y=None,
                   alpha=0.0, singular_fix=True):
    """Distributed Poisson/Helmholtz on local blocks inside shard_map.

    f: local (nxl, ny, nzl). plan_dev must carry 'lam_x_pad' (nkx_pad,),
    'lam_z' (nz,) full tables in addition to the eigen matrices.
    alpha != 0 solves Lap u + alpha u = f (modal u'' - (lam - alpha) u,
    same as ops.elliptic.solve_modal) with singular_fix=False.
    """
    px, pz = comm["px"], comm["pz"]
    nxl, ny, nzl = f.shape
    nx = nxl * px

    f = f.at[:, 0, :].set(0.0 if bcs_b is None else bcs_b)
    f = f.at[:, -1, :].set(0.0 if bcs_t is None else bcs_t)

    # forward: x lines
    fg = gather_x(f)                              # (nx, ny, nzl/px)
    dft = plan_dev.get("dft")
    use_dft = dft is not None and nx == dft["Cx"].shape[1]
    if use_dft:
        from tlab_tpu.ops import rdft
        fre, fim = rdft.forward_x_parts(dft, fg)
        fh = fre + 1j * fim
    else:
        fh = jnp.fft.rfft(fg, axis=0)             # (nkx, ny, nzl/px)
    nkx = nx // 2 + 1
    nkx_pad = plan_dev["nkx_pad"]
    fh = jnp.pad(fh, ((0, nkx_pad - nkx), (0, 0), (0, 0)))
    fh = scatter_x(fh)                            # (nkx_pad/px, ny, nzl)
    fh = gather_z(fh)                             # (nkx_pad/(px pz), ny, nz)
    if f.shape[2] * pz > 1:
        if use_dft and "Cz" in dft:
            from tlab_tpu.ops import rdft
            zr, zi = rdft.fft_z_parts(dft, jnp.real(fh), jnp.imag(fh))
            fh = zr + 1j * zi
        else:
            fh = jnp.fft.fft(fh, axis=2)

    # vertical modal solve with the local lambda slice
    chunk = nkx_pad // (px * pz)
    off = _kx_offset(nkx_pad, px, pz)
    lam_x = lax.dynamic_slice(plan_dev["lam_x_pad"], (off,), (chunk,))
    lam = lam_x[:, None] + plan_dev["lam_z"][None, :] - alpha

    V, W, lam_eig = plan_dev["V"], plan_dev["W"], plan_dev["lam_eig"]
    shift = plan_dev["shift"]
    # eigen recombination needs full f32 passes (cond(V) amplification)
    prec = (jax.lax.Precision.HIGHEST
            if fh.dtype == jnp.complex64 else None)
    G = jnp.einsum("ab,kbz->kaz", W.astype(fh.dtype), fh, precision=prec)
    denom = 1.0 - (lam[:, None, :] - shift) * lam_eig[None, :, None]
    G = G / denom.astype(fh.dtype)
    uh = jnp.einsum("ab,kbz->kaz", V.astype(fh.dtype), G, precision=prec)

    S_sing = plan_dev.get("S_sing") if singular_fix else None
    if S_sing is not None:
        f0 = fh[0, :, 0].at[0].set(0.0)
        u0 = jnp.matmul(S_sing.astype(fh.dtype), f0, precision=prec)
        uh_fixed = uh.at[0, :, 0].set(u0)
        uh = jnp.where(jnp.equal(off, 0), uh_fixed, uh)

    # backward
    if f.shape[2] * pz > 1:
        if use_dft and "Cz" in dft:
            from tlab_tpu.ops import rdft
            zr, zi = rdft.ifft_z_parts(dft, jnp.real(uh), jnp.imag(uh))
            uh = zr + 1j * zi
        else:
            uh = jnp.fft.ifft(uh, axis=2)
    uh = scatter_z(uh)                            # (nkx_pad/px, ny, nzl)
    uh = gather_x(uh)                             # hm: inverse of scatter_x
    uh = uh[:nkx]
    if use_dft:
        from tlab_tpu.ops import rdft
        pg = rdft.backward_x_parts(dft, jnp.real(uh), jnp.imag(uh))
    else:
        pg = jnp.fft.irfft(uh, n=nx, axis=0)      # (nx, ny, nzl/px)
    p = scatter_x(pg).astype(f.dtype)             # (nxl, ny, nzl)
    if d1y is not None:
        from tlab_tpu.ops.derivative import der1
        return p, der1(d1y, p, 1)
    return p


def pencil_helmholtz(plan_dev, f, comm, alpha, bcs_b=None, bcs_t=None):
    """Distributed Helmholtz solve Lap a + alpha a = f on local blocks
    inside shard_map -- the pencil analog of ops.elliptic.helmholtz
    (reference OPR_Helmholtz at any task count, opr_elliptic.f90): the
    [PressureFilter]/[Filter] Type=helmholtz backend under `--mesh`."""
    return pencil_poisson(plan_dev, f, comm, bcs_b=bcs_b, bcs_t=bcs_t,
                          alpha=alpha, singular_fix=False)


def pencil_poisson_factorize(fac_dev, f, comm, bcs_b=None, bcs_t=None):
    """Distributed factorized Poisson (NN) on local blocks inside
    shard_map -- the same reference-exact ODE2 composition as the
    single-device solver (ops/elliptic_factorize.py), so multi-device
    runs match single-device dns.out to round-off.

    fac_dev must carry 'kappa_pad' (nkx_pad, nz) -- the full per-mode
    kappa table padded for the kx all-to-alls (make_pencil_step adds it).
    Returns (p, dpdy) local blocks.
    """
    from tlab_tpu.ops import elliptic_factorize as fac

    px, pz = comm["px"], comm["pz"]
    nxl, ny, nzl = f.shape
    nx = nxl * px
    nz = nzl * pz

    f = f.at[:, 0, :].set(0.0 if bcs_b is None else bcs_b)
    f = f.at[:, -1, :].set(0.0 if bcs_t is None else bcs_t)

    # DFT-as-matmul transforms when the plan carries them -- the same
    # transform policy as the single-device poisson_factorize and
    # pencil_poisson (elliptic._transform_mode)
    dft = fac_dev.get("dft")
    nkx = nx // 2 + 1
    use_dft = dft is not None and nx == dft["Cx"].shape[1]

    fg = gather_x(f)                              # (nx, ny, nzl/px)
    if use_dft:
        from tlab_tpu.ops import rdft
        fre, fim = rdft.forward_x_parts(dft, fg)
        fh = fre + 1j * fim
    else:
        fh = jnp.fft.rfft(fg, axis=0)             # (nkx, ny, nzl/px)
    nkx_pad = fac_dev["nkx_pad"]
    fh = jnp.pad(fh, ((0, nkx_pad - nkx), (0, 0), (0, 0)))
    fh = scatter_x(fh)                            # (nkx_pad/px, ny, nzl)
    fh = gather_z(fh)                             # (nkx_pad/(px pz), ny, nz)
    if nz > 1:
        if use_dft and "Cz" in dft:
            from tlab_tpu.ops import rdft
            zr, zi = rdft.fft_z_parts(dft, jnp.real(fh), jnp.imag(fh))
            fh = zr + 1j * zi
        else:
            fh = jnp.fft.fft(fh, axis=2)

    chunk = nkx_pad // (px * pz)
    off = _kx_offset(nkx_pad, px, pz)
    kap = lax.dynamic_slice(fac_dev["kappa_pad"],
                            (off, jnp.zeros_like(off)), (chunk, nz))

    gb = fh[:, 0, :]
    gt = fh[:, -1, :]
    uh, vh = fac.solve_modal_factorize(fac_dev, fh, gb, gt, kap=kap,
                                       sing_idx=())

    # reference singular modes: global (kx, kz) in {0, nx/2} x {0, nz/2}
    # (a single (0,0) mode when staggered); fix the columns on the
    # device that owns them after the kx re-split
    for (gkx, kz) in fac_dev["sing_idx"]:
        li = gkx - off
        own = jnp.logical_and(li >= 0, li < chunk)
        li_c = jnp.clip(li, 0, chunk - 1)
        z0 = jnp.zeros_like(li_c)
        kzi = z0 + kz
        fcol = lax.dynamic_slice(fh, (li_c, z0, kzi), (1, ny, 1))[0, :, 0]
        us, vs = fac.sing_column(fac_dev, fcol,
                                 jnp.zeros((), fh.dtype), gt[li_c, kz],
                                 "nn", mean_mode=(gkx == 0 and kz == 0))
        uh = jnp.where(own,
                       lax.dynamic_update_slice(
                           uh, us[None, :, None], (li_c, z0, kzi)), uh)
        vh = jnp.where(own,
                       lax.dynamic_update_slice(
                           vh, vs[None, :, None], (li_c, z0, kzi)), vh)

    def backward(ah):
        if nz > 1:
            if use_dft and "Cz" in dft:
                from tlab_tpu.ops import rdft
                zr, zi = rdft.ifft_z_parts(dft, jnp.real(ah),
                                           jnp.imag(ah))
                ah = zr + 1j * zi
            else:
                ah = jnp.fft.ifft(ah, axis=2)
        ah = scatter_z(ah)                        # (nkx_pad/px, ny, nzl)
        ah = gather_x(ah)                         # (nkx_pad, ny, nzl/px)
        ah = ah[:nkx]
        if use_dft:
            from tlab_tpu.ops import rdft
            ag = rdft.backward_x_parts(dft, jnp.real(ah), jnp.imag(ah))
        else:
            ag = jnp.fft.irfft(ah, n=nx, axis=0)  # (nx, ny, nzl/px)
        return scatter_x(ag).astype(f.dtype)      # (nxl, ny, nzl)

    return backward(uh), backward(vh)


# ---------------------------------------------------------------------------
# Pencil step driver
# ---------------------------------------------------------------------------


def pencil_plans(mesh, P, wire_dtype=None) -> dict:
    """P augmented with the comm descriptor and the mesh-padded elliptic
    tables (kx zero-padding keeps the all-to-alls tiled; shared by every
    pencil step builder)."""
    px = mesh.shape["x"]
    pz = mesh.shape["z"]
    Pp = dict(P)
    Pp["comm"] = {"px": px, "pz": pz, "wire": wire_dtype}
    if P.get("ell_fac") is not None:
        # pad the per-mode kappa table for the kx all-to-alls so the
        # distributed solve is the same reference-exact composition
        fd = dict(P["ell_fac"])
        kapt = np.asarray(fd["kappa"])            # (nkx, nz)
        nkx = kapt.shape[0]
        nkx_pad = -(-nkx // (px * pz)) * (px * pz)
        pad = np.full((nkx_pad - nkx, kapt.shape[1]), 1e3, kapt.dtype)
        fd["kappa_pad"] = jnp.asarray(np.concatenate([kapt, pad], axis=0))
        fd["nkx_pad"] = nkx_pad
        Pp["ell_fac"] = fd
    def _pad_eigen(ell_in):
        ell = dict(ell_in)
        ell.pop("shardings", None)
        # pad the horizontal eigenvalue table for the kx all-to-alls
        if "lam_x_pad" in ell:
            return ell
        lam_x = np.asarray(ell["lam_xz"][:, 0])
        nkx = lam_x.shape[0]
        nkx_pad = -(-nkx // (px * pz)) * (px * pz)
        pad = np.full(nkx_pad - nkx, 1e6, dtype=lam_x.dtype)
        ell["lam_x_pad"] = jnp.asarray(np.concatenate([lam_x, pad]))
        ell["nkx_pad"] = nkx_pad
        ell["lam_z"] = jnp.asarray(
            np.asarray(ell["lam_xz"])[0, :] - lam_x[0])
        return ell

    if P.get("ell") is not None:
        Pp["ell"] = _pad_eigen(P["ell"])
    if P.get("ell_stag") is not None:
        # staggered-wavenumber eigen pencil (EllipticOrder=compactdirect*
        # with [Staggering]): same separable lam_x + lam_z structure
        Pp["ell_stag"] = _pad_eigen(P["ell_stag"])
    return Pp

def make_pencil_step(mesh, P, rk_step_fn, wire_dtype=None,
                     return_p: bool = False, aux_example=None,
                     inner_steps: int = 1):
    """Wrap the dycore rk_step in shard_map over the ('x','z') mesh.

    Returns step(state, dtime) -> state (or (state, p) with return_p,
    for the dns driver's stats pressure reuse) operating on sharded State
    arrays.  The dycore's operator helpers consult P['comm'] to route
    x/z-direction work through gather/scatter; y-direction work stays
    local.

    aux_example: a pytree with the STRUCTURE of the per-step aux argument
    (unsteady-inflow reference planes, wavemaker rtime, visc_scale ramp);
    when given, the returned step takes (state, dtime, aux) with every
    aux leaf replicated -- x/z-extended tables inside it are sliced to
    the local block by the dycore (buffer.localize / localize_wavemaker).

    inner_steps > 1 runs several FULL RK steps per dispatch inside a
    lax.fori_loop with a fixed dt (the dns driver's dispatch-amortization
    window on the single-device path, now available on the mesh too --
    the reference syncs every step at TIME_COURANT, time.f90:365; this
    is where this build beats that, not ties it).  The aux pytree,
    when present, is held fixed over the window (lagged CFL/ramp, same
    as the single-device window semantics).
    """
    Pp = pencil_plans(mesh, P, wire_dtype)
    px = mesh.shape["x"]
    pz = mesh.shape["z"]

    def _loop(state, dtime, aux=None):
        """inner_steps full RK steps; returns (state, last p)."""
        call = (lambda st: rk_step_fn(Pp, st, dtime, aux)) \
            if aux is not None else (lambda st: rk_step_fn(Pp, st, dtime))
        if inner_steps <= 1:
            return call(state)
        p0 = jnp.zeros_like(state.u)
        return lax.fori_loop(0, inner_steps,
                             lambda i, c: call(c[0]), (state, p0))

    fspec = PSpec("x", None, "z")
    sspec = PSpec(None, "x", None, "z")
    # the interactive-surface state (2, ns, nx, nz) shards like a
    # y-boundary plane stack; without [BoundaryConditions] SfcType it
    # stays None and the spec leaf must be None too (pytree match)
    sfc_spec = PSpec(None, None, "x", "z") \
        if P.get("surface_bc") is not None else None
    state_spec = State(u=fspec, v=fspec, w=fspec, s=sspec, sfc=sfc_spec)

    if aux_example is not None:
        aux_spec = jax.tree.map(lambda _: PSpec(), aux_example)

        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(state_spec, PSpec(), aux_spec),
            out_specs=(state_spec, fspec),
            check_vma=False)
        def step_local_aux(state, dtime, aux):
            return _loop(state, dtime, aux)

        return jax.jit(step_local_aux)

    if return_p:
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(state_spec, PSpec()),
            out_specs=(state_spec, fspec),
            check_vma=False)
        def step_local_p(state, dtime):
            return _loop(state, dtime)

        return jax.jit(step_local_p)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(state_spec, PSpec()),
        out_specs=state_spec,
        check_vma=False)
    def step_local(state, dtime):
        new_state, _ = _loop(state, dtime)
        return new_state

    return jax.jit(step_local)


def make_pencil_filter(mesh, P, mats=None, helmholtz_alpha=None,
                       wire_dtype=None):
    """Domain-filter application on the ('x','z') mesh through the SAME
    pencil engine as the RK step (no GSPMD mixing): x/z line-filter
    matrices apply on the all-to-all-gathered pencils, y locally; the
    Type=helmholtz filter routes through pencil_helmholtz.  The analog
    of the reference's OPR_FILTER at any task count
    (opr_filter.f90:200-285).

    Returns filt(state) -> state on sharded State arrays."""
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.ops.derivative import apply_along

    Pp = pencil_plans(mesh, P, wire_dtype)

    def _one(arr):
        if helmholtz_alpha is not None:
            al = helmholtz_alpha
            return pencil_helmholtz(Pp["ell"], al * arr, Pp["comm"],
                                    al).astype(arr.dtype)
        for nm, ax in (("x", 0), ("y", 1), ("z", 2)):
            M = mats.get(nm)
            if M is not None:
                arr = dyn._gathered_apply(
                    Pp, nm, arr,
                    lambda g, M=M, ax=ax: apply_along(M, g, ax))
        return arr

    fspec = PSpec("x", None, "z")
    sspec = PSpec(None, "x", None, "z")
    sfc_spec = PSpec(None, None, "x", "z") \
        if P.get("surface_bc") is not None else None
    state_spec = State(u=fspec, v=fspec, w=fspec, s=sspec, sfc=sfc_spec)

    @functools.partial(shard_map, mesh=mesh, in_specs=(state_spec,),
                       out_specs=state_spec, check_vma=False)
    def filt_local(state):
        s = state.s
        if s.shape[0]:
            s = jnp.stack([_one(s[i]) for i in range(s.shape[0])])
        return State(u=_one(state.u), v=_one(state.v), w=_one(state.w),
                     s=s, sfc=state.sfc)

    return jax.jit(filt_local)


def make_pencil_step_particles(mesh, P, grid, pprops, wire_dtype=None):
    """Coupled flow + Lagrangian-particle step on the ('x','z') mesh
    (reference TIME_SUBSTEP_PARTICLE at any task count, time.f90:906 +
    particle_mpi_send_recv.f90:13).

    Particles are owner-sharded fixed-capacity slot arrays with leading
    device dim (n_dev, cap, ...) sharded over BOTH mesh axes; each RK
    substep interpolates the pre-substep velocity on halo-extended local
    blocks, advances the particles, and migrates boundary crossers one
    ppermute ring pass per direction -- the low-storage tendencies ride
    the exchange as payload so a migrated particle keeps its RK carry
    (the reference ships l_hq with l_q).

    Supported types: tracer / inertia / tinia / bil_cloud_3/4 -- the
    droplet-scalar types compute the Eulerian source fields with the
    pencil operators and interpolate them on the same halo-extended
    blocks as the velocity (reference RHS_PART_1 at any task count);
    the droplet properties ride as columns 3: of the V slot array and
    their RK carries travel in the migration payload.
    Returns step(state, (X, V, T, M), dtime) -> (state, (X, V, T, M), p)."""
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.dycore.state import State as _State
    from tlab_tpu.particles import parallel as pp
    from tlab_tpu.particles.core import wrap_positions

    px = mesh.shape["x"]
    pz = mesh.shape["z"]
    Pp = pencil_plans(mesh, P, wire_dtype)
    locate = pp.make_block_locator(grid, px, pz)
    kdt = tuple(P["rk"]["kdt"])
    kco = tuple(P["rk"]["kco"])
    y_lo, y_hi = float(grid.y.nodes[0]), float(grid.y.nodes[-1])
    bil = pprops.bil_cloud if pprops.type.startswith("bil_cloud") else None
    ir_field = getattr(P.get("bodyforce"), "ir_field", None) \
        if bil is not None else None

    fspec = PSpec("x", None, "z")
    sspec = PSpec(None, "x", None, "z")
    sfc_spec = PSpec(None, None, "x", "z") \
        if P.get("surface_bc") is not None else None
    state_spec = State(u=fspec, v=fspec, w=fspec, s=sspec, sfc=sfc_spec)
    pspec = PSpec(("x", "z"))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(state_spec, (pspec,) * 4, PSpec()),
        out_specs=(state_spec, (pspec,) * 4, fspec),
        check_vma=False)
    def step_local(state, parts, dtime):
        X, V_all, T, M = (a[0] for a in parts)
        V, PR = V_all[:, :3], V_all[:, 3:]
        npp = PR.shape[1]
        hpx = jnp.zeros_like(X)
        hpv = jnp.zeros_like(V)
        hpp = jnp.zeros_like(PR)
        z = jnp.zeros_like(state.u)
        hq = (z, z, z)
        hs = jnp.zeros_like(state.s)
        p = z
        for i, k in enumerate(kdt):
            dte = dtime * k
            # particles first, with the PRE-substep velocity
            # (reference TIME_RUNGEKUTTA order, time.f90:220-246)
            uh = pp.halo_exchange(state.u)
            vh = pp.halo_exchange(state.v)
            wh = pp.halo_exchange(state.w)
            loc = locate(X)
            uf = jnp.stack([pp.interpolate_block(uh, loc),
                            pp.interpolate_block(vh, loc),
                            pp.interpolate_block(wh, loc)], axis=1)
            if pprops.type == "inertia":
                acc = (uf - V) / max(pprops.stokes, 1e-30)
                acc = acc.at[:, 1].add(-pprops.settling)
                dpx, dpv = V, acc
            elif pprops.type == "tinia":
                dpx = jnp.zeros_like(X)
                dpv = jnp.zeros_like(V)
            else:                      # tracer
                dpx, dpv = uf, jnp.zeros_like(V)
            if pprops.bcs == "stick":
                at_wall = (X[:, 1] <= y_lo) | (X[:, 1] >= y_hi)
                dpx = jnp.where(at_wall[:, None], 0.0, dpx)
                dpv = jnp.where(at_wall[:, None], 0.0, dpv)
            hpx = hpx + dpx
            hpv = hpv + dpv
            if bil is not None:
                # droplet-scalar sources from the CURRENT Eulerian state,
                # computed with the pencil operators and gathered on the
                # halo-extended blocks (reference RHS_PART_1)
                from tlab_tpu.particles import bil_cloud as bc
                rad = ir_field(state) if ir_field is not None else None
                src = bc.eulerian_sources(Pp, state.s, P["visc"], bil,
                                          radiation=rad)
                # ONE batched halo exchange for the (4, ...) source
                # stack, then plain block interpolation per field
                src_h = pp.halo_exchange(src)
                hpp = hpp.at[:, :2].add(
                    bc.droplet_rhs(bil, src_h, loc,
                                   interp=pp.interpolate_block))
                PR = PR + dte * hpp
            X = wrap_positions(grid, X + dte * hpx)
            V = V + dte * hpv
            # migrate crossers; the RK carries travel as payload
            payload = jnp.concatenate([V, hpx, hpv, PR, hpp], axis=1)
            sp = pp.ShardedParticles(x=X, v=payload, tags=T, mask=M)
            sp = pp.migrate(sp, grid, "x", px)
            sp = pp.migrate(sp, grid, "z", pz)
            X, T, M = sp.x, sp.tags, sp.mask
            V = sp.v[:, 0:3]
            hpx = sp.v[:, 3:6]
            hpv = sp.v[:, 6:9]
            PR = sp.v[:, 9:9 + npp]
            hpp = sp.v[:, 9 + npp:]
            # flow substep -- the same update as the single-device
            # particle path (stepping.rk_step_with_particles)
            hq, hs, p = dyn.substep_rhs(Pp, state, hq, hs, dte)
            state = _State(u=state.u + dte * hq[0],
                           v=state.v + dte * hq[1],
                           w=state.w + dte * hq[2],
                           s=state.s + dte * hs, sfc=state.sfc)
            if i < len(kdt) - 1:
                a = kco[i]
                hq = (a * hq[0], a * hq[1], a * hq[2])
                hs = a * hs
                hpx = a * hpx
                hpv = a * hpv
                hpp = a * hpp
        if bil is not None:
            # post-step bookkeeping (reference time.f90:250-258): clip
            # negative liquid; variant 4 advances the residence clocks
            from tlab_tpu.particles import bil_cloud as bc
            PR = PR.at[:, :2].set(bc.liquid_clip(PR[:, :2]))
            if bil.variant >= 4 and npp >= 4:
                res = bc.residence_update(bil, dtime, X[:, 1], PR[:, 2:4])
                PR = PR.at[:, 2:4].set(res)
        V_out = jnp.concatenate([V, PR], axis=1)
        return state, (X[None], V_out[None], T[None], M[None]), p

    return jax.jit(step_local)


def make_pencil_step_compressible(mesh, P, step_fn, wire_dtype=None,
                                  return_scalar: bool = False):
    """Explicit shard_map pencil step for the COMPRESSIBLE core: the
    conservative CompState shards P('x', None, 'z') (scalars stacked
    with a leading field axis) and the dycore's operators route x/z
    derivative work through the all-to-all engine via P['comm'] (the
    [D1;D2] viscous stacks gather/apply-global/scatter like Burgers;
    NSCBC tangential planes and the Mach drift go mesh-global).

    step_fn(P, U, dtime) -> U (e.g. a lambda closing over
    rk_step_compressible's physics arguments)."""
    from tlab_tpu.dycore.compressible import CompState
    Pp = pencil_plans(mesh, P, wire_dtype)

    fspec = PSpec("x", None, "z")
    sspec = PSpec(None, "x", None, "z")
    u_spec = CompState(rho=fspec, rhou=fspec, rhov=fspec, rhow=fspec,
                       rhoE=fspec, rhos=sspec)

    if return_scalar:
        # step_fn -> (U, scalar): e.g. the AirWater core's max Newton
        # residual (NewtonRs), reduced mesh-global with pmax
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(u_spec, PSpec()),
            out_specs=(u_spec, PSpec()),
            check_vma=False)
        def step_local_s(U, dtime):
            new_U, val = step_fn(Pp, U, dtime)
            val = lax.pmax(lax.pmax(val, "x"), "z")
            return new_U, val

        return jax.jit(step_local_s)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(u_spec, PSpec()),
        out_specs=u_spec,
        check_vma=False)
    def step_local(U, dtime):
        return step_fn(Pp, U, dtime)

    return jax.jit(step_local)
