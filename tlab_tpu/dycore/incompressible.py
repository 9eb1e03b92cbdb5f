"""Incompressible dynamical core: fused Burgers RHS + pressure projection.

One jitted function advances the state a full low-storage RK step, matching
the reference's hot loop (src/tools/dns/rhs_global_incompressible_1.f90 +
time.f90 TIME_RUNGEKUTTA):

per substep:
  1. advection-diffusion for the three momenta and all scalars via the fused
     Burgers operator  N(a; c, nu) = nu d2(a) - c d1(a)  along each direction
     (reference OPR_Burgers_X/Y/Z). Each Burgers term is ONE stacked
     [D1; D2] matmul plus two elementwise ops -- no transposes, no banded
     sweeps.
  2. sources (buoyancy, Coriolis) -- hooks below.
  3. pressure projection: solve Lap p = div(h + q/dte) with Neumann BCs taken
     from the vertical-momentum tendency at the walls (no-penetration), then
     h -= grad p  (reference rhs_global_incompressible_1.f90:177-360).
  4. boundary rows of the tendencies: Dirichlet walls pin the tendency to 0;
     Neumann (free-slip) walls recompute the wall value so the wall-normal
     derivative of the tendency vanishes (reference BOUNDARY_BCS_NEUMANN_Y,
     boundary_bcs.f90:368-474) -- reduced here to a precomputed dot-product
     row over y.
  5. q += dte h;  h *= kco.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from tlab_tpu.constants import BC
from tlab_tpu.dycore.state import State
from tlab_tpu.dycore import timemarch
from tlab_tpu.fdm.plan import FdmPlan, DerivPlan
from tlab_tpu.ops import elliptic
from tlab_tpu.ops.derivative import apply_along, der1, op_precision
from tlab_tpu.physics.params import NSParams


# ---------------------------------------------------------------------------
# Boundary-condition configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WallBCs:
    """Tendency BCs at jmin/jmax per variable: 'dirichlet' | 'neumann' | 'none'.

    'freeslip' walls => tangential velocities neumann, normal dirichlet;
    'noslip' => all dirichlet (reference boundary_bcs.f90:114-118).
    """

    u: tuple = ("dirichlet", "dirichlet")
    v: tuple = ("dirichlet", "dirichlet")
    w: tuple = ("dirichlet", "dirichlet")
    s: tuple = (("dirichlet", "dirichlet"),)

    @staticmethod
    def from_velocity_kind(jmin: str, jmax: str, scalar_bcs=(("dirichlet", "dirichlet"),)):
        def tang(kind):
            return "neumann" if kind == "freeslip" else "dirichlet"
        return WallBCs(
            u=(tang(jmin), tang(jmax)),
            v=("dirichlet", "dirichlet"),
            w=(tang(jmin), tang(jmax)),
            s=tuple(scalar_bcs),
        )


def neumann_value_rows(plan_y: DerivPlan, bot: bool, top: bool):
    """Row vectors (nb, nt) with wall value = row . u_column giving du/dy=0.

    Dense equivalent of reference BOUNDARY_BCS_NEUMANN_Y: from the Neumann-
    reduced derivative D (rows with f'_wall = 0), the wall value follows from
    the wall row of the compact system A f' = B f.
    """
    ibc = {(True, False): BC.ND, (False, True): BC.DN,
           (True, True): BC.NN}[(bot, top)]
    D = plan_y.d1[ibc]
    A1, B1 = plan_y.A1, plan_y.B1
    nb = nt = None
    if bot:
        nb = (A1[0, :] @ D - B1[0, :]) / B1[0, 0]
        nb[0] += 1.0
    if top:
        nt = (A1[-1, :] @ D - B1[-1, :]) / B1[-1, -1]
        nt[-1] += 1.0
    return nb, nt


# ---------------------------------------------------------------------------
# Device plan assembly
# ---------------------------------------------------------------------------

def build_device_plans(fdm: FdmPlan, nsp: NSParams, bcs: WallBCs,
                       rk_name: str = "RungeKuttaExplicit4",
                       dtype=jnp.float32,
                       ell_plan: Optional[elliptic.EllipticPlan] = None,
                       bodyforce=None, with_elliptic: bool = True,
                       wall_refs=None) -> dict:
    """Assemble the jit-ready pytree of operator matrices and coefficients.

    with_elliptic=False skips the Poisson plan (compressible mode, which has
    no pressure projection and allows periodic y).
    """
    if ell_plan is None and with_elliptic:
        ell_plan = elliptic.build_elliptic_plan(fdm, ibc=BC.NN)

    scheme = timemarch.get_scheme(rk_name)

    P = {
        "dtype": np.dtype(jnp.dtype(dtype)).name,
        "rk": {"kdt": tuple(scheme.kdt), "kco": tuple(scheme.kco),
               "ktime": tuple(scheme.ktime),
               # semi-implicit diffusion removes the diffusion-number dt
               # restriction (TIME_COURANT, time.f90:530-534)
               "explicit_diffusion": "diffusion" not in rk_name.lower()},
        "visc": float(nsp.visc),
        "diff": tuple(nsp.visc / sc for sc in nsp.schmidt),
        "sizes": tuple(p.size for p in (fdm.x, fdm.y, fdm.z)),
    }
    if ell_plan is not None:
        P["ell"] = elliptic.device_elliptic_plan(ell_plan, dtype=dtype)
    # plan constants are host numpy arrays, folded into the step as
    # compile-time constants
    nt = np.dtype(jnp.dtype(dtype))
    import os
    # banded-vs-dense crossover: untuned defaults between the two
    # power-of-two line lengths (2048-point lines run the dense [D1;D2],
    # 4096+ the O(N L) banded path); not measured on the GPU
    thomas_min_n = int(os.environ.get("TLAB_TPU_THOMAS_MIN_N", "2304"))
    part_min_n = int(os.environ.get("TLAB_TPU_PARTITION_MIN_N", "2304"))
    for name, plan in (("x", fdm.x), ("y", fdm.y), ("z", fdm.z)):
        if plan.size > 1:
            P[f"d1{name}"] = np.asarray(plan.d1[BC.DD], nt)
            P[f"d12{name}"] = np.asarray(plan.d12[BC.DD], nt)
            P[f"iod{name}"] = np.asarray(1.0 / plan.jac, nt)
            from tlab_tpu.ops import pallas_thomas as pthomas
            if plan.size >= thomas_min_n and not plan.periodic:
                P[f"d1{name}_banded"] = pthomas.banded_plan(
                    plan.A1, plan.B1, dtype)
            elif plan.size >= part_min_n and plan.periodic \
                    and plan.uniform:
                P[f"d1{name}_banded"] = pthomas.banded_plan(
                    plan.A1, plan.B1, dtype, periodic=True)
                P[f"d2{name}_banded"] = pthomas.banded_plan(
                    plan.A2, plan.B2, dtype, periodic=True)

    # wall-tendency BC rows along y (meaningless on periodic y)
    def rows_for(pair):
        bot = pair[0] == "neumann"
        top = pair[1] == "neumann"
        if not (bot or top) or fdm.y.periodic:
            return None
        nb, nt = neumann_value_rows(fdm.y, bot or top, bot or top)
        # reference uses the matched-ibc reduction; for mixed cases the
        # difference is only in the far-wall rows which are unused
        return {"nb": np.asarray(nb, np.dtype(jnp.dtype(dtype)))
                if bot else None,
                "nt": np.asarray(nt, np.dtype(jnp.dtype(dtype)))
                if top else None}

    P["bc_rows"] = {
        "u": rows_for(bcs.u), "v": rows_for(bcs.v), "w": rows_for(bcs.w),
        "s": tuple(rows_for(p) for p in bcs.s),
    }
    P["wall_bc_types"] = {"u": bcs.u, "v": bcs.v, "w": bcs.w, "s": bcs.s}
    # Dirichlet wall reference values (reference BcsFlowJmin/Jmax%ref,
    # boundary_bcs.f90; zero = no-slip default). Stored as plain floats so
    # the pinning is mesh-global and drift-free.
    P["wall_refs"] = wall_refs or {"u": (0.0, 0.0), "v": (0.0, 0.0),
                                   "w": (0.0, 0.0)}
    P["diffusion_constant"] = timemarch.diffusion_constant(fdm, nsp)
    P["bodyforce"] = bodyforce
    return P


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def _axis_comm(P, axis_name: str):
    """Pencil-communication descriptor if this direction is sharded."""
    comm = P.get("comm")
    if comm is None or axis_name == "y":
        return None
    return comm if comm.get(f"p{axis_name}", 1) > 1 else None


def _burgers(P, axis_name: str, axis: int, a, conv, diff):
    """nu * d2(a) - conv * d1(a) along `axis` (one fused matmul)."""
    d12 = P.get(f"d12{axis_name}")
    if d12 is None:
        return jnp.zeros_like(a)
    n = a.shape[axis]
    both = apply_along(d12, a, axis)
    sl1 = [slice(None)] * a.ndim
    sl2 = [slice(None)] * a.ndim
    sl1[axis] = slice(0, n)
    sl2[axis] = slice(n, 2 * n)
    da, d2a = both[tuple(sl1)], both[tuple(sl2)]
    return diff * d2a - conv * da


def _gathered_apply(P, axis_name: str, a, fn):
    """Run `fn` on the pencil-GATHERED lines of `a` along axis_name and
    scatter the result back (the OPR_Partial transpose sandwich,
    opr_partial.f90:59-142); identity routing when the axis is not
    sharded.  Shared by _d1/_d2/_stag and the pressure filter."""
    comm = _axis_comm(P, axis_name)
    if comm is None:
        return fn(a)
    from tlab_tpu.parallel import pencil
    wire = comm.get("wire")
    off = a.ndim - 3
    a_g = pencil.cast_on_wire(pencil.GATHER[axis_name], a, off, wire)
    return pencil.cast_on_wire(pencil.SCATTER[axis_name], fn(a_g), off,
                               wire)


def _d1(P, axis_name: str, axis: int, a):
    M = P.get(f"d1{axis_name}")
    if M is None:
        return jnp.zeros_like(a)
    bp = P.get(f"d1{axis_name}_banded")
    if bp is not None and P.get("comm") is None:
        from tlab_tpu.ops.pallas_thomas import banded_der1
        # callers always pass the axis index valid for `a` itself
        # (4-D stacks pass 1/2/3), so no ndim adjustment here
        return banded_der1(bp, a, axis)
    return _gathered_apply(P, axis_name, a, lambda g: der1(M, g, axis))


def _d2(P, axis_name: str, axis: int, a):
    """Compact second derivative along one direction (the OPR_P2 analog):
    the second half of the stacked [D1;D2] operator, with the same pencil
    routing as _d1."""
    d12 = P.get(f"d12{axis_name}")
    if d12 is None:
        return jnp.zeros_like(a)
    from tlab_tpu.ops.derivative import der12
    return _gathered_apply(P, axis_name, a,
                           lambda g: der12(d12, g, axis)[1])


def divergence(P, u, v, w):
    return _d1(P, "x", 0, u) + _d1(P, "y", 1, v) + _d1(P, "z", 2, w)


def _stag(P, axis_name: str, which: str, a):
    """Apply a staggered-grid operator (ivp/ipv/dvp/dpv) along x or z;
    identity when the axis has no extent (2-D runs).  On the production
    mesh the operator applies on the GATHERED pencils through the same
    all-to-all as _d1 (the reference staggers inside OPR_Partial at any
    task count, opr_partial.f90:19-27 OPR_P*_INT_VP/PV)."""
    M = P["stag"].get(f"{which}{axis_name}")
    if M is None:
        return a
    axis = 0 if axis_name == "x" else 2
    return _gathered_apply(P, axis_name, a, lambda g: der1(M, g, axis))


def divergence_staggered(P, u, v, w):
    """Divergence on the staggered pressure nodes (what the staggered
    projection annihilates)."""
    return (_stag(P, "z", "ivp", _stag(P, "x", "dvp", u))
            + _stag(P, "z", "ivp",
                    _stag(P, "x", "ivp", _d1(P, "y", 1, v)))
            + _stag(P, "x", "ivp", _stag(P, "z", "dvp", w)))


def _ydot(row, a):
    """row . a along y (axis -2) at the operator precision: a dot left at
    DEFAULT runs in TF32 on the GPU, and the wall rows carry it."""
    return jnp.einsum("b,...bk->...k", row, a,
                      precision=op_precision(a.dtype))


def _apply_wall_rows(h, rows):
    """Set the j=0 / j=ny-1 rows of the tendency per its BC type."""
    if rows is None:
        h = h.at[:, 0, :].set(0.0)
        h = h.at[:, -1, :].set(0.0)
        return h
    nb, nt = rows["nb"], rows["nt"]
    if nb is not None:
        h = h.at[:, 0, :].set(_ydot(nb, h))
    else:
        h = h.at[:, 0, :].set(0.0)
    if nt is not None:
        h = h.at[:, -1, :].set(_ydot(nt, h))
    else:
        h = h.at[:, -1, :].set(0.0)
    return h


# ---------------------------------------------------------------------------
# RHS of one substep (explicit, combined formulation)
# ---------------------------------------------------------------------------


def _d12_apply(P, axis_name: str, axis: int, arr, pref, prec):
    """(d1 arr, d2 arr) along axis+1 of a 4-D stack: the partitioned
    circulant plans when present (periodic long lines -- 2(L+2b) instead
    of 2N flops/point), else one fused dense [D1;D2] matmul."""
    b1 = P.get(f"d1{axis_name}_banded")
    b2 = P.get(f"d2{axis_name}_banded")
    if b1 is not None and b2 is not None and b1.get("periodic"):
        from tlab_tpu.ops.pallas_thomas import banded_der1
        return (banded_der1(b1, arr, axis + 1),
                banded_der1(b2, arr, axis + 1))
    d12 = P[f"d12{axis_name}"]
    n = arr.shape[axis + 1]
    eins = {0: "ab,fbjk->fajk", 1: "ab,fibk->fiak",
            2: "ab,fijb->fija"}[axis]
    both = jnp.einsum(eins, d12, arr, preferred_element_type=pref,
                      precision=prec).astype(arr.dtype)
    sl1 = [slice(None)] * 4
    sl2 = [slice(None)] * 4
    sl1[axis + 1] = slice(0, n)
    sl2[axis + 1] = slice(n, 2 * n)
    return both[tuple(sl1)], both[tuple(sl2)]


@jax.named_scope("burgers")      # names the layer in device traces
def _burgers_all(P, axis_name: str, axis: int, fields, conv, nu):
    """Fused Burgers for ALL prognostic fields along one direction.

    fields: (F, nx, ny, nz) stacked u,v,w,s...; conv: advecting velocity
    broadcast over F; nu: (F, 1, 1, 1) per-field diffusivity. One big
    [D1; D2] matmul for the whole stack -> one large matmul per direction (the
    batched analog of the reference's per-field OPR_Burgers calls).

    P['adv_form'] selects the advection formulation (reference [Main]
    TermAdvection, rhs_flow_global_incompressible_1/2/3.f90):
      convective     nu d2 f - c d1 f            (default, form 1)
      skewsymmetric  nu d2 f - 0.5 (c d1 f + d1 (c f))   (form 2)
      divergence     nu d2 f - d1 (c f)                  (form 3)
    The conservative forms stack [f; c f] into one [D1;D2] matmul of
    width 2F, so the matmul cost grows but no extra passes are made.
    """
    d12 = P.get(f"d12{axis_name}")
    if d12 is None:
        return jnp.zeros_like(fields)
    comm = _axis_comm(P, axis_name)
    mesh_comm = P.get("comm")
    ibm = P.get("ibm")
    fill = ibm.get("fills", {}).get(axis_name) if ibm is not None else None

    def _fill4(fl):
        return {k: v[None] for k, v in fl.items()}

    if fill is not None and comm is None:
        # replace solid regions by smooth interpolants before derivatives
        # (reference ibm_burgers hook, opr_burgers.f90:468); on the mesh
        # this covers y (never sharded) and unsharded x/z axes, with the
        # global tables sliced to the local block
        from tlab_tpu import ibm as ibmmod
        fl = ibmmod.localize_fill(fill, axis_name, mesh_comm,
                                  gathered=False) \
            if mesh_comm is not None else fill
        fields = ibmmod.apply_spline_fill(fields, _fill4(fl), axis + 1)
        conv = ibmmod.apply_spline_fill(conv, fl, axis)
    if comm is not None:
        # the advecting velocity rides the same all-to-all as the fields
        from tlab_tpu.parallel import pencil
        wire = comm.get("wire")
        stack = jnp.concatenate([fields, conv[None]], axis=0)
        stack = pencil.cast_on_wire(pencil.GATHER[axis_name], stack, 1, wire)
        if fill is not None:
            # spline fill on the GATHERED full lines -- exactly where the
            # reference fills its MPI-gathered pencils (ibm_spline.f90:30)
            from tlab_tpu import ibm as ibmmod
            flg = ibmmod.localize_fill(fill, axis_name, comm, gathered=True)
            stack = ibmmod.apply_spline_fill(stack, _fill4(flg), axis + 1)
        fields_t, conv_t = stack[:-1], stack[-1]
    else:
        fields_t, conv_t = fields, conv
    n = fields_t.shape[axis + 1]
    pref = jnp.float32 if fields.dtype in (jnp.bfloat16, jnp.float16) \
        else fields.dtype
    from tlab_tpu.ops.derivative import op_precision
    eins = {0: "ab,fbjk->fajk", 1: "ab,fibk->fiak", 2: "ab,fijb->fija"}[axis]
    form = P.get("adv_form", "convective")
    sl1 = [slice(None)] * 4
    sl2 = [slice(None)] * 4
    sl1[axis + 1] = slice(0, n)
    sl2[axis + 1] = slice(n, 2 * n)
    if form in ("divergence", "skewsymmetric"):
        F = fields_t.shape[0]
        big = jnp.concatenate([fields_t, conv_t[None] * fields_t], axis=0)
        dall, d2all = _d12_apply(P, axis_name, axis, big, pref,
                                 op_precision(fields.dtype))
        da = dall[:F]
        d2a = d2all[:F]
        dprod = dall[F:]
        if form == "divergence":
            adv = dprod
        else:
            adv = 0.5 * (conv_t[None] * da + dprod)
        ane = P.get("anelastic")
        if ane is not None:
            d2a = d2a * ane["rho_inv"][None, None, :, None]
        res = nu * d2a - adv
        if comm is not None:
            res = pencil.cast_on_wire(pencil.SCATTER[axis_name], res, 1,
                                      wire)
        return res
    da, d2a = _d12_apply(P, axis_name, axis, fields_t, pref,
                         op_precision(fields.dtype))
    ane = P.get("anelastic")
    if ane is not None:
        # mu-constant anelastic diffusion: nu_eff = nu / rho_bar(y); y stays
        # the middle axis through any gather (reference OPR_Burgers rhoinv
        # weighting, opr_burgers.f90:487-516)
        d2a = d2a * ane["rho_inv"][None, None, :, None]
    dea = P.get("dealias", {}).get(axis_name) if P.get("dealias") else None
    if dea is not None:
        # filter the factors of the advection product before multiplying
        # (reference OPR_Burgers_1D dealiasing, opr_burgers.f90:478-499)
        conv_f = apply_along(dea, conv_t, axis)
        da_f = jnp.einsum(eins, dea, da, preferred_element_type=pref,
                          precision=op_precision(fields.dtype)).astype(fields.dtype)
        res = nu * d2a - conv_f[None] * da_f
    else:
        res = nu * d2a - conv_t[None] * da
    if comm is not None:
        res = pencil.cast_on_wire(pencil.SCATTER[axis_name], res, 1, wire)
    return res


def substep_rhs(P, state: State, hq, hs, dte, aux=None):
    u, v, w, s = state.u, state.v, state.w, state.s
    visc = P["visc"]
    h1, h2, h3 = hq
    ns = s.shape[0]

    # advection-diffusion for all fields at once
    # (reference rhs_global_incompressible_1.f90:96-160)
    fields = jnp.concatenate([u[None], v[None], w[None], s], axis=0)
    nu = jnp.asarray((visc,) * 3 + tuple(P["diff"]),
                     fields.dtype)[:, None, None, None]
    if aux is not None and "visc_scale" in aux:
        # [ViscChange] ramp: restart viscosity relaxing toward the INI
        # value (dns_main.f90:176-184, 261); rides as a traced scalar
        nu = nu * aux["visc_scale"]
    adv = (_burgers_all(P, "x", 0, fields, u, nu)
           + _burgers_all(P, "y", 1, fields, v, nu)
           + _burgers_all(P, "z", 2, fields, w, nu))
    h1 = h1 + adv[0]
    h2 = h2 + adv[1]
    h3 = h3 + adv[2]
    hs = hs + adv[3:] if ns else hs

    # sources hook (buoyancy along y etc.; aux may carry the step rtime
    # for time-dependent forcing)
    if P["bodyforce"] is not None:
        h1, h2, h3, hs = P["bodyforce"](P, state, h1, h2, h3, hs, aux=aux)

    # buffer/sponge relaxation before the projection
    # (reference rhs_global_incompressible_1.f90:172); aux may carry
    # time-dependent inflow-strip references (spatial mode, reference
    # boundary_inflow.f90 role)
    buf = P.get("buffer")
    if buf is not None and aux is not None and "refs_x" in aux:
        buf = dict(buf)
        buf["refs_x"] = aux["refs_x"]
    if buf is not None:
        from tlab_tpu.dycore import buffer as bufmod
        buf = bufmod.localize(buf, P.get("comm"))
        h1 = bufmod.relax(buf, "u", u, h1)
        h2 = bufmod.relax(buf, "v", v, h2)
        h3 = bufmod.relax(buf, "w", w, h3)
        hs = jnp.stack([bufmod.relax(buf, f"s{i}", s[i], hs[i])
                        for i in range(s.shape[0])]) if s.shape[0] else hs

    dpdx, dpdy_v, dpdz, p = _solve_pressure(P, u, v, w, h1, h2, h3, dte,
                                            aux)
    ane = P.get("anelastic")
    if ane is not None:
        ri = ane["rho_inv"][None, :, None]
        h1 = h1 - ri * dpdx
        h2 = h2 - ri * dpdy_v
        h3 = h3 - ri * dpdz
    else:
        h1 = h1 - dpdx
        h2 = h2 - dpdy_v
        h3 = h3 - dpdz

    # wall rows of the tendencies
    rows = P["bc_rows"]
    h1 = _apply_wall_rows(h1, rows["u"])
    h2 = _apply_wall_rows(h2, rows["v"])
    h3 = _apply_wall_rows(h3, rows["w"])
    hs = jnp.stack([_apply_wall_rows(hs[i], rows["s"][i])
                    for i in range(hs.shape[0])]) if hs.shape[0] else hs

    return (h1, h2, h3), hs, p


@jax.named_scope("projection")      # names the layer in device traces
def _solve_pressure(P, u, v, w, h1, h2, h3, dte, aux=None):
    """Pressure projection (reference rhs_global_incompressible_1.f90:
    177-360): assemble the forcing divergence, solve the Poisson
    problem, filter, and return the pressure-gradient components on the
    velocity nodes -> (dpdx, dpdy_v, dpdz, p).  Anelastic weights the
    forcing by rho_bar (the 1/rho_bar gradient weighting is the
    caller's, :330-334)."""
    ane = P.get("anelastic")
    if P.get("remove_divergence", True):
        # default: the forcing carries q/dte so the projection removes
        # the RESIDUAL divergence too ([Main] TermDivergence=remove,
        # rhs_global_incompressible_1.f90:177)
        inv_dte = 1.0 / dte
        fx = h1 + u * inv_dte
        fy = h2 + v * inv_dte
        fz = h3 + w * inv_dte
    else:                        # TermDivergence=none
        fx, fy, fz = h1, h2, h3
    if ane is not None:
        rho = ane["rho"][None, :, None]
        fx, fy, fz = fx * rho, fy * rho, fz * rho
    stag = P.get("stag")
    if stag is not None:
        # horizontally staggered pressure (reference stagger_on branch,
        # rhs_global_incompressible_1.f90:216-320): forcing divergence
        # assembled on the pressure nodes with the VP operators
        div = (_stag(P, "z", "ivp", _stag(P, "x", "dvp", fx))
               + _stag(P, "z", "ivp",
                       _stag(P, "x", "ivp", _d1(P, "y", 1, fy)))
               + _stag(P, "x", "ivp", _stag(P, "z", "dvp", fz)))
        h2_s = _stag(P, "z", "ivp", _stag(P, "x", "ivp", h2))
    else:
        div = _d1(P, "y", 1, fy) + _d1(P, "x", 0, fx) + _d1(P, "z", 2, fz)
        h2_s = h2

    if ane is not None:
        bcs_b = h2_s[:, 0, :] * ane["rho"][0]
        bcs_t = h2_s[:, -1, :] * ane["rho"][-1]
    else:
        bcs_b = h2_s[:, 0, :]
        bcs_t = h2_s[:, -1, :]
    if P.get("comm") is not None:
        from tlab_tpu.parallel import pencil
        if P.get("ell_fac") is not None and "kappa_pad" in P["ell_fac"]:
            # distributed reference-exact factorize: multi-device runs
            # match single-device dns.out to round-off
            p, dpdy = pencil.pencil_poisson_factorize(
                P["ell_fac"], div, P["comm"], bcs_b=bcs_b, bcs_t=bcs_t)
        else:
            # staggered runs must use the staggered-wavenumber eigen
            # table (P["ell_stag"]); the unstaggered one would not
            # annihilate the staggered divergence
            ellp = P["ell_stag"] if (stag is not None
                                     and P.get("ell_stag") is not None) \
                else P["ell"]
            p, dpdy = pencil.pencil_poisson(ellp, div, P["comm"],
                                            bcs_b=bcs_b, bcs_t=bcs_t,
                                            d1y=P["d1y"])
    elif P.get("ell_fac") is not None:
        # reference-default factorized formulation: stage-consistent dpdy
        # removes divergence to round-off (opr_elliptic.f90:108-110); when
        # staggered, the plan carries the staggered-derivative wavenumbers
        from tlab_tpu.ops import elliptic_factorize as fac
        tables = aux.get("fac_tables") if aux else None
        p, dpdy = fac.poisson_factorize(P["ell_fac"], div,
                                        bcs_b=bcs_b, bcs_t=bcs_t,
                                        tables=tables)
    elif stag is not None:
        p, dpdy = elliptic.poisson(P["ell_stag"], div, bcs_b=bcs_b,
                                   bcs_t=bcs_t, d1y=P["d1y"])
    else:
        p, dpdy = elliptic.poisson(P["ell"], div, bcs_b=bcs_b, bcs_t=bcs_t,
                                   d1y=P["d1y"])
    pfil = P.get("pfilter")
    if pfil is not None:
        # [PressureFilter]: filter p and dp/dy after the Poisson solve
        # (rhs_global_incompressible_1.f90:287-291) -- stabilizes the
        # staggered scheme's near-Nyquist pressure modes.  On the mesh
        # the x/z filter matrices apply on the gathered pencils.
        from tlab_tpu.ops.filter import apply_filter
        if isinstance(pfil, dict) and "helmholtz_alpha" in pfil:
            # Type=helmholtz: one implicit elliptic solve per field,
            # distributed under the mesh (pencil_helmholtz) -- the
            # reference runs this path at any task count
            # (opr_filter.f90:285 + opr_elliptic.f90 OPR_Helmholtz)
            al = pfil["helmholtz_alpha"]
            if P.get("comm") is not None:
                from tlab_tpu.parallel import pencil

                def _filt(arr):
                    return pencil.pencil_helmholtz(
                        P["ell"], al * arr, P["comm"], al).astype(arr.dtype)
            else:
                def _filt(arr):
                    return elliptic.helmholtz(P["ell"], al * arr, al)
        elif P.get("comm") is not None and not callable(pfil):
            from tlab_tpu.ops.derivative import apply_along

            def _filt(arr):
                for nm, ax in (("x", 0), ("y", 1), ("z", 2)):
                    M = pfil.get(nm)
                    if M is not None:
                        arr = _gathered_apply(
                            P, nm, arr,
                            lambda g, M=M, ax=ax: apply_along(M, g, ax))
                return arr
        else:
            def _filt(arr):
                return apply_filter(pfil, arr)
        p = _filt(p)
        dpdy = _filt(dpdy)
    if stag is not None:
        # pressure gradient back on velocity nodes with the PV operators
        # (reference rhs_global_incompressible_1.f90:307-320)
        dpdx = _stag(P, "z", "ipv", _stag(P, "x", "dpv", p))
        dpdy_v = _stag(P, "x", "ipv", _stag(P, "z", "ipv", dpdy))
        dpdz = _stag(P, "x", "ipv", _stag(P, "z", "dpv", p))
    else:
        dpdx = _d1(P, "x", 0, p)
        dpdy_v = dpdy
        dpdz = _d1(P, "z", 2, p)
    return dpdx, dpdy_v, dpdz, p


def _apply_wall_rows_stacked(H, i, rows):
    """Wall-row imposition directly on the stacked tendency H at field
    index i (dynamic-update-slice of the rows only -- no per-component
    field copies; same arithmetic as _apply_wall_rows)."""
    if rows is None:
        H = H.at[i, :, 0, :].set(0.0)
        H = H.at[i, :, -1, :].set(0.0)
        return H
    nb, nt = rows["nb"], rows["nt"]
    if nb is not None:
        H = H.at[i, :, 0, :].set(_ydot(nb, H[i]))
    else:
        H = H.at[i, :, 0, :].set(0.0)
    if nt is not None:
        H = H.at[i, :, -1, :].set(_ydot(nt, H[i]))
    else:
        H = H.at[i, :, -1, :].set(0.0)
    return H


def substep_rhs_stacked(P, Q, H, dte, aux=None):
    """substep_rhs on a STACKED carry: Q, H are (3+ns, nx, ny, nz) with
    rows u, v, w, s1..  The per-substep concatenate of the advected
    fields disappears (Q IS the Burgers stack) and the tendency
    accumulates as one fused array op -- ~1 GB/substep less HBM traffic
    at the benchmark size (r5 roofline study).  Arithmetic is
    elementwise-identical to substep_rhs; rk_step selects this path
    when no component-structured hook (IBM, interactive surface BC)
    requires the tuple form.  Returns (H_new, p)."""
    u, v, w, s = Q[0], Q[1], Q[2], Q[3:]
    visc = P["visc"]

    nu = jnp.asarray((visc,) * 3 + tuple(P["diff"]),
                     Q.dtype)[:, None, None, None]
    if aux is not None and "visc_scale" in aux:
        nu = nu * aux["visc_scale"]
    H = H + (_burgers_all(P, "x", 0, Q, u, nu)
             + _burgers_all(P, "y", 1, Q, v, nu)
             + _burgers_all(P, "z", 2, Q, w, nu))

    if P["bodyforce"] is not None or P.get("buffer") is not None:
        # component-structured hooks: bridge through views and restack
        # (the concat cost returns only when sources/buffers are active,
        # exactly what the tuple path always paid)
        state = State(u=u, v=v, w=w, s=s)
        h1, h2, h3, hs = H[0], H[1], H[2], H[3:]
        if P["bodyforce"] is not None:
            h1, h2, h3, hs = P["bodyforce"](P, state, h1, h2, h3, hs,
                                            aux=aux)
        buf = P.get("buffer")
        if buf is not None and aux is not None and "refs_x" in aux:
            buf = dict(buf)
            buf["refs_x"] = aux["refs_x"]
        if buf is not None:
            from tlab_tpu.dycore import buffer as bufmod
            buf = bufmod.localize(buf, P.get("comm"))
            h1 = bufmod.relax(buf, "u", u, h1)
            h2 = bufmod.relax(buf, "v", v, h2)
            h3 = bufmod.relax(buf, "w", w, h3)
            hs = jnp.stack([bufmod.relax(buf, f"s{i}", s[i], hs[i])
                            for i in range(s.shape[0])]) \
                if s.shape[0] else hs
        H = jnp.concatenate([h1[None], h2[None], h3[None], hs], axis=0)

    dpdx, dpdy_v, dpdz, p = _solve_pressure(P, u, v, w, H[0], H[1], H[2],
                                            dte, aux)
    ane = P.get("anelastic")
    if ane is not None:
        ri = ane["rho_inv"][None, :, None]
        H = H.at[0].add(-ri * dpdx)
        H = H.at[1].add(-ri * dpdy_v)
        H = H.at[2].add(-ri * dpdz)
    else:
        H = H.at[0].add(-dpdx)
        H = H.at[1].add(-dpdy_v)
        H = H.at[2].add(-dpdz)

    rows = P["bc_rows"]
    H = _apply_wall_rows_stacked(H, 0, rows["u"])
    H = _apply_wall_rows_stacked(H, 1, rows["v"])
    H = _apply_wall_rows_stacked(H, 2, rows["w"])
    for i in range(s.shape[0]):
        H = _apply_wall_rows_stacked(H, 3 + i, rows["s"][i])
    return H, p


def surface_bc_step(P, s_pre, s_new, sfc, dte):
    """Interactive (linear) surface BC (reference BOUNDARY_BCS_SURFACE_Y,
    boundary_bcs.f90:478-545 + the hs wall-row imposition,
    rhs_global_incompressible_1.f90:390-396):

        ref += cpl (hfx - <hfx>)        (per substep, flux of the
                                         PRE-update scalar)
        wall TENDENCY = ref  =>  s_wall += dte ref

    The persistent surface state ref rides as State.sfc (2, ns, nx, nz);
    sides with SfcType=static keep ref = 0 (frozen Dirichlet wall).
    Returns (s_updated, sfc_updated)."""
    sbc = P.get("surface_bc")
    if sbc is None or s_new.shape[0] == 0 or sfc is None:
        return s_new, sfc
    d1y = P["d1y"]
    diff = jnp.asarray(P["diff"], s_new.dtype)[:, None, None]
    def pmean(a):
        m = jnp.mean(a, axis=(1, 2), keepdims=True)
        comm = P.get("comm")
        if comm is not None:
            from jax import lax
            if comm.get("px", 1) > 1:
                m = lax.pmean(m, "x")
            if comm.get("pz", 1) > 1:
                m = lax.pmean(m, "z")
        return m

    cplb = sbc.get("cpl_jmin")
    cplt = sbc.get("cpl_jmax")
    if cplb is not None and any(c != 0.0 for c in cplb):
        hfx = diff * _ydot(d1y[0], s_pre)
        anom = hfx - pmean(hfx)
        sfc = sfc.at[0].add(
            jnp.asarray(cplb, s_new.dtype)[:, None, None] * anom)
        s_new = s_new.at[:, :, 0, :].add(dte * sfc[0])
    if cplt is not None and any(c != 0.0 for c in cplt):
        hfx = -diff * _ydot(d1y[-1], s_pre)
        # the reference's top-boundary average uses +diff times the
        # BOTTOM plane's mean derivative (AVG1V2D at j=1,
        # boundary_bcs.f90:531-537) -- mirrored verbatim for parity
        hfx_avg = pmean(diff * _ydot(d1y[0], s_pre))
        anom = hfx - hfx_avg
        sfc = sfc.at[1].add(
            jnp.asarray(cplt, s_new.dtype)[:, None, None] * anom)
        s_new = s_new.at[:, :, -1, :].add(dte * sfc[1])
    return s_new, sfc


def _enforce_wall_values(P, state: State) -> State:
    """Re-impose Dirichlet wall values on the fields (reference applies
    BcsFlowJmin/Jmax%ref each substep, boundary_bcs.f90): no-penetration
    v=0 always; u/w zeroed for no-slip walls. Protects against ICs or
    round-off drift depositing values on pinned rows."""
    if P["sizes"][1] == 1 or P.get("y_periodic", False):
        return state
    kinds = P["wall_bc_types"]
    refs = P.get("wall_refs") or {"u": (0.0, 0.0), "v": (0.0, 0.0),
                                  "w": (0.0, 0.0)}
    u, v, w = state.u, state.v, state.w
    for j, side in ((0, 0), (-1, 1)):
        if kinds["v"][side] == "dirichlet":
            v = v.at[:, j, :].set(refs["v"][side])
        if kinds["u"][side] == "dirichlet":
            u = u.at[:, j, :].set(refs["u"][side])
        if kinds["w"][side] == "dirichlet":
            w = w.at[:, j, :].set(refs["w"][side])
    return State(u=u, v=v, w=w, s=state.s, sfc=state.sfc)


def _rk_substep(P, state: State, hq, hs, dte, kco_i, aux=None):
    """One low-storage substep: accumulate tendencies, update the state,
    then scale h by the carry coefficient (0 after the last stage)."""
    hq, hs, p = substep_rhs(P, state, hq, hs, dte, aux=aux)
    s_new = state.s + dte * hs
    bounds = P.get("scal_bounds")        # (mins, maxs) tuples or None
    if bounds is not None and s_new.shape[0]:
        # per-substep scalar clipping (reference DNS_BOUNDS_LIMIT,
        # dns_local.f90:67-90, called each substep from TIME_RUNGEKUTTA)
        mins, maxs = bounds
        lo = jnp.asarray(mins, s_new.dtype)[:, None, None, None]
        hi = jnp.asarray(maxs, s_new.dtype)[:, None, None, None]
        s_new = jnp.clip(s_new, lo, hi)
    sfc = state.sfc
    if s_new.shape[0]:
        s_new, sfc = surface_bc_step(P, state.s, s_new, sfc, dte)
    state = State(u=state.u + dte * hq[0],
                  v=state.v + dte * hq[1],
                  w=state.w + dte * hq[2],
                  s=s_new, sfc=sfc)
    if P.get("ibm") is not None:
        # direct forcing: zero state in solids after the substep
        # (reference dns_main.f90:254-257)
        from tlab_tpu import ibm as ibmmod
        state = ibmmod.apply_ibm_state(P["ibm"], state, comm=P.get("comm"))
    hq = (kco_i * hq[0], kco_i * hq[1], kco_i * hq[2])
    hs = kco_i * hs
    return state, hq, hs, p


def rk_step(P, state: State, dtime, aux=None):
    """One full low-storage RK step; returns (new_state, last pressure).

    The substep loop is a lax.scan over the (kdt, kco) tables so the
    compiled graph holds ONE substep body regardless of the scheme's stage
    count (5x smaller HLO for RK4-5).  Inlining the five substeps instead
    ran the 512x256x256 fp32 step in 146.3 vs 147.1 ms on an H100 (400 W)
    and took 12.5 vs 5.0 s to compile (`python chip_study.py unroll`), so
    the scan is the only form.
    """
    kdt = P["rk"]["kdt"]
    kco = P["rk"]["kco"]
    state = _enforce_wall_values(P, state)
    if P.get("surface_bc") is not None and state.sfc is None \
            and state.s.shape[0]:
        ns_, nx_, _, nz_ = state.s.shape
        state = state._replace(sfc=jnp.zeros((2, ns_, nx_, nz_),
                                             state.s.dtype))
    # stacked-carry fast path: the prognostic fields and tendencies ride
    # as single (3+ns, ...) arrays through the substeps (no per-substep
    # field concatenate); component-structured hooks that need the tuple
    # form (IBM direct forcing, interactive surface BC) keep the
    # original path -- arithmetic is elementwise-identical either way
    if P.get("ibm") is None and P.get("surface_bc") is None:
        return _rk_step_stacked(P, state, dtime, kdt, kco, aux)
    z = jnp.zeros_like(state.u)
    hq = (z, z, z)
    hs = jnp.zeros_like(state.s)
    kdt_a = jnp.asarray(kdt, state.u.dtype)
    kco_a = jnp.asarray(tuple(kco) + (0.0,), state.u.dtype)[: len(kdt)]

    def body(carry, ks):
        state, hq, hs, _ = carry
        k, kco_i = ks
        state, hq, hs, p = _rk_substep(P, state, hq, hs, dtime * k,
                                       kco_i, aux=aux)
        return (state, hq, hs, p), None

    p0 = jnp.zeros_like(state.u)
    (state, hq, hs, p), _ = jax.lax.scan(body, (state, hq, hs, p0),
                                         (kdt_a, kco_a))
    return state, p


def rk_loop_stacked(P, state: State, dtime, n_steps: int, aux=None):
    """n_steps full RK steps with the State<->stacked conversion done
    ONCE per dispatch (the per-step concatenate/split otherwise costs
    ~0.65 GB/substep at the bench size).  Same eligibility as the
    rk_step stacked path; falls back to per-step rk_step otherwise.
    Returns (state, last p)."""
    if not (P.get("ibm") is None and P.get("surface_bc") is None):
        def body(i, c):
            st, _ = c
            return rk_step(P, st, dtime, aux=aux)
        return jax.lax.fori_loop(0, n_steps, body,
                                 (state, jnp.zeros_like(state.u)))
    state = _enforce_wall_values(P, state)
    Q0 = jnp.concatenate([state.u[None], state.v[None], state.w[None],
                          state.s], axis=0)
    kdt = P["rk"]["kdt"]
    kco = P["rk"]["kco"]

    def body(i, c):
        Q, _ = c
        Q, p = _rk_core_stacked(P, Q, dtime, kdt, kco, aux)
        return Q, p

    Q, p = jax.lax.fori_loop(0, n_steps, body,
                             (Q0, jnp.zeros_like(Q0[0])))
    return State(u=Q[0], v=Q[1], w=Q[2], s=Q[3:], sfc=state.sfc), p


def _rk_step_stacked(P, state: State, dtime, kdt, kco, aux):
    """rk_step body on the stacked carry (substep_rhs_stacked)."""
    Q = jnp.concatenate([state.u[None], state.v[None], state.w[None],
                         state.s], axis=0)
    Q, p = _rk_core_stacked(P, Q, dtime, kdt, kco, aux)
    return State(u=Q[0], v=Q[1], w=Q[2], s=Q[3:], sfc=state.sfc), p


def _rk_core_stacked(P, Q, dtime, kdt, kco, aux):
    H0 = jnp.zeros_like(Q)
    bounds = P.get("scal_bounds")

    def one(Q, H, dte, kco_i):
        H, p = substep_rhs_stacked(P, Q, H, dte, aux=aux)
        Q = Q + dte * H
        if bounds is not None and Q.shape[0] > 3:
            # per-substep scalar clipping (reference DNS_BOUNDS_LIMIT,
            # dns_local.f90:67-90)
            mins, maxs = bounds
            lo = jnp.asarray(mins, Q.dtype)[:, None, None, None]
            hi = jnp.asarray(maxs, Q.dtype)[:, None, None, None]
            Q = Q.at[3:].set(jnp.clip(Q[3:], lo, hi))
        return Q, kco_i * H, p

    kdt_a = jnp.asarray(kdt, Q.dtype)
    kco_a = jnp.asarray(tuple(kco) + (0.0,), Q.dtype)[: len(kdt)]

    def body(carry, ks):
        Q, H, _ = carry
        k, kco_i = ks
        Q, H, p = one(Q, H, dtime * k, kco_i)
        return (Q, H, p), None

    p0 = jnp.zeros_like(Q[0])
    (Q, H, p), _ = jax.lax.scan(body, (Q, H0, p0), (kdt_a, kco_a))
    return Q, p


# ---------------------------------------------------------------------------
# Diagnostics for the step log / adaptive dt
# ---------------------------------------------------------------------------

def cfl_advective_max(P, state: State):
    """max(|u|/dx + |v|/dy + |w|/dz), cf. reference TIME_COURANT."""
    acc = 0.0
    if "iodx" in P:
        acc = acc + jnp.abs(state.u) * P["iodx"][:, None, None]
    if "iody" in P:
        acc = acc + jnp.abs(state.v) * P["iody"][None, :, None]
    if "iodz" in P:
        acc = acc + jnp.abs(state.w) * P["iodz"][None, None, :]
    return jnp.max(acc)


def dilatation_minmax(P, state: State):
    """Dilatation extrema for the dns.out log / bounds control. Anelastic
    runs monitor the CONSTRAINT residual div(rho_bar u) -- the reference
    weights the velocity by rbackground before FI_INVARIANT_P
    (dns_local.f90:158-166) -- so a healthy anelastic run logs round-off,
    not the physical div(u) = -v dlnrho/dy."""
    ane = P.get("anelastic")
    div = divergence_staggered if P.get("stag") is not None else divergence
    if ane is not None:
        r = ane["rho"][None, :, None]
        d = div(P, state.u * r, state.v * r, state.w * r)
    else:
        d = div(P, state.u, state.v, state.w)
    return jnp.min(d), jnp.max(d)


def next_dt(P, cfl_max_value, cfla, cfld):
    """Host-side dt selection (reference TIME_COURANT final ops); the
    diffusion limit applies only to fully explicit schemes
    (time.f90:530-534, RKM_EXP3/EXP4). A semi-implicit run starting
    from REST (cfl max 0) still needs a finite dt, so the diffusion
    limit serves as the cold-start fallback."""
    dtc = cfla / cfl_max_value if cfl_max_value > 0 else np.inf
    dconst = P["diffusion_constant"]
    dtd = cfld / dconst if dconst > 0 else np.inf
    if not P["rk"].get("explicit_diffusion", True):
        return dtc if np.isfinite(dtc) else dtd
    return min(dtc, dtd)
