"""Factorized Poisson solver: two first-order compact integrals per mode
(the reference's default TYPE_FACTORIZE, opr_elliptic.f90:263-364;
Mellado & Ansorge 2012, ZAMM), reference-exact.

For each horizontal mode with kappa = sqrt(lambda) (lambda from the D1
modified wavenumbers), p'' - kappa^2 p = f is factored into two sweeps
    (D + kappa) v = f   with v_1 given,
    (D - kappa) p = v   with p_N given,
each solved with the compact D1 system itself. The reference's Int1 sweep
(fdm_integral.f90 FDM_Int1_CreateSystem/Solve) is mathematically: enforce
ALL N scheme rows of (B +- kappa A) u = A f~ while leaving the boundary
forcing slot f~ at the bc end FREE (that row *defines* it -- the Poisson
driver stores boundary-condition values there, planes.f90... opr_elliptic
.f90:285-286) plus the boundary value of u given.  We therefore solve the
augmented lambda-affine system

    [ B + kappa A   -A e_b ] [u ]   [ A|_drop-col-b  f ]
    [    e_b^T         0   ] [ft] = [       bc         ]

per mode -- an (ny+1) pencil diagonalized ONCE (complex eigen) and applied
to all modes as batched matmuls, exactly like the direct eigen
solver.  The recovered ft gives the reference's du_boundary:
u'_b = ft - lambda_plan u_b (identical by the scheme's row b).

On top of the sweeps, OPR_ODE2_Factorize_NN/DD + the _Sing variants
(opr_odes.f90:266-480,37-260) superpose homogeneous responses
(em, v1, u1, sp, ep) and close with the reference's exact 3x3 (NN) or
2x2 (DD) constraint systems, including the free top-forcing unknown fn.
This reproduces the reference's wall-row behavior bit-for-bit at the
truncation level: divergence is removed to round-off in the INTERIOR
(A-row contamination decays exponentially from the walls), with the same
O(0.1->0.001) decaying near-wall dilatation signature the reference logs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from tlab_tpu.fdm.plan import DerivPlan, FdmPlan
from tlab_tpu.ops.derivative import op_precision


def _ell_precision(is_f32: bool):
    """The eigen-pencil recombinations carry cond(V) up to ~1e7: any
    reduced-precision pass (TF32, or a split into bf16 passes) amplifies
    its ~1e-4 product error into garbage/NaN here, so the elliptic modal
    einsums always run HIGHEST (plain fp32) for f32, whatever the
    operator precision (op_precision)."""
    import jax
    return jax.lax.Precision.HIGHEST if is_f32 else None


# ---------------------------------------------------------------------------
# Int1 pencils (legacy helper kept for the grid builder's cumulative
# integral, grid.py:101)
# ---------------------------------------------------------------------------

def build_int1_pencil(plan_y: DerivPlan, end: str):
    """(M0, M1, R) for u' + kappa u = f with u given at `end` ('min'/'max');
    wall-forcing column eliminated with the dropped biased row."""
    A, B = plan_y.A1, plan_y.B1
    n = plan_y.size
    Bi, Ai, Ri = B.copy(), A.copy(), A.copy()
    M0 = np.zeros((n, n))
    M1 = np.zeros((n, n))
    R = np.zeros((n, n))
    if end == "min":
        c = Ai[1:, 0] / A[0, 0]
        Bi[1:] -= np.outer(c, B[0])
        Ri[1:] -= np.outer(c, A[0])
        Ai[1:] -= np.outer(c, A[0])
        M0[1:] = Bi[1:]
        M1[1:] = Ai[1:]
        R[1:] = Ri[1:]
        R[1:, 0] = 0.0
        M0[0, 0] = 1.0
        R[0, 0] = 1.0
    else:
        c = Ai[:-1, -1] / A[-1, -1]
        Bi[:-1] -= np.outer(c, B[-1])
        Ri[:-1] -= np.outer(c, A[-1])
        Ai[:-1] -= np.outer(c, A[-1])
        M0[:-1] = Bi[:-1]
        M1[:-1] = Ai[:-1]
        R[:-1] = Ri[:-1]
        R[:-1, -1] = 0.0
        M0[-1, -1] = 1.0
        R[-1, -1] = 1.0
    return M0, M1, R


# ---------------------------------------------------------------------------
# Augmented reference-exact sweep pencils
# ---------------------------------------------------------------------------

def _ft_rows(plan_y: DerivPlan, end: str):
    """Recovery data for the sweep's free boundary forcing ft.

    The bc-end scheme row of (B + t A) u = A f~ DEFINES the boundary
    forcing (fdm_integral.f90 keeps that row out of the solve); given the
    solved u and the supplied interior f,
        ft = (B_b . u + t (A_b . u) - sum_{j!=b} A_bj f_j) / A_bb,
    which yields the reference's du_boundary: u'_b = ft - t u_b."""
    A, B = plan_y.A1, plan_y.B1
    n = plan_y.size
    b = 0 if end == "min" else n - 1
    rAf = A[b].copy()
    rAf[b] = 0.0
    return {"rB": B[b] / A[b, b], "rA": A[b] / A[b, b],
            "rAf": rAf / A[b, b]}


def _eigen(M0, M1, R, shift):
    """Eigen data for x = V [(W r)/(1 + (t - shift) lam)] solving
    (M0 + t M1) x = R r -- spectra are genuinely complex (D1 pencil)."""
    Ms = M0 + shift * M1
    K = np.linalg.solve(Ms, M1)
    lam, V = np.linalg.eig(K)
    return {"V": V, "W": np.linalg.inv(V) @ np.linalg.solve(Ms, R),
            "lam": lam, "cond": float(np.linalg.cond(V))}


@dataclasses.dataclass(frozen=True)
class FactorizePlan:
    ny: int
    shift: float
    emin: dict                  # eigen data, 'min' sweep (t = +kappa)
    emax: dict                  # eigen data, 'max' sweep (t = -kappa)
    kappa: np.ndarray           # (nkx, nz) per-mode sqrt(lambda)
    sing: np.ndarray            # (nkx, nz) bool: reference singular modes
    sing_idx: tuple             # static ((i,k), ...) of singular modes


def build_factorize_plan(fdm: FdmPlan, shift: float = 1.0,
                         mwn_x=None, mwn_z=None,
                         sing_idx=None) -> FactorizePlan:
    """mwn_x/mwn_z override the horizontal modified wavenumbers (rfft
    ordering for x, full-fft ordering for z).  Singular modes follow the
    reference's INDEX sets i_sing = {0, nx/2} x k_sing = {0, nz/2}
    (opr_elliptic.f90:204-208); the staggered pressure grid passes
    sing_idx=((0,0),) (only one singular mode, :144-147)."""
    plan_y = fdm.y
    emin = _eigen(*build_int1_pencil(plan_y, "min"), shift)
    emax = _eigen(*build_int1_pencil(plan_y, "max"), -shift)
    emin.update({k + "_ft": v for k, v in _ft_rows(plan_y, "min").items()})
    emax.update({k + "_ft": v for k, v in _ft_rows(plan_y, "max").items()})

    nx = fdm.x.size
    nz = fdm.z.size
    custom = mwn_x is not None or mwn_z is not None
    if mwn_x is None:
        mwn_x = fdm.x.mwn1[: nx // 2 + 1] if fdm.x.periodic else np.zeros(1)
    if mwn_z is None:
        mwn_z = fdm.z.mwn1 if nz > 1 else np.zeros(1)
    lam = mwn_x[:, None] ** 2 + mwn_z[None, :] ** 2
    kappa = np.sqrt(lam)
    nkx, nzm = kappa.shape
    if sing_idx is None:
        if custom:
            sing_idx = ((0, 0),)
        else:
            i_sing = [0] + ([nx // 2] if nkx > nx // 2 else [])
            k_sing = [0] + ([nz // 2] if nz > 1 else [])
            # the reference index set {0, n/2} assumes EVEN grids, where
            # the compact scheme's modified wavenumber vanishes exactly
            # at Nyquist; on odd axes n//2 is a regular mode and the
            # singular override would corrupt (then blow up) the
            # projection -- keep only modes whose kappa is truly ~0
            tol = 1e-8 * max(kappa.max(), 1.0)
            sing_idx = tuple((i, k) for i in i_sing for k in k_sing
                             if kappa[i, k] < tol)
    sing = np.zeros((nkx, nzm), bool)
    for (i, k) in sing_idx:
        sing[i, k] = True
    return FactorizePlan(ny=plan_y.size, shift=shift, emin=emin, emax=emax,
                         kappa=kappa, sing=sing, sing_idx=tuple(sing_idx))


def device_factorize_plan(plan: FactorizePlan, dtype=jnp.float32) -> dict:
    """Host-side plan dict; the complex eigen matrices are host numpy
    arrays that the solver folds into the step as constants."""
    kap = plan.kappa.astype(np.float64)
    nkx, nz = kap.shape

    from tlab_tpu.ops.elliptic import _transform_mode
    dft = None
    if _transform_mode() == "matmul":
        from tlab_tpu.ops import rdft
        dft = rdft.device_rdft_plan(2 * (nkx - 1), nz, dtype)
    np_c = np.complex64 if dtype == jnp.float32 else np.complex128
    d = {
        "Vmin": np.asarray(plan.emin["V"], np_c),
        "Wmin": np.asarray(plan.emin["W"], np_c),
        "Vmax": np.asarray(plan.emax["V"], np_c),
        "Wmax": np.asarray(plan.emax["W"], np_c),
        "lam_min": np.asarray(plan.emin["lam"], np_c),
        "lam_max": np.asarray(plan.emax["lam"], np_c),
        "shift": float(plan.shift),
        "kappa": np.asarray(kap, np.dtype(jnp.dtype(dtype))),
        "sing": np.asarray(plan.sing),
        "sing_idx": plan.sing_idx,
        "ny": plan.ny,
    }
    for side, e in (("min", plan.emin), ("max", plan.emax)):
        for r in ("rB_ft", "rA_ft", "rAf_ft"):
            d[f"{r}_{side}"] = np.asarray(e[r], np.float64)
    if dft is not None:
        d["dft"] = dft
    return d


# ---------------------------------------------------------------------------
# Modal sweeps
# ---------------------------------------------------------------------------

def _modal_solve(V, W, dnm, rhs):
    """x = V [(W rhs) / dnm] batched over modes; rhs (nkx, n+1, nz)."""
    prec = _ell_precision(rhs.dtype == jnp.complex64)
    G = jnp.einsum("ab,kbz->kaz", W, rhs.astype(W.dtype), precision=prec)
    G = G / jnp.moveaxis(dnm, 0, 1)
    return jnp.einsum("ab,kbz->kaz", V, G,
                      precision=prec).astype(rhs.dtype)


def build_tables(dev: dict, cd=None, kap=None):
    """Per-mode denominators + the five homogeneous responses of the
    ODE2 composition (opr_odes.f90:266-380):
      em : 'min' response to bc = 1 (the discrete e^-)
      v1 : 'min' response to f_N = 1 (free-top-forcing route)
      u1 : 'max' response to rhs = v1, bc = 0
      sp : 'max' response to rhs = em, bc = 0 (the discrete s^+)
      ep : 'max' response to bc = 1 (the discrete e^+)
    plus the max-sweep boundary derivatives du1_n/dsp_n/dep_n recovered
    from the bc-end scheme row.  Jit once at setup; the tables are
    (ny, nkx, nz) -- too large for jit constants."""
    if cd is None:
        cd = jnp.complex64 if dev["kappa"].dtype == jnp.float32 \
            else jnp.complex128
    if kap is None:
        kap = dev["kappa"]
    kap = jnp.asarray(kap).astype(cd)                      # (nkx,nz)
    kl = kap[None, :, :]                                   # (1,nkx,nz)
    shift = dev["shift"]
    dmin = 1.0 + (kl - shift) * jnp.asarray(dev["lam_min"],
                                            cd)[:, None, None]
    dmax = 1.0 + (-kl + shift) * jnp.asarray(dev["lam_max"],
                                             cd)[:, None, None]
    Vmin = jnp.asarray(dev["Vmin"], cd)
    Wmin = jnp.asarray(dev["Wmin"], cd)
    Vmax = jnp.asarray(dev["Vmax"], cd)
    Wmax = jnp.asarray(dev["Wmax"], cd)
    prec = _ell_precision(cd == jnp.complex64)
    ny = dev["ny"]

    def s_col(V, W, dnm, col):
        return jnp.einsum("ab,bkz->akz", V,
                          W[:, col][:, None, None] / dnm, precision=prec)

    def s_of(V, W, dnm, vec, bslot):
        v = vec.at[bslot, :, :].set(0.0)       # bc = 0 on the forcing route
        G = jnp.einsum("ab,bkz->akz", W, v, precision=prec)
        return jnp.einsum("ab,bkz->akz", V, G / dnm, precision=prec), v

    em = s_col(Vmin, Wmin, dmin, 0)            # bc = 1 ('min' slot 0)
    v1 = s_col(Vmin, Wmin, dmin, ny - 1)       # f_N = 1
    ep = s_col(Vmax, Wmax, dmax, ny - 1)       # bc = 1 ('max' slot N)
    u1, v1f = s_of(Vmax, Wmax, dmax, v1, ny - 1)
    sp, emf = s_of(Vmax, Wmax, dmax, em, ny - 1)

    # max-sweep boundary forcing ft -> u'_N = ft - t u_N with t = -kappa
    rB = jnp.asarray(dev["rB_ft_max"], cd)
    rA = jnp.asarray(dev["rA_ft_max"], cd)
    rAf = jnp.asarray(dev["rAf_ft_max"], cd)

    def ft_max(u, f):
        return (jnp.einsum("a,akz->kz", rB, u, precision=prec)
                - kap * jnp.einsum("a,akz->kz", rA, u, precision=prec)
                - jnp.einsum("a,akz->kz", rAf, f, precision=prec))

    du1_n = ft_max(u1, v1f)                    # u1_N = 0 (bc)
    dsp_n = ft_max(sp, emf)
    dep_n = ft_max(ep, jnp.zeros_like(em)) + kap   # ep_N = 1 (bc)

    # all-real pytree: the homogeneous responses of the real ODE are real
    # (their imaginary parts are round-off); the denominators keep both
    out = {"dmin_re": jnp.real(dmin), "dmin_im": jnp.imag(dmin),
           "dmax_re": jnp.real(dmax), "dmax_im": jnp.imag(dmax)}
    for name, t in (("em", em), ("v1", v1), ("u1", u1), ("sp", sp),
                    ("ep", ep), ("du1_n", du1_n), ("dsp_n", dsp_n),
                    ("dep_n", dep_n)):
        out[name] = jnp.real(t)
    return out


def materialize_tables(dev: dict):
    """build_tables as one jitted device computation; the result rides
    into the step as a traced argument.  A failure raises."""
    return jax.jit(lambda: build_tables(dev))()


def sing_column(dev: dict, fcol, gbs, gts, ibc: str = "nn",
                mean_mode: bool = False):
    """Reference singular-mode (kappa = 0) column solve: NN via
    DN_Sing(gb=0), DD via DD_Sing (opr_odes.f90:37-100,188-260).

    fcol: (ny,) complex forcing column; gbs/gts scalars.
    Returns (u, v) columns.  The kappa=0 sweep denominators are
    mode-independent (1 -+ shift*lam), so no per-mode tables needed."""
    cd = fcol.dtype
    ny = dev["ny"]
    Vmin = jnp.asarray(dev["Vmin"], cd)
    Wmin = jnp.asarray(dev["Wmin"], cd)
    Vmax = jnp.asarray(dev["Vmax"], cd)
    Wmax = jnp.asarray(dev["Wmax"], cd)
    shift = dev["shift"]
    dmin0 = (1.0 - shift * jnp.asarray(dev["lam_min"], cd))[:, None, None]
    dmax0 = (1.0 + shift * jnp.asarray(dev["lam_max"], cd))[:, None, None]
    rB0_min = jnp.asarray(dev["rB_ft_min"], cd)
    rAf0_min = jnp.asarray(dev["rAf_ft_min"], cd)
    rB0_max = jnp.asarray(dev["rB_ft_max"], cd)
    rAf0_max = jnp.asarray(dev["rAf_ft_max"], cd)

    def smin0(fv, bc):
        rhs = fv.at[0].set(bc)[None, :, None]
        x = _modal_solve(Vmin, Wmin, dmin0, rhs)
        return x[0, :, 0], rhs[0, :, 0]

    def smax0(fv, bc):
        rhs = fv.at[ny - 1].set(bc)[None, :, None]
        x = _modal_solve(Vmax, Wmax, dmax0, rhs)
        return x[0, :, 0], rhs[0, :, 0]

    one = jnp.asarray(1.0, cd)
    zero0 = jnp.asarray(0.0, cd)
    zcol = jnp.zeros(ny, cd)
    if ibc == "nn":
        import os
        if os.environ.get("TLAB_TPU_SING_MODE", "reference") == "legacy":
            # upward-integration convention: v0 from the MIN sweep
            # (v(0) = 0), shifted by the constant homogeneous mode to
            # hit v(N) = gts, then u integrated down with u(N) = 0.
            # Places the singular mode's compatibility defect at the
            # BOTTOM slot, which keeps the logged dilatation of the
            # cloud-top-forced stratocumulus family within ~1.6x of the
            # reference's (the default literal DN_Sing order deposits it
            # at the TOP row, where those cases force at O(1) and the
            # residual shows as a ~0.05 absolute DilMin band).  The
            # default stays 'reference' because it reproduces Case01's
            # dns.out to every printed digit.
            v0s, _ = smin0(fcol.at[ny - 1].set(0.0), zero0)
            vs = v0s + (gts - v0s[ny - 1])
            us, _ = smax0(vs, zero0)
            return us, vs
        # literal reference NN_Sing -> DN_Sing(gb=0)
        # (opr_odes.f90:170-185,37-100): v' = f with v_N = gts (max
        # sweep), then u' = v with u_1 = 0 (min sweep); constraint
        # adjusts the free bottom forcing f_1 of the max sweep
        v0s, _ = smax0(fcol.at[0].set(0.0), gts)
        v1s, _ = smax0(zcol.at[0].set(one), zero0)
        u0s, r0 = smin0(v0s, zero0)
        u1s, r1 = smin0(v1s, zero0)
        du0 = jnp.sum(rB0_min * u0s) - jnp.sum(rAf0_min * r0)  # u'_1 = ft
        du1 = jnp.sum(rB0_min * u1s) - jnp.sum(rAf0_min * r1)
        coef = (v0s[0] - du0) / (du1 - v1s[0])
        return u0s + coef * u1s, v0s + coef * v1s
    # DD_Sing: v' = f with v_1 = 0 (min sweep), u' = v with u_N = gts
    # (max sweep) + s^+ correction for u_1 = gbs
    v0s, _ = smin0(fcol.at[ny - 1].set(0.0), zero0)
    v1s, _ = smin0(zcol.at[ny - 1].set(one), zero0)
    u0s, r0 = smax0(v0s, gts)
    u1s, r1 = smax0(v1s, zero0)
    sps, _ = smax0(jnp.ones(ny, cd), zero0)
    du0 = jnp.sum(rB0_max * u0s) - jnp.sum(rAf0_max * r0)      # u'_N = ft
    du1 = jnp.sum(rB0_max * u1s) - jnp.sum(rAf0_max * r1)
    coef = (v0s[ny - 1] - du0) / (du1 - v1s[ny - 1])
    q1s = (gbs - (u0s[0] + coef * u1s[0])) / sps[0]
    us = (u0s + coef * u1s + q1s * sps).at[0].set(gbs)
    vs = v0s + coef * v1s + q1s
    return us, vs


def solve_modal_factorize(dev: dict, f_hat, gb, gt, tables=None,
                          ibc: str = "nn", kap=None, sing_idx=None):
    """p and dpdy per mode for p'' - kappa^2 p = f (reference
    OPR_ODE2_Factorize_NN/DD + _Sing, opr_odes.f90).

    f_hat: (nkx, ny, nz) complex; gb/gt: (nkx, nz) complex boundary values
    (Neumann p' for 'nn', Dirichlet p for 'dd').
    Returns (p_hat, dpdy_hat); dpdy is the composition's v + kappa*p --
    the stage derivative the reference's RK substep consumes.
    """
    cd = f_hat.dtype
    ny = dev["ny"]
    if kap is None:
        kap = dev["kappa"]
    if sing_idx is None:
        sing_idx = dev["sing_idx"]
    kap = jnp.asarray(kap).astype(cd)                      # (nkx,nz)
    kap3 = kap[:, None, :]                                 # (nkx,1,nz)
    if tables is None:
        tables = build_tables(dev, cd, kap=kap)
    dmin = jax.lax.complex(tables["dmin_re"], tables["dmin_im"]).astype(cd)
    dmax = jax.lax.complex(tables["dmax_re"], tables["dmax_im"]).astype(cd)
    Vmin = jnp.asarray(dev["Vmin"], cd)
    Wmin = jnp.asarray(dev["Wmin"], cd)
    Vmax = jnp.asarray(dev["Vmax"], cd)
    Wmax = jnp.asarray(dev["Wmax"], cd)
    prec = _ell_precision(cd == jnp.complex64)

    em = jnp.moveaxis(tables["em"], 0, 1).astype(cd)       # (nkx,ny,nz)
    v1 = jnp.moveaxis(tables["v1"], 0, 1).astype(cd)
    u1 = jnp.moveaxis(tables["u1"], 0, 1).astype(cd)
    sp = jnp.moveaxis(tables["sp"], 0, 1).astype(cd)
    ep = jnp.moveaxis(tables["ep"], 0, 1).astype(cd)
    du1_n = tables["du1_n"].astype(cd)
    dsp_n = tables["dsp_n"].astype(cd)
    dep_n = tables["dep_n"].astype(cd)

    rB = jnp.asarray(dev["rB_ft_max"], cd)
    rA = jnp.asarray(dev["rA_ft_max"], cd)
    rAf = jnp.asarray(dev["rAf_ft_max"], cd)

    zero = jnp.zeros_like(gb)

    # stage 1 (min sweep): v0 with f_N <- 0, bc v_1 = 0
    rhs1 = f_hat.at[:, ny - 1, :].set(0.0).at[:, 0, :].set(0.0)
    v0 = _modal_solve(Vmin, Wmin, dmin, rhs1)

    # stage 2 (max sweep): u0 with bc u_N = 0 ('nn') or gt ('dd')
    bc2 = zero if ibc == "nn" else gt
    rhs2s = v0.at[:, ny - 1, :].set(bc2)
    u0 = _modal_solve(Vmax, Wmax, dmax, rhs2s)

    # u'_N of stage 2 from the bc-end scheme row (du_boundary)
    ft0 = (jnp.einsum("a,kaz->kz", rB, u0, precision=prec)
           - kap * jnp.einsum("a,kaz->kz", rA, u0, precision=prec)
           - jnp.einsum("a,kaz->kz", rAf, rhs2s, precision=prec))
    du0_n = ft0 + kap * bc2

    # the kappa = 0 modes (exactly the reference's singular index set for
    # mwn-based kappa) are guarded against 0/0 here and overwritten by
    # sing_column below
    sing = jnp.real(kap) <= 0.0

    def safe(x):
        return jnp.where(sing, jnp.ones_like(x), x)

    if ibc == "nn":
        # reference 3x3 closure over (q1 = v_1, uN, fn) -- exact LU order
        # (opr_odes.f90:330-358)
        a11 = 1.0 + kap * sp[:, 0, :]
        a21 = em[:, ny - 1, :]
        a31 = dsp_n
        a12 = kap * ep[:, 0, :]
        a22 = kap
        a32 = dep_n
        a13 = kap * u1[:, 0, :]
        a23 = v1[:, ny - 1, :]
        a33 = du1_n

        a12 = a12 / safe(a11)
        a22 = a22 - a21 * a12
        a32 = a32 - a31 * a12
        a13 = a13 / safe(a11)
        a23 = (a23 - a21 * a13) / safe(a22)
        a33 = a33 - a31 * a13 - a32 * a23

        q1 = (gb - kap * u0[:, 0, :]) / safe(a11)
        uN = (gt - v0[:, ny - 1, :] - a21 * q1) / safe(a22)
        fn = (gt - du0_n - a31 * q1 - a32 * uN) / safe(a33)
        uN = uN - a23 * fn
        q1 = q1 - a12 * uN - a13 * fn

        # uniform superposition: u0_N = u1_N = sp_N = 0 (bc rows) and
        # ep_N = 1, so row N reduces to the solved uN, matching the
        # reference's explicit i = nx handling
        u = u0 + fn[:, None, :] * u1 + q1[:, None, :] * sp \
            + uN[:, None, :] * ep
        v = v0 + fn[:, None, :] * v1 + q1[:, None, :] * em + kap3 * u
    else:
        # reference DD closure over (q1 = v_1, fn) (opr_odes.f90:452-466)
        aa = du1_n - v1[:, ny - 1, :]
        bb = dsp_n - em[:, ny - 1, :]
        det = safe(aa * sp[:, 0, :] - bb * u1[:, 0, :])
        rhs_c = kap * gt - du0_n + v0[:, ny - 1, :]
        q1 = (aa * (gb - u0[:, 0, :]) - u1[:, 0, :] * rhs_c) / det
        fn = (sp[:, 0, :] * rhs_c - bb * (gb - u0[:, 0, :])) / det

        u = u0 + fn[:, None, :] * u1 + q1[:, None, :] * sp
        u = u.at[:, 0, :].set(gb)
        v = v0 + fn[:, None, :] * v1 + q1[:, None, :] * em + kap3 * u

    # ---- reference singular modes (kappa = 0 at {0,Nyq} x {0,Nyq}) ----
    for (i, k) in sing_idx:
        gbs = zero[i, k] if ibc == "nn" else gb[i, k]
        mean_mode = (i == 0 and k == 0)
        us, vs = sing_column(dev, f_hat[i, :, k], gbs, gt[i, k], ibc,
                             mean_mode=mean_mode)
        u = u.at[i, :, k].set(us)
        v = v.at[i, :, k].set(vs)

    return u, v


def poisson_factorize(dev: dict, f, bcs_b=None, bcs_t=None,
                      tables=None, ibc: str = "nn"):
    """Physical-space Poisson via the factorized modal solver.

    Returns (p, dpdy); dpdy is the stage-consistent first derivative --
    the reference's OPR_Poisson dpdy output (opr_elliptic.f90:336)."""
    nx, ny, nz = f.shape
    zero = jnp.zeros((nx, nz), f.dtype)
    gb_phys = zero if bcs_b is None else bcs_b
    gt_phys = zero if bcs_t is None else bcs_t

    dft = dev.get("dft")

    def fwd(a):
        if dft is not None and a.shape[0] == dft["Cx"].shape[1]:
            from tlab_tpu.ops import rdft
            re, im = rdft.forward_parts(dft, a)
            return re + 1j * im
        ah = jnp.fft.rfft(a, axis=0)
        return jnp.fft.fft(ah, axis=-1) if nz > 1 else ah

    def bwd(ah):
        if dft is not None and ah.dtype != f.dtype:
            from tlab_tpu.ops import rdft
            return rdft.backward_parts(dft, jnp.real(ah), jnp.imag(ah))
        if nz > 1:
            ah = jnp.fft.ifft(ah, axis=-1)
        return jnp.fft.irfft(ah, n=nx, axis=0)

    f_hat = fwd(f)
    gb = fwd(gb_phys[:, None, :])[:, 0, :]
    gt = fwd(gt_phys[:, None, :])[:, 0, :]
    p_hat, dpdy_hat = solve_modal_factorize(dev, f_hat, gb, gt,
                                            tables=tables, ibc=ibc)
    return bwd(p_hat).astype(f.dtype), bwd(dpdy_hat).astype(f.dtype)
