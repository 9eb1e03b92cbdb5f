"""Infrared radiation: 1-D two-stream RTE along y
(reference src/physics/radiation.f90).

Three formulations, matching the reference's types:

- grayliquid (IR_RTE1_OnlyLiquid, radiation.f90:401-444): absorption-only,
  a = kappa rho_bar q_l; no mean-direction factor, no emission.
- gray (IR_RTE1_Incremental/Global, radiation.f90:448-712): emission
  b = sigma T^4, absorption a = rho_bar (kappa_l ql + kappa_v qv + kappa_g)
  divided by the mean direction mu = (1/sqrt(3)+1/sqrt(2))/2
  (radiation.f90:204), incremental level-to-level flux recurrences.
- band (TYPE_IR_BAND, radiation.f90:322-372): per-band absorption tables
  kappa(comp, band) and quadratic-in-T emission fractions beta(:, band),
  per-band top fluxes; band sources add.

The level recurrences F(j) = T(j) F(j+1) + 0.5 dy (ab_j + T(j) ab_{j+1})
are linear scans along y (lax.scan with (nx, nz)-vector carries); written
WITHOUT any exp(+tau) factor so optically thick layers cannot overflow in
f32 (the reference's f64 form divides by the transmission, radiation.f90:
493-496, algebraically identical).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

# mean direction of the two-stream closure, in (1/sqrt(3), 1/sqrt(2))
# (reference radiation.f90:204)
MU_REFERENCE = 0.5 * (1.0 / np.sqrt(3.0) + 1.0 / np.sqrt(2.0))

# Stefan-Boltzmann constant, W/m^2/K^4 (radiation.f90:57); the gray/band
# emission b = sigma T^4 is dimensional in the reference (those types are
# only exercised with [Thermodynamics] Nondimensional=no)
SIGMA = 5.67037442e-8

# default Jeevanjee (2023) emission-fraction polynomials for the first two
# vapor bands (reference radiation.f90:142-143); the last band is derived
# from sum_b beta_b(T) = 1
BETA_DEFAULT_BAND1 = (2.6774e-1, -1.3344e-3, 1.8017e-6)
BETA_DEFAULT_BAND2 = (-2.2993e-2, 8.7439e-5, 1.4744e-7)


@dataclasses.dataclass(frozen=True)
class RadiationProps:
    type: str = "none"            # none | grayliquid | gray | band
    scalar: int = 0               # index of the heated scalar (h)
    ql_scalar: int = -1           # index of liquid-water scalar; -1 => diagnostic
    kappa: float = 1.0            # liquid mass absorption coefficient (nondim)
    kappa_v: float = 0.0          # vapor absorption (gray variant)
    kappa_g: float = 0.0          # background-gas absorption (gray variant)
    beta: float = 1.0             # emission scale (sigma T_ref^4 nondim)
    emissivity: float = 1.0       # surface emissivity at ymin
    flux_top: float = 1.0         # downward flux at ymax
    flux_bottom: float = 0.0      # upward flux at ymin (grayliquid only)
    mu: float = MU_REFERENCE      # mean direction (gray/band; 1 to disable)
    # band variant (reference-layout tables)
    nbands: int = 1
    kappa_table: tuple = ()       # (ncomps, nbands) rows = (liquid,vapor,const)
    beta_table: tuple = ()        # (nbands, 3) per-band polynomial coeffs
    bcs_top: tuple = ()           # (nbands,) downward fluxes at ymax


def derive_band_tables(bcs_list, absorption_components, beta_rows):
    """Reference [Infrared] parsing layout (radiation.f90:117-163):

    - bcs_list: the BoundaryConditions values; the LAST is the surface
      emissivity, the first nbands are per-band downward top fluxes.
    - absorption_components: list over components c=1.. of per-band kappa
      lists (AbsorptionComponent<c>), each of length nbands.
    - beta_rows: list over coefficient index ic=1..3 of per-band values
      (BetaCoefficient<ic>), each of length nbands-1 (the last band is
      derived from sum_b beta_b = 1); empty -> Jeevanjee defaults.

    Returns (nbands, epsilon, bcs_top, kappa_table, beta_table)."""
    bcs = tuple(float(v) for v in bcs_list) if bcs_list else (1.0, 1.0)
    nbands = max(len(bcs) - 1, 1)
    epsilon = bcs[-1]
    bcs_top = bcs[:nbands]

    kappa_table = tuple(tuple(float(v) for v in comp[:nbands])
                        + (0.0,) * (nbands - len(comp))
                        for comp in absorption_components)

    # coefficient-major beta input -> per-band rows
    beta = np.zeros((3, max(nbands, 2)))
    beta[:, 0] = BETA_DEFAULT_BAND1
    if max(nbands, 2) > 1:
        beta[:, 1] = BETA_DEFAULT_BAND2
    for ic, row in enumerate(beta_rows[:3]):
        if row:
            vals = [float(v) for v in row]
            beta[ic, : len(vals)] = vals
    beta = beta[:, :nbands].copy()
    if nbands > 1:
        beta[:, -1] = np.array([1.0, 0.0, 0.0]) - beta[:, :-1].sum(axis=1)
    else:
        beta[:, 0] = [1.0, 0.0, 0.0]
    beta_table = tuple(tuple(beta[:, b]) for b in range(nbands))
    return nbands, epsilon, bcs_top, kappa_table, beta_table


def cumulative_matrices(y: np.ndarray):
    """(J_from_top, J_from_bottom): lower/upper triangular trapezoid
    integration matrices; (J_top @ a)[j] = int_{y_j}^{y_top} a dy."""
    ny = y.shape[0]
    dy = np.diff(y)
    Jb = np.zeros((ny, ny))
    for j in range(1, ny):
        Jb[j, :] = Jb[j - 1, :]
        Jb[j, j - 1] += 0.5 * dy[j - 1]
        Jb[j, j] += 0.5 * dy[j - 1]
    total = Jb[-1:, :]
    Jt = total - Jb               # int_y^top = int_bot^top - int_bot^y
    return Jt, Jb


def int1_cumulative_matrices(plan_y):
    """Compact-integral matrices from the reference's FDM_Int1 system
    (fdm_integral.f90; what IR_RTE1_* integrates tau with): (Jt, Jb),
    (Jt f)[j] = int_y^top f, (Jb f)[j] = int_bot^y f, 6th-order.
    Replaces the 2nd-order trapezoid whose ~1e-4 tau error left the
    radiation-family dilatation columns (Case17/18/19/24/54/55) ~0.1-1%
    off the reference (r4 root-cause)."""
    from tlab_tpu.ops.elliptic_factorize import build_int1_pencil
    M0, _M1, R = build_int1_pencil(plan_y, "max")
    T = np.linalg.solve(M0, R)
    T[:, -1] = 0.0                     # the bc slot carries u(top) = 0
    Jt = -T                            # solve gives -int_y^top
    M0b, _M1b, Rb = build_int1_pencil(plan_y, "min")
    Tb = np.linalg.solve(M0b, Rb)
    Tb[:, 0] = 0.0
    return Jt, Tb


def infrared_source(props: RadiationProps, Jt, Jb, ql, rho_bar):
    """Heating-rate field from liquid water (ql: (nx, ny, nz)); the
    reference's IR_RTE1_OnlyLiquid (no mean-direction factor,
    radiation.f90:401-432): p_tau = exp(-int_y^top a); the upward flux
    uses the RATIO p_tau(bottom)/p_tau(y) exactly as the reference (one
    integral, not a second one)."""
    a = props.kappa * ql * rho_bar[None, :, None]
    from tlab_tpu.ops.derivative import op_precision
    ptau = jnp.exp(-jnp.einsum("ab,ibk->iak", Jt, a,
                               precision=op_precision(a.dtype)))
    if abs(props.flux_bottom) > 0:
        src = a * (ptau * props.flux_top
                   + (ptau[:, :1, :] / ptau) * props.flux_bottom)
    else:
        src = a * (props.flux_top * ptau)
    return src


def infrared_gray_source(props: RadiationProps, y, a, b,
                         emissivity: float = 1.0, return_fluxes=False,
                         flux_top=None):
    """Gray two-stream RTE with emission (reference IR_RTE1_Incremental,
    radiation.f90:448-541): absorption field a(x,y,z) (scaled by 1/mu as
    in the reference), emission function b = sigma T^4 (already scaled);
    downward flux from flux_top at ymax, upward flux from the surface
    (emissivity-mixed reflection); source S = a (F_up + F_down) - 2 a b.

    The level-to-level recurrences are linear scans along y written in the
    overflow-safe form F(j) = tr F(j+1) + 0.5 dy (ab_j + tr ab_{j+1}).
    flux_top may be an (nx, nz) array (per-band boundary reuse).
    """
    import jax
    yv = jnp.asarray(y, a.dtype)
    dy = yv[1:] - yv[:-1]                            # (ny-1,)
    a = a / jnp.asarray(props.mu, a.dtype)           # mean-direction factor
    ab = a * b                                       # absorption * emission
    # incremental optical depth (trapezoid) and transmission factors
    tau_inc = 0.5 * (a[:, 1:, :] + a[:, :-1, :]) * dy[None, :, None]
    trans = jnp.exp(-tau_inc)                        # I_{j-1,j} (nx,ny-1,nz)

    half_dy = 0.5 * dy[None, :, None]
    em_lo = half_dy * ab[:, :-1, :]                  # 0.5 dy ab_j
    em_hi = half_dy * ab[:, 1:, :]                   # 0.5 dy ab_{j+1}

    # downward: F(j) = tr(j) F(j+1) + 0.5 dy (ab_j + tr(j) ab_{j+1})
    def down(carry, inp):
        tr, elo, ehi = inp
        fd = tr * (carry + ehi) + elo
        return fd, fd

    if flux_top is None:
        f_top = jnp.full_like(a[:, 0, :], props.flux_top)
    else:
        f_top = jnp.broadcast_to(jnp.asarray(flux_top, a.dtype),
                                 a[:, 0, :].shape)
    _, fd_scan = jax.lax.scan(
        down, f_top,
        (jnp.moveaxis(trans, 1, 0)[::-1], jnp.moveaxis(em_lo, 1, 0)[::-1],
         jnp.moveaxis(em_hi, 1, 0)[::-1]))
    flux_dn = jnp.concatenate(
        [jnp.moveaxis(fd_scan[::-1], 0, 1), f_top[:, None, :]], axis=1)

    # bottom boundary: upward flux = eps b_sfc + (1-eps) reflected
    f_bot = emissivity * b[:, 0, :] + (1.0 - emissivity) * flux_dn[:, 0, :]

    # upward: F(j+1) = tr(j) F(j) + 0.5 dy (tr(j) ab_j + ab_{j+1})
    def up(carry, inp):
        tr, elo, ehi = inp
        fu = tr * (carry + elo) + ehi
        return fu, fu

    _, fu_scan = jax.lax.scan(
        up, f_bot, (jnp.moveaxis(trans, 1, 0), jnp.moveaxis(em_lo, 1, 0),
                    jnp.moveaxis(em_hi, 1, 0)))
    flux_up = jnp.concatenate(
        [f_bot[:, None, :], jnp.moveaxis(fu_scan, 0, 1)], axis=1)

    src = a * (flux_up + flux_dn) - 2.0 * ab
    if return_fluxes:
        return src, flux_dn, flux_up
    return src


def infrared_band_source(props: RadiationProps, y, a_bands, T,
                         beta_bands, emissivity: float = 1.0,
                         bcs_top=None):
    """Multi-band RTE (reference TYPE_IR_BAND, radiation.f90:322-372): each
    band carries its own absorption field, its own downward top flux, and a
    quadratic-in-T emission fraction b_band = beta T^4 (b0 + T (b1 + T b2));
    band sources add."""
    src = None
    tops = bcs_top if bcs_top is not None else \
        (props.bcs_top or (props.flux_top,) * len(a_bands))
    for a_b, (b0, b1, b2), f_top in zip(a_bands, beta_bands, tops):
        # sigma T^4 (beta_band(T)) emission (radiation.f90:341)
        emis = props.beta * SIGMA * T ** 4 * (b0 + T * (b1 + T * b2))
        s = infrared_gray_source(props, y, a_b, emis,
                                 emissivity=emissivity, flux_top=f_top)
        src = s if src is None else src + s
    return src
