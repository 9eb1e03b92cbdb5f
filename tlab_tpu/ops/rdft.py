"""Horizontal Fourier transforms as dense real matmuls.

The alternative to XLA's FFT for the elliptic solvers' horizontal
transforms, selected with TLAB_TPU_POISSON_TRANSFORM=matmul
(elliptic._transform_mode).  On an H100 (400 W) at 512x256x256 fp32 the
whole step takes 167.2 ms this way against 147.8 ms with cuFFT, at the
same divergence residual (`python chip_study.py transform`), so the FFT
is the default.  The rfft_x /
fft_z pair plays the role of the reference OPR_Fourier's FFTW plans
(src/operators/opr_fourier.f90:101-200).

Forward x (rfft):   re = C @ f,  im = S @ f        C,S: (nkx, nx)
Forward z (fft):    (re,im) -> 2x2 real matmuls with Cz, Sz: (nz, nz)
Inverse z:          conj matrices / nz
Inverse x (irfft):  f = Ci @ re + Si @ im          Ci,Si: (nx, nkx)
with the standard conjugate-even weights w = (1, 2, ..., 2, 1).
"""
from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

import jax
from tlab_tpu.ops.derivative import op_precision


def _dft_precision(dtype):
    """Matmul precision for the DFT stages.  The DFT matrices are
    orthogonal up to scaling (cond 1), so they follow the operator
    precision (op_precision) rather than the elliptic chain's HIGHEST
    pin; TLAB_TPU_DFT_PRECISION=highest pins them to HIGHEST whatever
    the operator precision."""
    if dtype == jnp.float32 and \
            os.environ.get("TLAB_TPU_DFT_PRECISION", "op") == "highest":
        return jax.lax.Precision.HIGHEST
    return op_precision(dtype)


def build_rdft_x(nx: int, dtype=np.float32):
    """(C, S, Ci, Si) for the rfft/irfft pair along a periodic x axis."""
    k = np.arange(nx // 2 + 1)
    n = np.arange(nx)
    ang = 2.0 * np.pi * np.outer(k, n) / nx
    C = np.cos(ang)
    S = -np.sin(ang)
    w = np.full(nx // 2 + 1, 2.0)
    w[0] = 1.0
    if nx % 2 == 0:
        w[-1] = 1.0
    Ci = (C * w[:, None]).T / nx
    Si = (S * w[:, None]).T / nx
    return tuple(np.asarray(M, dtype) for M in (C, S, Ci, Si))


def build_dft_z(nz: int, dtype=np.float32):
    """(Cz, Sz) for the full complex DFT along z; inverse uses the
    conjugate pair divided by nz."""
    k = np.arange(nz)
    ang = 2.0 * np.pi * np.outer(k, k) / nz
    Cz = np.cos(ang)
    Sz = -np.sin(ang)
    return np.asarray(Cz, dtype), np.asarray(Sz, dtype)


def device_rdft_plan(nx: int, nz: int, dtype=jnp.float32):
    nt = np.dtype(jnp.dtype(dtype))
    C, S, Ci, Si = build_rdft_x(nx, np.float64)
    out = {"Cx": np.asarray(C, nt), "Sx": np.asarray(S, nt),
           "Cxi": np.asarray(Ci, nt), "Sxi": np.asarray(Si, nt)}
    if nz > 1:
        Cz, Sz = build_dft_z(nz, np.float64)
        out["Cz"] = np.asarray(Cz, nt)
        out["Sz"] = np.asarray(Sz, nt)
        out["nz"] = nz
    return out


def _mm(M, a, axis):
    eins = {0: "ab,bjk->ajk", 2: "ab,ijb->ija"}[axis]
    pref = jnp.float32 if a.dtype in (jnp.bfloat16, jnp.float16) else a.dtype
    return jnp.einsum(eins, M, a, preferred_element_type=pref,
                      precision=_dft_precision(a.dtype)).astype(a.dtype)


def forward_parts(plan: dict, f):
    """Same as forward but keeps (re, im) as separate real arrays (lets the
    modal solve run in pure real matmuls)."""
    re, im = forward_x_parts(plan, f)
    if "Cz" in plan:
        re, im = fft_z_parts(plan, re, im)
    return re, im


def backward_parts(plan: dict, re, im):
    """(re, im) modal -> real field (nx, ny, nz)."""
    if "Cz" in plan:
        re, im = ifft_z_parts(plan, re, im)
    return backward_x_parts(plan, re, im)


# -- split-direction variants (distributed pencil path: the z transform
# happens after an all-to-all, so x and z are applied separately) ----------

def forward_x_parts(plan: dict, f):
    return _mm(plan["Cx"], f, 0), _mm(plan["Sx"], f, 0)


def backward_x_parts(plan: dict, re, im):
    return _mm(plan["Cxi"], re, 0) + _mm(plan["Sxi"], im, 0)


def fft_z_parts(plan: dict, re, im):
    return (_mm(plan["Cz"], re, 2) - _mm(plan["Sz"], im, 2),
            _mm(plan["Sz"], re, 2) + _mm(plan["Cz"], im, 2))


def ifft_z_parts(plan: dict, re, im):
    nz = plan["nz"]
    return ((_mm(plan["Cz"], re, 2) + _mm(plan["Sz"], im, 2)) / nz,
            (_mm(plan["Cz"], im, 2) - _mm(plan["Sz"], re, 2)) / nz)
