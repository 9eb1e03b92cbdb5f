"""Derivative application: dense operator matmuls along one array axis.

A compact-FD derivative is a single matmul with the precomputed
dense operator (see tlab_tpu.fdm.plan). This replaces the reference's
transpose -> banded matvec -> Thomas solve pipeline (src/operators/
opr_partial.f90:31-150) with one fused contraction that XLA shards and
schedules.

Convention: fields are (nx, ny, nz); `axis` selects the contraction
dimension. The operator matrix M has shape (m, n) and maps values on the n
source nodes to m output nodes (m == n for derivatives, m == 2n for the
fused [D1; D2] stack).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EINSUM = {
    0: "ab,bjk->ajk",
    1: "ab,ibk->iak",
    2: "ab,ijb->ija",
}

# 4-D variants (leading stacked-field axis, e.g. (ns, nx, ny, nz))
_EINSUM4 = {
    1: "ab,fbjk->fajk",
    2: "ab,fibk->fiak",
    3: "ab,fijb->fija",
}


_PRECISION_BY_NAME = {
    "default": None,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def op_precision(dtype):
    """Matmul precision for f32 operator applications (None otherwise).

    Default HIGHEST: plain fp32 products, which hold the 1e-4 relative
    error per RK step that the production f32 run is allowed (~20x below
    the compact-6 truncation error of a resolved DNS).  One RK4-5 step of
    the 512x256x256 shear layer against f64 on an H100 (400 W), max over
    fields of the relative L2 error (`python chip_study.py precision`):

        high (TF32, one pass)                 6.2e-4   fails
        highest (fp32)                        1.8e-5
        TF32_TF32_F32_X3 (3-pass TF32)        1.9e-5
        BF16_BF16_F32_X3 (3-pass bf16)        3.6e-5   (divergence 2.9e-3)

    TLAB_TPU_MATMUL_PRECISION=default leaves the choice to JAX's own
    jax_default_matmul_precision, which also takes the names of
    jax.lax.DotAlgorithmPreset (how the 3-pass rows were measured).
    """
    if dtype in (jnp.float32,):
        import os
        name = os.environ.get("TLAB_TPU_MATMUL_PRECISION", "highest").lower()
        return _PRECISION_BY_NAME.get(name, jax.lax.Precision.HIGHEST)
    return None


def apply_along(M, u, axis: int):
    """out = M @ u along `axis`, accumulating in f32 for low-precision inputs."""
    pref = jnp.float32 if u.dtype in (jnp.bfloat16, jnp.float16) else u.dtype
    eins = _EINSUM4[axis] if u.ndim == 4 else _EINSUM[axis]
    return jnp.einsum(eins, M, u, preferred_element_type=pref,
                      precision=op_precision(u.dtype)).astype(u.dtype)


def der1(plan_d1, u, axis: int):
    """First derivative along `axis`; plan_d1 = device matrix for the BC case."""
    return apply_along(plan_d1, u, axis)


def der2(plan_d2, u, axis: int):
    """Second derivative along `axis`."""
    return apply_along(plan_d2, u, axis)


def der12(plan_d12, u, axis: int):
    """Fused first+second derivative with the stacked (2n, n) operator.

    One matmul computes both derivatives (a single pass over u), the hot
    pattern of the Burgers operator.
    """
    n = u.shape[axis]
    out = apply_along(plan_d12, u, axis)
    lo = [slice(None)] * u.ndim
    hi = [slice(None)] * u.ndim
    lo[axis] = slice(0, n)
    hi[axis] = slice(n, 2 * n)
    return out[tuple(lo)], out[tuple(hi)]
