"""Batched banded-solver backends for long compact-FDM lines.

The dense-operator formulation (fdm/plan.py) applies compact schemes as
N x N matmuls -- the right choice for moderate line lengths, where the 2N
flops/point of one large matmul cost less than the extra passes of a
banded solve.  For long lines this module provides the O(N L)
PARTITIONED (substructured) solve: per-segment dense inverses + a small
interface system, all einsums -- the matmul-shaped answer to the
reference's TRIDFS/TRIDSS banded LU sweeps (src/utils/linear3.f90:29-56).
The partitioned solve is the single long-line backend; no sequential
Thomas kernel is kept.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Partitioned (substructured) tridiagonal solve -- the O(N L) backend.
# A sequential Thomas recurrence exposes no parallelism along the line;
# instead the line is split into
# S segments of length L, each segment solved by a PRECOMPUTED dense
# L x L inverse (a matmul), with the 2S interface unknowns closed by
# a small precomputed 2S x 2S inverse.  Exact algebra (a block LU of the
# same matrix), flops/point = 2L instead of the dense path's 2N -- a
# N/L saving at N >> L that stays entirely in XLA-scheduled
# einsums (no hand-written kernel, no sequential loop).
# Cf. Wang 1981 partition method; PAPERS.md PaScaL_TDMA.
# ---------------------------------------------------------------------------

def partitioned_plan(A: np.ndarray, L: int = 128, dtype=jnp.float32,
                     periodic: bool = False):
    """Host-side substructuring of a shared (quasi-)tridiagonal A.

    A may carry arbitrary boundary ROWS (the compact schemes' biased
    rows live inside the first/last segment blocks); only the
    off-segment couplings must be the single sub/superdiagonal elements,
    true for tridiagonal A away from the wall rows.  periodic=True adds
    the circulant corner couplings A[0, n-1]/A[n-1, 0] (the
    Sherman-Morrison analog lives in the interface system for free)."""
    A = np.asarray(A, np.float64)
    n = A.shape[0]
    if n % L:
        # choose the largest power-of-two-ish block that divides n
        for cand in (256, 128, 64, 32, 16, 8):
            if n % cand == 0 and cand < n:
                L = cand
                break
        else:
            raise ValueError(f"n={n} has no usable segment size")
    S = n // L
    Tinv = np.zeros((S, L, L))
    xL = np.zeros((S, L))
    xR = np.zeros((S, L))
    for s in range(S):
        sl = slice(s * L, (s + 1) * L)
        Ts = A[sl, sl]
        Tinv[s] = np.linalg.inv(Ts)
        if s > 0:
            a_edge = A[s * L, s * L - 1]          # coupling to prev last
            xL[s] = Tinv[s, :, 0] * a_edge
        if s < S - 1:
            c_edge = A[(s + 1) * L - 1, (s + 1) * L]  # coupling to next
            xR[s] = Tinv[s, :, L - 1] * c_edge
    if periodic:
        # wrap couplings: segment 0 first row <- u[n-1]; last segment's
        # last row <- u[0]
        xL[0] = Tinv[0, :, 0] * A[0, n - 1]
        xR[S - 1] = Tinv[S - 1, :, L - 1] * A[n - 1, 0]

    # interface system M z = v_edges over z = [u_s[0], u_s[L-1]]_s
    M = np.eye(2 * S)
    for s in range(S):
        i0, i1 = 2 * s, 2 * s + 1
        sp_ = (s - 1) % S if periodic else s - 1
        sn_ = (s + 1) % S if periodic else s + 1
        if s > 0 or periodic:
            M[i0, 2 * sp_ + 1] += xL[s, 0]
            M[i1, 2 * sp_ + 1] += xL[s, L - 1]
        if s < S - 1 or periodic:
            M[i0, 2 * sn_] += xR[s, 0]
            M[i1, 2 * sn_] += xR[s, L - 1]
    Minv = np.linalg.inv(M)
    nt = np.dtype(jnp.dtype(dtype))
    return {"Tinv": np.asarray(Tinv, nt), "xL": np.asarray(xL, nt),
            "xR": np.asarray(xR, nt), "Minv": np.asarray(Minv, nt),
            "S": S, "L": L, "n": n, "periodic": bool(periodic)}


def partitioned_solve(plan: dict, rhs):
    """Solve A u = rhs for all lines: rhs (m, N) -> u (m, N)."""
    from tlab_tpu.ops.derivative import op_precision
    S, L, n = plan["S"], plan["L"], plan["n"]
    m = rhs.shape[0]
    prec = op_precision(rhs.dtype)
    d = rhs.reshape(m, S, L)
    Tinv = jnp.asarray(plan["Tinv"])
    v = jnp.einsum("slk,msk->msl", Tinv, d, precision=prec)
    # interface solve
    v_edges = jnp.stack([v[:, :, 0], v[:, :, L - 1]],
                        axis=2).reshape(m, 2 * S)
    z = jnp.einsum("ab,mb->ma", jnp.asarray(plan["Minv"]), v_edges,
                   precision=prec).reshape(m, S, 2)
    # corrections: u_s = v_s - xL_s z_{s-1,last} - xR_s z_{s+1,first}
    if plan.get("periodic"):
        zprev = jnp.roll(z[:, :, 1], 1, axis=1)
        znext = jnp.roll(z[:, :, 0], -1, axis=1)
    else:
        zprev = jnp.concatenate([jnp.zeros((m, 1), z.dtype), z[:, :-1, 1]],
                                axis=1)                   # (m, S)
        znext = jnp.concatenate([z[:, 1:, 0], jnp.zeros((m, 1), z.dtype)],
                                axis=1)
    u = v - jnp.asarray(plan["xL"])[None] * zprev[:, :, None] \
        - jnp.asarray(plan["xR"])[None] * znext[:, :, None]
    return u.reshape(m, n)


# ---------------------------------------------------------------------------
# Production banded D1 path: B u via shifted diagonal adds + partitioned
# solve of A -- the O(N L) alternative to the dense A^{-1}B matmul for
# long lines. Selected by build_device_plans when the line length reaches
# TLAB_TPU_THOMAS_MIN_N.
# ---------------------------------------------------------------------------

def banded_plan(A1: np.ndarray, B1: np.ndarray, dtype=jnp.float32,
                band: int = 8, seg: int = 128, periodic: bool = False):
    """Fused substructured derivative: per segment s the stage-1 result
    of the partitioned solve of A with rhs = B u is

        v_s = (Tinv_s @ B[rows_s, slab_s]) u[slab_s]

    with slab_s = [sL - band, (s+1)L + band) (B is banded; boundary
    biased rows live inside the first/last slab -- or wrap around for
    periodic/circulant schemes).  One matmul pass total -- flops/point
    2(L + 2 band) instead of the dense path's 2N."""
    A1 = np.asarray(A1, np.float64)
    B1 = np.asarray(B1, np.float64)
    n = A1.shape[0]
    part = partitioned_plan(A1, L=seg, dtype=dtype, periodic=periodic)
    S, L = part["S"], part["L"]
    pad = band
    W = L + 2 * pad
    F = np.zeros((S, L, W))
    Tinv = np.asarray(part["Tinv"], np.float64)
    for s in range(S):
        rows = np.arange(s * L, (s + 1) * L)
        g0 = s * L - pad                          # slab's first column
        blk = np.zeros((L, W))
        placed = 0.0
        for rl, r in enumerate(rows):
            for c in np.nonzero(B1[r])[0]:
                d = (c - g0) % n if periodic else c - g0
                if 0 <= d < W:
                    blk[rl, d] += B1[r, c]
                    placed += abs(B1[r, c])
        total = np.abs(B1[rows]).sum()
        if total - placed > 1e-9 * max(total, 1.0):
            raise ValueError("B bandwidth exceeds the slab pad")
        F[s] = Tinv[s] @ blk
    nt = np.dtype(jnp.dtype(dtype))
    return {"part": part, "F": np.asarray(F, nt), "pad": pad,
            "n": n, "band": band, "periodic": bool(periodic)}


def banded_der1(plan: dict, u, axis: int):
    """D1 u along `axis` via the fused substructured solve; u any rank."""
    from tlab_tpu.ops.derivative import op_precision
    part = plan["part"]
    n, S, L = plan["n"], part["S"], part["L"]
    pad = plan["pad"]
    u_m = jnp.moveaxis(u, axis, -1)
    lead = u_m.shape[:-1]
    u2 = u_m.reshape(-1, n)
    m = u2.shape[0]
    prec = op_precision(u2.dtype)

    if plan.get("periodic"):
        up = jnp.concatenate([u2[:, -pad:], u2, u2[:, :pad]], axis=1)
    else:
        up = jnp.pad(u2, ((0, 0), (pad, pad)))
    slabs = jnp.stack([up[:, s * L:s * L + L + 2 * pad] for s in range(S)],
                      axis=1)                      # (m, S, L+2p)
    v = jnp.einsum("slw,msw->msl", jnp.asarray(plan["F"]), slabs,
                   precision=prec)
    # interface closure + corrections (same algebra as partitioned_solve)
    v_edges = jnp.stack([v[:, :, 0], v[:, :, L - 1]],
                        axis=2).reshape(m, 2 * S)
    z = jnp.einsum("ab,mb->ma", jnp.asarray(part["Minv"]), v_edges,
                   precision=prec).reshape(m, S, 2)
    if part.get("periodic"):
        zprev = jnp.roll(z[:, :, 1], 1, axis=1)
        znext = jnp.roll(z[:, :, 0], -1, axis=1)
    else:
        zprev = jnp.concatenate([jnp.zeros((m, 1), z.dtype), z[:, :-1, 1]],
                                axis=1)
        znext = jnp.concatenate([z[:, 1:, 0], jnp.zeros((m, 1), z.dtype)],
                                axis=1)
    out = v - jnp.asarray(part["xL"])[None] * zprev[:, :, None] \
        - jnp.asarray(part["xR"])[None] * znext[:, :, None]
    return jnp.moveaxis(out.reshape(*lead, n), -1, axis)
