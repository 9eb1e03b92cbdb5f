"""3-D field filtering (reference src/operators/opr_filter.f90).

A FilterPlan holds one dense line-filter matrix per active direction; the
3-D filter is their composition, each one matmul. Used for the domain
filter (every nitera_filter steps), dealiasing, and pressure filtering.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from tlab_tpu.fdm import filters as flt
from tlab_tpu.fdm.plan import FdmPlan
from tlab_tpu.ops.derivative import apply_along


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    type: str = "none"       # none|compact|explicit6|explicit4|tophat|adm|helmholtz
    parameters: tuple = (0.49,)
    active: tuple = (True, True, True)
    step: int = 0            # domain-filter cadence (0 = off)
    # y-direction wall closure (reference BcsJmin/BcsJmax,
    # opr_filter.f90:160-185): 'biased' (default) | 'zero'
    bcs_j: tuple = ("biased", "biased")


def adm_matrix(nodes, periodic):
    """Approximate deconvolution (ADM) regularization: G3 = 3G - 3G^2 + G^3
    applied to the top-hat kernel (reference DNS_FILTER_ADM family)."""
    G = flt.tophat_matrix(nodes, 2, periodic)
    G2 = G @ G
    return 3.0 * G - 3.0 * G2 + G2 @ G


def build_filter_matrices(fdm: FdmPlan, spec: FilterSpec, dtype=jnp.float64):
    """dict axis -> device matrix (None for inactive/size-1 directions)."""
    out = {}
    for name, plan, on in (("x", fdm.x, spec.active[0]),
                           ("y", fdm.y, spec.active[1]),
                           ("z", fdm.z, spec.active[2])):
        if not on or plan.size == 1 or spec.type == "none":
            out[name] = None
            continue
        if spec.type == "compact":
            bcs = getattr(spec, "bcs_j", ("biased", "biased")) \
                if name == "y" else ("biased", "biased")
            M = flt.compact4_matrix(plan.nodes, spec.parameters[0],
                                    plan.periodic, bcs=bcs)
        elif spec.type == "explicit6":
            M = flt.explicit6_matrix(plan.size, plan.periodic)
        elif spec.type == "explicit4":
            M = flt.explicit4_matrix(plan.nodes, plan.periodic)
        elif spec.type == "tophat":
            M = flt.tophat_matrix(plan.nodes,
                                  int(spec.parameters[0]) if spec.parameters else 2,
                                  plan.periodic)
        elif spec.type == "adm":
            M = adm_matrix(plan.nodes, plan.periodic)
        elif spec.type in ("spectralband", "spectralerf"):
            if not plan.periodic:
                out[name] = None          # spectral filters: periodic only
                continue
            M = flt.spectral_matrix(plan.size,
                                    "band" if spec.type.endswith("band")
                                    else "erf", spec.parameters)
        else:
            raise NotImplementedError(f"filter type {spec.type}")
        out[name] = np.asarray(M, np.dtype(jnp.dtype(dtype)))
    return out


def build_helmholtz_filter(ell_dev: dict, width: float):
    """3-D Helmholtz filter: (1 - w^2/24 Lap) uf = u (reference
    DNS_FILTER_HELMHOLTZ): one implicit elliptic solve per field."""
    alpha = -24.0 / max(width, 1e-30) ** 2

    def apply(a):
        from tlab_tpu.ops import elliptic
        f = alpha * a
        return elliptic.helmholtz(ell_dev, f, alpha)

    return apply


def apply_filter(mats: dict, a):
    if callable(mats):
        return mats(a)
    for name, axis in (("x", 0), ("y", 1), ("z", 2)):
        M = mats.get(name)
        if M is not None:
            a = apply_along(M, a, axis)
    return a


def filter_state(mats: dict, state):
    from tlab_tpu.dycore.state import State
    s = state.s
    if s.shape[0]:
        s = jnp.stack([apply_filter(mats, s[i]) for i in range(s.shape[0])])
    return State(u=apply_filter(mats, state.u),
                 v=apply_filter(mats, state.v),
                 w=apply_filter(mats, state.w),
                 s=s, sfc=state.sfc)
