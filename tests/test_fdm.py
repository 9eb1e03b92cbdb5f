"""Operator-level validation against analytic fields.

JAX-native port of the reference's valid/ programs (vpartial, vintegral):
evaluate compact derivatives on sin/cos fields and check accuracy/convergence.
"""
import numpy as np
import pytest

from tlab_tpu.constants import BC
from tlab_tpu.fdm import schemes
from tlab_tpu.fdm.plan import build_deriv_plan
from tlab_tpu.grid import make_axis


def periodic_axis(n, length=2 * np.pi):
    return make_axis(np.arange(n) * (length / n), periodic=True)


def bounded_axis(n, length=1.0):
    return make_axis(np.linspace(0.0, length, n), periodic=False)


def stretched_axis(n, length=1.0):
    s = np.linspace(0.0, 1.0, n)
    nodes = length * (s + 0.12 * np.sin(np.pi * s))
    return make_axis(nodes, periodic=False)


# ---------------------------------------------------------------------------
# periodic: derivative of sin(kx) must follow the modified wavenumber exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme1", ["CompactJacobian4", "CompactJacobian6",
                                     "CompactJacobian6Penta"])
def test_periodic_d1_matches_modified_wavenumber(scheme1):
    n = 64
    ax = periodic_axis(n)
    plan = build_deriv_plan(ax, scheme1, "CompactJacobian6Hyper")
    x = ax.nodes
    for k in (1, 3, 7, 21):
        u = np.sin(k * x)
        du = plan.d1[BC.DD] @ u
        kp = plan.mwn1[k]           # modified wavenumber, physical units
        assert np.allclose(du, kp * np.cos(k * x), atol=1e-10), (scheme1, k)


@pytest.mark.parametrize("scheme2", ["CompactJacobian6", "CompactJacobian6Hyper"])
def test_periodic_d2_matches_modified_wavenumber(scheme2):
    n = 64
    ax = periodic_axis(n)
    plan = build_deriv_plan(ax, "CompactJacobian6", scheme2)
    x = ax.nodes
    for k in (1, 3, 7):
        u = np.cos(k * x)
        d2u = plan.d2[BC.DD] @ u
        kpp = plan.mwn2[k]
        assert np.allclose(d2u, -kpp * np.cos(k * x), atol=1e-9), (scheme2, k)


def test_periodic_low_wavenumber_exactness():
    """At low k the modified wavenumber must be ~exact (6th order)."""
    n = 128
    ax = periodic_axis(n)
    plan = build_deriv_plan(ax)
    assert abs(plan.mwn1[1] - 1.0) < 1e-9
    assert abs(plan.mwn2[1] - 1.0) < 1e-9


# ---------------------------------------------------------------------------
# non-periodic: convergence order on smooth fields
# ---------------------------------------------------------------------------

def _errors(n, axis_fn, scheme1, scheme2, second):
    """(global max error, mid-domain max error) for d1 or d2."""
    ax = axis_fn(n)
    plan = build_deriv_plan(ax, scheme1, scheme2)
    x = ax.nodes
    u = np.sin(2 * np.pi * x) + 0.3 * np.cos(4 * np.pi * x)
    if second:
        exact = (-(2 * np.pi) ** 2 * np.sin(2 * np.pi * x)
                 - 0.3 * (4 * np.pi) ** 2 * np.cos(4 * np.pi * x))
        err = np.abs(plan.d2[BC.DD] @ u - exact)
    else:
        exact = (2 * np.pi * np.cos(2 * np.pi * x)
                 - 1.2 * np.pi * np.sin(4 * np.pi * x))
        err = np.abs(plan.d1[BC.DD] @ u - exact)
    mid = (x > 0.25 * x[-1]) & (x < 0.75 * x[-1])
    return err.max(), err[mid].max()


@pytest.mark.parametrize("axis_fn", [bounded_axis, stretched_axis])
def test_bounded_d1_convergence(axis_fn):
    """Interior 6th order; global max limited by 3rd-order boundary rows
    (by scheme design, identical property to the reference)."""
    g1, m1 = _errors(64, axis_fn, "CompactJacobian6", "CompactJacobian6Hyper", False)
    g2, m2 = _errors(128, axis_fn, "CompactJacobian6", "CompactJacobian6Hyper", False)
    assert np.log2(m1 / m2) > 5.0, (m1, m2)     # interior ~6th order
    assert np.log2(g1 / g2) > 2.5, (g1, g2)     # boundary ~3rd order
    assert g2 < 2e-3


@pytest.mark.parametrize("axis_fn", [bounded_axis, stretched_axis])
def test_bounded_d2_convergence(axis_fn):
    g1, m1 = _errors(64, axis_fn, "CompactJacobian6", "CompactJacobian6", True)
    g2, m2 = _errors(128, axis_fn, "CompactJacobian6", "CompactJacobian6", True)
    assert np.log2(m1 / m2) > 4.5, (m1, m2)
    assert np.log2(g1 / g2) > 2.0, (g1, g2)
    assert g2 < 0.2


def test_neumann_reduction():
    """D with Neumann ends: rows zero; interior accurate for compatible u."""
    n = 96
    ax = bounded_axis(n)
    plan = build_deriv_plan(ax)
    x = ax.nodes
    u = np.cos(np.pi * x)          # u' = 0 at both ends
    du = plan.d1[BC.NN] @ u
    assert du[0] == 0.0 and du[-1] == 0.0
    assert np.max(np.abs(du[1:-1] + np.pi * np.sin(np.pi * x[1:-1]))) < 1e-5


def test_uniform_grid_jacobian_is_exact():
    ax = bounded_axis(33)
    plan = build_deriv_plan(ax)
    h = ax.nodes[1] - ax.nodes[0]
    assert np.allclose(plan.jac, h, atol=1e-12)


def test_neumann_row_coefs_uniform():
    """Reference values (fdm_integral.f90:614-615): (-29/6,9,-9/2,1/3)/h, 3h."""
    from tlab_tpu.ops.elliptic import neumann_row_coefs
    h = 0.1
    y = np.arange(8) * h
    b, a2, idx = neumann_row_coefs(y, at_max=False)
    assert np.allclose(b * h, [-29 / 6, 9.0, -27 / 6, 2 / 6], atol=1e-12)
    assert np.allclose(a2 / h, 3.0, atol=1e-12)
