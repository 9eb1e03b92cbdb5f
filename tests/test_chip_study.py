"""chip_study.py at a tiny size on the CPU: the variants of each study,
the one-step and dilatation studies end to end, and the reduction of a
device trace to layers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
import chip_study as study
from tlab_tpu.dycore import incompressible as dyn
from tlab_tpu.dycore.state import State
from tlab_tpu.fdm.plan import build_fdm_plan
from tlab_tpu.grid import uniform_grid
from tlab_tpu.ops.derivative import op_precision
from tlab_tpu.physics.params import NSParams

TINY = (32, 24, 16)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("study"))
    cs.prepare_case(wd, 2, TINY)
    return wd


def test_preset_reaches_the_operators_through_jax_default(monkeypatch):
    monkeypatch.delenv("TLAB_TPU_MATMUL_PRECISION", raising=False)
    setting = study.variants("precision")["BF16_BF16_F32_X3"]
    with study._setting(**setting):
        assert op_precision(jnp.float32) is None
        assert jax.config.jax_default_matmul_precision == "BF16_BF16_F32_X3"
    assert "TLAB_TPU_MATMUL_PRECISION" not in os.environ
    assert op_precision(jnp.float32) == jax.lax.Precision.HIGHEST
    high = study.variants("precision")["high"]
    with study._setting(**high):
        assert op_precision(jnp.float32) == jax.lax.Precision.HIGH


def test_inline_setting_unrolls_scans_and_restores_them():
    scan = jax.lax.scan
    with study._setting(inline=True):
        assert jax.lax.scan is not scan
        assert jax.lax.scan.keywords == {"unroll": True}
    assert jax.lax.scan is scan


@pytest.mark.parametrize("name,kw", [
    ("precision", {"precisions": ("high", "highest")}),
    ("transform", {}),
    ("unroll", {}),
])
def test_step_study_tiny(case, name, kw):
    res = study.step_study(case, name, **kw)
    assert set(res) == set(study.variants(name, **kw))
    for r in res.values():
        assert r["within_budget"] and r["max_rel_err"] <= cs.F32_STEP_TOL
        assert r["f32_ms_per_step"] > 0 and r["f32_compile_s"] > 0


def test_dilatation_study_tiny(case):
    res = study.dilatation_study(case, steps=2)
    with open(os.path.join(case, "f32", "tlab.log")) as fh:
        assert "float32" in fh.read()
    with open(os.path.join(case, "f64", "tlab.log")) as fh:
        assert "float64" in fh.read()
    for run in ("f32", "f64"):
        r = res[run]
        assert len(r["dil_min"]) == 3 and len(r["dil_max"]) == 3
        # the extrema sit on the wall rows, the interior is far quieter
        assert r["y_of_min"] in (0, TINY[1] - 1)
        assert r["middle_half"] < 1e-3 * r["wall_rows"]
    assert res["f32_minus_f64"]["max"] <= 1e-3 * r["wall_rows"]


def test_op_scopes_name_the_layers_of_the_step():
    grid = uniform_grid(16, 12, 8, 2.0 * np.pi, 1.0, np.pi)
    nsp = NSParams(reynolds=500.0, schmidt=(1.0,))
    bcs = dyn.WallBCs.from_velocity_kind(
        "freeslip", "freeslip", scalar_bcs=(("neumann", "neumann"),))
    P = dyn.build_device_plans(build_fdm_plan(grid), nsp, bcs,
                               dtype=jnp.float32)
    z = jnp.zeros(grid.shape, jnp.float32)
    st = State(u=z, v=z, w=z, s=z[None])
    text = jax.jit(lambda s: dyn.rk_step(P, s, 1e-3)[0]).lower(
        st).compile().as_text()
    scopes = study.op_scopes(text)
    assert set(scopes.values()) == {"burgers", "projection", "other"}


def test_layer_breakdown_sums_by_scope():
    scopes = {"gemm.1": "burgers", "fusion.2": "burgers",
              "fft.3": "projection", "copy.4": "other"}
    ms = 1_000_000
    events = [("s1", "cutlass_sgemm", "gemm.1", 0, 4 * ms),
              ("s1", "loop_fusion", "fusion.2", 4 * ms, 2 * ms),
              ("s1", "vector_fft", "fft.3", 6 * ms, 3 * ms),
              ("s2", "MemcpyD2D", "copy.4", 8 * ms, 2 * ms),
              ("s1", "stray", "", 11 * ms, 1 * ms)]
    res = study.layer_breakdown(events, scopes, n_steps=2)
    assert res["ms_per_step"] == {"burgers_matmul": 2.0, "burgers_rest": 1.0,
                                  "projection": 1.5, "other": 1.5}
    assert res["stream_ms_per_step"] == {"s1": 5.0, "s2": 1.0}
    # 0-10 ms and 11-12 ms busy, the copy overlapping the FFT
    assert res["busy_ms_per_step"] == 5.5
    assert res["window_ms_per_step"] == 6.0
    assert res["idle_share"] == pytest.approx(1 / 12)
    assert sum(res["share"].values()) == pytest.approx(1.0)
    assert res["unmapped_top_ms"] == {"stray": 0.5}


def test_trace_study_runs_on_cpu(case):
    """The CPU has no GPU plane: the study still steps, times and traces,
    and finds no device kernel to attribute."""
    res = study.trace_study(case, n_steps=1)
    assert res["step_ms"]["driver"] > 0 and res["step_ms"]["traced"] > 0
    assert res["busy_ms_per_step"] == 0 and res["idle_share"] is None
    assert res["burgers_roundtrip_bytes_per_substep"] == \
        3 * 2 * 2 * 4 * int(np.prod(TINY)) * 4
