"""chip_smoke.py's phases at a tiny size on the CPU, its refusal to run
without a GPU, and (marked `gpu`) the f32-vs-f64 step at full size."""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import chip_smoke as cs

TINY = (32, 24, 16)


def test_device_phase_refuses_cpu(monkeypatch):
    import jax
    cpu = types.SimpleNamespace(platform="cpu", device_kind="cpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [cpu])
    with pytest.raises(SystemExit) as exc:
        cs.device_phase()
    assert exc.value.code not in (0, None)


def test_script_without_gpu_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, cs.__file__], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_case_ini_sets_steps_profiling_and_shape(tmp_path):
    from tlab_tpu.config import load_case
    case = load_case(cs.case_ini(str(tmp_path), 3, TINY))
    assert (case.it_end, case.it_restart) == (3, 3)
    assert case.ini.get_bool("Main", "Profiling", False)
    assert case.ini.get_int("Grid", "Imax", 0) == TINY[0]
    assert case.ini.get_int("IniGridOz", "points_1", 0) == TINY[2] + 1
    full = load_case(cs.case_ini(str(tmp_path / "full"), 10))
    assert full.ini.get_int("Grid", "Jmax", 0) == 256


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("smoke"))
    return wd, cs.main_phase(wd, steps=2, shape=TINY)


def test_main_phase_tiny(tiny_run):
    wd, res = tiny_run
    assert res["steps"] == 2
    assert res["compile_s"] > 0 and res["ms_per_step"] > 0
    assert np.all(np.isfinite(res["last_row"])) and res["last_row"][1] == 2
    for f in ("flow.2.1", "flow.2.2", "flow.2.3", "scal.2.1", "dns.prof"):
        assert os.path.exists(os.path.join(wd, f))


def test_accuracy_phase_tiny(tiny_run):
    wd, _ = tiny_run
    res = cs.accuracy_phase(wd)
    assert set(res["rel_err"]) == {"u", "v", "w", "s"}
    assert res["max_rel_err"] <= cs.F32_STEP_TOL
    # f32 and f64 remove the interior divergence to their own round-off
    assert res["div_interior"]["f64"] < 1e-3
    assert res["div_interior"]["f32"] < 1e-3
    json.dumps(res)


def test_accuracy_phase_fails_over_budget(tiny_run):
    wd, _ = tiny_run
    with pytest.raises(SystemExit):
        cs.accuracy_phase(wd, tol=1e-12)


def test_main_phase_rejects_short_log(tmp_path, monkeypatch):
    """A dns run that logs fewer rows than asked for fails the phase."""
    real = cs._cli

    def short(*args):
        if args[0] == "dns":
            args = args[:-1] + ("1",)
        real(*args)

    monkeypatch.setattr(cs, "_cli", short)
    with pytest.raises(SystemExit, match="dns.out"):
        cs.main_phase(str(tmp_path), steps=2, shape=TINY)


def test_four_cards_phase_on_virtual_devices(tmp_path):
    """The --four-cards path on four of the suite's virtual CPU devices."""
    res = cs.four_cards_phase(str(tmp_path), steps=2, shape=TINY)
    assert res["mesh"] == [2, 2]
    assert max(res["field_rel_err"].values()) <= cs.MESH_TOL
    assert res["log_rel_err"] <= cs.MESH_TOL
    assert res["dilatation_max_diff"] <= cs.MESH_DIL_ABS
    assert res["step_devices"] == {"mesh": 4, "one": 1}
    assert res["ms_per_step"]["mesh"] > 0 and res["ms_per_step"]["one"] > 0


@pytest.mark.gpu
def test_f32_step_vs_f64_full_size(gpu, tmp_path):
    """One f32 RK4-5 step of the 512x256x256 shear layer against f64 on
    the same card, within the per-step budget."""
    wd = str(tmp_path)
    cs.prepare_case(wd, 1)
    res = cs.accuracy_phase(wd)
    assert res["max_rel_err"] <= cs.F32_STEP_TOL
