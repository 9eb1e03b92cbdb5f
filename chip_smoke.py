"""Smoke run of the shear-layer DNS on the GPU: the quickest proof that the
system starts on the card and gives the right answer there.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # four GPUs: 2x2 mesh vs one card

Phases, in order (any failure exits non-zero before the result line):

  device    JAX's first device must be a GPU; prints the card's name and
            power limit (nvidia-smi).
  native    builds native/ (the reference-exact RNG that draws the initial
            condition and the threaded field I/O) and requires it to load.
  main      examples/shear3d/tlab.ini (512x256x256, fp32, RK4-5, compact-6,
            factorized Poisson) through tlab_tpu.tools.cli.main in this
            process: inigrid -> ini -> dns --steps 10.  Checks 10 finite
            dns.out rows and the restart files; prints compile time,
            ms/step and peak device bytes.
  accuracy  one RK4-5 step from the same initial state in f32 at the
            production matmul precision and in f64 on the same card;
            relative L2 error per field must be <= 1e-4 per step.

--four-cards runs only the 2x2-mesh dns of the same case against a
one-card run of the same initial fields, in this process.

The last line of stdout is the JSON result
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Field files go to .chip_smoke/ in the repo (listed in .gitignore).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

CASE = os.path.join(REPO, "examples", "shear3d", "tlab.ini")
STEPS = 10
F32_STEP_TOL = 1e-4     # README's per-step budget: ~20x below compact-6
# 2x2 mesh vs one card, both f32, after STEPS steps: the runs differ in
# summation order, GEMM blocking and FFT sizes, so not bit for bit.  Each
# may stray from the exact f32 arithmetic by the per-step budget, so they
# may differ by STEPS budgets (relative L2 per field, relative per dns.out
# column; a 64x48x32 rehearsal on the CPU differed by at most 1.1e-5)
MESH_TOL = STEPS * F32_STEP_TOL
# The logged dilatation extrema sit on the wall rows, where the
# factorized projection leaves the scheme's dilatation (3.9e-3 after 10
# steps in f64).  f32 round-off, amplified near the walls, moves them
# by up to DIL_F32 from f64 over those steps on one card
# (`python chip_study.py dilatation`, H100 at 400 W) -- as much as the
# f64 value itself, so two f32 runs that sum in another order, such as a
# mesh and one card, may differ by twice that per step.  A projection
# that fails leaves O(1) dilatation.
DIL_F32 = 3.627e-3
MESH_DIL_ABS = 2 * DIL_F32


def device_phase() -> dict:
    """JAX's first device must be a GPU; returns it as JAX reports it."""
    from tlab_tpu.utils.device import card_line, require_gpu
    dev = require_gpu()
    card = card_line()
    print(f"device: {dev['kind']} x{dev['count']} ({dev['platform']})")
    print(f"card: {card}")
    dev["card"] = card
    return dev


def native_phase() -> None:
    subprocess.run([sys.executable, os.path.join(REPO, "native", "build.py")],
                   check=True, stdout=subprocess.DEVNULL)
    from tlab_tpu.utils import nrrandom
    if not nrrandom.native_loaded():
        raise SystemExit("native: the NR RNG extension did not load")
    print("native: built and loaded")


def case_ini(workdir: str, steps: int, shape=None) -> str:
    """Copy of the shear3d case with End/Restart at `steps` (so the run
    ends on a restart) and per-dispatch profiling on; `shape` (nx, ny, nz)
    cuts the grid for CPU tests.  Returns the new ini's path."""
    os.makedirs(workdir, exist_ok=True)
    sec = None
    out = []
    with open(CASE) as fh:
        for line in fh:
            s = line.strip()
            if s.startswith("["):
                sec = s[1:-1]
                out.append(line)
                if sec == "Main":
                    out.append("Profiling=yes\n")
                continue
            key = s.split("=")[0].strip()
            if sec == "Iteration" and key in ("End", "Restart"):
                line = f"{key}={steps}\n"
            elif shape is not None:
                nx, ny, nz = shape
                if sec == "Grid" and key in ("Imax", "Jmax", "Kmax"):
                    line = f"{key}={dict(Imax=nx, Jmax=ny, Kmax=nz)[key]}\n"
                elif key == "points_1" and sec in ("IniGridOx", "IniGridOy",
                                                   "IniGridOz"):
                    n = {"IniGridOx": nx + 1, "IniGridOy": ny,
                         "IniGridOz": nz + 1}[sec]
                    line = f"points_1={n}\n"
            out.append(line)
    path = os.path.join(workdir, "tlab.ini")
    with open(path, "w") as fh:
        fh.writelines(out)
    return path


def _cli(*args) -> None:
    from tlab_tpu.tools import cli
    rc = cli.main(list(args))
    if rc != 0:
        raise SystemExit(f"cli {args[0]} returned {rc}")


def _log_rows(path: str) -> np.ndarray:
    """Numeric rows of a dns.out step log: status, itime, time, dt, ..."""
    rows = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(t) for t in line.split()])
    return np.asarray(rows)


def _ms_per_step(workdir: str) -> float:
    """Median per-dispatch wall time of dns.prof, leaving out the first
    dispatch (it includes compilation) when there are others."""
    samples = np.atleast_1d(np.loadtxt(os.path.join(workdir, "dns.prof")))
    return float(np.median(samples[1:] if len(samples) > 1 else samples)) \
        * 1e3


def _peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _read_fields(workdir: str, itime: int) -> dict:
    from tlab_tpu.io.fields_io import read_field
    names = [f"flow.{itime}.{i}" for i in (1, 2, 3)] + [f"scal.{itime}.1"]
    return {n: read_field(os.path.join(workdir, n))[0] for n in names}


class _CompileClock:
    """Seconds JAX spends tracing, lowering and compiling while active."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration

    def __enter__(self):
        import jax
        jax.monitoring.register_event_duration_secs_listener(self)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_duration_listener(self)


def prepare_case(workdir: str, steps: int, shape=None) -> str:
    """A fresh `workdir` with the case (case_ini), its grid and initial
    fields, made through the CLI; returns the ini's path."""
    shutil.rmtree(workdir, ignore_errors=True)
    ini = case_ini(workdir, steps, shape)
    _cli("inigrid", "--ini", ini, "--outdir", workdir)
    _cli("ini", "--ini", ini, "--outdir", workdir)
    return ini


def main_phase(workdir: str, steps: int = STEPS, shape=None) -> dict:
    """inigrid -> ini -> dns through the CLI in a fresh `workdir`; checks
    the step log and the restart files.  Returns compile seconds, ms/step
    and peak bytes."""
    import jax
    ini = prepare_case(workdir, steps, shape)
    with _CompileClock() as clock:
        _cli("dns", "--ini", ini, "--outdir", workdir, "--steps", str(steps))

    rows = _log_rows(os.path.join(workdir, "dns.out"))
    stepped = rows[rows[:, 1] > 0]
    if len(stepped) != steps or not np.all(np.isfinite(stepped)) \
            or np.any(stepped[:, 0] != 0):
        raise SystemExit(f"main: dns.out has {len(stepped)} step rows, "
                         f"want {steps} finite rows with status 0")
    from tlab_tpu.grid import read_reference_grid
    grid_shape = read_reference_grid(os.path.join(workdir, "grid")).shape
    for name, a in _read_fields(workdir, steps).items():
        if a.shape != grid_shape or not np.all(np.isfinite(a)):
            raise SystemExit(f"main: restart file {name} is not a finite "
                             f"field of the grid's shape")
    return {"steps": steps, "compile_s": clock.seconds,
            "ms_per_step": _ms_per_step(workdir),
            "peak_bytes": _peak_bytes(jax.devices()[0]),
            "last_row": stepped[-1].tolist()}


def initial_state(workdir: str):
    """The initial fields of the case in `workdir` as an f32 State and its
    f64 copy, and the first step's dt; turns on JAX's 64-bit mode for the
    rest of the process."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.dycore.state import State
    from tlab_tpu.io import fields_io
    from tlab_tpu.runtime import Simulation

    sim = Simulation.from_case(os.path.join(workdir, "tlab.ini"),
                               dtype=jnp.float64)
    u, v, w, s, _, _ = fields_io.read_state(
        os.path.join(workdir, "flow"), os.path.join(workdir, "scal"), 0,
        sim.nsp.n_scalars)
    st32 = State(u=jnp.asarray(u, jnp.float32), v=jnp.asarray(v, jnp.float32),
                 w=jnp.asarray(w, jnp.float32), s=jnp.asarray(s, jnp.float32))
    st64 = jax.tree.map(lambda a: a.astype(jnp.float64), st32)
    dtime = dyn.next_dt(sim.P, float(dyn.cfl_advective_max(sim.P, st64)),
                        sim.case.time_cfl, sim.case.time_cfl_diffusive)
    return st32, st64, dtime


def run_step(workdir: str, state, dtime, repeats: int = 3) -> dict:
    """One RK step of the case in `workdir` at the state's dtype, through
    the dns driver's step function.  Returns the new state, max|div u|
    after the projection everywhere and in the middle half of y, the
    seconds JAX spent compiling, and the median ms of `repeats` more
    calls (None for none)."""
    import jax
    import jax.numpy as jnp
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.runtime import Simulation
    from tlab_tpu.tools.dns import make_step_functions

    sim = Simulation.from_case(os.path.join(workdir, "tlab.ini"),
                               dtype=state.u.dtype)
    step, _ = make_step_functions(sim)
    with _CompileClock() as clock:
        new, _, _, dil = jax.block_until_ready(step(state, dtime))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(step(state, dtime))
        times.append(time.perf_counter() - t0)
    # the factorized projection leaves the reference's decaying
    # near-wall dilatation (ops/elliptic_factorize.py); the middle
    # half of the layer shows the round-off level
    d = dyn.divergence(sim.P, new.u, new.v, new.w)
    ny = d.shape[1]
    return {"state": new, "div_max": float(jnp.max(jnp.abs(dil))),
            "div_interior": float(jnp.max(jnp.abs(
                d[:, ny // 4:3 * ny // 4]))),
            "compile_s": clock.seconds,
            "ms": float(np.median(times)) * 1e3 if times else None}


def step_report(r32: dict, r64: dict) -> dict:
    """f32 step against the f64 one: relative L2 error per field, both
    runs' divergence residuals, the f32 compile seconds and ms/step."""
    err = {}
    for f in ("u", "v", "w", "s"):
        a = np.asarray(getattr(r32["state"], f), np.float64)
        b = np.asarray(getattr(r64["state"], f))
        err[f] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return {"rel_err": err, "max_rel_err": max(err.values()),
            "div_max": {"f32": r32["div_max"], "f64": r64["div_max"]},
            "div_interior": {"f32": r32["div_interior"],
                             "f64": r64["div_interior"]},
            "f32_compile_s": r32["compile_s"], "f32_ms_per_step": r32["ms"]}


def accuracy_phase(workdir: str, tol: float = F32_STEP_TOL) -> dict:
    """One RK step of the case in `workdir` (written by main_phase) in f32
    and in f64 from the same f32-representable initial state; the f32
    error must be at most `tol` per field (step_report)."""
    st32, st64, dtime = initial_state(workdir)
    r64 = run_step(workdir, st64, dtime, repeats=0)
    res = step_report(run_step(workdir, st32, dtime), r64)
    res.update(dt=dtime, tol=tol)
    if not res["max_rel_err"] <= tol:
        raise SystemExit(f"accuracy: f32 vs f64 error {res['max_rel_err']:.3e}"
                         f" per step exceeds {tol:.0e}: {res['rel_err']}")
    return res


def prof_devices(workdir: str) -> int:
    """Devices the stepped state spanned, as dns.prof records it."""
    with open(os.path.join(workdir, "dns.prof")) as fh:
        for line in fh:
            if "devices=" in line:
                return int(line.split("devices=")[1].split()[0])
    raise SystemExit(f"{workdir}/dns.prof names no device count")


def four_cards_phase(workdir: str, steps: int = STEPS, shape=None,
                     mesh=(2, 2)) -> dict:
    """dns on a px x pz mesh against one card from the same initial fields
    (ini on one card, copied to both run directories); compares dns.out
    and the final fields, and checks that the stepped state spanned every
    mesh device.  Returns the differences, both runs' ms/step and the
    per-device peak bytes."""
    import jax
    shutil.rmtree(workdir, ignore_errors=True)
    one, many = os.path.join(workdir, "one"), os.path.join(workdir, "mesh")
    ini = prepare_case(one, steps, shape)
    os.makedirs(many, exist_ok=True)
    for f in os.listdir(one):
        if f in ("tlab.ini", "grid") or f.startswith(("flow.0.", "scal.0.")):
            shutil.copy(os.path.join(one, f), many)
    ini_m = os.path.join(many, "tlab.ini")
    n_dev = mesh[0] * mesh[1]
    _cli("dns", "--ini", ini_m, "--outdir", many, "--steps", str(steps),
         "--mesh", f"{mesh[0]},{mesh[1]}")
    peaks = [_peak_bytes(d) for d in jax.devices()[:n_dev]]
    _cli("dns", "--ini", ini, "--outdir", one, "--steps", str(steps))

    r1 = _log_rows(os.path.join(one, "dns.out"))
    rm = _log_rows(os.path.join(many, "dns.out"))
    # columns: status itime time dt CFL D# visc DilMin DilMax
    scale = np.maximum(np.abs(r1[:, 2:7]), 1e-30)
    log_err = float(np.max(np.abs(rm[:, 2:7] - r1[:, 2:7]) / scale))
    dil_diff = float(np.max(np.abs(rm[:, 7:9] - r1[:, 7:9])))
    f1, fm = _read_fields(one, steps), _read_fields(many, steps)
    field_err = {n: float(np.linalg.norm(fm[n] - f1[n])
                          / np.linalg.norm(f1[n])) for n in f1}
    devices = {"mesh": prof_devices(many), "one": prof_devices(one)}
    res = {"mesh": list(mesh), "log_rel_err": log_err,
           "dilatation_max_diff": dil_diff, "field_rel_err": field_err,
           "ms_per_step": {"mesh": _ms_per_step(many),
                           "one": _ms_per_step(one)},
           "step_devices": devices, "peak_bytes_per_device": peaks,
           "tol": {"rel": MESH_TOL, "dilatation_abs": MESH_DIL_ABS}}
    if len(r1) != len(rm) or max(log_err, *field_err.values()) > MESH_TOL \
            or dil_diff > MESH_DIL_ABS:
        raise SystemExit(f"four-cards: mesh run differs from one card: {res}")
    if devices != {"mesh": n_dev, "one": 1}:
        raise SystemExit(f"four-cards: the mesh step did not span {n_dev} "
                         f"devices: {devices}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 2x2-mesh check on four GPUs")
    args = ap.parse_args(argv)

    dev = device_phase()
    from tlab_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    card = dev.pop("card")
    workdir = os.path.join(REPO, ".chip_smoke")
    native_phase()
    if args.four_cards:
        if dev["count"] < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {dev['count']}")
        res = four_cards_phase(workdir)
        print(f"four-cards [{card}]: {json.dumps(res)}")
    else:
        res = main_phase(workdir)
        print(f"main [{card}]: compile {res['compile_s']:.1f} s, "
              f"{res['ms_per_step']:.2f} ms/step, peak "
              f"{res['peak_bytes']} bytes; last dns.out row "
              f"{res['last_row']}")
        acc = accuracy_phase(workdir)
        print(f"accuracy [{card}]: {json.dumps(acc)}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
