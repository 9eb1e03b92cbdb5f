"""Measurements behind the GPU defaults of the shear-layer step, on the
512x256x256 case of examples/shear3d (the case chip_smoke.py runs):

    python chip_study.py precision    # f32 operator precision against f64
    python chip_study.py transform    # Poisson transforms: cuFFT, DFT matmuls
    python chip_study.py unroll       # RK substeps scanned or inlined
    python chip_study.py dilatation   # logged dilatation, f32 against f64
    python chip_study.py trace        # device time of one step by layer

Several studies may share one call; `trace` turns off XLA's command
buffers, so that every kernel carries its HLO op, and runs alone.  The
persistent compile cache is off, so compile seconds are cold.  Each
variant prints one line `<study> <variant> [<card>]: <json>`.  With
--cpu and --shape NX,NY,NZ the studies rehearse at a small size on the
CPU.  Files go to .chip_smoke/study/ (listed in .gitignore).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import json
import os
import re
import shutil
import sys

import numpy as np

import chip_smoke as cs

STUDIES = ("dilatation", "precision", "transform", "unroll", "trace")
# f32 operator precisions: names of op_precision, or of
# jax.lax.DotAlgorithmPreset (reached through JAX's default precision)
PRECISIONS = ("high", "highest", "TF32_TF32_F32_X3", "BF16_BF16_F32_X3")
LAYERS = ("burgers", "projection")      # named scopes of dycore


@contextlib.contextmanager
def _setting(env=None, matmul=None, inline=False):
    """Environment variables, JAX's default matmul precision and the
    inlining of every lax.scan, for the steps traced inside."""
    import jax
    env = env or {}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    scan = jax.lax.scan
    if inline:
        jax.lax.scan = functools.partial(scan, unroll=True)
    try:
        with (jax.default_matmul_precision(matmul) if matmul
              else contextlib.nullcontext()):
            yield
    finally:
        jax.lax.scan = scan
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def variants(study: str, precisions=PRECISIONS) -> dict:
    """Variant name -> _setting keywords of a one-step study."""
    if study == "precision":
        return {p: ({"env": {"TLAB_TPU_MATMUL_PRECISION": p}}
                    if p.islower() else
                    {"env": {"TLAB_TPU_MATMUL_PRECISION": "default"},
                     "matmul": p}) for p in precisions}
    if study == "transform":
        return {t: {"env": {"TLAB_TPU_POISSON_TRANSFORM": t}}
                for t in ("fft", "matmul")}
    if study == "unroll":
        return {"scan": {}, "inlined": {"inline": True}}
    raise ValueError(study)


def step_study(workdir: str, study: str, **kw) -> dict:
    """One f32 RK step of the case in `workdir` per variant of `study`,
    each against the same f64 step (chip_smoke.step_report)."""
    st32, st64, dtime = cs.initial_state(workdir)
    r64 = cs.run_step(workdir, st64, dtime, repeats=0)
    out = {}
    for name, setting in variants(study, **kw).items():
        with _setting(**setting):
            r32 = cs.run_step(workdir, st32, dtime)
        out[name] = cs.step_report(r32, r64)
        out[name]["within_budget"] = \
            out[name]["max_rel_err"] <= cs.F32_STEP_TOL
    return out


def _x64(on: bool):
    import jax
    jax.config.update("jax_enable_x64", on)


def dilatation_study(workdir: str, steps: int = cs.STEPS) -> dict:
    """dns of the case in `workdir` for `steps` steps in f32 and in f64
    from its initial fields, through the CLI.  Returns both runs' logged
    dilatation extrema per step, their largest difference, and where in
    y the final fields' extrema lie (divergence recomputed in f64)."""
    import jax
    import jax.numpy as jnp
    from tlab_tpu.dycore import incompressible as dyn
    from tlab_tpu.runtime import Simulation
    was_x64 = jax.config.jax_enable_x64
    runs = {}
    for name in ("f32", "f64"):
        d = os.path.join(workdir, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in os.listdir(workdir):
            if f in ("tlab.ini", "grid") or f.startswith(("flow.0.",
                                                          "scal.0.")):
                shutil.copy(os.path.join(workdir, f), d)
        _x64(name == "f64")
        try:
            cs._cli("dns", "--ini", os.path.join(d, "tlab.ini"),
                    "--outdir", d, "--steps", str(steps))
        finally:
            _x64(was_x64)
        runs[name] = d

    _x64(True)
    try:
        sim = Simulation.from_case(os.path.join(workdir, "tlab.ini"),
                                   dtype=jnp.float64)
        out = {}
        for name, d in runs.items():
            rows = cs._log_rows(os.path.join(d, "dns.out"))
            f = cs._read_fields(d, steps)
            u, v, w = (jnp.asarray(f[f"flow.{steps}.{i}"]) for i in (1, 2, 3))
            div = np.asarray(dyn.divergence(sim.P, u, v, w))
            ny = div.shape[1]
            by_y = np.max(np.abs(div), axis=(0, 2))
            out[name] = {
                "dil_min": rows[:, 7].tolist(), "dil_max": rows[:, 8].tolist(),
                "y_of_min": int(np.unravel_index(div.argmin(), div.shape)[1]),
                "y_of_max": int(np.unravel_index(div.argmax(), div.shape)[1]),
                "wall_rows": float(max(by_y[0], by_y[-1])),
                "next_3_rows": float(max(by_y[1:4].max(), by_y[-4:-1].max())),
                "middle_half": float(by_y[ny // 4:3 * ny // 4].max())}
    finally:
        _x64(was_x64)
    diff = np.max(np.abs(np.array([out["f32"]["dil_min"], out["f32"]["dil_max"]])
                         - np.array([out["f64"]["dil_min"],
                                     out["f64"]["dil_max"]])), axis=0)
    out["f32_minus_f64"] = {"per_step": diff.tolist(),
                            "max": float(diff.max())}
    return out


def op_scopes(hlo_text: str, scopes=LAYERS) -> dict:
    """HLO instruction name -> the first of `scopes` its op_name passes
    through, else 'other'."""
    out = {}
    for m in re.finditer(r'%([\w.\-]+) = [^\n]*?op_name="([^"]*)"',
                         hlo_text):
        parts = m.group(2).split("/")
        out[m.group(1)] = next((s for s in scopes if s in parts), "other")
    return out


def _is_matmul(kernel: str, hlo_op: str) -> bool:
    return "gemm" in kernel or hlo_op.startswith(("custom-call", "dot",
                                                   "gemm_fusion"))


def layer_breakdown(events, scopes: dict, n_steps: int) -> dict:
    """Device time per layer from kernel events (stream, kernel name, HLO
    op, start ns, duration ns) of `n_steps` steps; the Burgers layer
    split into its matmuls and the rest (the combine and the round trip
    of its 2F-field product).  Layer and stream times sum kernel
    durations, so with kernels on several streams at once they can add
    up to more than the busy time, which counts each instant once."""
    ms, streams, unmapped, spans = {}, {}, {}, []
    for stream, kernel, hlo_op, start, dur in events:
        layer = scopes.get(hlo_op, "other")
        if hlo_op not in scopes:
            unmapped[hlo_op or kernel] = unmapped.get(hlo_op or kernel,
                                                      0) + dur
        if layer == "burgers":
            layer += "_matmul" if _is_matmul(kernel, hlo_op) else "_rest"
        ms[layer] = ms.get(layer, 0.0) + dur / 1e6 / n_steps
        streams[stream] = streams.get(stream, 0.0) + dur / 1e6 / n_steps
        spans.append((start, start + dur))
    busy, end = 0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    window = max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans) \
        if spans else 0
    total = sum(ms.values())
    top = sorted(unmapped.items(), key=lambda kv: -kv[1])[:5]
    return {"ms_per_step": ms,
            "share": {k: v / total for k, v in ms.items()},
            "stream_ms_per_step": streams,
            "busy_ms_per_step": busy / 1e6 / n_steps,
            "window_ms_per_step": window / 1e6 / n_steps,
            "idle_share": 1.0 - busy / window if window else None,
            "unmapped_top_ms": {k: v / 1e6 / n_steps for k, v in top}}


def _device_events(trace_dir: str):
    import jax
    path, = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                hlo_op = dict(ev.stats).get("hlo_op", "")
                yield (line.name, ev.name, hlo_op, ev.start_ns,
                       ev.duration_ns)


def trace_study(workdir: str, n_steps: int = 2) -> dict:
    """Profile `n_steps` f32 steps of the case in `workdir` as the dns
    driver runs them (make_step_functions: RK step, CFL, dilatation) and
    split the device time by layer (named scopes of the compiled step)."""
    import time
    import jax
    import jax.numpy as jnp
    from tlab_tpu.runtime import Simulation
    from tlab_tpu.tools.dns import make_step_functions
    st32, _, dtime = cs.initial_state(workdir)
    sim = Simulation.from_case(os.path.join(workdir, "tlab.ini"),
                               dtype=jnp.float32)
    step, _ = make_step_functions(sim)
    # one program holding the driver's step, so that its HLO names the
    # kernels the trace records
    prog = jax.jit(step)
    scopes = op_scopes(prog.lower(st32, dtime).compile().as_text())
    ms = {}
    for name, fn in (("driver", step), ("traced", prog)):
        jax.block_until_ready(fn(st32, dtime))
        times = []
        for _ in range(3):
            t = time.perf_counter()
            jax.block_until_ready(fn(st32, dtime))
            times.append(time.perf_counter() - t)
        ms[name] = float(np.median(times)) * 1e3
    tdir = os.path.join(workdir, "trace")
    shutil.rmtree(tdir, ignore_errors=True)
    jax.profiler.start_trace(tdir)
    for _ in range(n_steps):
        jax.block_until_ready(prog(st32, dtime))
    jax.profiler.stop_trace()
    res = layer_breakdown(_device_events(tdir), scopes, n_steps)
    n = st32.u.size
    n_fields = 3 + st32.s.shape[0]
    # the [D1;D2] product of all fields, written and read back, per
    # direction, per substep
    res["burgers_roundtrip_bytes_per_substep"] = 3 * 2 * 2 * n_fields * n * 4
    res["step_ms"] = ms
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("studies", nargs="+", choices=STUDIES)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (with --shape)")
    ap.add_argument("--shape", default="",
                    help="NX,NY,NZ instead of the case's 512,256,256")
    args = ap.parse_args(argv)
    if "trace" in args.studies:
        if len(args.studies) > 1:
            raise SystemExit("trace runs alone")
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_gpu_enable_command_buffer=")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        card = "cpu"
    else:
        dev = cs.device_phase()
        card = dev["card"]
        cs.native_phase()
    jax.config.update("jax_enable_compilation_cache", False)
    shape = tuple(int(a) for a in args.shape.split(",")) if args.shape \
        else None
    workdir = os.path.join(cs.REPO, ".chip_smoke", "study")
    cs.prepare_case(workdir, cs.STEPS, shape)
    for study in args.studies:
        if study == "dilatation":
            res = {"runs": dilatation_study(workdir)}
        elif study == "trace":
            res = {"xla": trace_study(workdir)}
        else:
            res = step_study(workdir, study)
        for name, r in res.items():
            print(f"{study} {name} [{card}]: {json.dumps(r)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
