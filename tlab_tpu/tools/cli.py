"""Command-line entry points sharing one tlab.ini-compatible config.

Usage:  python -m tlab_tpu.tools.cli <command> [--ini tlab.ini] [options]
Commands: inigrid, inirand, iniflow, iniscal, dns, bench-step.
Equivalent surface to the reference executables inigrid.x/inirand.x/
iniflow.x/iniscal.x/dns.x.
"""
from __future__ import annotations

import argparse
import os
import sys


def _cloud_tool(args) -> int:
    """state/smooth/saturation/reversal: the reference cloud-state
    executables (src/tools/cloud/{state,smooth,saturation,reversal}.f90,
    shipped binaries per src/tools/CMakeLists.txt:135-143) with flags in
    place of the interactive prompts.  [Thermodynamics] of --ini is
    honored when the file exists; outputs go to --outdir."""
    import numpy as np
    from tlab_tpu.physics import thermo
    from tlab_tpu.tools import cloudstate as cs

    kw = {"mixture": "airwater"}
    if os.path.exists(args.ini):
        from tlab_tpu.config import load_case
        tcfg = getattr(load_case(args.ini), "thermo", {}) or {}
        sh = tcfg.get("scale_height", 0.0)
        kw.update(scale_height_inv=(1.0 / sh if sh > 0 else 0.0),
                  dsmooth=tcfg.get("smooth", 0.0),
                  thermo_param=tuple(tcfg.get("parameters", ())),
                  nondimensional=tcfg.get("nondimensional", True))
    tp = thermo.ThermoParams(**kw)
    os.makedirs(args.outdir, exist_ok=True)

    def sweep(default_lo, default_hi, n=None):
        if args.sweep:
            lo, hi, npts = args.sweep.split(",")
            return np.linspace(float(lo), float(hi), int(npts))
        return np.linspace(default_lo, default_hi, n or args.npts)

    if args.command == "state":
        if args.h is None or args.qt is None:
            raise SystemExit("state: --h and --qt required (p-h case)")
        import jax.numpy as jnp
        T, ql = thermo.equilibrium_T_ql(
            tp, jnp.full(1, args.h), jnp.full(1, args.qt),
            jnp.full(1, args.p), jnp.zeros(1))
        qs = float(tp.qsat(T, jnp.asarray(args.p))[0])
        R = float(thermo.mixture_R(tp, jnp.full(1, args.qt), ql)[0])
        rows = {"p": args.p, "h": args.h, "qt": args.qt,
                "T": float(T[0]), "ql": float(ql[0]),
                "qv": args.qt - float(ql[0]), "qsat": qs,
                "R": R, "rho": args.p / (R * float(T[0]))}
        path = os.path.join(args.outdir, "state.dat")
        with open(path, "w") as fh:
            fh.write("# " + " ".join(rows) + "\n")
            fh.write(" ".join(f"{v:.10e}" for v in rows.values()) + "\n")
        for k, v in rows.items():
            print(f"{k:5s} = {v:.10e}")
        return 0

    if args.command == "smooth":
        if args.h is None:
            raise SystemExit("smooth: --h required (p-h sweep over qt)")
        qt = sweep(0.0, 0.05)
        cs.vapor_table(tp, args.p, args.h, qt,
                       path=os.path.join(args.outdir, "vapor.dat"))
        print(f"vapor.dat written ({qt.size} rows, p={args.p}, "
              f"h={args.h})")
        return 0

    if args.command == "saturation":
        T = sweep(0.85, 1.05)
        qs = cs.saturation_curve(tp, T, args.p)
        path = os.path.join(args.outdir, "sat.dat")
        np.savetxt(path, np.column_stack([T, qs]),
                   header=f"T qsat(p={args.p})")
        print(f"sat.dat written ({T.size} rows)")
        return 0

    # reversal
    if None in (args.h, args.qt, args.h2, args.qt2):
        raise SystemExit("reversal: --h --qt --h2 --qt2 required")
    d = cs.buoyancy_reversal(tp, args.h, args.qt, args.h2, args.qt2,
                             args.p, n=args.npts)
    path = os.path.join(args.outdir, "reversal.dat")
    cols = ("chi", "h", "qt", "T", "ql", "b")
    np.savetxt(path, np.column_stack([d[k] for k in cols]),
               header=" ".join(cols)
               + f"  chi_star={d['chi_star']:.6e}"
                 f" b_star={d['b_star']:.6e} chi_s={d['chi_s']:.6e}")
    print(f"reversal.dat written; chi_star={d['chi_star']:.6e} "
          f"b_star={d['b_star']:.6e} chi_s={d['chi_s']:.6e}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tlab-tpu")
    ap.add_argument("command", choices=["inigrid", "inirand", "iniflow",
                                        "iniscal", "ini", "inipart", "dns",
                                        "averages", "spectra", "pdfs", "superlayer",
                                        "visuals", "transfields",
                                        "transgrid", "apriori",
                                        "planes2nc", "tower2nc",
                                        "stats2nc",
                                        "state", "smooth", "saturation",
                                        "reversal"])
    ap.add_argument("--ini2", default="",
                    help="target-case ini for transfields remeshing")
    ap.add_argument("--nparticles", type=int, default=10000)
    ap.add_argument("--inner-steps", type=int, default=1,
                    help="RK steps per device dispatch (fixed dt within)")
    ap.add_argument("--mesh", default="",
                    help="PX,PZ device mesh for a multi-device dns run "
                         "(the reference's per-task [Grid] Imax(*)/Kmax(*) "
                         "analog); also read from [Parallel] Mesh")
    ap.add_argument("--ini", default="tlab.ini")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--seed", type=int, default=None,
                    help="override [Broadband] Seed (default: ini value)")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 (validation mode)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as JAX_PLATFORMS=cpu does); "
                         "without it a run that finds no GPU stops")
    ap.add_argument("--debug-nans", action="store_true",
                    help="trap the first NaN/Inf produced by any jit "
                         "computation with a traceback (the reference's "
                         "debug-build FPE trap, config/*.cmake "
                         "-ffpe-trap); also [Main] DebugNans=yes")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--files", default="",
                    help="comma-separated snapshot iterations for postprocessing")
    ap.add_argument("--fields", default="",
                    help="comma-separated derived fields for visuals "
                         "(default: [PostProcessing] ParamVisuals, else "
                         "Enstrophy)")
    ap.add_argument("--cross", action="store_true",
                    help="spectra: add pair cross-spectra (pow/pha)")
    ap.add_argument("--correlations", action="store_true",
                    help="spectra: add two-point correlations (xcr/zcr)")
    ap.add_argument("--y-blocks", type=int, default=0,
                    help="spectra: write 2-D (kx,kz) spectra in y blocks")
    ap.add_argument("--gate-scalar", type=int, default=0,
                    help="averages: condition on scalar # > gate level")
    ap.add_argument("--gate-level", type=float, default=0.0)
    ap.add_argument("--refine", type=int, default=2,
                    help="transgrid: points multiplier per direction")
    # cloud-state tools (reference state.x/smooth.x/saturation.x/
    # reversal.x, src/tools/cloud) -- flags replace the interactive
    # prompts; [Thermodynamics] of --ini is honored when present
    ap.add_argument("--p", type=float, default=1.0,
                    help="cloud tools: pressure (nondimensional)")
    ap.add_argument("--h", type=float, default=None,
                    help="cloud tools: static enthalpy")
    ap.add_argument("--qt", type=float, default=None,
                    help="cloud tools: total-water specific humidity")
    ap.add_argument("--h2", type=float, default=None,
                    help="reversal: enthalpy of the second parcel")
    ap.add_argument("--qt2", type=float, default=None,
                    help="reversal: qt of the second parcel")
    ap.add_argument("--range", dest="sweep", default="",
                    help="smooth/saturation: sweep 'start,stop,n'")
    ap.add_argument("--npts", type=int, default=201,
                    help="cloud tools: points along the mixing line")
    ap.add_argument("--grid-in", default="grid")
    ap.add_argument("--grid-out", default="grid.ref")
    args = ap.parse_args(argv)

    import jax
    from tlab_tpu.utils.device import enable_compile_cache
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() == "cpu" \
            and jax.config.jax_platforms != "cpu":
        raise SystemExit("no GPU found; pass --cpu or set JAX_PLATFORMS=cpu "
                         "to run on the CPU")
    enable_compile_cache()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    from tlab_tpu.config import load_case
    from tlab_tpu.runtime import Simulation, grid_from_case
    from tlab_tpu.grid import write_reference_grid

    if args.command == "transgrid":
        # grid refinement/coarsening (reference transgrid.f90): resample
        # each axis's nodes with a cubic spline in the arc parameter
        from tlab_tpu.grid import (read_reference_grid,
                                   write_reference_grid, make_axis, Grid)
        import numpy as np
        g = read_reference_grid(os.path.join(args.outdir, args.grid_in))
        axes = []
        for ax in (g.x, g.y, g.z):
            if ax.size <= 1:
                axes.append(ax)
                continue
            n_new = ax.size * args.refine if args.refine > 0 \
                else ax.size // (-args.refine)
            t_old = np.linspace(0.0, 1.0, ax.size)
            t_new = np.linspace(0.0, 1.0, n_new)
            nodes = np.interp(t_new, t_old, ax.nodes)
            axes.append(make_axis(nodes, ax.periodic))
        write_reference_grid(os.path.join(args.outdir, args.grid_out),
                             Grid(*axes))
        print(f"transgrid done -> {args.grid_out}")
        return 0


    if args.command in ("state", "smooth", "saturation", "reversal"):
        return _cloud_tool(args)

    case = load_case(args.ini)
    ini0 = getattr(case, "ini", None)
    if ini0 is not None and ini0.get("Main", "DebugNans",
                                     "no").lower() in ("yes", "true"):
        jax.config.update("jax_debug_nans", True)
    os.makedirs(args.outdir, exist_ok=True)
    from tlab_tpu.utils import trace
    trace.maybe_init(case, args.outdir)
    trace.point(f"tool {args.command} starting ({args.ini})")

    if args.command == "inigrid":
        grid = grid_from_case(case)
        write_reference_grid(os.path.join(args.outdir, "grid"), grid)
        case.ini.write_bak(os.path.join(args.outdir,
                                        os.path.basename(args.ini) + ".bak"))
        print(f"grid written: {grid.shape}")
        return 0

    sim = Simulation.from_case(case)

    is_comp = getattr(sim, "comp", None) is not None

    if args.command in ("inirand", "iniflow", "iniscal", "ini"):
        from tlab_tpu.io import fields_io
        if is_comp:
            # compressible restart: 5 conservative fields
            # (reference inb_flow=5, io_fields flow.<it>.1-5)
            from tlab_tpu.tools.initialize import compressible_initial_state
            U = compressible_initial_state(sim, seed=args.seed)
            fields_io.write_comp_state(os.path.join(args.outdir, "flow"),
                                       case.it_start, U, 0.0, sim.nsp.visc)
        else:
            from tlab_tpu.tools.initialize import initial_state
            state = initial_state(sim, seed=args.seed)
            fields_io.write_state(os.path.join(args.outdir, "flow"),
                                  os.path.join(args.outdir, "scal"),
                                  case.it_start, state, 0.0, sim.nsp.visc)
        print(f"initial fields written at it={case.it_start}")
        return 0

    if args.command == "dns":
        from tlab_tpu.io import fields_io
        from tlab_tpu.tools import dns as dns_tool
        from tlab_tpu.dycore.state import State
        import jax.numpy as jnp
        import numpy as np

        # multi-device mesh: --mesh PX,PZ or [Parallel] Mesh=PX,PZ
        mesh = None
        mesh_spec = args.mesh or (case.ini.get("Parallel", "Mesh", "")
                                  if getattr(case, "ini", None) else "")
        if mesh_spec:
            from tlab_tpu.parallel.mesh import make_mesh
            px, pz = (int(v) for v in mesh_spec.split(","))
            mesh = make_mesh(px, pz)

        it0 = case.it_start
        if is_comp:
            from tlab_tpu.dycore.compressible import CompState
            U0, rtime, _ = fields_io.read_comp_state(
                os.path.join(args.outdir, "flow"), it0)
            state = CompState(*(jnp.asarray(a, sim.dtype)
                                if a is not None else None
                                for a in U0))
            run = dns_tool.run(sim, state, outdir=args.outdir, itime=it0,
                               rtime=float(rtime), n_steps=args.steps,
                               log_path=os.path.join(args.outdir,
                                                     "dns.out"),
                               inner_steps=args.inner_steps, mesh=mesh)
            print("\n".join(run.log.lines[-3:]))
            return 0
        u, v, w, s, rtime, visc0 = fields_io.read_state(
            os.path.join(args.outdir, "flow"),
            os.path.join(args.outdir, "scal"), it0, sim.nsp.n_scalars)
        state = State(u=jnp.asarray(u, sim.dtype), v=jnp.asarray(v, sim.dtype),
                      w=jnp.asarray(w, sim.dtype),
                      s=jnp.asarray(s, sim.dtype))
        # Lagrangian particles (reference dns.x particle path): engaged
        # when [Particles] Type is set and a part.<it> restart exists
        pstate = pprops = None
        if getattr(case, "ini", None) is not None:
            from tlab_tpu.particles.core import props_from_ini
            pprops = props_from_ini(case.ini)
            ppath = os.path.join(args.outdir, f"part.{it0}")
            if pprops is not None and os.path.exists(ppath):
                from tlab_tpu.particles.io import read_particles
                pstate, _ = read_particles(ppath)
            elif pprops is not None:
                pprops = None           # no particle restart -> flow only
        run = dns_tool.run(sim, state, outdir=args.outdir, itime=it0,
                           rtime=float(rtime), n_steps=args.steps,
                           log_path=os.path.join(args.outdir, "dns.out"),
                           inner_steps=args.inner_steps,
                           pstate=pstate, particle_props=pprops,
                           restart_visc=float(visc0) if visc0 else None,
                           mesh=mesh)
        print("\n".join(run.log.lines[-3:]))
        return 0

    if args.command == "inipart":
        from tlab_tpu.particles.core import init_particles
        from tlab_tpu.particles.io import write_particles
        ini = getattr(case, "ini", None)
        n_part = ini.get_int("Particles", "Number", args.nparticles) \
            if ini is not None else args.nparticles
        kw = {}
        if ini is not None:
            # [Particles] IniP block (particle_main.f90:65-84,198-254):
            # ymean from YMeanIniP or relative YMeanRelativeIniP*scale,
            # slab width DiamIniP; ProfileIniP=scalar/hardcoded special.
            g = sim.grid
            rel = ini.get("Particles", "YMeanRelativeIniP", "")
            absm = ini.get("Particles", "YMeanIniP", "")
            if absm:
                kw["ymean"] = float(absm)
            elif rel:
                kw["ymean"] = float(g.y.nodes[0]) + float(g.y.scale) * float(rel)
            diam = ini.get("Particles", "DiamIniP", "")
            if diam:
                kw["diam"] = float(diam)
            prof = ini.get("Particles", "ProfileIniP", "none").lower()
            if prof == "hardcoded":
                kw["mode"] = "hardcoded"
            elif prof == "scalar":
                from tlab_tpu.io import fields_io
                s1, _, _ = fields_io.read_field(
                    os.path.join(args.outdir, f"scal.{case.it_start}.1"))
                kw.update(mode="scalar", scal=s1,
                          scal_mean=ini.get_float("Scalar", "MeanScalar1", 0.0),
                          scal_delta=ini.get_float("Scalar", "DeltaScalar1", 1.0))
        ps = init_particles(sim.grid, n_part,
                            seed=7 if args.seed is None else args.seed, **kw)
        from tlab_tpu.particles.core import props_from_ini, n_props
        pprops = props_from_ini(ini) if ini is not None else None
        if pprops is not None and pprops.type.startswith("bil_cloud"):
            # droplet scalars start at the LOCAL airwaterlinear liquid
            # interpolated to the particle (particle_main.f90:266-281);
            # bil_cloud_4 residence clocks start at zero
            import numpy as _np
            import jax.numpy as _jnp
            npp = n_props(pprops)
            pr = _np.zeros((n_part, npp))
            tcfg = getattr(case, "thermo", {}) or {}
            s1p = os.path.join(args.outdir, f"scal.{case.it_start}.1")
            if tcfg.get("mixture") == "airwaterlinear" \
                    and tcfg.get("parameters") and os.path.exists(s1p):
                from tlab_tpu.io import fields_io
                from tlab_tpu.physics import thermo as th
                from tlab_tpu.particles.core import (
                    make_locator, interpolate_to_particles)
                s1, _, _ = fields_io.read_field(s1p)
                s2p = os.path.join(args.outdir,
                                   f"scal.{case.it_start}.2")
                fields = [_jnp.asarray(s1)]
                if os.path.exists(s2p):
                    fields.append(_jnp.asarray(
                        fields_io.read_field(s2p)[0]))
                loc = make_locator(sim.grid)(_jnp.asarray(ps.x))
                sp = _jnp.stack([interpolate_to_particles(f, loc)
                                 for f in fields])
                liq = _np.asarray(th.airwater_linear(
                    tuple(tcfg["parameters"]), sp))
                pr[:, 0] = liq
                pr[:, 1] = liq
            ps = ps._replace(props=_jnp.asarray(pr))
        write_particles(os.path.join(args.outdir, f"part.{case.it_start}"),
                        ps, case.it_start)
        print(f"{n_part} particles written")
        return 0

    if args.command == "transfields":
        from tlab_tpu.config import load_case as lc
        from tlab_tpu.runtime import grid_from_case
        from tlab_tpu.ops.interpolate import remesh_field
        from tlab_tpu.io import fields_io
        import jax.numpy as jnp
        import numpy as np
        case2 = lc(args.ini2)
        grid2 = grid_from_case(case2)
        its = [int(t) for t in args.files.split(",") if t]
        for it in its:
            u, v, w, s, rtime, visc_ = fields_io.read_state(
                os.path.join(args.outdir, "flow"),
                os.path.join(args.outdir, "scal"), it, sim.nsp.n_scalars)
            from tlab_tpu.dycore.state import State
            new = State(
                u=remesh_field(jnp.asarray(u), sim.grid, grid2),
                v=remesh_field(jnp.asarray(v), sim.grid, grid2),
                w=remesh_field(jnp.asarray(w), sim.grid, grid2),
                s=jnp.stack([remesh_field(jnp.asarray(s[i]), sim.grid, grid2)
                             for i in range(s.shape[0])]) if s.shape[0]
                else jnp.zeros((0,) + grid2.shape))
            fields_io.write_state(os.path.join(args.outdir, "flow_rm"),
                                  os.path.join(args.outdir, "scal_rm"),
                                  it, new, float(rtime), float(visc_))
        print(f"remeshed {its} onto {grid2.shape}")
        return 0

    if args.command in ("planes2nc", "tower2nc", "stats2nc"):
        # scripts/python ecosystem converters (Planes2nc.py, tower2nc.py,
        # stats2nc.py): reference binaries -> NetCDF
        from tlab_tpu.tools import convert
        its = [int(t) for t in args.files.split(",") if t]
        if not its and args.command != "tower2nc":
            its = [int(v) for v in
                   case.ini.get_floats("PostProcessing", "Files", ())]
        if args.command == "planes2nc":
            out = convert.planes_to_nc(sim, args.outdir, its)
        elif args.command == "tower2nc":
            out = convert.towers_to_nc(sim, args.outdir)
            out = [out] if out else []
        else:
            out = convert.stats_to_nc(args.outdir, its)
        print(f"{args.command}: wrote {out}")
        return 0

    if args.command in ("averages", "spectra", "pdfs", "superlayer",
                        "visuals", "apriori"):
        from tlab_tpu.tools import postprocess as pp
        its = [int(t) for t in args.files.split(",") if t]
        if not its:
            # [PostProcessing] Files = iteration list (the reference
            # tools' batch input, dns_read_times.h)
            its = [int(v) for v in
                   case.ini.get_floats("PostProcessing", "Files", ())]
        fields = tuple(f for f in args.fields.split(",") if f) \
            or ("Enstrophy",)
        pvis = case.ini.get_floats("PostProcessing", "ParamVisuals", ())
        if args.command == "visuals" and not args.fields and pvis:
            # ParamVisuals quantity indices -> names (visuals.f90 menu,
            # iscal_offset = 9 for single-species)
            ns_ = sim.nsp.n_scalars
            lpe = ("LogPotentialEnstrophy",)
            eps_s = ("EpsSolid",) if sim.P.get("ibm") else ()
            tcfg = getattr(case, "thermo", None) or {}
            mix = (tcfg.get("mixture", "") or "").lower()
            # Damkohler(1)>0 = non-equilibrium airwater, prognostic
            # liquid as scalar 3 (visuals.f90:527 Supsat gate)
            damk = case.ini.get_floats("Parameters", "Damkohler", ())
            sups = ("Supsat",) if (mix == "airwater" and ns_ >= 3
                                   and damk and damk[0] > 0.0) else ()
            # species sub-menu + iscal_offset = 9 + NSP for mixtures
            # (visuals.f90:166-167,189-192,649-668)
            from tlab_tpu.physics.mixtures import MIXTURES
            if mix in ("", "none"):
                spn = ()
            elif mix == "airwater":
                spn = ("H2Ov", "Air", "H2Ol")
            elif mix == "airvapor":
                spn = ("H2Ov", "Air")
            elif mix == "airwaterlinear":
                spn = ("Chi", "Psi") + tuple(
                    f"Scalar{i}" for i in range(3, ns_ + 1)) + ("Liquid",)
            elif mix in MIXTURES:
                spn = MIXTURES[mix]
            else:
                spn = tuple(f"Scalar{i + 1}" for i in range(ns_))
            off = 9 + len(spn) if spn else 9
            scal9 = tuple(f"Scalar{i + 1}" for i in range(max(ns_, 1)))
            if mix in ("airwater", "airwaterlinear"):
                scal9 = scal9 + ("Liquid",)   # the inb_scal_array slot
            menu = {1: ("VelocityX",), 2: ("VelocityY",),
                    3: ("VelocityZ",),
                    4: ("VelocityVector",),
                    5: ("VelocityMagnitude",),
                    6: ("Density",), 7: ("Temperature",) + sups,
                    8: ("Pressure", "PressureGradientPower",
                        "PressureStrainX", "PressureStrainY",
                        "PressureStrainZ", "PressureHydrostatic",
                        "PressureHydrodynamic"),
                    9: scal9}
            for i, nm in enumerate(spn):
                menu[10 + i] = (nm,)
            menu.update({
                off + 1: ("ScalarGradientVector",),
                off + 2: ("ScalarGradient",),
                off + 3: ("ScalarGradientProduction",),
                off + 4: ("VorticityVector",),
                off + 5: ("LogEnstrophy",) + lpe,
                off + 6: ("Enstrophy", "EnstrophyProduction",
                          "EnstrophyDiffusion") + lpe,
                off + 7: ("StrainTensor",),
                # +8/+9 share the Strain block which also accumulates
                # the stress tensor + IBM mask (visuals.f90:786-830)
                off + 8: ("LogStrain", "StressTensor") + eps_s,
                off + 9: ("Strain", "StressTensor", "StrainProduction",
                          "StrainDiffusion", "StrainPressure") + eps_s,
                off + 10: ("InvariantP", "InvariantQ", "InvariantR"),
                off + 12: ("Buoyancy", "Fvb", "bPrime", "Cvb",
                           "LogBuoyancySource"),
                off + 14: ("HorizontalDivergence",),
                off + 15: ("Tke", "ReynoldsTensor"),
                off + 16: ("Radiation",),
                off + 17: ("RelativeHumidity",),
                off + 18: ("ParticleDensity",),
                off + 19: ("LaplacianV", "Buoyancy", "LaplacianB",
                           "GradientRi", "Pressure", "PressureGradientY"),
                off + 20: ("StressTensor",) + eps_s})
            if case.ini.get("PostProcessing", "PressureDecomposition",
                            "total").lower() == "resolved":
                menu[8] = menu[8] + (
                    "PressureCoriolis", "PressureBuoyancy",
                    "PressureDiffusion", "PressureAdvection",
                    "PressureAdvDiff", "PressureTotal")
            fields = tuple(n for v in pvis for n in menu.get(int(v), ()))
            if not fields:
                fields = ("Enstrophy",)
        if args.command == "averages":
            pp.run_averages(sim, args.outdir, its,
                            gate_scalar=args.gate_scalar,
                            gate_level=args.gate_level)
        elif args.command == "spectra":
            cross, corr, ybl = (args.cross, args.correlations,
                                args.y_blocks)
            psp = case.ini.get_floats("PostProcessing", "ParamSpectra",
                                      ())
            if psp and not (cross or corr or ybl):
                # ParamSpectra: 1 spectra, 2 cross-spectra,
                # 3 correlations, 4 cross-correlations (spectra.f90 menu)
                om = int(psp[0])
                cross = om in (2, 4)
                corr = om in (3, 4)
            pp.run_spectra(sim, args.outdir, its, cross=cross,
                           correlations=corr, y_blocks=ybl)
        elif args.command == "pdfs":
            pp.run_pdfs(sim, args.outdir, its)
        elif args.command == "superlayer":
            pp.run_superlayer(sim, args.outdir, its)
        elif args.command == "apriori":
            pp.run_apriori(sim, args.outdir, its)
        else:
            pp.run_visuals(sim, args.outdir, its, which=fields)
        print(f"{args.command} done for {its}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
