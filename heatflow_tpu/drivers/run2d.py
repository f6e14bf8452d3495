"""2D axisymmetric transient driver — the framework's flagship entry point.

Parameter surface, on-disk artifacts, and console reporting mirror the
reference's ``run_simulation`` (ref run_no_diamond.py:29-653 and
run_with_diamond.py:27-551; the material layout is auto-detected from the
config so one driver covers both the 5-material and the 9-material DAC
geometry). Outputs per run:

  * ``used_config.yaml``          — copy of the config actually used
  * ``watcher_points.csv``        — time column + one column per watcher
  * ``radial_gradient.csv``       — z-binned band-averaged ∂T/∂r (time index)
  * ``radial_gradient_raw.csv``   — raw ∂T/∂r at r=0 nodes (time index)
  * ``output.xdmf`` / ``.h5``     — full temperature time series
  * mesh folder: ``mesh.msh`` + ``mesh_cfg.yaml`` (with material_tags)
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.config import (load_config, load_yaml, save_config,
                                 validate_config)
from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh.msh_io import write_msh
from heatflow_tpu.mesh.structured import build_structured_mesh, mesh_from_meta
from heatflow_tpu.io.csvio import write_gradient_csv, write_watcher_csv
from heatflow_tpu.sim.bc import HeatingCurve
from heatflow_tpu.sim.problem import build_problem
from heatflow_tpu.sim.stepper import run_transient


@contextlib.contextmanager
def suppress_output(enabled: bool):
    """Silence stdout/stderr (sweep workers), ref run_no_diamond.py:20-27."""
    if not enabled:
        yield
    else:
        with open(os.devnull, "w") as fnull:
            with contextlib.redirect_stdout(fnull), \
                 contextlib.redirect_stderr(fnull):
                yield


def default_dtype():
    """float64 when x64 is enabled (parity runs), else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _prepare_mesh(cfg, mesh_folder, rebuild_mesh, layout,
                  mesh_style="structured"):
    """Build-or-load the mesh, persisting/consuming mesh.msh + mesh_cfg.yaml
    exactly like the reference (ref run_no_diamond.py:140-180).

    mesh_style: 'structured' (graded tensor grid, the default) or
    'unstructured' (graded non-grid triangulation — the analogue of the
    reference's gmsh meshes, ref mesh_and_materials/mesh.py:81-149; runs
    through the ELL operator path)."""
    mesh_cfg_path = os.path.join(mesh_folder, "mesh_cfg.yaml")
    mesh_file_path = os.path.join(mesh_folder, "mesh.msh")
    domain, mats = build_layout(cfg, layout)

    if rebuild_mesh:
        os.makedirs(mesh_folder, exist_ok=True)
        mesh_cfg = copy.deepcopy(cfg)
        if mesh_style == "unstructured":
            from heatflow_tpu.mesh.unstructured_gen import \
                build_unstructured_mesh
            umesh = build_unstructured_mesh(domain, mats)
            mesh_cfg["material_tags"] = dict(umesh.material_tags)
            # no structured_grid key → reloads through the import path
            save_config(mesh_cfg, mesh_cfg_path)
            write_msh(mesh_file_path, umesh.nodes, umesh.cells,
                      umesh.cell_tags, umesh.material_tags)
            if umesh.grid_overlay is not None:
                # lattice sidecar → the 9-point stencil operator path
                np.savez(os.path.join(mesh_folder, "mesh_overlay.npz"),
                         shape=np.asarray(umesh.grid_overlay["shape"]),
                         index=umesh.grid_overlay["index"])
            return umesh
        if mesh_style != "structured":
            raise ValueError(f"unknown mesh_style {mesh_style!r}")
        mesh = build_structured_mesh(domain, mats)
        mesh_cfg["material_tags"] = dict(mesh.material_tags)
        mesh_cfg["structured_grid"] = mesh.to_meta()
        save_config(mesh_cfg, mesh_cfg_path)
        tris, tri_tags = mesh.triangles()
        write_msh(mesh_file_path, mesh.node_coords(), tris, tri_tags,
                  mesh.material_tags)
        return mesh
    missing = [n for n, p in (("mesh.msh", mesh_file_path),
                              ("mesh_cfg.yaml", mesh_cfg_path))
               if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(
            f"Missing required file(s) in {mesh_folder}: {', '.join(missing)}")
    mesh_cfg = load_yaml(mesh_cfg_path)
    if mesh_style == "unstructured" and "structured_grid" in mesh_cfg:
        raise ValueError(
            f"{mesh_folder} holds a structured mesh but "
            "mesh_style='unstructured' was requested; pass rebuild_mesh=True "
            "to regenerate it")
    if "structured_grid" not in mesh_cfg:
        # externally produced mesh (e.g. the reference's gmsh output):
        # import and run through the unstructured path (grid-overlay
        # stencil when a lattice sidecar exists, ELL otherwise)
        from heatflow_tpu.mesh.msh_io import read_msh
        umesh = read_msh(mesh_file_path)
        if not umesh.material_tags:
            umesh.material_tags = dict(mesh_cfg.get("material_tags", {}))
        overlay_path = os.path.join(mesh_folder, "mesh_overlay.npz")
        if os.path.isfile(overlay_path):
            with np.load(overlay_path) as ov:
                umesh.grid_overlay = {"shape": tuple(ov["shape"]),
                                      "index": ov["index"]}
        return umesh
    return mesh_from_meta(mesh_cfg["structured_grid"], materials=mats)


def run_simulation(cfg, mesh_folder, rebuild_mesh=False, visualize_mesh=False,
                   output_folder=None, watcher_points=None, write_xdmf=True,
                   suppress_print=False, *, layout="auto", dtype=None,
                   rtol=None, maxiter=20000, record_gradient=True,
                   solver="auto", profile_dir=None, resume_from=None,
                   write_checkpoint=True, mesh_style="structured",
                   warm_start=None, precondition=None,
                   z_shards=1, f64_refine=0):
    """Run the 2D transient simulation. See module docstring for outputs.

    watcher_points: dict name -> (z, r), or list of {'name','coords'} dicts
    (same accepted forms as the reference, ref run_no_diamond.py:385-393).
    """
    with suppress_output(suppress_print):
        t_start = time.time()
        validate_config(cfg, require_heating_file=True)
        if f64_refine and dtype is None:
            dtype = jnp.float32   # refinement IS the mixed-precision mode
        dtype = dtype or default_dtype()
        if warm_start is None:
            # the linearly-extrapolated seed measures ~2x lower f32 trace
            # error at equal iterations (and is part of the official
            # flagship point); f64 runs keep 'previous' (converged either
            # way — and golden traces stay byte-stable)
            warm_start = ("extrapolate" if jnp.dtype(dtype) == jnp.float32
                          else "previous")
        if rtol is None:
            # increment-relative stopping (stepper default rtol_wrt='r0'):
            # 1e-4 keeps f32 traces at the f32 noise floor; with refinement
            # it is the inner correction tolerance
            rtol = 1e-11 if dtype == jnp.float64 else 1e-4

        mesh = _prepare_mesh(cfg, mesh_folder, rebuild_mesh, layout,
                             mesh_style)
        if visualize_mesh:
            from heatflow_tpu.mesh.viz import plot_mesh
            png = os.path.join(mesh_folder, "mesh_visualization.png")
            plot_mesh(mesh, png)
            print(f"Mesh visualization written to {png}")
        from heatflow_tpu.mesh.msh_io import UnstructuredMesh
        if precondition is None:
            # per-regime line-preconditioner defaults for f32 structured
            # runs (pure-f32 'adi', refined 'rline'); see
            # utils.resolve_recording_precondition. rtol_wrt forwarded
            # explicitly (run2d always steps with increment-relative 'r0'
            # stopping — see the make_simulate_fn call below) so the
            # resolver's adi-only-under-r0 guard is wired to the actual
            # stopping rule
            from heatflow_tpu.utils import resolve_recording_precondition
            precondition = resolve_recording_precondition(
                record_gradient, dtype,
                unstructured=isinstance(mesh, UnstructuredMesh),
                f64_refine=f64_refine, rtol_wrt="r0")
        if isinstance(mesh, UnstructuredMesh):
            if z_shards > 1:
                # z-sharding is wired for the structured stepper only
                # (make_simulate_fn(mesh=...)); a silent single-device run
                # here would contradict the flag the user relied on
                raise ValueError(
                    "--z-shards applies to structured meshes only (the "
                    "unstructured path runs whole problems on one device); "
                    "drop the flag or use --mesh-style structured")
            return _run_unstructured(cfg, mesh, output_folder,
                                     watcher_points, write_xdmf,
                                     dtype=dtype, rtol=rtol, maxiter=maxiter,
                                     record_gradient=record_gradient,
                                     solver=solver, profile_dir=profile_dir,
                                     resume_from=resume_from,
                                     write_checkpoint=write_checkpoint,
                                     warm_start=warm_start,
                                     precondition=precondition,
                                     f64_refine=f64_refine)
        print(f"Mesh ready: {mesh.shape[0]} x {mesh.shape[1]} grid = "
              f"{mesh.num_nodes} nodes, {2 * mesh.num_cells} triangles")

        heating = HeatingCurve.from_csv(cfg["heating"]["file"])

        if isinstance(watcher_points, list):
            watcher_points = {pt["name"]: tuple(pt["coords"])
                              for pt in watcher_points}
        elif watcher_points is not None and not isinstance(watcher_points, dict):
            raise ValueError("watcher_points must be a dict or list of dicts")

        print("Assigning material properties...")
        problem = build_problem(mesh, heating, cfg,
                                watcher_points=watcher_points)
        print("Material properties assigned.")
        if record_gradient:
            from heatflow_tpu.sim.problem import radial_band_analysis
            band = radial_band_analysis(mesh)
            print(f"--- Radial Band Analysis ---\n"
                  f"  Nodes in band: {band['n_band_nodes']}, "
                  f"β = {band.get('beta', float('nan')):.4f} "
                  f"({band['verdict']})\n"
                  f"----------------------------")

        # output folder layout (ref run_no_diamond.py:348-362)
        if output_folder is not None:
            save_folder = output_folder
        else:
            save_folder = os.path.join(os.getcwd(), "sim_outputs",
                                       "heatflow_tpu_run")
        os.makedirs(save_folder, exist_ok=True)
        save_config(cfg, os.path.join(save_folder, "used_config.yaml"))

        u0, t0 = None, 0.0
        if resume_from is not None:
            from heatflow_tpu.io.checkpoint import load_checkpoint
            u0, t0, step0, _ = load_checkpoint(resume_from)
            print(f"Resuming from checkpoint at t={t0:.4e} s"
                  + (f" (step {step0})" if step0 is not None else ""))

        dev_mesh = None
        if z_shards > 1:
            # shard THIS problem's z axis over the first z_shards devices
            # (SURVEY §2.3 item 2: problems too big for one device)
            from heatflow_tpu.parallel.sharding import config_mesh
            dev_mesh = config_mesh(n_devices=z_shards, z_shards=z_shards)
            print(f"z-sharding the field over {z_shards} devices")

        print("Beginning loop...")
        t_loop = time.time()
        from heatflow_tpu.utils import profile_trace
        with profile_trace(profile_dir):
            result = run_transient(problem, dtype=dtype, rtol=rtol,
                                   maxiter=maxiter,
                                   record_gradient=record_gradient,
                                   record_fields=write_xdmf, solver=solver,
                                   warm_start=warm_start, mesh=dev_mesh,
                                   precondition=precondition,
                                   f64_refine=f64_refine, u0=u0, t0=t0)
        # scan results are already on host after run_transient
        t_end = time.time()

        # ---------------- outputs ----------------
        if watcher_points:
            write_watcher_csv(
                os.path.join(save_folder, "watcher_points.csv"),
                result.times,
                {n: result.watcher[:, k]
                 for k, n in enumerate(result.watcher_names)})
        if record_gradient and result.band_rows is not None:
            write_gradient_csv(
                os.path.join(save_folder, "radial_gradient.csv"),
                result.times, result.band_centers, result.band_rows)
            write_gradient_csv(
                os.path.join(save_folder, "radial_gradient_raw.csv"),
                result.times, result.axis_z, result.axis_rows)
        if write_xdmf:
            from heatflow_tpu.io.xdmfio import XDMFTimeSeriesWriter
            tris, _ = mesh.triangles()
            w = XDMFTimeSeriesWriter(
                os.path.join(save_folder, "output.xdmf"),
                mesh.node_coords(), tris)
            w.write(np.full(mesh.num_nodes, problem.ic_temp), 0.0)
            for s, t in enumerate(result.times):
                w.write(result.fields[s].ravel(), float(t))
            w.close()

        if write_checkpoint:
            from heatflow_tpu.io.checkpoint import save_checkpoint
            save_checkpoint(save_folder, result.final_u,
                            float(result.times[-1]),
                            step=problem.num_steps)

        # ---------------- timing summary (ref :619-630) ----------------
        total = t_end - t_start
        loop = t_end - t_loop
        per_step = loop / max(1, problem.num_steps)
        print("\n--- Timing Summary ---")
        print(f"Total time: {total:.2f} s")
        print(f"Startup time: {t_loop - t_start:.2f} s")
        print(f"Loop time: {loop:.2f} s (includes jit compile)")
        print(f"Average time per step: {per_step:.4f} s")
        print(f"CG iterations/step: min {result.cg_iters.min()} "
              f"max {result.cg_iters.max()} mean {result.cg_iters.mean():.1f}")
        print("----------------------\n")
        return result


def _run_unstructured(cfg, umesh, output_folder, watcher_points, write_xdmf,
                      *, dtype, rtol, maxiter, record_gradient,
                      solver="auto", profile_dir=None, resume_from=None,
                      write_checkpoint=True, warm_start="previous",
                      precondition="jacobi", f64_refine=0):
    """Transient run on an imported gmsh mesh via the ELL operator path,
    producing the same artifact set and feature surface (resume/profile/
    checkpoint) as the structured driver."""
    from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                               make_simulate_fn_unstructured)

    form = ("grid-overlay 9-point stencil"
            if getattr(umesh, "grid_overlay", None) is not None else
            "ELL gather")
    print(f"Imported unstructured mesh: {len(umesh.nodes)} nodes, "
          f"{len(umesh.cells)} triangles ({form} operator path)")
    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    if isinstance(watcher_points, list):
        watcher_points = {pt["name"]: tuple(pt["coords"])
                          for pt in watcher_points}
    problem = build_problem_unstructured(umesh, heating, cfg,
                                         watcher_points=watcher_points)
    if rtol is None:
        rtol = 1e-11 if dtype == jnp.float64 else 1e-4

    u0, t0 = None, 0.0
    if resume_from is not None:
        from heatflow_tpu.io.checkpoint import load_checkpoint
        u0, t0, step0, _ = load_checkpoint(resume_from)
        print(f"Resuming from checkpoint at t={t0:.4e} s"
              + (f" (step {step0})" if step0 is not None else ""))

    fn = make_simulate_fn_unstructured(
        problem, dtype=dtype, rtol=rtol, maxiter=maxiter, rtol_wrt="r0",
        record_gradient=record_gradient, record_fields=write_xdmf,
        solver=solver, warm_start=warm_start, precondition=precondition,
        f64_refine=f64_refine)
    t_loop = time.time()
    from heatflow_tpu.utils import profile_trace
    with profile_trace(profile_dir):
        ys = jax.tree.map(np.asarray, fn(u0=u0, t0=t0))
    loop = time.time() - t_loop

    save_folder = output_folder or os.path.join(os.getcwd(), "sim_outputs",
                                                "unstructured_run")
    os.makedirs(save_folder, exist_ok=True)
    save_config(cfg, os.path.join(save_folder, "used_config.yaml"))
    if watcher_points:
        write_watcher_csv(os.path.join(save_folder, "watcher_points.csv"),
                          ys["times"],
                          {n: ys["watch"][:, k]
                           for k, n in enumerate(problem.watcher_names)})
    if record_gradient and "band" in ys:
        write_gradient_csv(os.path.join(save_folder, "radial_gradient.csv"),
                           ys["times"], problem.bin_centers, ys["band"])
        write_gradient_csv(
            os.path.join(save_folder, "radial_gradient_raw.csv"),
            ys["times"], problem.axis_z, ys["axis"])
    if write_xdmf:
        from heatflow_tpu.io.xdmfio import XDMFTimeSeriesWriter
        w = XDMFTimeSeriesWriter(os.path.join(save_folder, "output.xdmf"),
                                 umesh.nodes, umesh.cells)
        w.write(np.full(len(umesh.nodes), problem.ic_temp), 0.0)
        for s, t in enumerate(ys["times"]):
            w.write(ys["field"][s], float(t))
        w.close()
    if write_checkpoint:
        from heatflow_tpu.io.checkpoint import save_checkpoint
        save_checkpoint(save_folder, ys["final_u"], float(ys["times"][-1]),
                        step=problem.num_steps)
    print(f"Loop time: {loop:.2f} s (includes jit compile); "
          f"CG iters mean {np.asarray(ys['cg_iters']).mean():.1f}")
    return ys


def main(argv=None):
    p = argparse.ArgumentParser(description="heatflow_tpu 2D transient solver")
    p.add_argument("--config", type=str, default="simulation_template.yaml")
    p.add_argument("--mesh-folder", type=str, default="meshes")
    p.add_argument("--rebuild-mesh", action="store_true")
    p.add_argument("--visualize-mesh", action="store_true")
    p.add_argument("--output-folder", type=str, default=None)
    p.add_argument("--watcher-points", type=str, default=None,
                   help="JSON mapping name -> [z, r], e.g. "
                        "'{\"pside\": [1e-6, 0]}'; 'auto' places points at "
                        "the coupler centers")
    p.add_argument("--write-xdmf", action="store_true")
    p.add_argument("--suppress-print", action="store_true")
    p.add_argument("--layout", choices=["auto", "no_diamond", "with_diamond",
                                        "custom"],
                   default="auto",
                   help="'custom': every material carries explicit bounds "
                        "[zmin,zmax,rmin,rmax] (free-form stacks, e.g. the "
                        "reference notebooks' IR-layer geometries)")
    p.add_argument("--mesh-style", choices=["structured", "unstructured"],
                   default="structured",
                   help="'unstructured': graded non-grid triangulation (the "
                        "gmsh-mesh analogue, runs through the ELL path)")
    p.add_argument("--solver", choices=["auto", "xla"], default="auto",
                   help="'auto' and 'xla' both name the XLA engine (kept "
                        "for command-line compatibility)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="capture a jax.profiler trace into this directory")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint.npz (or its folder) to resume from")
    p.add_argument("--warm-start", choices=["previous", "extrapolate"],
                   default=None,
                   help="CG seed per step: previous solution, or its linear "
                        "time extrapolation (same cost, lower f32 trace "
                        "error at equal iterations). "
                        "Default: extrapolate at f32, previous at f64")
    p.add_argument("--precondition",
                   choices=["jacobi", "rline", "zline", "adi", "mg"],
                   default=None,
                   help="CG preconditioner: 'rline' = r-line "
                        "block-tridiagonal via precomputed PCR (several-"
                        "fold fewer iterations on DAC operators), 'adi' = "
                        "split-additive r-line + z-line (further iteration "
                        "cut, best on cold/deep solves), 'mg' = Galerkin "
                        "multigrid V-cycle. Default: per regime (pure-f32 "
                        "'adi', refined 'rline', f64 and unstructured "
                        "'jacobi')")
    p.add_argument("--f64-refine", type=int, default=0,
                   help="mixed-precision iterative refinement: N passes of "
                        "f64-residual / f32-correction per step (enables "
                        "x64; near-f64 trace accuracy at f32 solve cost)")
    p.add_argument("--z-shards", type=int, default=1,
                   help="shard the field's z axis over this many devices "
                        "(single-problem spatial sharding; Nz must divide "
                        "evenly)")
    p.add_argument("--rtol", type=float, default=None,
                   help="CG stopping tolerance (increment-relative, "
                        "rtol_wrt='r0'; with --f64-refine: the inner "
                        "correction solves' tolerance). Default: 1e-11 at "
                        "f64, 1e-4 at f32")
    args = p.parse_args(argv)
    from heatflow_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    if args.f64_refine:
        # the refinement's f64 outer residual needs x64 (validated in
        # make_simulate_fn); the f32 inner path is explicitly cast
        jax.config.update("jax_enable_x64", True)

    cfg = load_config(args.config)
    if args.watcher_points == "auto":
        wp = coupler_watcher_points(cfg)
    elif args.watcher_points:
        wp = {k: tuple(v) for k, v in json.loads(args.watcher_points).items()}
    else:
        wp = None
    run_simulation(cfg, args.mesh_folder, args.rebuild_mesh,
                   args.visualize_mesh, args.output_folder, wp,
                   args.write_xdmf, args.suppress_print, layout=args.layout,
                   solver=args.solver, profile_dir=args.profile_dir,
                   resume_from=args.resume, mesh_style=args.mesh_style,
                   warm_start=args.warm_start,
                   precondition=args.precondition, z_shards=args.z_shards,
                   f64_refine=args.f64_refine, rtol=args.rtol)


if __name__ == "__main__":
    main()
