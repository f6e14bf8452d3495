"""Parameter-sweep engine: the reference's multiprocessing grid search
(ref parameter_sweep.py:289-536) re-designed as vmapped device batches.

Grid: FWHM (log-spaced) x sample conductivity (log-spaced) x sample width
(linear). Width changes the geometry, so runs are grouped by width with one
mesh per group (ref :367-373); within a group the whole (fwhm, k) plane runs
as a single sharded, vmapped, jitted scan — thousands of concurrent transient
solves per device instead of one process per config.

Artifacts match the reference: sweep_metadata.json, successful_runs.csv,
failed_runs.csv, per-run directories named fwhm_{:.2e}_k_{:.2f}_width_{:.2e}
with watcher_points.csv + used_config.yaml.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.config import load_config, save_config, with_parameters
from heatflow_tpu.drivers.run2d import _prepare_mesh, default_dtype
from heatflow_tpu.geometry import coupler_watcher_points
from heatflow_tpu.io.csvio import (read_records_csv, write_gradient_csv,
                                   write_records_csv, write_watcher_csv)
from heatflow_tpu.sim.bc import HeatingCurve
from heatflow_tpu.sim.problem import build_problem
from heatflow_tpu.sim.sweepkernel import make_sweep_fn
from heatflow_tpu.utils import resolve_solver


def create_parameter_grid(fwhm_range, k_range, width_range, num_points):
    """Log x log x linear grid, grouped by width first (ref :195-235)."""
    nf, nk, nw = num_points
    fwhm_vals = np.logspace(np.log10(fwhm_range[0]), np.log10(fwhm_range[1]),
                            nf)
    k_vals = np.logspace(np.log10(k_range[0]), np.log10(k_range[1]), nk)
    width_vals = np.linspace(width_range[0], width_range[1], nw)
    combos = [{"fwhm": f, "k": k, "width": w}
              for w in width_vals
              for f, k in itertools.product(fwhm_vals, k_vals)]
    return combos, fwhm_vals, k_vals, width_vals


def run_name(fwhm, k, width):
    """Reference directory naming incl. its string transforms (ref :145)."""
    return (f"fwhm_{fwhm:.2e}_k_{k:.2f}_width_{width:.2e}"
            .replace("+", "").replace("-0", "-"))


def mesh_folder_for_width(base_mesh_folder, width):
    w = f"{width:.3e}".replace("+", "").replace("-0", "-")
    return os.path.join(base_mesh_folder, f"width_{w}")


# Width-group (mesh, problem, heating) cache across driver invocations.
# Rebuilding the problem per call is the dominant fixed cost of the sweep
# path (.msh parse + host assembly + jit retrace — a fresh Problem2D also
# empties the makers' memoization); repeated calls with the same
# config/width reuse the problem AND its compiled sweep fns. Keyed by the
# full config content (minus the swept fwhm/k, which the makers take as
# runtime arguments), so any config edit is a cache miss. Bounded LRU —
# each entry pins host stencils + any device arrays the makers
# materialized.
_GROUP_CACHE: dict = {}
_GROUP_CACHE_MAX = 4


def _file_sig(path):
    """(mtime_ns, size) of a file, or None if absent — the staleness
    signature for cache validation (a rewrite at the same path changes it)."""
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def _group_sigs(cfg_w, mesh_folder):
    """Signatures of every file the cached (mesh, problem, heating) entry
    embeds parsed contents of: the heating CSV and the on-disk mesh pair.
    A rewrite of any of them between invocations must be a cache miss."""
    return (_file_sig(cfg_w["heating"]["file"]),
            _file_sig(os.path.join(mesh_folder, "mesh.msh")),
            _file_sig(os.path.join(mesh_folder, "mesh_cfg.yaml")))


def _cached_group(cfg_w, mesh_folder):
    """(mesh, problem, heating) for one width group, LRU-cached across
    run_parameter_sweep invocations. ``cfg_w`` must already carry the
    group's width; its fwhm/p_sample.k are part of the key but callers
    pass the BASE config's values so the key is sweep-range-independent.
    Hits are validated against the heating-CSV and mesh-file signatures
    captured at build time — rewriting any of those files at the same
    path invalidates the entry instead of silently serving stale data."""
    key = (json.dumps(cfg_w, sort_keys=True, default=str), mesh_folder)
    hit = _GROUP_CACHE.pop(key, None)
    if hit is not None and hit[1] == _group_sigs(cfg_w, mesh_folder):
        _GROUP_CACHE[key] = hit          # re-insert: most-recently-used
        return hit[0]
    os.makedirs(mesh_folder, exist_ok=True)
    rebuild = not (os.path.exists(os.path.join(mesh_folder, "mesh.msh"))
                   and os.path.exists(os.path.join(mesh_folder,
                                                   "mesh_cfg.yaml")))
    mesh_w = _prepare_mesh(cfg_w, mesh_folder, rebuild, "auto")
    heating = HeatingCurve.from_csv(cfg_w["heating"]["file"])
    wp = coupler_watcher_points(cfg_w)
    from heatflow_tpu.mesh.msh_io import UnstructuredMesh
    if isinstance(mesh_w, UnstructuredMesh):
        from heatflow_tpu.sim.unstructured import build_problem_unstructured
        problem = build_problem_unstructured(mesh_w, heating, cfg_w,
                                             watcher_points=wp)
    else:
        problem = build_problem(mesh_w, heating, cfg_w, watcher_points=wp)
    entry = (mesh_w, problem, heating)
    _GROUP_CACHE[key] = (entry, _group_sigs(cfg_w, mesh_folder))
    while len(_GROUP_CACHE) > _GROUP_CACHE_MAX:
        _GROUP_CACHE.pop(next(iter(_GROUP_CACHE)))
    return entry


def run_parameter_sweep(base_config_path, output_dir, fwhm_range, k_range,
                        width_range, num_points, base_mesh_folder="meshes",
                        write_xdmf=False, suppress_print=True,
                        num_processes=None, *, dtype=None,
                        batch_size: int | None = None,
                        save_run_dirs: bool = True, devices=None,
                        solver: str = "auto",
                        fixed_iters: int | None = None,
                        warm_start: str | None = None,
                        record_gradient: bool = False,
                        rtol: float | None = None,
                        rtol_wrt: str = "b",
                        f64_refine: int = 0,
                        precondition: str | None = None,
                        resume: bool = False):
    """Run the sweep. ``num_processes`` is accepted for API parity and
    ignored — parallelism is the vmapped batch, sharded over ``devices``
    (default: all of ``jax.devices()``) along the batch axis; each device
    integrates its shard of configs independently (the multi-device scaling
    of the reference's process fan-out, ref parameter_sweep.py:436-446).
    ``solver``: 'auto' or 'xla', both the XLA engine.

    ``resume=True``: runs already recorded as successful in the output
    dir's successful_runs.csv are skipped (matched by run_name); previously
    failed runs are retried. The merged result set is re-written. (Beyond
    the reference, which restarts sweeps from scratch.)"""
    del write_xdmf  # per-run XDMF in sweeps is supported only via run2d
    if f64_refine and dtype is None:
        # the mixed mode is f32-around-f64 on every backend
        dtype = jnp.float32
    dtype = dtype or (jnp.float32 if jax.default_backend() != "cpu"
                      else default_dtype())
    solver = resolve_solver(solver)
    if f64_refine:
        if jnp.dtype(dtype) != jnp.float32:
            # refine is the mixed mode AROUND f32; CPU test runs default to
            # f64 where plain rtol already reaches any accuracy
            raise ValueError("f64_refine needs dtype=float32")
    if warm_start is None:
        # linear-extrapolation seeds (solve AND per-step projection) for
        # tolerance-stopped f32 recording sweeps; fixed-budget and
        # loose-tolerance plain sweeps keep 'previous' (the gain-2 seed
        # amplifies unconverged noise there)
        warm_start = ("extrapolate" if record_gradient
                      and fixed_iters is None
                      and jnp.dtype(dtype) == jnp.float32 else "previous")
    prec_defaulted = precondition is None
    if prec_defaulted:
        # rline for f32 --record-gradient sweeps (clean near-axis gradient
        # artifacts at the same rtol), jacobi otherwise — see
        # utils.resolve_recording_precondition
        from heatflow_tpu.utils import resolve_recording_precondition
        precondition = resolve_recording_precondition(
            record_gradient, dtype, fixed_iters=fixed_iters, batched=True)
    rtol_kw = {} if rtol is None else {"rtol": rtol}
    if rtol_wrt != "b":
        # increment-relative stopping: the sweep accuracy regime (lower
        # worst-lane deviation at a higher cost)
        rtol_kw["rtol_wrt"] = rtol_wrt
    # Default-tolerance resolution — ONCE, before the width loop (the
    # defaults are width-independent; resolving them inside the loop would
    # leak the first width's resolved rtol into later widths' "was rtol
    # given?" checks and silently drop the tighter recording default).
    rec_rtol = rtol_kw
    if f64_refine and "rtol" not in rtol_kw:
        # refine's inner correction solves stop wrt the per-pass f64
        # residual; 1e-4 is the default inner speed/accuracy point
        rtol_kw = rec_rtol = {**rtol_kw, "rtol": 1e-4}
    elif ("rtol" not in rtol_kw and fixed_iters is None
            and jnp.dtype(dtype) == jnp.float32):
        # the makers' 1e-6 default (wrt ||b||) is below the f32
        # residual floor — every solve would run to maxiter. Plain
        # sweeps use the f32 throughput point (1e-4); artifact-recording
        # sweeps stop tighter (1e-5, where the watch/band errors drop
        # several-fold for under twice the cost). Applies to both mesh
        # kinds.
        rtol_kw = {**rtol_kw, "rtol": 1e-4}
        rec_rtol = {**rec_rtol,
                    "rtol": 1e-5 if record_gradient else 1e-4}
    devs = list(devices) if devices is not None else jax.devices()
    mesh = None
    if len(devs) > 1:
        # config-axis sharding only: each device integrates its shard of
        # configs, whole problems stay on one device
        from heatflow_tpu.parallel.sharding import config_mesh
        mesh = config_mesh(devices=devs, z_shards=1)
    n_conf = 1 if mesh is None else mesh.shape["config"]
    if isinstance(base_config_path, dict):
        base_config, base_config_name = base_config_path, "<dict>"
    else:
        base_config = load_config(base_config_path)
        base_config_name = str(base_config_path)

    combos, fwhm_vals, k_vals, width_vals = create_parameter_grid(
        fwhm_range, k_range, width_range, num_points)
    # run_id is the combo's 1-based position in the full grid: stable across
    # resumes (a retried run keeps the id its first attempt had), so merged
    # successful/failed records never carry duplicate ids
    for _i, _c in enumerate(combos):
        _c["run_id"] = _i + 1
    os.makedirs(output_dir, exist_ok=True)

    prior_records = []
    done_names = set()
    succ_csv = os.path.join(output_dir, "successful_runs.csv")
    if resume and os.path.isfile(succ_csv):
        prior_records = read_records_csv(succ_csv)
        done_names = {rec["run_name"] for rec in prior_records}
        if not suppress_print:
            print(f"resume: {len(done_names)} runs already recorded, "
                  f"skipping them")

    metadata = {
        "base_config": base_config_name,
        "fwhm_range": list(fwhm_range), "k_range": list(k_range),
        "width_range": list(width_range), "num_points": list(num_points),
        "fwhm_values": fwhm_vals.tolist(), "k_values": k_vals.tolist(),
        "width_values": width_vals.tolist(), "total_runs": len(combos),
        "engine": "heatflow_tpu vmapped batch"
                  + (f" sharded over {n_conf} devices" if mesh else ""),
        "solver": solver,
        "fixed_iters": fixed_iters,
        "record_gradient": record_gradient,
        "f64_refine": f64_refine,
        "precondition": precondition,
        "devices": [str(d) for d in devs],
        "timestamp": datetime.now().isoformat(),
        "watcher_points": {
            "description": "Temperature monitoring points positioned halfway "
                           "through the coupler layers",
            "locations": {"pside": "Center of p-side coupler (r=0)",
                          "oside": "Center of o-side coupler (r=0)"},
        },
    }
    with open(os.path.join(output_dir, "sweep_metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)

    results, failed = [], []
    t_sweep = time.time()

    for width in width_vals:
        group = [c for c in combos if c["width"] == width]
        if done_names:
            group = [c for c in group
                     if run_name(c["fwhm"], c["k"], width) not in done_names]
            if not group:
                continue
        mesh_folder = mesh_folder_for_width(base_mesh_folder, width)
        # width is the ONLY parameter that reaches the problem build: the
        # makers treat fwhm/k as runtime batch arguments relative to the
        # problem's own base values, so the base config's values keep the
        # group cache sweep-range-independent (results are identical up to
        # FP rounding of A0 + dk*Kv vs a different base split)
        cfg_w = with_parameters(base_config, sample_z=width)
        mesh_w, problem, heating = _cached_group(cfg_w, mesh_folder)
        from heatflow_tpu.mesh.msh_io import UnstructuredMesh
        if isinstance(mesh_w, UnstructuredMesh):
            # imported / generated non-grid mesh → unstructured sweep kernel
            # (config-axis sharded over the device mesh exactly like the
            # structured branch)
            from heatflow_tpu.sim.unstructured import \
                make_sweep_fn_unstructured
            prec_u = precondition
            if prec_defaulted:
                # the unstructured engine has no line preconditioner; a
                # defaulted rline falls back rather than erroring
                prec_u = "jacobi"
            sweep_fn = make_sweep_fn_unstructured(
                problem, dtype=dtype, fixed_iters=fixed_iters,
                warm_start=warm_start, mesh=mesh,
                record_gradient=record_gradient, f64_refine=f64_refine,
                precondition=prec_u, **rec_rtol)
        else:
            if record_gradient:
                # full-surface vmapped sweep: every run also gets the
                # reference's per-run gradient CSVs (ref run_no_diamond.py
                # :602-617 under parameter_sweep.py:157-166)
                from heatflow_tpu.sim.sweepkernel import \
                    make_sweep_fn_recording
                sweep_fn = make_sweep_fn_recording(
                    problem, dtype=dtype, fixed_iters=fixed_iters,
                    warm_start=warm_start, mesh=mesh,
                    f64_refine=f64_refine, precondition=precondition,
                    **rec_rtol)
            else:
                sweep_fn = make_sweep_fn(problem, dtype=dtype, mesh=mesh,
                                         fixed_iters=fixed_iters,
                                         warm_start=warm_start,
                                         f64_refine=f64_refine,
                                         precondition=precondition,
                                         **rtol_kw)

        ks = np.array([c["k"] for c in group])
        fs = np.array([c["fwhm"] for c in group])
        B = len(group)
        # default chunking bounds each device call's batch (and so its
        # device memory); sharded chunks are padded to a multiple of the
        # config-axis size
        chunk = batch_size or min(B, 64)
        chunk = max(n_conf, (chunk // n_conf) * n_conf)
        if record_gradient:
            # full-stepper chunks cost ~2 solves/step/config and carry
            # the gradient fields too: halve the default chunk
            chunk = min(chunk, max(n_conf, (32 // n_conf) * n_conf))
        from heatflow_tpu.utils import pad_to_multiple
        t_group = time.time()
        # Pipeline: dispatch EVERY chunk before fetching any — jax device
        # calls are async, so while the host blocks on (then formats and
        # writes the artifacts of) chunk i, the device is already
        # integrating chunks i+1… . This overlaps the host's CSV/YAML
        # artifact writing with device compute (the outputs of all
        # pending chunks are a few MB of device memory).
        pending = []
        for s in range(0, B, chunk):
            ks_c, fs_c = ks[s:s + chunk], fs[s:s + chunk]
            n_c = len(ks_c)
            ks_c = pad_to_multiple(ks_c, n_conf)
            fs_c = pad_to_multiple(fs_c, n_conf)
            pending.append((s, n_c, sweep_fn(ks_c, fs_c)))

        times = sweep_fn.times
        group_results, group_failed = [], []
        for s, n_c, out in pending:
            if record_gradient:
                traces = np.asarray(out["watch"])[:n_c]
                bands = np.asarray(out["band"])[:n_c]
                axes_rows = np.asarray(out["axis"])[:n_c]
            else:
                traces = np.asarray(out)[:n_c]
            ok = np.all(np.isfinite(traces), axis=(1, 2))
            err_detail = np.where(ok, "",
                                  "non-finite trace").astype(object)
            if record_gradient:
                # a config whose gradient projection went non-finite must
                # not be recorded as success with NaN-filled radial CSVs
                ok_grad = (np.all(np.isfinite(bands), axis=(1, 2))
                           & np.all(np.isfinite(axes_rows), axis=(1, 2)))
                err_detail[ok & ~ok_grad] = "non-finite gradient projection"
                ok = ok & ok_grad
            for i, combo in enumerate(group[s:s + n_c]):
                name = run_name(combo["fwhm"], combo["k"], width)
                run_dir = os.path.join(output_dir, name)
                rec = {"run_id": combo["run_id"], "run_name": name,
                       "fwhm": combo["fwhm"], "k": combo["k"],
                       "width": width, "output_dir": run_dir,
                       "runtime": None,    # filled with group mean below
                       "status": "success" if ok[i] else "failed",
                       "error": None if ok[i] else str(err_detail[i])}
                if ok[i]:
                    if save_run_dirs:
                        os.makedirs(run_dir, exist_ok=True)
                        write_watcher_csv(
                            os.path.join(run_dir, "watcher_points.csv"),
                            times,
                            {n: traces[i, :, j] for j, n in
                             enumerate(problem.watcher_names)})
                        if record_gradient:
                            write_gradient_csv(
                                os.path.join(run_dir,
                                             "radial_gradient.csv"),
                                times, sweep_fn.band_centers, bands[i])
                            write_gradient_csv(
                                os.path.join(run_dir,
                                             "radial_gradient_raw.csv"),
                                times, sweep_fn.axis_z, axes_rows[i])
                        save_config(
                            with_parameters(base_config,
                                            fwhm=combo["fwhm"],
                                            sample_k=combo["k"],
                                            sample_z=width),
                            os.path.join(run_dir, "used_config.yaml"))
                    group_results.append(rec)
                else:
                    group_failed.append(rec)
        group_runtime = time.time() - t_group
        for rec in group_results + group_failed:
            rec["runtime"] = group_runtime / B
        results.extend(group_results)
        failed.extend(group_failed)
        if not suppress_print:
            print(f"width {width:.2e}: {B} runs in {group_runtime:.2f}s "
                  f"({B / group_runtime:.1f} configs/s)")

    results = prior_records + results
    if results:
        write_records_csv(succ_csv, results)
    failed_csv = os.path.join(output_dir, "failed_runs.csv")
    if failed:
        write_records_csv(failed_csv, failed)
    elif resume and os.path.isfile(failed_csv):
        # every previously-failed run succeeded on retry; a stale
        # failed_runs.csv would contradict the merged successful_runs.csv
        os.remove(failed_csv)

    total_time = time.time() - t_sweep
    if not suppress_print:
        print(f"PARAMETER SWEEP COMPLETE: {len(results)} ok, "
              f"{len(failed)} failed, {total_time:.2f}s total "
              f"({len(combos) / total_time:.1f} configs/s)")
    return results, failed


def main(argv=None):
    p = argparse.ArgumentParser(
        description="heatflow_tpu vmapped parameter sweep")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--fwhm-range", type=float, nargs=2, default=[1e-6, 1e-4])
    p.add_argument("--k-range", type=float, nargs=2, default=[1.0, 100.0])
    p.add_argument("--width-range", type=float, nargs=2,
                   default=[1e-6, 10e-6])
    p.add_argument("--num-points", type=int, nargs=3, default=[5, 5, 3])
    p.add_argument("--mesh-folder", type=str, default="meshes")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=None,
                   help="accepted for reference-CLI parity and ignored "
                        "(parallelism is the vmapped device-sharded batch)")
    p.add_argument("--solver", choices=["auto", "xla"], default="auto",
                   help="'auto' and 'xla' both name the XLA engine (kept "
                        "for command-line compatibility)")
    p.add_argument("--fixed-iters", type=int, default=None,
                   help="fixed CG iterations per step (static control flow)")
    p.add_argument("--resume", action="store_true",
                   help="skip runs already in successful_runs.csv; retry "
                        "failed ones")
    p.add_argument("--rtol-wrt", choices=["b", "r0"], default="b",
                   help="CG stopping reference: 'b' (throughput regime) or "
                        "'r0' (increment-relative accuracy regime)")
    p.add_argument("--rtol", type=float, default=None,
                   help="CG stopping tolerance for tolerance-based solves "
                        "(default: engine default 1e-6)")
    p.add_argument("--record-gradient", action="store_true",
                   help="also write radial_gradient[_raw].csv per run "
                        "(full-stepper sweep with the per-step projection, "
                        "matching the reference's per-run artifacts)")
    p.add_argument("--warm-start", choices=["previous", "extrapolate"],
                   default=None,
                   help="CG seed per step: previous field, or 2u_n - u_{n-1}. "
                        "Default: extrapolate for f32 --record-gradient "
                        "sweeps, previous otherwise")
    p.add_argument("--precondition",
                   choices=["jacobi", "rline", "adi", "mg"],
                   default=None,
                   help="CG preconditioner (default: rline for f32 "
                        "--record-gradient sweeps — jacobi's unconverged "
                        "f32 error sits in the near-axis modes the gradient "
                        "artifacts amplify ~1/h_r; jacobi otherwise)")
    p.add_argument("--f64-refine", type=int, default=0, metavar="N",
                   help="mixed-precision sweeps (f32): N passes of "
                        "f64-operator residual refinement around the f32 "
                        "correction solve per step — breaks the f32 "
                        "representation floor per sweep lane")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    from heatflow_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    if args.f64_refine:
        # the refinement's f64 outer residual needs x64 (validated in the
        # sweep makers); the f32 compute path is explicitly cast
        jax.config.update("jax_enable_x64", True)
    if any(x <= 0 for x in args.num_points):
        p.error("Number of points must be positive")
    for rng_name in ("fwhm_range", "k_range", "width_range"):
        lo, hi = getattr(args, rng_name)
        if lo <= 0 or hi <= 0:
            p.error(f"{rng_name} must be positive")
    run_parameter_sweep(
        args.config, args.output_dir, tuple(args.fwhm_range),
        tuple(args.k_range), tuple(args.width_range),
        tuple(args.num_points), base_mesh_folder=args.mesh_folder,
        suppress_print=not args.verbose, batch_size=args.batch_size,
        solver=args.solver, fixed_iters=args.fixed_iters,
        warm_start=args.warm_start, record_gradient=args.record_gradient,
        rtol=args.rtol, rtol_wrt=args.rtol_wrt,
        f64_refine=args.f64_refine, precondition=args.precondition,
        resume=args.resume)


if __name__ == "__main__":
    main()
