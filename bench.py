#!/usr/bin/env python
"""Benchmark of the XLA engine on the GPU: implicit backward-Euler steps/s
on the full-DAC flagship (cfgs/geballe_with_diamond.yaml, 251x1107 nodes,
100 steps, f32, rtol 1e-4 wrt the warm-start residual) and vmapped sweep
configs/s (cfgs/geballe_no_diamond.yaml, 243x1001, 40 steps, kappa
log-spaced over [1, 100]).

    python bench.py                                   # driver defaults
    python bench.py --preconditioners jacobi,rline,adi,mg --sweep-batch 0

Each flagship row reports warm steps/s, CG iterations per step, the largest
watcher-trace error against the f64 truth
(benchmarks/.flagship_truth_f64.npz), compile seconds and
``peak_bytes_in_use``. The last line is one JSON object with the headline
numbers and the device (``platform``, ``device_kind``, device count).
Without a GPU it fails: a CPU number is not a device metric.

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
baseline is measured on the host of the same run — a factor-once sparse-LU
backward-Euler step (scipy SuperLU on the identical operator), the
algorithm the reference delegates to PETSc/MUMPS (ref
run_no_diamond.py:339-344, 529-541).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
TRUTH = os.path.join(ROOT, "benchmarks", ".flagship_truth_f64.npz")


def build(cfg_name):
    from heatflow_tpu.config import load_config
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem

    cfg = load_config(os.path.join(ROOT, "cfgs", cfg_name))
    cfg["heating"]["file"] = os.path.join(ROOT, cfg["heating"]["file"])
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    return build_problem(mesh, heating, cfg,
                         watcher_points=coupler_watcher_points(cfg))


def bench_flagship(problem, precondition, truth, *, reps=3, rtol=1e-4,
                   maxiter=20000):
    """One flagship row: the watcher-only transient (the with_diamond
    reference loop samples watchers only, ref run_with_diamond.py:469-504)
    with the given preconditioner, f32, extrapolated seeds. Steps/s from the
    median of ``reps`` warm calls; compile seconds = first call - median."""
    import jax
    import jax.numpy as jnp
    from heatflow_tpu.sim.stepper import make_simulate_fn

    fn = make_simulate_fn(problem, dtype=jnp.float32, rtol=rtol,
                          maxiter=maxiter, record_gradient=False,
                          rtol_wrt="r0", precondition=precondition,
                          warm_start="extrapolate")

    def timed():
        t0 = time.perf_counter()
        ys = fn()
        ys["final_u"].block_until_ready()
        return time.perf_counter() - t0, ys

    first, _ = timed()
    runs = []
    for _ in range(reps):
        dt_s, ys = timed()
        runs.append(dt_s)
    run = float(np.median(runs))
    iters = np.asarray(ys["cg_iters"])
    watch = np.asarray(ys["watch"], np.float64)
    return {
        "precondition": precondition,
        "steps_per_sec": problem.num_steps / run,
        "run_s": runs,
        "compile_s": first - run,
        "cg_iters_mean": float(iters.mean()),
        "cg_iters_max": int(iters.max()),
        "trace_max_err_K": float(np.abs(watch - truth).max()),
        "peak_bytes_in_use":
            jax.devices()[0].memory_stats()["peak_bytes_in_use"],
    }


def bench_sweep(n_configs, step_chunk=25):
    """Vmapped sweep configs/s with the sweep driver's f32 defaults (jacobi,
    rtol 1e-4 wrt ||b||), time-chunked."""
    import jax
    import jax.numpy as jnp
    from heatflow_tpu.sim.sweepkernel import run_sweep_time_chunked

    problem = build("geballe_no_diamond.yaml")
    ks = np.logspace(0.0, 2.0, n_configs)
    fs = np.full(n_configs, problem.fwhm)

    def once():
        t0 = time.perf_counter()
        tr = np.asarray(run_sweep_time_chunked(
            problem, ks, fs, step_chunk=step_chunk, rtol=1e-4,
            dtype=jnp.float32))
        return time.perf_counter() - t0, tr

    cold, tr = once()
    warm, tr = once()
    if not np.isfinite(tr).all():
        raise AssertionError("non-finite sweep lanes")
    return {"configs_per_sec": n_configs / warm, "batch": n_configs,
            "warm_s": warm, "cold_s": cold, "peak_bytes_in_use":
                jax.devices()[0].memory_stats()["peak_bytes_in_use"]}


def bench_baseline(problem):
    """Factor-once sparse LU backward-Euler steps/s (reference algorithm)
    on this host's CPU, on the identical operator."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from heatflow_tpu.ops.stencil import stencil_to_coo

    st = problem.stencils
    M7 = np.einsum("m,mkij->kij", problem.rho_cvs, st.M)
    A7 = M7 + problem.dt * np.einsum("m,mkij->kij", problem.kappas, st.K)
    n = problem.mesh.num_nodes
    rows, cols, vals = stencil_to_coo(A7)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    rows, cols, vals = stencil_to_coo(M7)
    M = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()

    free = problem.free_mask.ravel()
    A_ff = A[free][:, free].tocsc()
    A_fd = A[free][:, ~free].tocsr()
    t0 = time.perf_counter()
    lu = spla.splu(A_ff)
    factor_s = time.perf_counter() - t0

    u = np.full(n, problem.ic_temp)
    g = np.full((~free).sum(), problem.ic_temp)
    n_steps = 5
    t0 = time.perf_counter()
    for _ in range(n_steps):
        u[free] = lu.solve((M @ u)[free] - A_fd @ g)
    per_step = (time.perf_counter() - t0) / n_steps
    return {"steps_per_sec": 1.0 / per_step, "factor_s": factor_s}


def main(argv=None):
    import jax
    import jax.numpy as jnp
    from heatflow_tpu.utils import (enable_compilation_cache,
                                    resolve_recording_precondition)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preconditioners", default=None,
                   help="comma-separated flagship preconditioners (default: "
                        "the driver's choice for this run)")
    p.add_argument("--sweep-batch", type=int, default=1024,
                   help="sweep configs (0 skips the sweep)")
    args = p.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"bench.py measures the GPU; JAX's default "
                           f"device is {devs[0].platform}")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    print(f"# compile cache: {enable_compilation_cache()}", file=sys.stderr)

    problem = build("geballe_with_diamond.yaml")
    truth = np.load(TRUTH)["watch"]
    default = resolve_recording_precondition(False, jnp.float32,
                                             rtol_wrt="r0")
    precs = (args.preconditioners.split(",") if args.preconditioners
             else [default])
    rows = []
    for prec in precs:
        row = bench_flagship(problem, prec, truth)
        rows.append(row)
        print(json.dumps({**row, "device": device}), flush=True)
    head = rows[0]
    base = bench_baseline(problem)
    result = {
        "metric": "implicit_steps_per_sec_2d_dac",
        "precondition": head["precondition"],
        "value": head["steps_per_sec"],
        "unit": "steps/s",
        "trace_max_err_K": head["trace_max_err_K"],
        "vs_baseline": head["steps_per_sec"] / base["steps_per_sec"],
        "baseline_host_steps_per_sec": base["steps_per_sec"],
        "device": device,
    }
    if args.sweep_batch:
        sw = bench_sweep(args.sweep_batch)
        result["sweep_configs_per_sec"] = sw["configs_per_sec"]
        result["sweep_batch"] = sw["batch"]
        result["sweep_peak_bytes_in_use"] = sw["peak_bytes_in_use"]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
