#!/usr/bin/env python
"""Smoke test of the simulator on one NVIDIA GPU, through its entry points.

    python chip_smoke.py               # five phases on one card
    python chip_smoke.py --four-cards  # only the paths that span four cards

One process drives every phase, in order; a failing phase raises and the
script exits non-zero without the final ``ok`` line:

1. flagship-f32: ``drivers.run2d.main`` on the full-DAC flagship
   (cfgs/geballe_with_diamond.yaml, 251x1107 nodes, 100 implicit steps) with
   the driver's f32 defaults; watcher traces against the f64 truth
   (benchmarks/.flagship_truth_f64.npz).
2. flagship-f64-parity: the same problem at f64 (jacobi, rtol 1e-11) through
   ``make_simulate_fn``; rel-L2 against the truth (the parity target).
3. sweep: ``drivers.sweep.run_parameter_sweep`` over 8 FWHM x 8 kappa x 1
   width (cfgs/geballe_no_diamond.yaml, 243x1001, f32) in the driver's
   accuracy regime (``rtol_wrt='r0'``: its default wrt-||b|| stopping is a
   throughput setting whose lanes stray several K from f64); every lane
   finite, two sampled lanes against f64 single runs.
4. fit-gradient: ``jax.value_and_grad`` of the fit objective
   (cfgs/geballe_no_diamond_read_flux.yaml, f64) against central
   differences.
5. gpu-checks: the device checks of ``heatflow_tpu.devicecheck``.

``--four-cards`` instead runs a B=256 config-sharded sweep over four cards
against one-card runs of sampled lanes, and the z-sharded single problem
(geballe_no_diamond, Nz=243 over 3 cards) against the unsharded run.

The last line of standard output is one JSON object naming the device.
Meshes and outputs go under ``sim_outputs/chip_smoke`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "sim_outputs", "chip_smoke")
TRUTH = os.path.join(ROOT, "benchmarks", ".flagship_truth_f64.npz")
FLAGSHIP = os.path.join(ROOT, "cfgs", "geballe_with_diamond.yaml")
NO_DIAMOND = os.path.join(ROOT, "cfgs", "geballe_no_diamond.yaml")
READ_FLUX = os.path.join(ROOT, "cfgs", "geballe_no_diamond_read_flux.yaml")

# bounds, each with its reason
FLAGSHIP_MAX_K = 2.0     # f32 driver defaults vs f64 truth; the GPU's
#                          reduction order differs from the CPU's
PARITY_REL_L2 = 1e-8     # BASELINE.md parity target at f64
SWEEP_MAX_K = 2.0        # f32 sweep lane vs f64 single run, same config
GRAD_REL = 1e-4          # implicit-diff gradient vs central difference
SHARDED_SWEEP_MAX_K = 0.1   # same f32 lanes in other batch shapes: only
#                             reduction order differs, CG stops at rtol 1e-4
SWEEP_KW = dict(rtol_wrt="r0")   # the sweep driver's accuracy regime
ZSHARD_REL = 1e-8        # f64 z-sharded vs unsharded, both at rtol 1e-11


def require_gpu():
    """The JAX devices, if they are GPUs; raise otherwise (no CPU fallback:
    nothing this script measures means anything off the card)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is "
                           f"{devs[0].platform} ({devs[0].device_kind})")
    return devs


def result_line(devs) -> str:
    """The final line: ok plus the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def max_abs_error(got, truth) -> float:
    """Largest absolute deviation of finite traces of the truth's shape."""
    got = np.asarray(got, np.float64)
    truth = np.asarray(truth, np.float64)
    if got.shape != truth.shape:
        raise AssertionError(f"shape {got.shape} != truth {truth.shape}")
    if not np.isfinite(got).all():
        raise AssertionError("non-finite values")
    return float(np.abs(got - truth).max())


def rel_l2(got, truth) -> float:
    """||got - truth|| / ||truth|| over finite traces of the truth's shape."""
    max_abs_error(got, truth)
    got = np.asarray(got, np.float64)
    truth = np.asarray(truth, np.float64)
    return float(np.linalg.norm(got - truth) / np.linalg.norm(truth))


def check(name: str, value: float, bound: float) -> None:
    print(f"  {name}: {value!r} (bound {bound!r})", flush=True)
    if not value <= bound:
        raise AssertionError(f"{name} = {value!r} exceeds {bound!r}")


def card_info() -> str:
    """Name and power limit of each card, from a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def print_peak(phase: str) -> None:
    import jax
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()]
    print(f"[{phase}] peak_bytes_in_use per device: {peaks}", flush=True)


def read_watchers(path: str) -> np.ndarray:
    """(steps, watchers) from a driver's watcher_points.csv."""
    from heatflow_tpu.io.csvio import read_numeric_columns
    cols = read_numeric_columns(path)
    names = [n for n in cols if n != "time"]
    return np.stack([cols[n] for n in names], axis=1)


def build(cfg_path: str):
    """(cfg, problem) for a config, built the way the drivers build it."""
    from heatflow_tpu.config import load_config
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    cfg = load_config(cfg_path)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(cfg["heating"]["file"]),
                            cfg, watcher_points=coupler_watcher_points(cfg))
    return cfg, problem


def sample_kappas(problem, k: float) -> np.ndarray:
    kp = np.array(problem.kappas, np.float64)
    kp[list(problem.mesh.material_tags).index("p_sample")] = k
    return kp


def phase_flagship_f32(truth):
    import jax.numpy as jnp
    from heatflow_tpu.drivers import run2d
    from heatflow_tpu.sim.stepper import run_transient
    from heatflow_tpu.utils import resolve_recording_precondition
    print("== phase 1: flagship-f32 (drivers.run2d.main, driver defaults)",
          flush=True)
    mesh_dir = os.path.join(OUT, "mesh_flagship")
    out_dir = os.path.join(OUT, "flagship")
    t0 = time.perf_counter()
    run2d.main(["--config", FLAGSHIP, "--mesh-folder", mesh_dir,
                "--rebuild-mesh", "--output-folder", out_dir,
                "--watcher-points", "auto"])
    cold = time.perf_counter() - t0
    watch = read_watchers(os.path.join(out_dir, "watcher_points.csv"))
    print(f"  compile+first-run (driver wall time incl. mesh build): "
          f"{cold!r} s", flush=True)
    check("flagship f32 max |trace - truth| [K]",
          max_abs_error(watch, truth), FLAGSHIP_MAX_K)

    # warm rate: the same configuration the driver resolved (f32, rtol 1e-4
    # wrt r0, extrapolated seeds, recording on), run twice on one problem
    # object so the second call reuses the compiled program
    _cfg, problem = build(FLAGSHIP)
    prec = resolve_recording_precondition(True, jnp.float32, rtol_wrt="r0")
    kw = dict(dtype=jnp.float32, rtol=1e-4, maxiter=20000,
              record_gradient=True, precondition=prec,
              warm_start="extrapolate")
    run_transient(problem, **kw)
    t0 = time.perf_counter()
    res = run_transient(problem, **kw)
    warm = time.perf_counter() - t0
    print(f"  preconditioner {prec}; warm steps/s "
          f"{problem.num_steps / warm!r}; CG iterations/step mean "
          f"{float(res.cg_iters.mean())!r} max {int(res.cg_iters.max())}",
          flush=True)
    check("warm rerun max |trace - driver trace| [K]",
          max_abs_error(res.watcher, watch), FLAGSHIP_MAX_K)
    print_peak("flagship-f32")
    return problem


def phase_flagship_f64(problem, truth):
    import jax
    import jax.numpy as jnp
    from heatflow_tpu.sim.stepper import make_simulate_fn
    print("== phase 2: flagship-f64-parity (jacobi, rtol 1e-11)", flush=True)
    jax.config.update("jax_enable_x64", True)
    fn = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                          maxiter=100000, precondition="jacobi",
                          record_gradient=False)
    t0 = time.perf_counter()
    ys = fn()
    watch = np.asarray(ys["watch"])
    elapsed = time.perf_counter() - t0
    iters = np.asarray(ys["cg_iters"])
    print(f"  compile+run {elapsed!r} s; CG iterations/step mean "
          f"{float(iters.mean())!r} max {int(iters.max())}", flush=True)
    check("flagship f64 rel-L2 vs truth", rel_l2(watch, truth),
          PARITY_REL_L2)
    print_peak("flagship-f64-parity")


def phase_sweep():
    import jax
    import jax.numpy as jnp
    from heatflow_tpu.drivers.sweep import run_parameter_sweep
    from heatflow_tpu.sim.stepper import make_simulate_fn
    print("== phase 3: sweep (8 FWHM x 8 kappa x 1 width, f32)", flush=True)
    cfg, problem = build(NO_DIAMOND)
    width = float(cfg["mats"]["p_sample"]["z"])
    t0 = time.perf_counter()
    results, failed = run_parameter_sweep(
        NO_DIAMOND, os.path.join(OUT, "sweep"), (6.6e-6, 2.64e-5),
        (1.0, 100.0), (width, width), (8, 8, 1),
        base_mesh_folder=os.path.join(OUT, "sweep_meshes"),
        suppress_print=False, dtype=jnp.float32,
        devices=jax.devices()[:1], **SWEEP_KW)
    print(f"  driver wall time {time.perf_counter() - t0!r} s", flush=True)
    if failed or len(results) != 64:
        raise AssertionError(f"{len(results)} ok, {len(failed)} failed "
                             "(non-finite lanes)")
    print("  64 lanes, all finite", flush=True)
    fn = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-10,
                          maxiter=100000, precondition="jacobi",
                          record_gradient=False)
    for rec in (results[0], results[-1]):
        lane = read_watchers(os.path.join(rec["output_dir"],
                                          "watcher_points.csv"))
        ref = np.asarray(fn(kappas=sample_kappas(problem, rec["k"]),
                            fwhm=rec["fwhm"])["watch"])
        check(f"lane k={rec['k']!r} fwhm={rec['fwhm']!r} max |f32 - f64| "
              "[K]", max_abs_error(lane, ref), SWEEP_MAX_K)
    print_peak("sweep")


def phase_fit_gradient():
    import jax
    import jax.numpy as jnp
    from heatflow_tpu.drivers.fit import experimental_objective
    print("== phase 4: fit-gradient (f64 value_and_grad vs central "
          "differences)", flush=True)
    _cfg, problem = build(READ_FLUX)
    obj = experimental_objective(problem, dtype=jnp.float64)
    f = jax.jit(lambda th: obj(th[0], th[1]))
    theta = np.array([8.0, 1.0e-5])
    t0 = time.perf_counter()
    value, grad = jax.jit(jax.value_and_grad(f))(jnp.asarray(theta))
    grad = np.asarray(grad)
    print(f"  objective {float(value)!r}, gradient {grad.tolist()!r} "
          f"({time.perf_counter() - t0!r} s incl. compile)", flush=True)
    for i, name in enumerate(("kappa", "fwhm")):
        h = 1e-3 * theta[i]
        up, dn = theta.copy(), theta.copy()
        up[i] += h
        dn[i] -= h
        fd = (float(f(jnp.asarray(up))) - float(f(jnp.asarray(dn)))) / (2 * h)
        check(f"d/d{name} relative error vs central difference",
              abs(grad[i] - fd) / abs(fd), GRAD_REL)
    print_peak("fit-gradient")


def phase_gpu_checks():
    from heatflow_tpu.devicecheck import CHECKS
    print("== phase 5: gpu-checks", flush=True)
    for name, fn in CHECKS.items():
        print(f"  {name}: deviation {fn()!r}", flush=True)
    print_peak("gpu-checks")


def four_cards():
    import jax
    import jax.numpy as jnp
    from heatflow_tpu.drivers.sweep import run_parameter_sweep
    from heatflow_tpu.parallel.sharding import config_mesh
    from heatflow_tpu.sim.stepper import make_simulate_fn
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn
    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    cfg, problem = build(NO_DIAMOND)
    width = float(cfg["mats"]["p_sample"]["z"])

    print("== four cards: config-axis sweep, B=256 over 4 cards", flush=True)
    t0 = time.perf_counter()
    results, failed = run_parameter_sweep(
        NO_DIAMOND, os.path.join(OUT, "sweep4"), (6.6e-6, 2.64e-5),
        (1.0, 100.0), (width, width), (16, 16, 1),
        base_mesh_folder=os.path.join(OUT, "sweep_meshes"),
        suppress_print=False, dtype=jnp.float32, devices=devs, **SWEEP_KW)
    print(f"  driver wall time {time.perf_counter() - t0!r} s", flush=True)
    if failed or len(results) != 256:
        raise AssertionError(f"{len(results)} ok, {len(failed)} failed")
    picks = [results[i] for i in np.linspace(0, 255, 8).astype(int)]
    # the driver's plain f32 sweep in that regime: jacobi, rtol 1e-4 wrt r0
    one = make_sweep_fn(problem, dtype=jnp.float32, rtol=1e-4, **SWEEP_KW)(
        np.array([r["k"] for r in picks]), np.array([r["fwhm"] for r in picks]))
    one = np.asarray(one)
    err = max(max_abs_error(read_watchers(os.path.join(
        r["output_dir"], "watcher_points.csv")), one[i])
        for i, r in enumerate(picks))
    check("8 sampled lanes, max |4-card - 1-card| [K]", err,
          SHARDED_SWEEP_MAX_K)
    print_peak("four-card sweep")

    print("== four cards: z-sharded single problem, Nz=243 over 3 cards "
          "(f64)", flush=True)
    jax.config.update("jax_enable_x64", True)
    kw = dict(dtype=jnp.float64, rtol=1e-11, maxiter=100000,
              precondition="jacobi", record_gradient=True)
    ref = make_simulate_fn(problem, **kw)()
    got = make_simulate_fn(problem, mesh=config_mesh(3, z_shards=3), **kw)()
    for key in ("watch", "band", "axis"):
        a = np.asarray(ref[key])
        check(f"z-sharded {key} rel-max vs unsharded",
              max_abs_error(got[key], a) / np.abs(a).max(), ZSHARD_REL)
    print_peak("z-sharded")
    return devs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the paths that span four cards")
    args = p.parse_args(argv)
    import jax
    import jaxlib
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}", flush=True)
    devs = require_gpu()
    print(f"card: {card_info()}", flush=True)
    from heatflow_tpu.utils import enable_compilation_cache
    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    os.chdir(ROOT)         # the configs name their heating files relatively
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    if args.four_cards:
        devs = four_cards()
    else:
        truth = np.load(TRUTH)["watch"]
        problem = phase_flagship_f32(truth)
        phase_flagship_f64(problem, truth)
        phase_sweep()
        phase_fit_gradient()
        phase_gpu_checks()
    print(f"all phases passed in {time.perf_counter() - t0!r} s", flush=True)
    print(result_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
