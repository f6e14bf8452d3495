"""Mixed-precision sweeps: make_sweep_fn(f64_refine=N) — f64-operator
residual refinement around f32 correction solves, per sweep lane (the
sweep twin of stepper.make_simulate_fn(f64_refine=N), pinned in
tests/test_refine.py). Each lane's converged trajectory is the f64
operator's solution while the per-iteration work stays f32.

Also pins the per-lane rtol plumbing of the vmapped CG (the degenerate-lane
guard the refinement uses) and the rtol_wrt pass-through on the
unstructured sweep maker (regression: the sweep driver forwards rtol_wrt
to both mesh kinds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
from heatflow_tpu.sim.bc import HeatingCurve
from heatflow_tpu.sim.problem import build_problem
from heatflow_tpu.sim.sweepkernel import (make_sweep_fn,
                                          run_sweep_time_chunked)
from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                           make_sweep_fn_unstructured)
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

KS = np.array([2.0, 3.8, 7.5])
FS = np.array([4e-6, 6e-6, 9e-6])


@pytest.fixture(scope="module")
def sweep_problem():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 5
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                          temp=df["temp"].to_numpy())
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, heating, cfg,
                            watcher_points=coupler_watcher_points(cfg))
    truth = np.asarray(make_sweep_fn(problem, dtype=jnp.float64,
                                     rtol=1e-12)(KS, FS), np.float64)
    return problem, truth


def test_sweep_refine_breaks_f32_floor(sweep_problem):
    """Refined f32 sweep lands orders of magnitude closer to the f64
    trajectories than the plain f32 sweep at the same inner rtol."""
    problem, truth = sweep_problem
    plain = np.asarray(make_sweep_fn(
        problem, dtype=jnp.float32, rtol=1e-5,
        maxiter=20000)(KS, FS), np.float64)
    refined = make_sweep_fn(
        problem, dtype=jnp.float32, rtol=1e-5,
        maxiter=20000, f64_refine=2)(KS, FS)
    # fields and traces are carried in f64
    assert np.asarray(refined).dtype == np.float64
    e_plain = np.abs(plain - truth).max()
    e_ref = np.abs(np.asarray(refined) - truth).max()
    assert e_ref < e_plain / 20, (e_ref, e_plain)
    assert e_ref < 1e-4


def test_sweep_refine_composes_with_rline_and_extrapolate(sweep_problem):
    """The production recipe (rline + extrapolated seed + refine) converges
    to the same f64 trajectories."""
    problem, truth = sweep_problem
    refined = np.asarray(make_sweep_fn(
        problem, dtype=jnp.float32, rtol=1e-5,
        maxiter=20000, f64_refine=2, precondition="rline",
        warm_start="extrapolate")(KS, FS))
    assert np.abs(refined - truth).max() < 1e-4


def test_sweep_refine_time_chunked_matches_full(sweep_problem):
    """Chunked refined sweeps thread the f64 warm-start history across
    chunk boundaries — the chunked trajectory equals the unchunked one."""
    problem, _ = sweep_problem
    full = np.asarray(make_sweep_fn(
        problem, dtype=jnp.float32, rtol=1e-6,
        maxiter=20000, f64_refine=2,
        warm_start="extrapolate")(KS, FS))
    ch = run_sweep_time_chunked(problem, KS, FS, step_chunk=2,
                                dtype=jnp.float32, rtol=1e-6,
                                maxiter=20000, f64_refine=2,
                                warm_start="extrapolate")
    np.testing.assert_allclose(ch, full, rtol=0,
                               atol=1e-7 * np.abs(full).max())


def test_sweep_refine_unstructured_overlay():
    """The grid-overlay unstructured sweep path shares the refined scan:
    refined lanes reproduce the f64 ELL sweep."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 4
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=7)
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                          temp=df["temp"].to_numpy())
    problem = build_problem_unstructured(
        umesh, heating, cfg, watcher_points=coupler_watcher_points(cfg))
    truth = np.asarray(make_sweep_fn_unstructured(
        problem, dtype=jnp.float64, rtol=1e-12)(KS, FS), np.float64)
    refined = np.asarray(make_sweep_fn_unstructured(
        problem, dtype=jnp.float32, rtol=1e-5,
        maxiter=20000, f64_refine=2)(KS, FS))
    assert np.abs(refined - truth).max() < 1e-4


def test_unstructured_sweep_rtol_wrt_accepted():
    """Regression: the sweep driver forwards rtol_wrt='r0' to BOTH mesh
    kinds; the unstructured maker must accept and apply it."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 3
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=3)
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                          temp=df["temp"].to_numpy())
    problem = build_problem_unstructured(
        umesh, heating, cfg, watcher_points=coupler_watcher_points(cfg))
    out = np.asarray(make_sweep_fn_unstructured(
        problem, dtype=jnp.float64, rtol=1e-10,
        rtol_wrt="r0")(KS[:2], FS[:2]))
    ref = np.asarray(make_sweep_fn_unstructured(
        problem, dtype=jnp.float64, rtol=1e-12)(KS[:2], FS[:2]))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def test_recording_sweep_refine(sweep_problem):
    """Artifact-parity (recording) sweeps compose with f64_refine: every
    lane's full stepper — watcher traces AND per-step gradient projection
    — runs the refined trajectory and reproduces the f64 recording
    sweep."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn_recording
    problem, _ = sweep_problem
    truth = make_sweep_fn_recording(problem, dtype=jnp.float64,
                                    rtol=1e-12)(KS, FS)
    refined = make_sweep_fn_recording(problem, dtype=jnp.float32,
                                      rtol=1e-5, maxiter=20000,
                                      f64_refine=2)(KS, FS)
    # the gradient projection deliberately stays f32 in refine mode (the
    # scaled mass solve is well-conditioned — stepper.py), so band/axis
    # retain f32 projection roundoff while the watcher traces are fully
    # refined; still ~1000x closer than the plain f32 recording sweep
    # (measured: watch 1.7e-4 / band 1.1e-2 / axis 1.4e-1 plain)
    tols = {"watch": 1e-6, "band": 1e-4, "axis": 1e-3}
    for key, tol in tols.items():
        a = np.asarray(truth[key], np.float64)
        b = np.asarray(refined[key], np.float64)
        assert np.isfinite(b).all(), key
        if a.size == 0:
            continue
        scale = max(1.0, np.abs(a).max())
        assert np.abs(a - b).max() / scale < tol, key


def test_sweep_refine_one_config_fallback(sweep_problem):
    """The maker's .one_config attribute stays usable on a refined sweep fn
    (regression: it seeded the scan carry at f32 against f64 ops)."""
    problem, truth = sweep_problem
    fn = make_sweep_fn(problem, dtype=jnp.float32,
                       rtol=1e-5, maxiter=20000, f64_refine=2)
    tr = np.asarray(fn.one_config(KS[0], FS[0]))
    assert np.isfinite(tr).all()
    # the single config runs the same refined solve as the batch lanes
    assert np.abs(tr - truth[0]).max() < 1e-4


def test_unstructured_recording_sweep_refine():
    """record_gradient + f64_refine on an unstructured mesh runs the
    vmapped refined full stepper (regression: every solver choice raised
    with contradictory errors)."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 3
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=3)
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                          temp=df["temp"].to_numpy())
    problem = build_problem_unstructured(
        umesh, heating, cfg, watcher_points=coupler_watcher_points(cfg))
    truth = make_sweep_fn_unstructured(
        problem, dtype=jnp.float64, rtol=1e-12,
        record_gradient=True)(KS[:2], FS[:2])
    refined = make_sweep_fn_unstructured(
        problem, dtype=jnp.float32, rtol=1e-5, maxiter=20000,
        record_gradient=True, f64_refine=2)(KS[:2], FS[:2])
    a = np.asarray(truth["watch"], np.float64)
    b = np.asarray(refined["watch"], np.float64)
    assert np.abs(a - b).max() < 1e-4
    for key in ("band", "axis"):
        assert np.isfinite(np.asarray(refined[key])).all(), key


def test_sweep_refine_tiny_residual_scales():
    """Regression: on problems whose scaled residuals sit far below 1 (the
    supercoarse flagship used by the multichip dry run), the f32 inner
    stopping target rtol²·‖b‖² used to underflow to zero — the inner CG
    ground to maxiter on denormal noise and poisoned progressive lanes.
    The unit-norm rhs scaling keeps every inner solve at O(1)."""
    import __graft_entry__ as g
    problem, _ = g._tiny_flagship(size_scale=24.0)
    base_k = float(problem.kappas[
        list(problem.mesh.material_tags).index("p_sample")])
    ks = base_k * np.linspace(0.5, 2.0, 4)
    fs = problem.fwhm * np.linspace(0.8, 1.25, 4)
    tr = np.asarray(make_sweep_fn(
        problem, dtype=jnp.float32, rtol=1e-6, maxiter=2000, num_steps=4,
        f64_refine=2, warm_start="extrapolate")(ks, fs))
    truth = np.asarray(make_sweep_fn(
        problem, dtype=jnp.float64, rtol=1e-13, num_steps=4)(ks, fs))
    assert np.isfinite(tr).all()
    assert np.abs(tr - truth).max() < 1e-9


def test_batched_tol_per_config_rtol():
    """The vmapped CG takes a per-lane rtol — a lane at rtol>=1 stops at
    its first residual check (the refinement's degenerate-lane guard)."""
    import jax
    from heatflow_tpu.ops.cg import pcg
    from heatflow_tpu.ops.stencil import apply_stencil
    rng = np.random.default_rng(0)
    nz, nr = 8, 16
    # constant off-diagonals keep the stencil operator symmetric (paired
    # offsets share the coefficient); diagonal dominance makes it SPD
    A = jnp.full((7, nz, nr), -0.3, jnp.float64)
    A = A.at[0].set(4.0 + rng.random((nz, nr)))
    b = jnp.asarray(rng.random((2, nz, nr)))
    rtols = jnp.asarray([1e-9, 2.0])
    sol = jax.vmap(lambda bb, rt: pcg(lambda v: apply_stencil(A, v), bb,
                                      jnp.zeros_like(bb), rtol=rt,
                                      maxiter=400))(b, rtols)
    it = np.asarray(sol.iters)
    assert it[0] > 0
    assert it[1] == 0
    assert np.allclose(np.asarray(sol.x[1]), 0.0)


def test_sweep_cli_refine_flag(tmp_path):
    """The sweep CLI's --f64-refine spelling parses, enables x64, applies
    the documented inner-rtol default, and writes the artifact set."""
    import yaml
    from heatflow_tpu.drivers.sweep import main as sweep_main
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    cfg_path = tmp_path / "cfg.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    sweep_main(["--config", str(cfg_path),
                "--output-dir", str(tmp_path / "out"),
                "--mesh-folder", str(tmp_path / "m"),
                "--fwhm-range", "4e-6", "9e-6",
                "--k-range", "2.0", "7.5",
                "--width-range", "1.84e-6", "1.84e-6",
                "--num-points", "2", "1", "1",
                "--solver", "xla", "--f64-refine", "1",
                "--warm-start", "extrapolate"])
    import json
    from heatflow_tpu.io.csvio import read_records_csv
    meta = json.load(open(tmp_path / "out" / "sweep_metadata.json"))
    assert meta["f64_refine"] == 1
    succ = read_records_csv(tmp_path / "out" / "successful_runs.csv")
    assert len(succ) == 2
    assert all(r["status"] == "success" for r in succ)
