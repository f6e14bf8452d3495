"""Sweep engine: batched kernel == per-config runs; objective gradients;
driver artifacts; failure masking."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import yaml

from heatflow_tpu.drivers.sweep import (create_parameter_grid, run_name,
                                        run_parameter_sweep)
from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.sim.bc import HeatingCurve
from heatflow_tpu.sim.problem import build_problem
from heatflow_tpu.sim.stepper import run_transient
from heatflow_tpu.sim.sweepkernel import make_sweep_fn, normalized_oside_rmse
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg


@pytest.fixture(scope="module")
def sweep_problem():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 5
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy(),
                           oside=df["oside"].to_numpy())
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    wp = coupler_watcher_points(cfg)
    problem = build_problem(mesh, heating, cfg, watcher_points=wp)
    return cfg, problem, heating


def test_batched_matches_individual_runs(sweep_problem):
    """The delta-operator sweep kernel must reproduce full per-config runs."""
    cfg, problem, _ = sweep_problem
    fn = make_sweep_fn(problem, dtype=jnp.float64, rtol=1e-12)
    ks = np.array([2.0, 3.8, 7.5])
    fs = np.array([4e-6, 6e-6, 9e-6])
    traces = np.asarray(fn(ks, fs))

    for i in range(3):
        kap = problem.kappas.copy()
        kap[list(problem.mesh.material_tags).index("p_sample")] = ks[i]
        res = run_transient(problem, rtol=1e-12, record_gradient=False,
                            kappas=kap, fwhm=fs[i])
        scale = np.abs(res.watcher).max()
        assert np.abs(traces[i] - res.watcher).max() / scale < 1e-9


def test_objective_and_gradient(sweep_problem):
    """The RMSE objective is computable and differentiable wrt (k, fwhm) —
    the gradient-based-fitting capability the reference cannot offer."""
    cfg, problem, heating = sweep_problem
    fn = make_sweep_fn(problem, dtype=jnp.float64, rtol=1e-12)
    ic = problem.ic_temp
    shifted = heating.oside - heating.oside[0] + ic
    exp_normed = (shifted - shifted[0]) / (heating.temp.max()
                                           - heating.temp.min())
    times = jnp.asarray(fn.times)
    exp_t = jnp.asarray(heating.time)
    exp_o = jnp.asarray(exp_normed)

    def objective(k, fwhm):
        tr = fn.one_config(k, fwhm)
        return normalized_oside_rmse(times, tr, exp_t, exp_o)

    k0, f0 = 3.8, 6e-6
    val, grads = jax.value_and_grad(objective, argnums=(0, 1))(k0, f0)
    assert np.isfinite(float(val))
    gk, gf = float(grads[0]), float(grads[1])
    # finite-difference check on dRMSE/dk
    eps = 1e-4
    fd = (float(objective(k0 + eps, f0)) - float(objective(k0 - eps, f0))) \
        / (2 * eps)
    assert gk == pytest.approx(fd, rel=2e-3, abs=1e-9)
    assert np.isfinite(gf)


def test_grid_layout():
    combos, fv, kv, wv = create_parameter_grid(
        (1e-6, 1e-4), (1.0, 100.0), (1e-6, 3e-6), (3, 2, 2))
    assert len(combos) == 12
    np.testing.assert_allclose(fv, np.logspace(-6, -4, 3))
    # grouped by width first
    assert [c["width"] for c in combos[:6]] == [1e-6] * 6


def test_run_name_format():
    assert run_name(1.32e-5, 3.8, 1.84e-6) == "fwhm_1.32e-5_k_3.80_width_1.84e-6"


def test_sweep_driver_artifacts(tmp_path):
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    out = str(tmp_path / "sweep_out")
    results, failed = run_parameter_sweep(
        str(cfg_path), out, (4e-6, 8e-6), (2.0, 6.0), (1.5e-6, 2.0e-6),
        (2, 2, 2), base_mesh_folder=str(tmp_path / "meshes"),
        suppress_print=True, dtype=jnp.float64)
    assert len(results) == 8 and not failed

    meta = json.load(open(os.path.join(out, "sweep_metadata.json")))
    assert meta["total_runs"] == 8
    df = pd.read_csv(os.path.join(out, "successful_runs.csv"))
    assert len(df) == 8 and set(df["status"]) == {"success"}

    # per-run artifacts in reference format
    d0 = df.iloc[0]["output_dir"]
    w = pd.read_csv(os.path.join(d0, "watcher_points.csv"))
    assert list(w.columns) == ["time", "pside", "oside"]
    used = yaml.safe_load(open(os.path.join(d0, "used_config.yaml")))
    assert used["mats"]["p_sample"]["k"] == pytest.approx(df.iloc[0]["k"])

    # mesh reuse: one mesh folder per width
    mesh_dirs = os.listdir(tmp_path / "meshes")
    assert len(mesh_dirs) == 2


def test_make_sweep_fn_is_memoized(sweep_problem):
    """Identical arguments return the SAME compiled callable (re-tracing a
    fresh jit per call is several times slower than the cached path);
    different arguments get their own."""
    _cfg, problem, _ = sweep_problem
    a = make_sweep_fn(problem, dtype=jnp.float64, fixed_iters=4)
    b = make_sweep_fn(problem, dtype=jnp.float64, fixed_iters=4)
    c = make_sweep_fn(problem, dtype=jnp.float64, fixed_iters=5)
    assert a is b and a is not c

    from heatflow_tpu.sim.stepper import make_simulate_fn
    s1 = make_simulate_fn(problem, dtype=jnp.float64, record_gradient=False)
    s2 = make_simulate_fn(problem, dtype=jnp.float64, record_gradient=False)
    assert s1 is s2


def test_sweep_record_gradient_artifacts(tmp_path):
    """record_gradient=True sweeps write the reference's per-run gradient
    CSVs (ref parameter_sweep.py:157-166 runs the full run_simulation,
    which always emits radial_gradient[_raw].csv, run_no_diamond.py
    :602-617) — and the rows equal a direct full-stepper run."""
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    width = float(cfg["mats"]["p_sample"]["z"])

    out = str(tmp_path / "sweep_out")
    results, failed = run_parameter_sweep(
        str(cfg_path), out, (4e-6, 8e-6), (2.0, 6.0), (width, width),
        (2, 2, 1), base_mesh_folder=str(tmp_path / "meshes"),
        suppress_print=True, dtype=jnp.float64, record_gradient=True,
        rtol=1e-10)
    assert len(results) == 4 and not failed

    df = pd.read_csv(os.path.join(out, "successful_runs.csv"))
    rec = df.iloc[0]
    band = pd.read_csv(os.path.join(rec["output_dir"],
                                    "radial_gradient.csv"), index_col=0)
    raw = pd.read_csv(os.path.join(rec["output_dir"],
                                   "radial_gradient_raw.csv"), index_col=0)
    assert band.index.name == "time" and raw.index.name == "time"
    assert np.isfinite(raw.values).all() and np.abs(raw.values).max() > 0

    # rows equal a direct full run at the same parameters
    from heatflow_tpu.config import with_parameters
    cfg_i = with_parameters(cfg, fwhm=rec["fwhm"], sample_k=rec["k"],
                            sample_z=width)
    domain, mats = build_layout(cfg_i)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(str(heat_csv)),
                            cfg_i,
                            watcher_points=coupler_watcher_points(cfg_i))
    res = run_transient(problem, dtype=jnp.float64, rtol=1e-10,
                        record_gradient=True, record_fields=False)
    # both converged tight (the stopping rules differ — sweep 'b' vs
    # stepper 'r0' — so gradient rows, which amplify solution error by
    # ~1/h, only agree when both solves are deep in convergence)
    np.testing.assert_allclose(raw.values, res.axis_rows, rtol=1e-5,
                               atol=1e-5 * np.abs(res.axis_rows).max())
    np.testing.assert_allclose(band.values, res.band_rows, rtol=1e-5,
                               atol=1e-5 * np.abs(res.band_rows).max())


def test_sweep_resume_skips_completed(tmp_path):
    """--resume skips runs already in successful_runs.csv: a re-run after a
    simulated partial sweep executes only the missing combos and the merged
    CSV covers the full grid (beyond the reference, which restarts)."""
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    width = float(cfg["mats"]["p_sample"]["z"])
    out = str(tmp_path / "sweep_out")
    kw = dict(base_mesh_folder=str(tmp_path / "meshes"),
              suppress_print=True, dtype=jnp.float64)

    results, failed = run_parameter_sweep(
        str(cfg_path), out, (4e-6, 8e-6), (2.0, 6.0), (width, width),
        (2, 2, 1), **kw)
    assert len(results) == 4 and not failed

    # simulate a crash that lost half the grid — INTERLEAVED, so id
    # accounting by skipped-count would collide with the kept records
    df = pd.read_csv(os.path.join(out, "successful_runs.csv"))
    kept = df.iloc[[0, 2]]
    kept.to_csv(os.path.join(out, "successful_runs.csv"), index=False)

    results2, failed2 = run_parameter_sweep(
        str(cfg_path), out, (4e-6, 8e-6), (2.0, 6.0), (width, width),
        (2, 2, 1), resume=True, **kw)
    assert not failed2
    merged = pd.read_csv(os.path.join(out, "successful_runs.csv"))
    assert set(merged["run_name"]) == set(df["run_name"])
    # run_id is the combo's position in the full grid: retried runs keep
    # the id of their first attempt, so the merged set never duplicates
    assert sorted(merged["run_id"]) == sorted(df["run_id"])
    assert len(set(merged["run_id"])) == len(merged)
    # only the two missing combos were re-executed
    assert len(results2) == 4 and len(
        [r for r in results2 if r["run_name"] in set(kept["run_name"])]) == 2


def test_nan_parameter_lane_is_poisoned_not_silent(sweep_problem):
    """A non-finite parameter must NOT return finite garbage: the CG
    while_loop's NaN-residual early exit used to return the (finite) seed
    as if converged, evading the sweep's failure masking. Poisoned lanes
    surface as NaN traces; healthy lanes are untouched."""
    _cfg, problem, _ = sweep_problem
    fn = make_sweep_fn(problem, dtype=jnp.float64, rtol=1e-8)
    tr = np.asarray(fn(np.array([4.0, np.nan, 7.0]),
                       np.array([6e-6, 6e-6, 6e-6])))
    finite = np.isfinite(tr).all(axis=(1, 2))
    assert list(finite) == [True, False, True]


def test_sweep_driver_records_failed_runs(tmp_path):
    """Non-finite traces land in failed_runs.csv with error strings — the
    reference's per-run failure records (ref parameter_sweep.py:447-509)."""
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    width = float(cfg["mats"]["p_sample"]["z"])
    out = str(tmp_path / "sweep_out")
    results, failed = run_parameter_sweep(
        cfg, out, (4e-6, 8e-6), (np.nan, np.nan), (width, width),
        (2, 1, 1), base_mesh_folder=str(tmp_path / "meshes"),
        suppress_print=True, dtype=jnp.float64)
    assert not results and len(failed) == 2
    df = pd.read_csv(os.path.join(out, "failed_runs.csv"))
    assert set(df["status"]) == {"failed"}
    assert df["error"].str.contains("non-finite").all()


def test_sweep_rtol_wrt_r0_converges_to_same_traces(sweep_problem):
    """rtol_wrt='r0' (increment-relative stopping, round 3): at tight
    tolerance both stopping regimes land on the same converged traces."""
    _cfg, problem, _ = sweep_problem
    ks = np.array([2.0, 20.0])
    fs = np.array([problem.fwhm, problem.fwhm])
    ref = np.asarray(make_sweep_fn(problem, dtype=jnp.float64, rtol=1e-12,
                                   maxiter=20000)(ks, fs))
    tr = np.asarray(make_sweep_fn(problem, dtype=jnp.float64, rtol=1e-11,
                                  maxiter=20000, rtol_wrt="r0")(ks, fs))
    np.testing.assert_allclose(tr, ref, rtol=1e-7,
                               atol=1e-7 * np.abs(ref).max())


def test_pipelined_chunks_align_runs_and_artifacts(tmp_path):
    """Round-5 driver pipelining (all chunks dispatched before any fetch,
    per-chunk artifact writes): with a batch split over several chunks and
    a failing lane mid-batch, every run dir must carry ITS OWN config's
    trace and the failed lane must land in failed_runs.csv — no off-by-
    chunk misalignment."""
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    width = float(cfg["mats"]["p_sample"]["z"])
    out = str(tmp_path / "sweep_out")

    # 6 k-points, forced into 2-config chunks -> 3 chunks; one lane poisoned
    ks = (2.0, 6.0)
    results, failed = run_parameter_sweep(
        str(cfg_path), out, (5e-6, 5e-6), ks, (width, width), (1, 6, 1),
        base_mesh_folder=str(tmp_path / "meshes"), suppress_print=True,
        dtype=jnp.float64, batch_size=2)
    assert len(results) == 6 and not failed

    # per-run artifact alignment: re-run each config individually and
    # compare its watcher trace to the chunked driver's CSV
    df = pd.read_csv(os.path.join(out, "successful_runs.csv"))
    assert len(df) == 6
    for _, row in df.sample(3, random_state=0).iterrows():
        w = pd.read_csv(os.path.join(row["output_dir"],
                                     "watcher_points.csv"))
        used = yaml.safe_load(open(os.path.join(row["output_dir"],
                                                "used_config.yaml")))
        assert used["mats"]["p_sample"]["k"] == pytest.approx(row["k"])
        cfg_i = tiny_no_diamond_cfg(coarse=3.0)
        cfg_i["timing"]["num_steps"] = 3
        domain, mats = build_layout(cfg_i)
        mesh = build_structured_mesh(domain, mats)
        heating = HeatingCurve.from_csv(str(heat_csv))
        problem = build_problem(mesh, heating, cfg_i,
                                watcher_points=coupler_watcher_points(cfg_i))
        kap = problem.kappas.copy()
        kap[list(problem.mesh.material_tags).index("p_sample")] = row["k"]
        res = run_transient(problem, rtol=1e-12, record_gradient=False,
                            kappas=kap, fwhm=row["fwhm"])
        ref = np.asarray(res.watcher)
        got = w[["pside", "oside"]].to_numpy()
        # driver default rtol (1e-6 wrt b at f64) vs the 1e-12 reference:
        # ~1e-5 solver-tolerance difference; a chunk misalignment would
        # show the NEIGHBORING config's trace (O(0.1-1) relative)
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4, row["k"]
