"""Round-3 fixes, part 2: the f32 recording-run preconditioner default.

At f32, jacobi-CG's unconverged error concentrates in exactly the
near-axis radial modes the gradient artifacts amplify by ~1/h_r — the
raw-axis CSV (ref run_no_diamond.py:610-617) picks up spurious spikes far
above the rline engine's at the same rtol, while the per-step projection
solve itself converges fine either way. So f32 gradient-recording runs
default to a line preconditioner in both drivers
(utils.resolve_recording_precondition), and the recording sweep maker
threads ``precondition`` to its engine (it was silently dropped before).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from heatflow_tpu.utils import resolve_recording_precondition
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg


def test_resolve_recording_precondition_matrix():
    f32, f64 = jnp.float32, jnp.float64
    # structured single runs: adi
    assert resolve_recording_precondition(True, f32) == "adi"
    # batched sweeps: rline
    assert resolve_recording_precondition(True, f32, batched=True) \
        == "rline"
    # f64 converges past the artifact sensitivity — keep jacobi
    assert resolve_recording_precondition(True, f64) == "jacobi"
    # watcher-only STRUCTURED SINGLE runs: adi — in the pure-f32 wrt-r0
    # regime rline grinds near the floor on late steps while adi
    # converges first; plain SWEEPS keep jacobi
    assert resolve_recording_precondition(False, f32) == "adi"
    assert resolve_recording_precondition(False, f32,
                                          batched=True) == "jacobi"
    # refined structured singles: rline
    assert resolve_recording_precondition(True, f32, f64_refine=1) \
        == "rline"
    assert resolve_recording_precondition(False, f32,
                                          f64_refine=1) == "rline"
    # the unstructured engine has no line solve
    assert resolve_recording_precondition(True, f32,
                                          unstructured=True) == "jacobi"
    # fixed budgets keep jacobi
    assert resolve_recording_precondition(True, f32,
                                          fixed_iters=50) == "jacobi"


def _tiny_problem(tmp_path):
    from heatflow_tpu.config import validate_config
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    validate_config(cfg, require_heating_file=True)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(str(heat_csv)), cfg,
                            watcher_points=coupler_watcher_points(cfg))
    return cfg, problem


def test_recording_xla_engine_threads_precondition(tmp_path, monkeypatch):
    """make_sweep_fn_recording(solver='xla') passes precondition (and the
    projection settings) through to make_simulate_fn."""
    from heatflow_tpu.sim import stepper
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn_recording

    _, problem = _tiny_problem(tmp_path)
    seen = {}
    real = stepper.make_simulate_fn

    def capture(problem, **kw):
        seen.update(kw)
        return real(problem, **kw)

    monkeypatch.setattr(stepper, "make_simulate_fn", capture)
    make_sweep_fn_recording(problem, dtype=jnp.float32, rtol=1e-5,
                            precondition="rline", proj_maxiter=123)
    assert seen["precondition"] == "rline"
    assert seen["proj_maxiter"] == 123


def test_recording_rline_matches_jacobi_on_converged_solves(tmp_path):
    """End-to-end composition check: the rline-preconditioned f32 recording
    sweep produces the same artifacts as jacobi when both are converged
    (tiny well-conditioned problem, tight rtol)."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn_recording

    _, problem = _tiny_problem(tmp_path)
    ks = np.array([2.0, 6.0])
    fs = np.array([4e-6, 6e-6])
    arts = {}
    for prec in ("jacobi", "rline"):
        fn = make_sweep_fn_recording(problem, dtype=jnp.float32, rtol=1e-6,
                                     precondition=prec)
        ys = fn(ks, fs)
        arts[prec] = {k: np.asarray(ys[k]) for k in ("watch", "band", "axis")}
    # per-family tolerances follow the ~1/h error amplification ladder:
    # both engines stop at the f32 residual floor, and the floor-level
    # solution difference is amplified in the gradient families (measured
    # here: watch 6e-5, band 2e-3, axis 2e-2 of |max| — the miniature of
    # the production effect this default exists for)
    for k, tol in (("watch", 1e-3), ("band", 1e-2), ("axis", 5e-2)):
        a, b = arts["jacobi"][k], arts["rline"][k]
        assert np.isfinite(a).all() and np.isfinite(b).all()
        rng = float(np.abs(a).max()) or 1.0
        np.testing.assert_allclose(b, a, atol=tol * rng, rtol=0)


@pytest.mark.parametrize("dtype,expected", [(jnp.float32, "rline"),
                                            (jnp.float64, "jacobi")])
def test_sweep_driver_resolves_recording_precondition(tmp_path, dtype,
                                                      expected):
    """The sweep driver's metadata records the resolved preconditioner:
    rline for f32 --record-gradient sweeps, jacobi at f64."""
    from heatflow_tpu.drivers.sweep import run_parameter_sweep

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 2
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    width = float(cfg["mats"]["p_sample"]["z"])

    out = str(tmp_path / f"sweep_{jnp.dtype(dtype).name}")
    results, failed = run_parameter_sweep(
        str(cfg_path), out, (4e-6, 4e-6), (3.0, 3.0), (width, width),
        (1, 1, 1), base_mesh_folder=str(tmp_path / "meshes"),
        suppress_print=True, dtype=dtype, record_gradient=True)
    assert results and not failed
    meta = json.load(open(os.path.join(out, "sweep_metadata.json")))
    assert meta["precondition"] == expected
    raw = os.path.join(results[0]["output_dir"], "radial_gradient_raw.csv")
    assert os.path.isfile(raw)


def test_recording_vmem_adi_matches_jacobi_on_converged_solves(tmp_path):
    """The adi-preconditioned recording sweep (both line stacks factored
    per config) produces the same artifacts as the jacobi recording
    engine when both are converged."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn_recording

    _, problem = _tiny_problem(tmp_path)
    ks = np.array([2.0, 6.0])
    fs = np.array([4e-6, 6e-6])
    arts = {}
    for prec in ("jacobi", "adi"):
        fn = make_sweep_fn_recording(problem, dtype=jnp.float32, rtol=1e-6,
                                     precondition=prec)
        ys = fn(ks, fs)
        arts[prec] = {k: np.asarray(ys[k]) for k in ("watch", "band", "axis")}
    # same per-family tolerance ladder as the rline twin above
    for k, tol in (("watch", 1e-3), ("band", 1e-2), ("axis", 5e-2)):
        a, b = arts["jacobi"][k], arts["adi"][k]
        assert np.isfinite(a).all() and np.isfinite(b).all()
        rng = float(np.abs(a).max()) or 1.0
        np.testing.assert_allclose(b, a, atol=tol * rng, rtol=0)
