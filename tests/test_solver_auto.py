"""Driver defaults: solver='auto'.

'auto' (the drivers' default) and 'xla' both name the one XLA engine, for
every dtype, preconditioner and mesh kind; the sweep driver records the
engine that ran in sweep_metadata.json.
"""

import json
import os

import jax.numpy as jnp
import pytest
import yaml

from heatflow_tpu.sim.stepper import PRECONDITIONERS

from heatflow_tpu.drivers import sweep as sweep_mod
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg


def _tiny_mesh(tmp_path):
    from heatflow_tpu.geometry import build_layout
    from heatflow_tpu.mesh.structured import build_structured_mesh
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    domain, mats = build_layout(cfg)
    return build_structured_mesh(domain, mats)


@pytest.fixture(scope="module")
def problems():
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.sim.unstructured import build_problem_unstructured
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 2
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy())
    domain, mats = build_layout(cfg)
    wp = coupler_watcher_points(cfg)
    return {
        "structured": build_problem(build_structured_mesh(domain, mats),
                                    heating, cfg, watcher_points=wp),
        "unstructured": build_problem_unstructured(
            build_unstructured_mesh(domain, mats, jitter=0.25, seed=7),
            heating, cfg, watcher_points=wp),
    }


@pytest.mark.parametrize("mesh_kind", ["structured", "unstructured"])
@pytest.mark.parametrize("precondition", PRECONDITIONERS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_resolve_solver_matrix(problems, mesh_kind, precondition, dtype):
    """'auto' builds exactly the engine 'xla' builds (the makers memoize on
    the resolved solver, so both return the same callable); the unstructured
    engine rejects preconditioners it does not have under either name."""
    from heatflow_tpu.sim.stepper import make_simulate_fn
    from heatflow_tpu.sim.unstructured import make_simulate_fn_unstructured
    from heatflow_tpu.utils import resolve_solver
    assert resolve_solver("auto") == resolve_solver("xla") == "xla"
    problem = problems[mesh_kind]
    maker = (make_simulate_fn if mesh_kind == "structured"
             else make_simulate_fn_unstructured)
    kw = dict(dtype=jnp.dtype(dtype), precondition=precondition,
              record_gradient=False)
    if mesh_kind == "unstructured" and precondition != "jacobi":
        for solver in ("auto", "xla"):
            with pytest.raises(ValueError, match="precondition"):
                maker(problem, solver=solver, **kw)
        return
    assert maker(problem, solver="auto", **kw) is \
        maker(problem, solver="xla", **kw)


def test_sweep_metadata_records_resolved_solver(tmp_path):
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 2
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    width = float(cfg["mats"]["p_sample"]["z"])

    out = str(tmp_path / "sweep_auto")
    results, failed = sweep_mod.run_parameter_sweep(
        str(cfg_path), out, (4e-6, 4e-6), (3.0, 3.0), (width, width),
        (1, 2, 1), base_mesh_folder=str(tmp_path / "meshes"),
        suppress_print=True, dtype=jnp.float32)
    assert len(results) == 2 and not failed
    meta = json.load(open(os.path.join(out, "sweep_metadata.json")))
    # the metadata names the engine that ran, not the requested alias
    assert meta["solver"] == "xla"
    assert "solver_resolved" not in meta


def test_sweep_driver_resolves_warm_start(tmp_path):
    """f32 recording sweeps default to extrapolated warm starts (solve +
    per-step projection seed); the resolved value reaches the maker
    (captured via its memoization key)."""
    from heatflow_tpu.sim import sweepkernel

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 2
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    width = float(cfg["mats"]["p_sample"]["z"])

    seen = {}
    real = sweepkernel.make_sweep_fn_recording

    def capture(problem, **kw):
        seen.update(kw)
        return real(problem, **kw)

    import unittest.mock as mock
    with mock.patch.object(sweepkernel, "make_sweep_fn_recording", capture):
        results, failed = sweep_mod.run_parameter_sweep(
            str(cfg_path), str(tmp_path / "ws"), (4e-6, 4e-6), (3.0, 3.0),
            (width, width), (1, 1, 1),
            base_mesh_folder=str(tmp_path / "meshes"),
            suppress_print=True, dtype=jnp.float32, record_gradient=True)
    assert results and not failed
    assert seen["warm_start"] == "extrapolate"
    assert seen["precondition"] == "rline"
    assert seen["rtol"] == 1e-5
