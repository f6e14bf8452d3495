"""Round-5 fix regressions: sweep group-cache staleness, the rejection of
the retired per-step preconditioner options, and the rtol_wrt-aware
precondition resolution."""

import jax.numpy as jnp
import numpy as np
import pytest

from heatflow_tpu.utils import resolve_recording_precondition
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg


def test_group_cache_invalidates_on_heating_rewrite(tmp_path):
    """Rewriting the heating CSV at the same path between
    run_parameter_sweep invocations must be a cache miss — the cached
    problem embeds the parsed heating contents (ADVICE r4 medium)."""
    from heatflow_tpu.drivers import sweep as sweep_mod

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    mesh_folder = str(tmp_path / "meshes" / "w0")

    sweep_mod._GROUP_CACHE.clear()
    mesh1, problem1, heating1 = sweep_mod._cached_group(cfg, mesh_folder)
    # unchanged files: hit returns the identical objects
    mesh2, problem2, heating2 = sweep_mod._cached_group(cfg, mesh_folder)
    assert mesh2 is mesh1 and problem2 is problem1 and heating2 is heating1

    # rewrite the heating CSV at the SAME path with different contents
    df = synthetic_heating(n=40)
    df["temp"] = df["temp"] + 500.0
    df.to_csv(heat_csv, index=False)
    _m3, _p3, heating3 = sweep_mod._cached_group(cfg, mesh_folder)
    assert heating3 is not heating1
    assert np.max(np.abs(np.asarray(heating3.temp)
                         - np.asarray(heating1.temp))) > 100.0


def test_adaptive_rejects_cheb_degree():
    """The retired options are rejected, not silently ignored:
    precondition='adaptive' is unknown and vmem_cheb_degree is no
    parameter of the stepper."""
    from heatflow_tpu.geometry import build_layout
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.sim.stepper import make_simulate_fn

    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 2
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy(),
                           oside=df["oside"].to_numpy())
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, heating, cfg)
    with pytest.raises(ValueError, match="unknown precondition"):
        make_simulate_fn(problem, dtype=jnp.float32,
                         precondition="adaptive")
    with pytest.raises(TypeError, match="vmem_cheb_degree"):
        make_simulate_fn(problem, dtype=jnp.float32, precondition="rline",
                         vmem_cheb_degree=2)


def test_resolve_precondition_rtol_wrt():
    """Non-default loose stopping keeps the accuracy-safe preconditioners:
    the adi single-run default is measured only under wrt-'r0'."""
    f32 = jnp.float32
    assert resolve_recording_precondition(False, f32) == "adi"
    assert resolve_recording_precondition(False, f32, rtol_wrt="b") \
        == "jacobi"
    assert resolve_recording_precondition(True, f32, rtol_wrt="b") \
        == "rline"
    # refined runs are normalized to inner wrt-'b' stopping already and
    # keep their own resolution
    assert resolve_recording_precondition(False, f32, f64_refine=1) \
        == "rline"


def test_vmem_only_preconditions_reject_z_sharding():
    """The retired adaptive/mgz preconditioners raise a clean ValueError
    under mesh z-sharding too, before any device work."""
    import jax
    from jax.sharding import Mesh
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.sim.stepper import make_simulate_fn

    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 2
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy(),
                           oside=df["oside"].to_numpy())
    domain, mats = build_layout(cfg)
    mesh_s = build_structured_mesh(domain, mats)
    problem = build_problem(mesh_s, heating, cfg,
                            watcher_points=coupler_watcher_points(cfg))
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    dev_mesh = Mesh(devs, axis_names=("config", "z"))
    for prec in ("adaptive", "mgz"):
        with pytest.raises(ValueError, match="unknown precondition"):
            make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-5,
                             record_gradient=False, precondition=prec,
                             mesh=dev_mesh, maxiter=2002)
