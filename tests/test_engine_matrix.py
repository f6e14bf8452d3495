"""The XLA engine against the independent scipy reference
(tests/reference_fem.py: quadrature-assembled P1 FEM, factor-once sparse LU
backward Euler at f64), for every preconditioner in every workflow that
runs it: the single-problem stepper, the vmapped sweep, the recording
(artifact-parity) sweep, and the mixed-precision refined sweep."""

import jax.numpy as jnp
import numpy as np
import pytest

from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.sim.bc import HeatingCurve, gaussian_coeff
from heatflow_tpu.sim.problem import build_problem
from heatflow_tpu.sim.stepper import PRECONDITIONERS, make_simulate_fn
from heatflow_tpu.sim.sweepkernel import (make_sweep_fn,
                                          make_sweep_fn_recording)
from tests import reference_fem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

KS = np.array([2.0, 7.5])
FS = np.array([4e-6, 9e-6])


@pytest.fixture(scope="module")
def case():
    """A tiny DAC problem and the reference watcher traces (B, S, W) of the
    two (kappa, FWHM) configs."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 6
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy())
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, heating, cfg,
                            watcher_points=coupler_watcher_points(cfg))

    nodes = mesh.node_coords()
    tris, tri_tags = mesh.triangles()
    m_idx = list(mesh.material_tags).index("p_sample")
    rho_cvs = np.array([m.rho_cv for m in mats])
    ic = problem.ic_temp
    dirich = problem.dirichlet_mask.ravel()
    dir_f = dirich.astype(float)
    off = heating.amplitude_offset(ic)
    watch_nodes = [mesh.nearest_node(*p)
                   for p in coupler_watcher_points(cfg).values()]
    refs = []
    for k, f in zip(KS, FS):
        kappas = np.array([m.kappa for m in mats])
        kappas[m_idx] = k
        profile = (np.exp(gaussian_coeff(f) * problem.r_sq)
                   * problem.heat_mask.astype(float)).ravel()

        def g_of_t(t, profile=profile):
            amp = np.interp(t, heating.time, heating.temp) - off
            return ic * dir_f + (amp - ic) * profile

        refs.append(reference_fem.backward_euler(
            nodes, tris, kappas[tri_tags - 1], rho_cvs[tri_tags - 1],
            problem.dt, problem.num_steps, dirich, g_of_t, ic,
            watch_nodes=watch_nodes)["watch"])
    return problem, np.stack(refs), m_idx


def _run(workflow, problem, engine, m_idx):
    if workflow == "single":
        fn = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-12,
                              maxiter=20000, precondition=engine,
                              record_gradient=False)
        out = []
        for k, f in zip(KS, FS):
            kp = np.array(problem.kappas, np.float64)
            kp[m_idx] = k
            out.append(np.asarray(fn(kappas=kp, fwhm=f)["watch"]))
        return np.stack(out)
    if workflow == "sweep":
        return np.asarray(make_sweep_fn(
            problem, dtype=jnp.float64, rtol=1e-12, maxiter=20000,
            precondition=engine)(KS, FS))
    if workflow == "recording":
        return np.asarray(make_sweep_fn_recording(
            problem, dtype=jnp.float64, rtol=1e-12, maxiter=20000,
            precondition=engine)(KS, FS)["watch"])
    # refined: f32 correction solves around f64 residuals, three passes
    return np.asarray(make_sweep_fn(
        problem, dtype=jnp.float32, rtol=1e-5, maxiter=20000,
        precondition=engine, f64_refine=3)(KS, FS))


@pytest.mark.parametrize("workflow",
                         ["single", "sweep", "recording", "refined"])
@pytest.mark.parametrize("engine", PRECONDITIONERS)
def test_engine_matches_reference_fem(case, engine, workflow):
    problem, ref, m_idx = case
    got = _run(workflow, problem, engine, m_idx)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-8, f"{engine}/{workflow}: rel-max {err:.2e}"
