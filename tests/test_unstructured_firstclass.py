"""First-class unstructured path (VERDICT r1 items 1 & 6): a genuinely
non-grid perturbed/graded triangulation of the reference geometry run through
the full feature surface — f64 parity vs the independent scipy FEM, 1D axis
extraction, steady state, parameter overrides, sweeps, differentiability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
from heatflow_tpu.sim.bc import HeatingCurve, gaussian_coeff
from heatflow_tpu.sim.reduced1d import (extract_axis_submesh,
                                        extract_axis_submesh_unstructured)
from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                           make_simulate_fn_unstructured,
                                           make_sweep_fn_unstructured,
                                           solve_steady_unstructured)
from tests import reference_fem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg


@pytest.fixture(scope="module")
def perturbed():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 5
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=7)
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy())
    wp = coupler_watcher_points(cfg)
    problem = build_problem_unstructured(umesh, heating, cfg,
                                         watcher_points=wp)
    return cfg, domain, mats, umesh, heating, problem


def test_mesh_is_genuinely_non_grid(perturbed):
    """Not a tensor grid: interior nodes do not share coordinates along
    lines, and both diagonal orientations occur."""
    *_, umesh, _heating, _problem = perturbed
    z = umesh.nodes[:, 0]
    # on a tensor grid the number of distinct z-values equals Nz (~50);
    # after jitter almost every interior node has a unique z
    assert len(np.unique(np.round(z, 12))) > 0.5 * len(z)
    # mixed diagonals: edge (n00, n11) and (n10, n01) both present
    e = np.sort(np.concatenate([umesh.cells[:, [0, 1]],
                                umesh.cells[:, [1, 2]],
                                umesh.cells[:, [2, 0]]]), axis=1)
    # count edges shared by exactly two triangles (interior edges) — a valid
    # conforming triangulation; and orientation counts differ per quad
    _uniq, counts = np.unique(e, axis=0, return_counts=True)
    assert counts.max() == 2 and (counts == 2).sum() > 100


def test_cell_tags_conform_to_materials(perturbed):
    """Every triangle centroid lies inside its tagged material rectangle —
    jittering must never move a cell across an interface."""
    _cfg, _domain, mats, umesh, *_ = perturbed
    cent = umesh.nodes[umesh.cells].mean(axis=1)
    for tag, m in enumerate(mats, start=1):
        sel = umesh.cell_tags == tag
        zmin, zmax, rmin, rmax = m.bounds
        assert np.all(cent[sel, 0] >= zmin - 1e-12)
        assert np.all(cent[sel, 0] <= zmax + 1e-12)
        assert np.all(cent[sel, 1] >= rmin - 1e-12)
        assert np.all(cent[sel, 1] <= rmax + 1e-12)


def test_transient_parity_vs_reference_fem(perturbed):
    """f64 1e-8 rel-L2 gate on the genuinely unstructured triangulation
    (the exact-mesh parity check the structured path already passes)."""
    cfg, _domain, mats, umesh, heating, problem = perturbed
    fn = make_simulate_fn_unstructured(problem, rtol=1e-13,
                                       record_fields=True)
    ys = jax.tree.map(np.asarray, fn())

    kappas = np.array([m.kappa for m in mats])
    rho_cvs = np.array([m.rho_cv for m in mats])
    ck, cr = kappas[umesh.cell_tags - 1], rho_cvs[umesh.cell_tags - 1]
    ic = problem.ic_temp
    dirich = problem.dirichlet
    dir_f = dirich.astype(float)
    coeff = gaussian_coeff(problem.fwhm)
    profile = np.exp(coeff * umesh.nodes[:, 1] ** 2) \
        * problem.heat_mask.astype(float)
    off = heating.amplitude_offset(ic)

    def g_of_t(t):
        amp = np.interp(t, heating.time, heating.temp) - off
        return ic * dir_f + (amp - ic) * profile

    ref = reference_fem.backward_euler(
        umesh.nodes, umesh.cells, ck, cr, problem.dt, problem.num_steps,
        dirich, g_of_t, ic, watch_nodes=list(problem.watcher_nodes),
        project_gradient=True)

    rel_l2 = (np.linalg.norm(ys["field"] - ref["u"])
              / np.linalg.norm(ref["u"]))
    assert rel_l2 < 1e-8, f"rel-L2 {rel_l2:.2e}"
    scale = np.abs(ref["watch"]).max()
    assert np.abs(ys["watch"] - ref["watch"]).max() / scale < 2e-8
    # gradient projection rows (amplified by ~1/h, looser gate)
    grad_ref = ref["grad_r"][:, problem.axis_nodes]
    ascale = np.abs(grad_ref).max()
    assert np.abs(ys["axis"] - grad_ref).max() / ascale < 2e-5


def test_axis_extraction_matches_structured(perturbed):
    """The facet-scan extraction on the perturbed mesh yields the same
    material tag sequence as the structured j=0 column rule (the geometry is
    identical; only node placement/numbering differ)."""
    cfg, domain, mats, umesh, *_ = perturbed
    from heatflow_tpu.mesh.structured import build_structured_mesh
    smesh = build_structured_mesh(domain, mats)
    z_s, tags_s = extract_axis_submesh(smesh)
    z_u, tags_u = extract_axis_submesh_unstructured(umesh)
    assert len(z_u) == len(z_s)
    assert np.all(np.diff(z_u) > 0)
    np.testing.assert_array_equal(tags_u, tags_s)
    # endpoints are pinned; interior axis nodes are genuinely jittered
    np.testing.assert_allclose([z_u[0], z_u[-1]], [z_s[0], z_s[-1]])
    assert np.abs(z_u[1:-1] - z_s[1:-1]).max() > 0


def test_steady_unstructured_vs_scipy(perturbed):
    """Steady conduction on the ELL operators vs a direct sparse solve."""
    import scipy.sparse.linalg as spla
    cfg, _domain, mats, umesh, heating, problem = perturbed
    from heatflow_tpu.sim.unstructured import solve_steady_unstructured
    ic = problem.ic_temp
    coeff = gaussian_coeff(problem.fwhm)
    profile = np.exp(coeff * umesh.nodes[:, 1] ** 2) \
        * problem.heat_mask.astype(float)
    bc = ic * problem.dirichlet.astype(float) + (2000.0 - ic) * profile
    u, info = solve_steady_unstructured(problem, bc, rtol=1e-13)
    assert info["converged"]

    kappas = np.array([m.kappa for m in mats])
    ck = kappas[umesh.cell_tags - 1]
    K, _ = reference_fem.assemble(umesh.nodes, umesh.cells, ck,
                                  np.ones(len(umesh.cells)),
                                  r_weighted=False)
    free = ~problem.dirichlet
    A = K.tocsc()
    g = np.where(problem.dirichlet, bc, 0.0)
    rhs = -(A[free][:, problem.dirichlet] @ g[problem.dirichlet])
    x = spla.splu(A[free][:, free].tocsc()).solve(rhs)
    u_ref = g.copy()
    u_ref[free] = x
    rel = np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref)
    assert rel < 1e-9, f"steady rel-L2 {rel:.2e}"


def test_parameter_overrides_and_grad(perturbed):
    """kappas/fwhm overrides change the answer; the solve is differentiable
    through the unstructured path (enables gradient-based fitting)."""
    *_, problem = perturbed
    fn = make_simulate_fn_unstructured(problem, rtol=1e-10,
                                       record_gradient=False)
    base = np.asarray(fn()["watch"])
    kp2 = np.asarray(problem.kappas).copy()
    kp2[2] *= 2.0
    mod = np.asarray(fn(kappas=kp2)["watch"])
    assert np.abs(mod - base).max() > 1e-3
    fw = np.asarray(fn(fwhm=problem.fwhm * 0.5)["watch"])
    assert np.abs(fw - base).max() > 1e-3

    fn_d = make_simulate_fn_unstructured(problem, rtol=1e-10,
                                         record_gradient=False,
                                         differentiable=True)

    def loss(k_sample):
        kp = jnp.asarray(problem.kappas).at[2].set(k_sample)
        ys = fn_d(kappas=kp)
        return jnp.sum(ys["watch"] ** 2)

    g = jax.grad(loss)(jnp.asarray(problem.kappas[2]))
    assert np.isfinite(float(g)) and float(g) != 0.0


def test_resume_segments_match_full_run(perturbed):
    """u0/t0 segmented integration equals the uninterrupted run (checkpoint
    resume parity on the ELL path)."""
    *_, problem = perturbed
    fn = make_simulate_fn_unstructured(problem, rtol=1e-13,
                                       record_gradient=False)
    full = jax.tree.map(np.asarray, fn())
    k = 2
    import dataclasses
    p_head = dataclasses.replace(problem, num_steps=k)
    p_tail = dataclasses.replace(problem, num_steps=problem.num_steps - k)
    head = jax.tree.map(np.asarray, make_simulate_fn_unstructured(
        p_head, rtol=1e-13, record_gradient=False)())
    tail = jax.tree.map(np.asarray, make_simulate_fn_unstructured(
        p_tail, rtol=1e-13, record_gradient=False)(
            u0=head["final_u"], t0=k * problem.dt))
    np.testing.assert_allclose(
        np.concatenate([head["watch"], tail["watch"]]), full["watch"],
        rtol=1e-9, atol=1e-7)


def test_unstructured_sweep_matches_per_config(perturbed):
    """The batched unstructured sweep equals one-config runs (mirror of
    test_sweep.py on the ELL path)."""
    *_, problem = perturbed
    ks = np.array([2.0, 3.8, 7.0])
    fs = np.array([5e-6, 6e-6, 8e-6])
    sweep = make_sweep_fn_unstructured(problem, dtype=jnp.float64,
                                       rtol=1e-11)
    traces = np.asarray(sweep(ks, fs))
    assert traces.shape[0] == 3

    fn = make_simulate_fn_unstructured(problem, dtype=jnp.float64,
                                       rtol=1e-11, record_gradient=False)
    for i in range(3):
        kp = np.asarray(problem.kappas).copy()
        kp[2] = ks[i]
        single = np.asarray(fn(kappas=kp, fwhm=fs[i])["watch"])
        np.testing.assert_allclose(traces[i], single, rtol=1e-7, atol=1e-5)


def test_overlay_stencil_path_matches_ell(perturbed):
    """The grid-overlay 9-point stencil path and the ELL gather
    path produce the same traces/fields on the same unstructured problem."""
    import dataclasses
    cfg, _domain, _mats, umesh, heating, problem = perturbed
    assert umesh.grid_overlay is not None   # generator meshes carry it
    fn_ov = make_simulate_fn_unstructured(problem, rtol=1e-12,
                                          record_fields=True)
    ys_ov = jax.tree.map(np.asarray, fn_ov())

    bare = dataclasses.replace(umesh, grid_overlay=None)
    prob_ell = build_problem_unstructured(
        bare, heating, cfg, watcher_points=coupler_watcher_points(cfg))
    fn_ell = make_simulate_fn_unstructured(prob_ell, rtol=1e-12,
                                           record_fields=True)
    ys_ell = jax.tree.map(np.asarray, fn_ell())

    scale = np.abs(ys_ell["field"]).max()
    assert np.abs(ys_ov["field"] - ys_ell["field"]).max() / scale < 1e-10
    np.testing.assert_allclose(ys_ov["watch"], ys_ell["watch"], rtol=1e-9)
    np.testing.assert_allclose(ys_ov["axis"], ys_ell["axis"], rtol=1e-6,
                               atol=1e-8 * np.abs(ys_ell["axis"]).max())
    np.testing.assert_allclose(ys_ov["final_u"], ys_ell["final_u"],
                               rtol=1e-9)


def test_overlay_rejected_on_wrong_topology(perturbed):
    """A corrupted overlay (wrong lattice assignment) must be detected, not
    silently produce a wrong operator."""
    from heatflow_tpu.ops.overlay import ell_to_stencils
    *_, problem = perturbed
    n = len(problem.mesh.nodes)
    bad = {"shape": problem.mesh.grid_overlay["shape"],
           "index": np.roll(problem.mesh.grid_overlay["index"], 7)}
    with pytest.raises(ValueError, match="9-point|bijection"):
        ell_to_stencils(problem.ell, bad)


def test_steady_as_initial_condition_unstructured(perturbed):
    """Steady solve → transient start on the unstructured path (the
    notebooks' workflow, ref with_gasket.ipynb + space_and_forms.py:119-149):
    starting AT the steady state of the t=0 boundary data, the first-step
    temperature change is far smaller than from the cold uniform start."""
    *_, problem = perturbed
    ic = problem.ic_temp
    coeff = gaussian_coeff(problem.fwhm)
    profile = np.exp(coeff * problem.mesh.nodes[:, 1] ** 2) \
        * problem.heat_mask.astype(float)
    # heating amplitude at the first step, with the transient's amp-offset
    # convention (ref run_no_diamond.py:299-309)
    off = problem.heating.amplitude_offset(ic)
    amp0 = float(np.interp(problem.dt, problem.heating.time,
                           problem.heating.temp)) - off
    bc = ic * problem.dirichlet.astype(float) + (amp0 - ic) * profile
    u_steady, info = solve_steady_unstructured(problem, bc, weighted=True,
                                               rtol=1e-12)
    assert info["converged"]

    fn = make_simulate_fn_unstructured(problem, rtol=1e-12,
                                       record_gradient=False,
                                       record_fields=True)
    from_steady = np.asarray(fn(u0=u_steady)["field"][0])
    from_cold = np.asarray(fn()["field"][0])
    d_steady = np.abs(from_steady - u_steady).max()
    d_cold = np.abs(from_cold - ic).max()
    assert d_steady < 0.5 * d_cold
