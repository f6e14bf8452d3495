"""Round-3 review pass 4: fixes for findings from a whole-diff review.

1. ``pcg_solve``'s derivative solves (custom_linear_solve reuses the primal
   solve_fn for tangent/adjoint systems) used the solution-scale warm
   start and — under ``rtol_wrt='r0'`` — a solution-scale stop reference,
   stopping derivative solves orders of magnitude early. The seed is now
   the rhs/b projection of x0 (exactly x0 for the primal, ~0 for
   derivative rhs), keeping both ``rtol_wrt`` modes per-call correct.
2. The unstructured differentiable branch dropped ``rtol_wrt`` (threaded
   through the cache key but never into ``pcg_solve``).
3. ``refine_inner_seed``: a carried inner-CG seed (`inner_seed='carry'`)
   must be zeroed on degenerate refinement passes — the rtol_eff=2 early
   stop assumes the solve starts AT the rhs residual.
4. ``run_sweep_multihost`` forwards solver/precondition to the structured
   recording branch (an explicit solver was silently dropped) and raises
   on num_steps for unstructured sweeps (silently returned full-transient
   traces).
5. ``run2d --z-shards`` on an unstructured mesh raises instead of silently
   running unsharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.sim.bc import HeatingCurve
from heatflow_tpu.sim.problem import build_problem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg


@pytest.fixture()
def tiny_problem(tmp_path):
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(str(heat_csv)), cfg,
                            watcher_points=coupler_watcher_points(cfg))
    return cfg, problem


# ---------------------------------------------------------------- 1.

def test_pcg_solve_primal_unchanged_by_projection_seed():
    """The rhs/b projection coefficient is exactly 1 for the primal call,
    so pcg_solve's forward result is bitwise the direct pcg solve from the
    same warm start."""
    from heatflow_tpu.ops.cg import pcg, pcg_solve
    rng = np.random.default_rng(0)
    n = 24
    d = jnp.asarray(rng.uniform(1.0, 3.0, n))
    b = jnp.asarray(rng.normal(size=n))
    x0 = jnp.asarray(rng.normal(size=n))
    apply_op = lambda v: d * v
    for wrt in ("b", "r0"):
        direct = pcg(apply_op, b, x0, rtol=1e-3, maxiter=50,
                     rtol_wrt=wrt).x
        solved = pcg_solve(apply_op, b, x0, rtol=1e-3, maxiter=50,
                           rtol_wrt=wrt)
        np.testing.assert_array_equal(np.asarray(direct),
                                      np.asarray(solved))


def test_pcg_solve_grad_correct_with_scale_mismatched_warm_start():
    """Adjoint solves under rtol_wrt='r0' with a solution-scale warm start:
    the stop reference must be the tangent rhs scale, not ||A·x0||.
    Pre-fix, the adjoint solve on this problem stops ~1e20x early and the
    gradient is solution-scale garbage."""
    from heatflow_tpu.ops.cg import pcg_solve
    n = 16
    w = jnp.linspace(1.0, 3.0, n)
    b = jnp.full((n,), 1e8)
    d0 = 2.0
    x0 = b / (d0 * w)                      # exact solution as warm start

    def loss(d):
        x = pcg_solve(lambda v: d * w * v, b, x0, rtol=1e-4, maxiter=400,
                      rtol_wrt="r0")
        return jnp.sum(x) / 1e8

    g = float(jax.grad(loss)(jnp.asarray(d0, jnp.float64)))
    analytic = float(-jnp.sum(1.0 / (d0 * d0 * w)))
    assert abs(g - analytic) / abs(analytic) < 1e-2, (g, analytic)


# ---------------------------------------------------------------- 2.

def test_unstructured_differentiable_branch_threads_rtol_wrt(tmp_path,
                                                             monkeypatch):
    from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
    from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                               make_simulate_fn_unstructured)
    import heatflow_tpu.ops.cg as cg_mod

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 2
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.2, seed=3)
    problem = build_problem_unstructured(
        umesh, HeatingCurve.from_csv(str(heat_csv)), cfg,
        watcher_points=coupler_watcher_points(cfg))

    seen = []
    real = cg_mod.pcg_solve

    def spy(*args, **kw):
        seen.append(kw.get("rtol_wrt", "b"))
        return real(*args, **kw)

    monkeypatch.setattr(cg_mod, "pcg_solve", spy)
    fn = make_simulate_fn_unstructured(
        problem, dtype=jnp.float64, rtol=1e-8, maxiter=4101,
        record_gradient=False, differentiable=True, rtol_wrt="r0")
    out = fn()
    assert np.isfinite(np.asarray(out["watch"])).all()
    assert seen and all(w == "r0" for w in seen)


# ---------------------------------------------------------------- 3.

def test_refine_inner_seed_zeroes_degenerate_passes():
    from heatflow_tpu.ops.cg import refine_inner_scale, refine_inner_seed
    seed = jnp.ones((4, 5))
    # scalar rtol_eff (stepper path)
    rn2 = jnp.asarray(1e-40)
    floor2 = jnp.asarray(1e-30)
    _, rtol_eff = refine_inner_scale(rn2, floor2, 1e-4, jnp.float32)
    assert float(rtol_eff) == 2.0
    np.testing.assert_array_equal(np.asarray(
        refine_inner_seed(seed, rtol_eff)), 0.0)
    _, rtol_live = refine_inner_scale(jnp.asarray(1.0), floor2, 1e-4,
                                      jnp.float32)
    np.testing.assert_array_equal(np.asarray(
        refine_inner_seed(seed, rtol_live)), np.asarray(seed))
    # batched rtol_eff (one lane degenerate, one live)
    seeds = jnp.ones((2, 4, 5))
    _, rtol_b = refine_inner_scale(jnp.asarray([1e-40, 1.0]),
                                   jnp.asarray([1e-30, 1e-30]), 1e-4,
                                   jnp.float32)
    gated = np.asarray(refine_inner_seed(seeds, rtol_b))
    np.testing.assert_array_equal(gated[0], 0.0)
    np.testing.assert_array_equal(gated[1], 1.0)


def test_refined_carry_seed_stops_on_forced_degenerate_pass(tiny_problem,
                                                            monkeypatch):
    """Wiring smoke: with every pass forced degenerate (rtol_eff=2), the
    carried-seed refined stepper stops each inner solve at its first
    residual check (zeroed seed ⇒ ||r0|| = ||b|| ≤ 2·||b||). The seed
    gating itself is pinned by test_refine_inner_seed_zeroes_degenerate_
    passes — here the carries are zero-initialized, so this asserts the
    carry path composes with the guard end-to-end."""
    import heatflow_tpu.ops.cg as cg_mod
    from heatflow_tpu.sim.stepper import make_simulate_fn
    _cfg, problem = tiny_problem
    if not jax.config.jax_enable_x64:
        pytest.skip("needs x64")

    # the refined solve (ops.cg.refined_solve) takes its guard from ops.cg
    monkeypatch.setattr(cg_mod, "refine_inner_scale",
                        lambda rn2, floor2, rtol, dtype:
                        (jnp.ones_like(rn2), jnp.asarray(2.0, dtype)))
    fn = make_simulate_fn(problem, dtype=jnp.float32, f64_refine=2,
                          rtol=1e-4, maxiter=4102, inner_seed="carry",
                          record_gradient=False)
    ys = fn()
    # every inner solve stops at the first check: 0 iterations per pass
    assert int(np.asarray(ys["cg_iters"]).max()) == 0


# ---------------------------------------------------------------- 4.

def test_multihost_recording_branch_forwards_solver(tiny_problem,
                                                    monkeypatch):
    import heatflow_tpu.sim.sweepkernel as sk
    from heatflow_tpu.parallel.multihost import run_sweep_multihost
    _cfg, problem = tiny_problem

    seen = {}
    real = sk.make_sweep_fn_recording

    def spy(p, **kw):
        seen.update(kw)
        return real(p, **kw)

    monkeypatch.setattr(sk, "make_sweep_fn_recording", spy)
    out = run_sweep_multihost(problem, np.array([3.0]), np.array([4e-6]),
                              dtype=jnp.float64, rtol=1e-8,
                              record_gradient=True, solver="xla",
                              precondition="jacobi")
    assert seen.get("solver") == "xla"
    assert seen.get("precondition") == "jacobi"
    assert np.isfinite(out["watch"]).all()
    assert np.isfinite(out["band"]).all() and np.isfinite(out["axis"]).all()


def test_multihost_unstructured_num_steps_xla_raises(tmp_path):
    from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
    from heatflow_tpu.parallel.multihost import run_sweep_multihost
    from heatflow_tpu.sim.unstructured import build_problem_unstructured

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 4
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.2, seed=5)
    problem = build_problem_unstructured(
        umesh, HeatingCurve.from_csv(str(heat_csv)), cfg,
        watcher_points=coupler_watcher_points(cfg))
    with pytest.raises(ValueError, match="num_steps"):
        run_sweep_multihost(problem, np.array([3.0]), np.array([4e-6]),
                            dtype=jnp.float64, num_steps=2, solver="xla")


# ---------------------------------------------------------------- 5.

def test_run2d_z_shards_unstructured_raises(tmp_path):
    from heatflow_tpu.drivers.run2d import run_simulation
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 2
    with pytest.raises(ValueError, match="z-shards"):
        run_simulation(cfg, str(tmp_path / "meshes"), rebuild_mesh=True,
                       output_folder=str(tmp_path / "out"),
                       mesh_style="unstructured", z_shards=2,
                       suppress_print=True)
