"""Mixed-precision iterative refinement (make_simulate_fn(f64_refine=N)).

The f32 trace error is the f32 *operator-representation* floor — not
accumulation, not CG truncation. Refinement computes each step's residual
against the f64 operator and solves only the f32 correction system, so the
converged trajectory is the f64 operator's solution at f32 solve cost. These
tests pin the mechanism at small scale on CPU: the refined f32 run must
land orders of magnitude closer to the f64 trajectory than the plain f32
run at the same inner tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as g
from heatflow_tpu.sim.stepper import make_simulate_fn
from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                           make_simulate_fn_unstructured)


@pytest.fixture(scope="module")
def tiny():
    problem, _ = g._tiny_flagship(size_scale=16.0)
    truth = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-13,
                             record_gradient=True)()
    return problem, truth


def _trace_err(ys, truth):
    return float(np.abs(np.asarray(ys["watch"], np.float64)
                        - np.asarray(truth["watch"])).max())


def test_refined_breaks_f32_floor(tiny):
    problem, truth = tiny
    plain = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-5,
                             maxiter=20000, record_gradient=True)()
    refined = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-4,
                               maxiter=20000, record_gradient=True,
                               f64_refine=2)()
    e_plain = _trace_err(plain, truth)
    e_ref = _trace_err(refined, truth)
    assert e_ref < e_plain / 20, (e_ref, e_plain)
    # the state is carried in f64 and the trajectory is the f64 operator's
    assert np.asarray(refined["final_u"]).dtype == np.float64
    assert np.all(np.asarray(refined["cg_iters"]) > 0)
    # gradient artifacts still produced (projection stays f32 — the scaled
    # mass solve is well-conditioned)
    ax = np.asarray(refined["axis"])
    assert np.isfinite(ax).all() and np.abs(ax).max() > 0


def test_refined_more_passes_converge_toward_f64(tiny):
    """Error is monotone (within noise) in the number of passes at loose
    inner tolerance — each pass contracts toward the f64 solution."""
    problem, truth = tiny
    errs = []
    for n in (1, 2, 3):
        ys = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-3,
                              maxiter=20000, record_gradient=False,
                              f64_refine=n)()
        errs.append(_trace_err(ys, truth))
    assert errs[2] < errs[0] / 5, errs


def test_refined_rline_matches_jacobi(tiny):
    """The inner engine is interchangeable: rline-preconditioned inner
    solves land on the same refined trajectory."""
    problem, truth = tiny
    a = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-4,
                         record_gradient=False, f64_refine=2)()
    b = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-4,
                         record_gradient=False, f64_refine=2,
                         precondition="rline")()
    ea, eb = _trace_err(a, truth), _trace_err(b, truth)
    e_plain = _trace_err(
        make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-5,
                         record_gradient=False)(), truth)
    assert ea < e_plain / 5, (ea, e_plain)
    assert eb < e_plain / 5, (eb, e_plain)


def test_refined_carry_inner_seed_matches_zero(tiny):
    """inner_seed='carry' (seed each pass's inner CG with the previous
    step's correction) is a pure iteration-count optimization: stopping is
    wrt the unit-normalized rhs, so the trajectory matches the zero-seed
    one at the inner tolerance and stays refined-accurate vs f64."""
    problem, truth = tiny
    z = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-4,
                         record_gradient=False, f64_refine=2,
                         inner_seed="zero")()
    c = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-4,
                         record_gradient=False, f64_refine=2,
                         inner_seed="carry")()
    ez, ec = _trace_err(z, truth), _trace_err(c, truth)
    assert ec < 5 * max(ez, 1e-10), (ec, ez)
    dz = float(np.abs(np.asarray(z["watch"], np.float64)
                      - np.asarray(c["watch"], np.float64)).max())
    span = float(np.abs(np.asarray(truth["watch"])).max())
    assert dz < 1e-3 * max(span, 1.0), dz
    # the seed must not *increase* the iteration bill
    assert (np.asarray(c["cg_iters"]).mean()
            <= np.asarray(z["cg_iters"]).mean() * 1.05)
    with pytest.raises(ValueError, match="inner_seed"):
        make_simulate_fn(problem, dtype=jnp.float32, f64_refine=1,
                         inner_seed="prev")


def test_refine_validation():
    problem, _ = g._tiny_flagship(size_scale=16.0)
    with pytest.raises(ValueError, match="float32"):
        make_simulate_fn(problem, dtype=jnp.float64, f64_refine=1)
    with pytest.raises(ValueError, match="fixed_iters"):
        make_simulate_fn(problem, dtype=jnp.float32, f64_refine=1,
                         fixed_iters=10)
    with pytest.raises(ValueError, match="jax_enable_x64"):
        prev = jax.config.jax_enable_x64
        try:
            jax.config.update("jax_enable_x64", False)
            make_simulate_fn(problem, dtype=jnp.float32, f64_refine=1)
        finally:
            jax.config.update("jax_enable_x64", prev)


def test_refined_unstructured_matches_f64(tiny_unstructured):
    """Unstructured (overlay) twin: f64_refine lands orders closer to the
    f64 trajectory than plain f32 at the same inner tolerance."""
    problem, truth = tiny_unstructured
    plain = make_simulate_fn_unstructured(
        problem, dtype=jnp.float32, rtol=1e-5, rtol_wrt="r0",
        record_gradient=False)()
    e_plain = _trace_err(plain, truth)
    ys = make_simulate_fn_unstructured(
        problem, dtype=jnp.float32, rtol=1e-4, record_gradient=False,
        f64_refine=2)()
    e_ref = _trace_err(ys, truth)
    assert e_ref < e_plain / 20, (e_ref, e_plain)
    with pytest.raises(ValueError, match="float32"):
        make_simulate_fn_unstructured(problem, dtype=jnp.float64,
                                      f64_refine=1)


@pytest.fixture(scope="module")
def tiny_unstructured():
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 8
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=3)
    df = synthetic_heating()
    heating = HeatingCurve(time=df["time"].to_numpy(),
                           temp=df["temp"].to_numpy())
    problem = build_problem_unstructured(
        umesh, heating, cfg, watcher_points=coupler_watcher_points(cfg))
    truth = make_simulate_fn_unstructured(
        problem, dtype=jnp.float64, rtol=1e-13, record_gradient=False)()
    return problem, truth


def test_refine_inner_scale_guard():
    """The shared inner-scale guard (ops.cg.refine_inner_scale): unit-norm
    scaling for live lanes, rtol_eff=2 for degenerate ones — scalar and
    batched shapes."""
    import jax.numpy as jnp
    from heatflow_tpu.ops.cg import refine_inner_scale
    # scalar (single-problem steppers)
    rnorm, rtol_eff = refine_inner_scale(jnp.asarray(4.0, jnp.float64),
                                         jnp.asarray(1e-30, jnp.float64),
                                         1e-4, jnp.float32)
    assert float(rnorm) == 2.0 and float(rtol_eff) == pytest.approx(1e-4)
    # batched (sweep scan): one live lane, one at the degenerate floor
    rn2 = jnp.asarray([9.0, 1e-40])
    fl2 = jnp.asarray([1e-30, 1e-30])
    rnorm, rtol_eff = refine_inner_scale(rn2, fl2, 1e-4, jnp.float32)
    assert np.allclose(np.asarray(rnorm), [3.0, 1.0])
    assert np.allclose(np.asarray(rtol_eff), [1e-4, 2.0])
