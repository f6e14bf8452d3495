"""Line (block-tridiagonal) PCR preconditioner — ops/linesolve.py.

The r-line block-Jacobi preconditioner exploits the DAC operator's
dominant radial coupling (ref context: the reference solves exactly with
MUMPS, run_no_diamond.py:339-344; here the Krylov solver gets the dominant
1D physics exactly instead). These tests pin: PCR solves random SPD
unit-diagonal tridiagonal systems exactly, the extracted line couplings
match a dense construction of the scaled operator, and the preconditioned
CG iteration count on a real problem drops by the measured margin.
"""

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.ops.linesolve import (line_couplings, line_preconditioner,
                                        pcr_apply, pcr_apply_folded,
                                        pcr_factor, pcr_fold)


def _random_spd_tridiag(n, rng, batch=()):
    """Unit-diagonal SPD tridiagonal: sym off-diagonals with |l|+|u| < 1."""
    off = 0.49 * (2 * rng.random(batch + (n - 1,)) - 1)
    u = np.zeros(batch + (n,)); u[..., :-1] = off
    l = np.zeros(batch + (n,)); l[..., 1:] = off
    return l, u


def _dense(l, u):
    n = l.shape[-1]
    T = np.eye(n)
    T += np.diag(u[:-1], 1)
    T += np.diag(l[1:], -1)
    return T


def test_pcr_solves_tridiagonal_exactly():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 64, 253):
        l, u = _random_spd_tridiag(n, rng)
        x_true = rng.standard_normal(n)
        d = _dense(l, u) @ x_true
        levels = pcr_factor(jnp.asarray(l), jnp.asarray(u), axis=-1)
        x = pcr_apply(levels, jnp.asarray(d), axis=-1)
        np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-10,
                                   atol=1e-10)


def test_pcr_fold_matches_raw_apply_and_exact_solve():
    """The folded factorization (2 coupling planes/level + one accumulated
    diagonal — the layout the line preconditioners apply)
    is the same operator as the raw (l, u, inv_a)-per-level form."""
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 7, 64, 253):
        l, u = _random_spd_tridiag(n, rng, batch=(4,))
        X = rng.standard_normal((4, n))
        D = np.stack([_dense(l[i], u[i]) @ X[i] for i in range(4)])
        levels = pcr_factor(jnp.asarray(l), jnp.asarray(u), axis=-1)
        levels2, g = pcr_fold(levels, axis=-1)
        # level count unchanged; one plane fewer per level
        assert len(levels2) == len(levels)
        x_raw = pcr_apply(levels, jnp.asarray(D), axis=-1)
        x_fold = pcr_apply_folded(levels2, g, jnp.asarray(D), axis=-1)
        np.testing.assert_allclose(np.asarray(x_fold), np.asarray(x_raw),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(x_fold), X, rtol=1e-9,
                                   atol=1e-9)
    # axis=-2 twin on one size
    l, u = _random_spd_tridiag(64, rng, batch=(4,))
    X = rng.standard_normal((4, 64))
    D = np.stack([_dense(l[i], u[i]) @ X[i] for i in range(4)])
    levels_t = pcr_factor(jnp.asarray(l.T), jnp.asarray(u.T), axis=-2)
    levels2_t, g_t = pcr_fold(levels_t, axis=-2)
    out_t = pcr_apply_folded(levels2_t, g_t, jnp.asarray(D.T), axis=-2)
    np.testing.assert_allclose(np.asarray(out_t).T, X, rtol=1e-9, atol=1e-9)


def test_pcr_vectorizes_over_rows_and_axis_choice():
    rng = np.random.default_rng(1)
    nz, nr = 5, 33
    l, u = _random_spd_tridiag(nr, rng, batch=(nz,))
    X = rng.standard_normal((nz, nr))
    D = np.stack([_dense(l[i], u[i]) @ X[i] for i in range(nz)])
    levels = pcr_factor(jnp.asarray(l), jnp.asarray(u), axis=-1)
    out = pcr_apply(levels, jnp.asarray(D), axis=-1)
    np.testing.assert_allclose(np.asarray(out), X, rtol=1e-9, atol=1e-9)
    # same systems along axis -2 via transpose
    levels_t = pcr_factor(jnp.asarray(l.T), jnp.asarray(u.T), axis=-2)
    out_t = pcr_apply(levels_t, jnp.asarray(D.T), axis=-2)
    np.testing.assert_allclose(np.asarray(out_t).T, X, rtol=1e-9, atol=1e-9)


def _tiny_problem():
    import sys
    sys.path.insert(0, "tests")
    from fixtures import synthetic_heating, tiny_no_diamond_cfg
    import tempfile, os
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    td = tempfile.mkdtemp()
    heat = os.path.join(td, "heat.csv")
    synthetic_heating(heat)
    cfg = tiny_no_diamond_cfg(coarse=1.0)
    cfg["heating"]["file"] = heat
    cfg["timing"]["num_steps"] = 4
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(heat), cfg,
                            watcher_points=coupler_watcher_points(cfg))
    return problem


def test_line_couplings_match_dense_scaled_operator():
    from heatflow_tpu.ops.stencil import combine_operator
    problem = _tiny_problem()
    dev = problem.device_arrays(jnp.float64)
    A, _ = combine_operator(dev["K"], dev["M"], dev["kappas"],
                            dev["rho_cvs"], jnp.asarray(problem.dt))
    free, dirich = dev["free"], dev["dirichlet"]
    s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free + dirich
    sf = s * free
    l, u = line_couplings(A, sf, -1)
    nz, nr = free.shape
    sfn, An = np.asarray(sf), np.asarray(A)
    # dense check on a few random rows: u[i,j] = sf[i,j] A3[i,j] sf[i,j+1]
    rng = np.random.default_rng(2)
    for _ in range(50):
        i = int(rng.integers(nz)); j = int(rng.integers(nr - 1))
        np.testing.assert_allclose(
            np.asarray(u)[i, j], sfn[i, j] * An[3, i, j] * sfn[i, j + 1],
            rtol=1e-13)
        np.testing.assert_allclose(
            np.asarray(l)[i, j + 1],
            sfn[i, j + 1] * An[4, i, j + 1] * sfn[i, j], rtol=1e-13)
    assert np.asarray(u)[:, -1].max() == 0.0
    assert np.asarray(l)[:, 0].max() == 0.0
    # symmetry of the scaled tridiagonal part: l[i, j+1] == u[i, j]
    np.testing.assert_allclose(np.asarray(l)[:, 1:], np.asarray(u)[:, :-1],
                               rtol=1e-12, atol=1e-15)


def test_rline_preconditioner_cuts_iterations_and_matches_solution():
    from heatflow_tpu.ops.cg import pcg
    from heatflow_tpu.ops.stencil import apply_stencil, combine_operator
    problem = _tiny_problem()
    dev = problem.device_arrays(jnp.float64)
    A, M_op = combine_operator(dev["K"], dev["M"], dev["kappas"],
                               dev["rho_cvs"], jnp.asarray(problem.dt))
    free, dirich = dev["free"], dev["dirichlet"]
    s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free + dirich
    apply_s = lambda y: s * apply_stencil(A, s * y)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(free.shape)) * free
    y0 = jnp.zeros_like(b)

    plain = pcg(apply_s, b, y0, mask=free, rtol=1e-11, maxiter=20000)
    pre = line_preconditioner(A, s, free, axis=-1)
    lined = pcg(apply_s, b, y0, precond=pre, mask=free, rtol=1e-11,
                maxiter=20000)
    assert bool(lined.converged) and bool(plain.converged)
    np.testing.assert_allclose(np.asarray(lined.x), np.asarray(plain.x),
                               rtol=1e-7, atol=1e-9)
    # the whole point: a real iteration cut (measured 6-8x on the flagship;
    # the tiny mesh is milder — require >=2x)
    assert int(lined.iters) * 2 <= int(plain.iters), \
        (int(lined.iters), int(plain.iters))


def test_rline_stepper_matches_jacobi_stepper():
    """Full transient through make_simulate_fn: preconditioning changes the
    Krylov path, not the answer."""
    from heatflow_tpu.sim.stepper import make_simulate_fn
    problem = _tiny_problem()
    ys_j = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                            precondition="jacobi")()
    ys_r = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                            precondition="rline")()
    np.testing.assert_allclose(np.asarray(ys_r["watch"]),
                               np.asarray(ys_j["watch"]),
                               rtol=1e-9, atol=1e-9)
    assert int(np.asarray(ys_r["cg_iters"]).sum()) \
        < int(np.asarray(ys_j["cg_iters"]).sum())


def test_adi_preconditioner_cuts_iterations_and_matches_solution():
    """Split-additive ADI (R + Z − I): same solution, fewer iterations than
    rline alone on cold solves (the steady/tight-tolerance regime it is
    for)."""
    from heatflow_tpu.ops.cg import pcg
    from heatflow_tpu.ops.linesolve import adi_preconditioner
    from heatflow_tpu.ops.stencil import apply_stencil, combine_operator
    problem = _tiny_problem()
    dev = problem.device_arrays(jnp.float64)
    A, _ = combine_operator(dev["K"], dev["M"], dev["kappas"],
                            dev["rho_cvs"], jnp.asarray(problem.dt))
    free, dirich = dev["free"], dev["dirichlet"]
    s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free + dirich
    apply_s = lambda y: s * apply_stencil(A, s * y)
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal(free.shape)) * free
    y0 = jnp.zeros_like(b)

    pre_r = line_preconditioner(A, s, free, axis=-1)
    lined = pcg(apply_s, b, y0, precond=pre_r, mask=free, rtol=1e-11,
                maxiter=20000)
    pre = adi_preconditioner(A, s, free)
    adi = pcg(apply_s, b, y0, precond=pre, mask=free, rtol=1e-11,
              maxiter=20000)
    assert bool(adi.converged) and bool(lined.converged)
    np.testing.assert_allclose(np.asarray(adi.x), np.asarray(lined.x),
                               rtol=1e-7, atol=1e-9)
    assert int(adi.iters) < int(lined.iters), \
        (int(adi.iters), int(lined.iters))


def test_adi_stepper_matches_jacobi_stepper():
    """make_simulate_fn(precondition='adi') (XLA path): same transient."""
    from heatflow_tpu.sim.stepper import make_simulate_fn
    problem = _tiny_problem()
    ys_j = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                            precondition="jacobi")()
    ys_a = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                            precondition="adi")()
    np.testing.assert_allclose(np.asarray(ys_a["watch"]),
                               np.asarray(ys_j["watch"]),
                               rtol=1e-9, atol=1e-9)
    assert int(np.asarray(ys_a["cg_iters"]).sum()) \
        < int(np.asarray(ys_j["cg_iters"]).sum())
