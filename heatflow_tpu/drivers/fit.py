"""Gradient-based experimental fitting — the capability the reference
approximates with brute-force grid sweeps (ref sweep_test.py, the 51-point κ
scan minimizing o-side RMSE).

Because the whole transient solve is differentiable (implicit-diff CG,
ops/cg.pcg_solve), the normalized o-side RMSE objective has exact gradients
with respect to (κ_sample, FWHM). Strategy:

  1. coarse *vmapped* sweep over the search box (global view, one jitted
     batch);
  2. Adam refinement in log-parameter space from the best starts, each step
     costing two transient solves (forward + adjoint) — all starts advance
     in parallel under vmap.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import optax

from heatflow_tpu.sim.problem import Problem2D
from heatflow_tpu.sim.sweepkernel import (make_sweep_fn,
                                          normalized_oside_residuals,
                                          normalized_oside_rmse)
from heatflow_tpu.utils import resolve_solver


@dataclass
class FitResult:
    k: float
    fwhm: float
    rmse: float
    history: list = field(default_factory=list)
    sweep_k: np.ndarray | None = None
    sweep_fwhm: np.ndarray | None = None
    sweep_rmse: np.ndarray | None = None
    k_stderr: float | None = None
    fwhm_stderr: float | None = None
    corr: float | None = None


def fit_uncertainty(objective, k: float, fwhm: float, *, dtype=jnp.float64):
    """Gauss–Newton (Laplace) standard errors at a fitted optimum.

    The residual Jacobian J = ∂r/∂(κ, FWHM) is exact — two tangent solves
    through the implicit-diff CG (jax.jacfwd over pcg_solve) — and the
    parameter covariance is σ² (JᵀJ)⁻¹ with σ² = RSS/(N−2), the standard
    nonlinear-least-squares error model (what scipy.curve_fit reports; the
    reference's grid scans provide no uncertainties at all). Returns
    (k_stderr, fwhm_stderr, correlation)."""
    theta = jnp.asarray([k, fwhm], dtype)
    res_fn = lambda th: objective.residuals(th[0], th[1])

    # jit the value+Jacobian pair (untraced jacfwd re-runs the full
    # transient eagerly per tangent); linearize shares ONE primal
    # transient between the residual value and both tangent solves
    # (res_fn + jacfwd would run it twice unless XLA happens to CSE the
    # duplicated scan)
    @jax.jit
    def rJ_fn(th):
        r, jvp = jax.linearize(res_fn, th)
        J = jax.vmap(jvp)(jnp.eye(2, dtype=dtype))      # (2, N) rows
        return r, J.T

    r_dev, J_dev = rJ_fn(theta)
    r, J = np.asarray(r_dev), np.asarray(J_dev)        # (N,), (N, 2)
    n, p = len(r), 2
    sigma2 = float(r @ r) / max(1, n - p)
    # pinv: a singular JtJ (parameter pinned at a box bound, insensitive
    # FWHM) must degrade to large/zero stderrs, not discard the whole fit
    cov = sigma2 * np.linalg.pinv(J.T @ J)
    se = np.sqrt(np.maximum(np.diag(cov), 0.0))
    corr = float(cov[0, 1] / (se[0] * se[1])) if se.all() else 0.0
    return float(se[0]), float(se[1]), corr


def resolve_fit_solver(dtype, rtol, rtol_wrt, solver, precondition):
    """Resolve the fit's solver stack to CONVERGING, fast defaults per
    dtype — the same convention run2d/sweep use (an unresolved f32 fit at
    the f64 rtol grinds every CG solve to maxiter: the rtol sits below the
    f32 residual floor).

    f64: rtol 1e-10 wrt ‖b‖ — the exact-parity regime.
    f32: rtol 1e-5 wrt the warm-start residual (increment-relative — the
    only stopping rule that converges at f32 on DAC operators). 1e-5,
    tighter than run2d's 1e-4 trace default, because the OBJECTIVE
    inherits the solve error: the normalized-RMSE floor is ~7e-3 at
    rtol 1e-4 vs ~1e-4 at 1e-5 — the former is the scale of real
    experimental fit minima (~0.007), the latter comfortably below it.

    Solver/preconditioner: the XLA engine with Jacobi scaling by default;
    an explicit ``precondition`` wins. Returns
    (rtol, rtol_wrt, solver, precondition)."""
    f64 = jnp.dtype(dtype) == jnp.float64
    if rtol is None:
        rtol = 1e-10 if f64 else 1e-5
    if rtol_wrt is None:
        rtol_wrt = "b" if f64 else "r0"
    solver = resolve_solver("auto" if solver is None else solver)
    if precondition is None:
        precondition = "jacobi"
    return rtol, rtol_wrt, solver, precondition


def experimental_objective(problem, *, dtype=jnp.float64,
                           rtol: float | None = None, maxiter: int = 20000,
                           vary_material: str = "p_sample",
                           rtol_wrt: str | None = None,
                           solver: str = "auto",
                           precondition: str | None = None):
    """Return objective(k, fwhm) -> normalized o-side RMSE vs the problem's
    heating-curve 'oside' trace (the reference's fit metric,
    ref no_diamond.py:65-99). Accepts Problem2D (stencil path) or
    ProblemUnstructured (overlay/ELL path, implicit-diff solves).

    ``rtol``/``rtol_wrt``/``solver``/``precondition`` default per dtype via
    :func:`resolve_fit_solver` — f32 resolves to converging
    increment-relative stopping, f64 to the exact-parity regime;
    ``precondition='rline'|'adi'|'zline'|'mg'`` selects the XLA engine's
    other preconditioners (structured problems)."""
    rtol, rtol_wrt, solver, precondition = resolve_fit_solver(
        dtype, rtol, rtol_wrt, solver, precondition)
    heating = problem.heating
    if heating.oside is None:
        raise ValueError("heating curve lacks an 'oside' column to fit")
    ic = problem.ic_temp
    shifted = heating.oside - heating.oside[0] + ic
    exp_normed = (shifted - shifted[0]) / (heating.temp.max()
                                           - heating.temp.min())
    exp_t = jnp.asarray(heating.time, dtype)
    exp_o = jnp.asarray(exp_normed, dtype)

    from heatflow_tpu.sim.unstructured import ProblemUnstructured
    if isinstance(problem, ProblemUnstructured):
        from heatflow_tpu.sim.unstructured import (
            make_simulate_fn_unstructured, make_sweep_fn_unstructured)
        # unstructured problems precondition with Jacobi scaling only
        # (check_unstructured_precondition); the refinement runs the
        # implicit-diff pcg_solve branch
        from heatflow_tpu.sim.unstructured import \
            check_unstructured_precondition
        check_unstructured_precondition(precondition)
        fnb = make_sweep_fn_unstructured(
            problem, dtype=dtype, rtol=rtol, maxiter=maxiter,
            vary_material=vary_material, rtol_wrt=rtol_wrt)
        fn1 = make_simulate_fn_unstructured(problem, dtype=dtype, rtol=rtol,
                                            maxiter=maxiter,
                                            record_gradient=False,
                                            differentiable=True,
                                            rtol_wrt=rtol_wrt)
        times = jnp.asarray(fnb.times, dtype)
        tag_order = sorted(problem.mesh.material_tags.items(),
                           key=lambda kv: kv[1])
        m_idx = [nm for nm, _ in tag_order].index(vary_material)
        base_k = jnp.asarray(problem.kappas, dtype)

        def objective(k, fwhm):
            kp = base_k.at[m_idx].set(k)
            tr = fn1(kappas=kp, fwhm=fwhm)["watch"]
            return normalized_oside_rmse(times, tr, exp_t, exp_o)

        def residuals(k, fwhm):
            kp = base_k.at[m_idx].set(k)
            tr = fn1(kappas=kp, fwhm=fwhm)["watch"]
            return normalized_oside_residuals(times, tr, exp_t, exp_o)

        objective.batch = lambda ks, fs: normalized_oside_rmse(
            times, fnb(ks, fs), exp_t, exp_o)
        objective.residuals = residuals
        return objective

    warm = "extrapolate" if jnp.dtype(dtype) == jnp.float32 else "previous"
    # one sweep maker serves the coarse batch and, through its
    # differentiable ``one_config``, the gradient solves
    fn = make_sweep_fn(problem, dtype=dtype, rtol=rtol, maxiter=maxiter,
                       rtol_wrt=rtol_wrt, solver=solver,
                       precondition=precondition, warm_start=warm)
    times = jnp.asarray(fn.times, dtype)

    def objective(k, fwhm):
        tr = fn.one_config(k, fwhm)
        return normalized_oside_rmse(times, tr, exp_t, exp_o)

    objective.batch = lambda ks, fs: normalized_oside_rmse(
        times, fn(ks, fs), exp_t, exp_o)
    objective.residuals = lambda k, fwhm: normalized_oside_residuals(
        times, fn.one_config(k, fwhm), exp_t, exp_o)
    return objective


def fit_parameters(problem, *, k_range=(1.0, 100.0),
                   fwhm_range=(1e-6, 1e-4), coarse=(8, 6), n_starts: int = 3,
                   adam_steps: int = 60, lr: float = 0.05,
                   dtype=jnp.float64, rtol: float | None = None,
                   verbose: bool = False,
                   coarse_chunk: int = 8,
                   uncertainty: bool = True,
                   rtol_wrt: str | None = None, solver: str = "auto",
                   precondition: str | None = None,
                   maxiter: int = 20000) -> FitResult:
    """Coarse sweep + parallel Adam refinement in log space.

    Solver settings default per dtype via :func:`resolve_fit_solver` —
    passing ``dtype=float32`` alone gives converging increment-relative
    stopping, not the f64 rtol that f32 CG can never reach.

    The coarse sweep runs in chunks of ``coarse_chunk`` configs (one
    compiled batch shape) and each Adam step is one device call."""
    obj = experimental_objective(problem, dtype=dtype, rtol=rtol,
                                 rtol_wrt=rtol_wrt, solver=solver,
                                 precondition=precondition, maxiter=maxiter)

    import time as _time
    t_start = _time.time()
    ks = np.logspace(np.log10(k_range[0]), np.log10(k_range[1]), coarse[0])
    fs = np.logspace(np.log10(fwhm_range[0]), np.log10(fwhm_range[1]),
                     coarse[1])
    KK, FF = np.meshgrid(ks, fs, indexing="ij")
    flat_k, flat_f = KK.ravel(), FF.ravel()
    from heatflow_tpu.utils import pad_to_multiple
    n_pts = len(flat_k)
    pk = pad_to_multiple(flat_k, coarse_chunk)  # one compiled chunk shape
    pf = pad_to_multiple(flat_f, coarse_chunk)
    pieces = []
    for sidx in range(0, len(pk), coarse_chunk):
        r = obj.batch(jnp.asarray(pk[sidx:sidx + coarse_chunk]),
                      jnp.asarray(pf[sidx:sidx + coarse_chunk]))
        pieces.append(np.asarray(r))
    sweep_rmse = np.concatenate(pieces)[:n_pts]
    order = np.argsort(np.where(np.isfinite(sweep_rmse), sweep_rmse, np.inf))
    starts = order[:n_starts]
    t_coarse = _time.time() - t_start
    if verbose:
        print(f"coarse sweep best: rmse={sweep_rmse[starts[0]]:.5f} at "
              f"k={flat_k[starts[0]]:.3f}, fwhm={flat_f[starts[0]]:.3e} "
              f"({t_coarse:.1f}s)")

    log_k0 = jnp.log(jnp.asarray(flat_k[starts], dtype))
    log_f0 = jnp.log(jnp.asarray(flat_f[starts], dtype))

    lo_k, hi_k = np.log(k_range[0]), np.log(k_range[1])
    lo_f, hi_f = np.log(fwhm_range[0]), np.log(fwhm_range[1])

    def loss(params):
        lk = jnp.clip(params[0], lo_k, hi_k)
        lf = jnp.clip(params[1], lo_f, hi_f)
        return obj(jnp.exp(lk), jnp.exp(lf))

    opt = optax.adam(lr)
    grad_fn = jax.value_and_grad(loss)

    @jax.jit
    def adam_step(params, state):
        """One Adam step for all starts (vmapped) — ONE bounded device call
        per optimization step instead of one giant scanned call."""
        def one(p, s):
            v, g = grad_fn(p)
            updates, s = opt.update(g, s)
            return optax.apply_updates(p, updates), s, v
        return jax.vmap(one)(params, state)

    params = jnp.stack([log_k0, log_f0], axis=1)  # (n_starts, 2)
    state = jax.vmap(opt.init)(params)
    best_p = np.asarray(params)
    best_v = np.full(n_starts, np.inf)
    hist = []
    # one extra adam_step evaluates the final iterate (its v is loss(params)
    # BEFORE the update) without compiling a second program
    for _step in range(adam_steps + 1):
        new_params, state, v = adam_step(params, state)
        v = np.asarray(v)
        hist.append(v)
        better = v < best_v
        best_p = np.where(better[:, None], np.asarray(params), best_p)
        best_v = np.where(better, v, best_v)
        params = new_params
    hist = np.stack(hist, axis=1)
    if verbose:
        print(f"adam refinement: {adam_steps + 1} steps in "
              f"{_time.time() - t_start - t_coarse:.1f}s")
    i = int(np.argmin(best_v))
    k_best = float(np.exp(np.clip(best_p[i, 0], lo_k, hi_k)))
    f_best = float(np.exp(np.clip(best_p[i, 1], lo_f, hi_f)))
    k_se = f_se = corr = None
    if uncertainty:
        k_se, f_se, corr = fit_uncertainty(obj, k_best, f_best, dtype=dtype)
        if verbose:
            print(f"uncertainty (Gauss-Newton): k ± {k_se:.4f}, "
                  f"FWHM ± {f_se:.3e}, corr {corr:+.3f}")
    return FitResult(k=k_best, fwhm=f_best, rmse=float(best_v[i]),
                     history=np.asarray(hist).tolist(),
                     sweep_k=flat_k, sweep_fwhm=flat_f,
                     sweep_rmse=sweep_rmse,
                     k_stderr=k_se, fwhm_stderr=f_se, corr=corr)


def main(argv=None):
    from heatflow_tpu.config import load_config
    from heatflow_tpu.drivers.run2d import _prepare_mesh, default_dtype
    from heatflow_tpu.geometry import coupler_watcher_points
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem

    p = argparse.ArgumentParser(
        description="Gradient-based (k, FWHM) experimental fit")
    p.add_argument("--config", required=True)
    p.add_argument("--mesh-folder", required=True)
    p.add_argument("--rebuild-mesh", action="store_true")
    p.add_argument("--k-range", type=float, nargs=2, default=[1.0, 100.0])
    p.add_argument("--fwhm-range", type=float, nargs=2,
                   default=[1e-6, 1e-4])
    p.add_argument("--adam-steps", type=int, default=60)
    p.add_argument("--rtol", type=float, default=None,
                   help="CG tolerance (default: per-dtype converging "
                        "setting — 1e-10 wrt b at f64, 1e-5 wrt r0 at f32)")
    p.add_argument("--solver", default="auto", choices=["auto", "xla"],
                   help="'auto' and 'xla' both name the XLA engine (kept "
                        "for command-line compatibility)")
    p.add_argument("--precondition", default=None,
                   choices=["jacobi", "rline", "adi", "mg"],
                   help="CG preconditioner (default: jacobi)")
    args = p.parse_args(argv)
    from heatflow_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    cfg = load_config(args.config)
    mesh = _prepare_mesh(cfg, args.mesh_folder, args.rebuild_mesh, "auto")
    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    from heatflow_tpu.mesh.msh_io import UnstructuredMesh
    if isinstance(mesh, UnstructuredMesh):
        from heatflow_tpu.sim.unstructured import build_problem_unstructured
        problem = build_problem_unstructured(
            mesh, heating, cfg, watcher_points=coupler_watcher_points(cfg))
    else:
        problem = build_problem(mesh, heating, cfg,
                                watcher_points=coupler_watcher_points(cfg))
    res = fit_parameters(problem, k_range=tuple(args.k_range),
                         fwhm_range=tuple(args.fwhm_range),
                         adam_steps=args.adam_steps, dtype=default_dtype(),
                         rtol=args.rtol, solver=args.solver,
                         precondition=args.precondition, verbose=True)
    print(f"BEST FIT: k = {res.k:.4f} W/m/K, FWHM = {res.fwhm:.4e} m, "
          f"o-side RMSE = {res.rmse:.6f}")
    if res.k_stderr is not None:
        print(f"          k = {res.k:.4f} ± {res.k_stderr:.4f} W/m/K, "
              f"FWHM = {res.fwhm:.4e} ± {res.fwhm_stderr:.3e} m "
              f"(1σ Gauss-Newton, corr {res.corr:+.3f})")


if __name__ == "__main__":
    main()
