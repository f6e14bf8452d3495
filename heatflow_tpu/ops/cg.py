"""Preconditioned conjugate-gradient solvers.

The accelerator-side replacement for PETSc KSP(PREONLY)+LU(MUMPS)
(ref: run_no_diamond.py:339-344): instead of a factor-once direct solve, each
backward-Euler step is an iterative solve against the matrix-free stencil
operator. Everything is jit-compatible (lax.while_loop / lax.scan) and
vmappable — under vmap the while_loop runs until every batch lane converges,
and pcg's body EXPLICITLY freezes converged lanes (JAX's batching rule keeps
the loop going but does NOT mask body updates; an unfrozen lane iterated
past convergence destabilizes in f32 — measured, see the body comment).

Dirichlet rows are handled with a free-dof mask: the operator is applied to
the full field but residuals/updates are restricted to free dofs, which keeps
the restricted operator SPD (equivalent to the reference's lifted-RHS
row/column elimination, ref space_and_forms.py:166-178).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray        # iterations performed
    residual: jnp.ndarray     # final ||r||
    converged: jnp.ndarray    # bool


def jacobi_preconditioner(diag: jnp.ndarray, mask: jnp.ndarray | None = None
                          ) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """M⁻¹ = 1/diag(A) on free dofs (diag entries of constrained dofs are
    irrelevant; guard against zeros)."""
    safe = jnp.where(diag != 0, diag, 1.0)
    inv = 1.0 / safe
    if mask is not None:
        inv = inv * mask
    return lambda r: inv * r


def _dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, dtype=a.dtype)


def refine_inner_scale(rn2, floor2, rtol, dtype):
    """Shared guard for the f64-residual refinement passes
    (:func:`refined_solve`): given the squared f64
    residual norm(s) ``rn2`` and the degenerate-rhs floor ``floor2``,
    return ``(rnorm, rtol_eff)`` for the f32 inner correction solve.

    The inner rhs must be normalized to unit norm (divide by ``rnorm``,
    rescale the update by it): residual scales far below 1 put the f32
    stopping target rtol²·‖b‖² into underflow, where the inner CG grinds
    on denormal noise to maxiter and then poisons — measured on the
    coarse dryrun problem. CG is scale-invariant, so the rescale is
    exact. A lane at/below the floor gets ``rtol_eff=2`` — it stops at
    its first residual check (nothing left to correct at f64 roundoff
    relative to the step's rhs)."""
    degen = rn2 <= floor2
    rnorm = jnp.sqrt(jnp.where(degen, 1.0, rn2))
    rtol_eff = jnp.where(degen, 2.0, rtol).astype(dtype)
    return rnorm, rtol_eff


def refine_inner_seed(seed, rtol_eff):
    """Zero a carried inner-CG seed on degenerate refinement passes.

    The degenerate stop from :func:`refine_inner_scale` (``rtol_eff=2``)
    only fires when the inner solve STARTS at the rhs residual — i.e. from
    a zero seed, where ``||r0|| = ||b|| <= 2·||b||`` at the first check. A
    carried nonzero seed (``inner_seed='carry'``) puts ``||r0|| ≈ ||A·seed||``
    far above the target, so the solve would grind the unnormalized
    f64-roundoff-scale rhs (the exact denormal regime the guard exists to
    avoid) to maxiter. Gate the seed on the live mask instead."""
    live = (rtol_eff < 1.0).astype(seed.dtype)
    return seed * jnp.reshape(live, live.shape + (1,) * (seed.ndim
                                                         - live.ndim))


def pcg(apply_op: Callable[[jnp.ndarray], jnp.ndarray],
        b: jnp.ndarray,
        x0: jnp.ndarray,
        *,
        precond: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
        mask: jnp.ndarray | None = None,
        rtol: float = 1e-10,
        atol: float = 0.0,
        maxiter: int = 2000,
        rtol_wrt: str = "b") -> CGResult:
    """Solve A x = b with preconditioned CG restricted to ``mask`` dofs.

    ``x0`` provides both the initial guess and the values of constrained dofs
    (they are preserved exactly in the output).

    rtol_wrt: 'b' stops at ||r|| <= rtol ||b||; 'r0' stops at
    ||r|| <= rtol ||r0||. With warm starts 'r0' ties the tolerance to the
    *increment* scale — essential for time stepping, where late-time
    increments are orders of magnitude smaller than the solution itself.
    """
    one = jnp.ones((), dtype=b.dtype)
    msk = one if mask is None else mask.astype(b.dtype)
    pre = precond if precond is not None else (lambda r: r)

    bm = b * msk
    r0 = (bm - apply_op(x0) * msk) * msk
    z0 = pre(r0) * msk
    rz0 = _dot(r0, z0)
    rr0 = _dot(r0, r0)
    ref2 = rr0 if rtol_wrt == "r0" else _dot(bm, bm)
    stop2 = jnp.maximum(rtol * rtol * ref2, jnp.asarray(atol * atol, b.dtype))

    def cond(state):
        _x, _r, _z, _p, _rz, rr2, k = state
        return jnp.logical_and(k < maxiter, rr2 > stop2)

    def body(state):
        x, r, z, p, rz, rr2, k = state
        # Explicit per-lane freeze: under vmap, while_loop runs the body
        # until EVERY lane's cond clears — without this gate, converged
        # lanes keep iterating, and f32 CG driven past convergence goes
        # unstable (measured: a lane converging in 42 iterations alone
        # diverged to NaN after ~700 joint iterations in a batch).
        active = rr2 > stop2
        Ap = apply_op(p) * msk
        pAp = _dot(p, Ap)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = pre(r_n) * msk
        rz_n = _dot(r_n, z_n)
        beta = rz_n / jnp.where(rz != 0, rz, 1.0)
        p_n = z_n + beta * p
        rr2_n = _dot(r_n, r_n)
        sel = lambda new, old: jnp.where(active, new, old)
        return (sel(x_n, x), sel(r_n, r), sel(z_n, z), sel(p_n, p),
                sel(rz_n, rz), sel(rr2_n, rr2), k + active.astype(jnp.int32))

    state = (x0, r0, z0, z0, rz0, rr0, jnp.zeros((), jnp.int32))
    x, r, _z, _p, _rz, _rr2, k = jax.lax.while_loop(cond, body, state)
    rnorm = jnp.sqrt(_dot(r, r))
    # A non-finite residual (NaN parameters, overflow mid-solve) makes the
    # while_loop cond false on its FIRST check, silently returning the
    # finite seed as if converged. Poison the solution instead so failures
    # propagate to the caller's finiteness masking (the sweep engine's
    # failed_runs.csv, ref parameter_sweep.py:447-509's failure records).
    x = jnp.where(jnp.isfinite(rnorm), x, jnp.nan)
    return CGResult(x=x, iters=k, residual=rnorm,
                    converged=_dot(r, r) <= stop2)


def pcg_solve(apply_op, b, x0, *, precond=None, mask=None, rtol=1e-10,
              atol=0.0, maxiter=2000, rtol_wrt: str = "b") -> jnp.ndarray:
    """Differentiable PCG solve via implicit differentiation.

    Wraps :func:`pcg` in ``lax.custom_linear_solve(symmetric=True)`` so
    reverse-mode gradients cost one additional CG solve (adjoint system)
    instead of unrolling the iteration — the enabler for gradient-based
    experimental fitting (∂trace/∂κ, ∂RMSE/∂FWHM).

    Constrained dofs must carry zeros in both ``b`` and ``x0`` so the masked
    operator is consistent on the full space.

    ``solve_fn`` below is reused by ``custom_linear_solve`` for the
    tangent/adjoint systems, whose rhs is derivative-scale — reusing the
    solution-scale ``x0`` there would (a) waste iterations burning down a
    huge initial residual and (b) under ``rtol_wrt='r0'`` set the stop
    target to ``rtol·||rhs − A·x0|| ≈ rtol·||A·x0||``, orders of magnitude
    above the tangent rhs, stopping those solves immediately and corrupting
    gradients. The seed is therefore scaled by the rhs/b projection
    coefficient ⟨rhs, b⟩/⟨b, b⟩: exactly 1 for the primal call (rhs ≡ b —
    the primal path is bit-identical to seeding with x0), ≈0 for
    derivative calls, which then start near zero with an rhs-scale stop
    reference in both ``rtol_wrt`` modes.
    """
    bb = _dot(b, b)
    bb_safe = jnp.where(bb > 0, bb, 1.0)

    def solve_fn(mv, rhs):
        c = _dot(rhs, b) / bb_safe
        return pcg(mv, rhs, c * x0, precond=precond, mask=mask, rtol=rtol,
                   atol=atol, maxiter=maxiter, rtol_wrt=rtol_wrt).x

    op = (lambda v: apply_op(v) * mask) if mask is not None else apply_op
    return jax.lax.custom_linear_solve(op, b, solve_fn, symmetric=True)


def pcg_fixed(apply_op, b, x0, *, precond=None, mask=None, iters: int = 50
              ) -> CGResult:
    """Fixed-iteration PCG (no convergence test) — fully static control flow
    for benchmarking and for maximum-throughput vmapped sweeps where the
    iteration count is chosen a priori."""
    one = jnp.ones((), dtype=b.dtype)
    msk = one if mask is None else mask.astype(b.dtype)
    pre = precond if precond is not None else (lambda r: r)

    bm = b * msk
    r0 = (bm - apply_op(x0) * msk) * msk
    z0 = pre(r0) * msk
    rz0 = _dot(r0, z0)

    def body(state, _):
        x, r, z, p, rz = state
        Ap = apply_op(p) * msk
        pAp = _dot(p, Ap)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r) * msk
        rz_new = _dot(r, z)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        p = z + beta * p
        return (x, r, z, p, rz_new), None

    (x, r, *_rest), _ = jax.lax.scan(body, (x0, r0, z0, z0, rz0), None,
                                     length=iters)
    rnorm = jnp.sqrt(_dot(r, r))
    return CGResult(x=x, iters=jnp.asarray(iters, jnp.int32), residual=rnorm,
                    converged=jnp.asarray(True))


def refined_solve(apply_op, apply_op32, b, y0, mask, *, passes: int,
                  rtol, maxiter: int, dtype, precond=None, seeds=None):
    """Mixed-precision iterative refinement of ``apply_op(y) = b`` on the
    ``mask`` dofs: ``passes`` rounds of residual against the f64 operator
    ``apply_op``, f32 correction solve with ``apply_op32`` (+ ``precond``)
    to ``rtol`` wrt its own unit-normalized rhs, update accumulated in
    f64. ``seeds``: optional (passes, ...) inner-CG seeds (the previous
    step's corrections); zero seeds otherwise.

    Returns (y, total inner iterations, (passes, ...) corrections).

    Inner stop floor: once the f64 residual is at f64 roundoff relative to
    the full rhs there is nothing left to correct — and the f32 target
    rtol²·‖r‖² would underflow to denormals, leaving the inner CG grinding
    on noise until maxiter (see :func:`refine_inner_scale`)."""
    mask32 = mask.astype(dtype)
    floor2 = jnp.asarray(1e-30, b.dtype) * _dot(b, b)
    y = y0
    iters = jnp.zeros((), jnp.int32)
    zero = jnp.zeros(b.shape, dtype)
    dys = []
    for i in range(passes):
        r64 = b - mask * apply_op(y)
        rnorm, rtol_eff = refine_inner_scale(_dot(r64, r64), floor2, rtol,
                                             dtype)
        r32 = (r64 / rnorm).astype(dtype)
        seed = zero if seeds is None else refine_inner_seed(seeds[i],
                                                            rtol_eff)
        sol = pcg(apply_op32, r32, seed, precond=precond, mask=mask32,
                  rtol=rtol_eff, maxiter=maxiter, rtol_wrt="b")
        dys.append(sol.x)
        y = y + sol.x.astype(y.dtype) * rnorm
        iters = iters + sol.iters
    return y, iters, jnp.stack(dys)
