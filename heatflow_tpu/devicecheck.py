"""Numerical checks of the solver stack on the default JAX device.

Each check runs a small problem on whatever device JAX uses by default,
compares it with an independent host reference (numpy / scipy at f64) and
raises ``AssertionError`` when they disagree; it returns the measured
deviation. The tests call them on the CPU and, marked ``gpu``, on a card;
``chip_smoke.py`` calls them on the card in-process. The f64 checks need
``jax_enable_x64``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _require_x64() -> None:
    if not jax.config.jax_enable_x64:
        raise RuntimeError("the f64 device checks need jax_enable_x64=True")


def check_combine_has_no_dot() -> float:
    """The batched material combine compiles to no matrix product on this
    device (a default-precision dot may drop f32 inputs to TF32 or bf16,
    which makes the backward-Euler operator indefinite) and matches the f64
    einsum to f32 rounding. Returns the max relative deviation."""
    from heatflow_tpu.ops.stencil import combine_operator
    rng = np.random.default_rng(0)
    K = rng.standard_normal((5, 7, 24, 40)).astype(np.float32)
    M = np.abs(rng.standard_normal((5, 7, 24, 40))).astype(np.float32)
    kp = np.abs(rng.standard_normal((16, 5))).astype(np.float32)
    rc = np.abs(rng.standard_normal((16, 5))).astype(np.float32)
    dt = np.float32(0.3)
    compiled = jax.jit(combine_operator).lower(K, M, kp, rc, dt).compile()
    hlo = compiled.as_text()
    for marker in ("dot(", "cublas", "gemm"):
        assert marker not in hlo, f"batched combine compiles to {marker!r}"
    A, M_op = compiled(K, M, kp, rc, dt)
    M_ref = np.einsum("bm,mkij->bkij", rc.astype(np.float64), M)
    A_ref = M_ref + float(dt) * np.einsum("bm,mkij->bkij",
                                          kp.astype(np.float64), K)
    dev = max(np.abs(np.asarray(A) - A_ref).max() / np.abs(A_ref).max(),
              np.abs(np.asarray(M_op) - M_ref).max() / np.abs(M_ref).max())
    assert dev < 1e-6, f"batched combine deviates {dev:.2e} from f64"
    return float(dev)


def check_normal_equations_precision() -> float:
    """The split-normal fit's f32 normal equations keep full f32 accuracy
    on this device (no TF32 contraction). Returns the max relative
    deviation from the f64 product."""
    from heatflow_tpu.analysis.splitnormal import normal_equations
    rng = np.random.default_rng(1)
    J = rng.standard_normal((2048, 5)) * np.array([1.0, 1e2, 1e-2, 3.0, 1.0])
    w = (rng.random(2048) > 0.1).astype(np.float64)
    res = rng.standard_normal(2048)
    g, H = normal_equations(*(jnp.asarray(a, jnp.float32)
                              for a in (J, w, res)))
    J32, w32, r32 = (a.astype(np.float32).astype(np.float64)
                     for a in (J, w, res))
    g_ref = J32.T @ r32
    H_ref = (J32 * w32[:, None]).T @ J32
    dev = max(np.abs(np.asarray(g, np.float64) - g_ref).max()
              / np.abs(g_ref).max(),
              np.abs(np.asarray(H, np.float64) - H_ref).max()
              / np.abs(H_ref).max())
    assert dev < 1e-5, f"f32 normal equations deviate {dev:.2e} from f64"
    return float(dev)


def _spd_stencil_system(nz=48, nr=96, seed=2):
    """A diagonally dominant symmetric 7-point stencil operator, a rhs and
    the scipy direct solution of the system (all f64)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from heatflow_tpu.ops.stencil import stencil_to_coo
    rng = np.random.default_rng(seed)
    A = np.full((7, nz, nr), -0.3)
    A[0] = 2.0 + rng.random((nz, nr))
    b = rng.standard_normal((nz, nr))
    rows, cols, vals = stencil_to_coo(A)
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(nz * nr,) * 2).tocsc()
    x_ref = spla.spsolve(mat, b.ravel()).reshape(nz, nr)
    return A, b, x_ref


def check_cg_matches_direct(precondition: str = "adi") -> float:
    """f64 PCG with a PCR line preconditioner on this device reproduces the
    scipy direct solve. Returns the relative max error."""
    _require_x64()
    from heatflow_tpu.ops.cg import pcg
    from heatflow_tpu.ops.linesolve import line_family_preconditioner
    from heatflow_tpu.ops.stencil import apply_stencil
    A_np, b_np, x_ref = _spd_stencil_system()
    A = jnp.asarray(A_np)
    free = jnp.ones(b_np.shape)
    s = jax.lax.rsqrt(A[0])

    @jax.jit
    def solve(b):
        pre = line_family_preconditioner(precondition, A, s, free)
        sol = pcg(lambda y: s * apply_stencil(A, s * y), s * b,
                  jnp.zeros_like(b), precond=pre, mask=free, rtol=1e-13,
                  maxiter=2000)
        return sol.x * s, sol.iters

    x, iters = solve(jnp.asarray(b_np))
    err = np.abs(np.asarray(x) - x_ref).max() / np.abs(x_ref).max()
    assert int(iters) < 2000, "PCG did not converge"
    assert err < 1e-10, f"PCG ({precondition}) deviates {err:.2e}"
    return float(err)


def check_refined_solve_matches_direct() -> float:
    """Mixed-precision refinement (f32 correction solves around f64
    residuals) on this device reaches the f64 direct solution. Returns the
    relative max error."""
    _require_x64()
    from heatflow_tpu.ops.cg import refined_solve
    from heatflow_tpu.ops.linesolve import line_family_preconditioner
    from heatflow_tpu.ops.stencil import apply_stencil
    A_np, b_np, x_ref = _spd_stencil_system(seed=3)
    A = jnp.asarray(A_np)
    free = jnp.ones(b_np.shape)
    s = jax.lax.rsqrt(A[0])
    A32, s32 = A.astype(jnp.float32), s.astype(jnp.float32)

    @jax.jit
    def solve(b):
        pre = line_family_preconditioner("rline", A32, s32,
                                         free.astype(jnp.float32))
        y, _iters, _dys = refined_solve(
            lambda y: s * apply_stencil(A, s * y),
            lambda y: s32 * apply_stencil(A32, s32 * y), s * b,
            jnp.zeros_like(b), free, passes=4, rtol=1e-5, maxiter=2000,
            dtype=jnp.float32, precond=pre)
        return y * s

    x = solve(jnp.asarray(b_np))
    err = np.abs(np.asarray(x) - x_ref).max() / np.abs(x_ref).max()
    assert err < 1e-10, f"refined solve deviates {err:.2e}"
    return float(err)


CHECKS = {
    "combine_has_no_dot": check_combine_has_no_dot,
    "normal_equations_precision": check_normal_equations_precision,
    "cg_matches_direct": check_cg_matches_direct,
    "refined_solve_matches_direct": check_refined_solve_matches_direct,
}
