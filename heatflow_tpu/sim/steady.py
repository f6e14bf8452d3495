"""Steady-state heat conduction solve and steady-as-initial-condition.

The reference exposes a steady form (unweighted: κ ∇u·∇v dx = f v dx,
ref space_and_forms.py:119-149) exercised by the with_gasket / with_ir_steady
notebooks, where the steady solution seeds the transient run. Here:

  * solve_steady — Jacobi/MG-preconditioned CG on the per-material unweighted
    stiffness stencils with Dirichlet lifting;
  * an axisymmetric (r-weighted) variant for physical consistency with the
    transient operator, selected by weighted=True.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.ops.cg import pcg
from heatflow_tpu.ops.stencil import apply_stencil
from heatflow_tpu.sim.problem import Problem2D


def solve_steady(problem: Problem2D, bc_values: np.ndarray, *,
                 f=None, weighted: bool = False, dtype=jnp.float64,
                 rtol: float = 1e-11, maxiter: int = 50000,
                 precondition: str = "adi"):
    """Solve Σ_m κ_m K_m u = f with Dirichlet data ``bc_values`` (full-grid
    array; only constrained entries are used). Returns u (Nz, Nr) ndarray.

    ``precondition``: 'adi' (default — steady solves are COLD, the regime
    where the split-additive r-line+z-line composition cuts iterations
    most: 2.3-4.8x fewer iterations than rline on the flagship
    operator), 'rline', 'zline', or 'jacobi'."""
    st = problem.stencils
    Ksrc = st.K if weighted else st.K_flat
    from heatflow_tpu.ops.stencil import material_combine
    K = material_combine(jnp.asarray(problem.kappas, dtype),
                         jnp.asarray(Ksrc, dtype))
    free = jnp.asarray(problem.free_mask, dtype)
    dirich = jnp.asarray(problem.dirichlet_mask, dtype)
    g = jnp.asarray(bc_values, dtype) * dirich

    diag = K[0]
    s = jax.lax.rsqrt(jnp.where(diag > 0, diag, 1.0)) * free + dirich
    apply_s = lambda y: s * apply_stencil(K, s * y)

    if precondition == "adi":
        from heatflow_tpu.ops.linesolve import adi_preconditioner
        pre = adi_preconditioner(K, s, free)
    elif precondition in ("rline", "zline"):
        from heatflow_tpu.ops.linesolve import line_preconditioner
        pre = line_preconditioner(
            K, s, free, axis=-1 if precondition == "rline" else -2)
    elif precondition == "jacobi":
        pre = None
    else:
        raise ValueError(f"unknown precondition {precondition!r}")

    if f is None:
        b = jnp.zeros_like(g)
    else:
        # consistent load: ∫ f φ dx via the unit mass (unweighted)
        M_unit = jnp.einsum("mkij->kij", jnp.asarray(
            st.M if weighted else st.M_flat, dtype))
        b = apply_stencil(M_unit, jnp.asarray(f, dtype))

    b_lift = (b - apply_stencil(K, g)) * s * free
    sol = pcg(apply_s, b_lift, jnp.zeros_like(g), mask=free, rtol=rtol,
              maxiter=maxiter, precond=pre)
    u = sol.x * s * free + g
    return np.asarray(u), {"iters": int(sol.iters),
                           "residual": float(sol.residual),
                           "converged": bool(sol.converged)}


def steady_heating_values(problem: Problem2D, t: float = 0.0,
                          amplitude: float | None = None) -> np.ndarray:
    """Boundary data for a steady solve: fixed edges at ic_temp, the heating
    line at the Gaussian profile with the given amplitude (defaults to the
    heating curve's value at time t) — the notebooks' workflow of holding the
    laser at a fixed level."""
    ic = problem.ic_temp
    if amplitude is None:
        off = problem.heating.amplitude_offset(ic)
        amplitude = float(np.interp(t, problem.heating.time,
                                    problem.heating.temp) - off)
    coeff = -4.0 * np.log(2.0) / problem.fwhm ** 2
    profile = np.exp(coeff * problem.r_sq) * problem.heat_mask
    return (ic * problem.dirichlet_mask.astype(float)
            + (amplitude - ic) * profile)
