"""Line (block-tridiagonal) preconditioning via parallel cyclic reduction.

The flagship operator's conditioning is dominated by the r-direction
coupling (fine radial grading near the heating axis: r-line block-Jacobi
cuts cold-solve CG iterations several-fold where z-line does little).
Block-Jacobi with one tridiagonal block per grid line
is SPD (principal submatrices of an SPD operator), so it is a valid CG
preconditioner; each application solves an independent tridiagonal system
per line.

A Thomas sweep along the 1107-node r axis is a sequential recurrence, so the
solve is parallel cyclic reduction (PCR): ceil(log2(N)) levels of uniform
full-array elementwise updates — shifted multiply-adds only, the same
pattern as the stencil apply, no gathers and no strided slices. Crucially
the backward-Euler operator is constant across the whole transient, so the
PCR *factorization* (the per-level elimination coefficients) is computed
once per solve setup and only the cheap rhs phase runs per CG iteration:

    level k, stride s=2^k, unit-diagonal system  x_i + l_i x_{i-s} + u_i x_{i+s} = d_i:
        alpha_i = 1 - l_i u_{i-s} - u_i l_{i+s}
        l'  = -l_i l_{i-s} / alpha_i          (factor phase, once)
        u'  = -u_i u_{i+s} / alpha_i
        d'  = (d_i - l_i d_{i-s} - u_i d_{i+s}) / alpha_i   (rhs phase, per apply)
    after 2^K >= N every coupling leaves the domain and x = d.

Per application: K levels x (2 shifted multiply-adds + 1 multiply) — about
3-4 stencil-apply equivalents for N≈1100.

Reference context: the reference solves every step exactly with MUMPS
(run_no_diamond.py:339-344); this is the iterative analogue of giving
the Krylov solver the dominant 1D physics exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def line_couplings(A: jnp.ndarray, sf: jnp.ndarray, axis: int):
    """(l, u) couplings of the symmetrically scaled operator sf·A·sf along
    one grid axis, with boundary couplings zeroed.

    A: (..., 7|9, Nz, Nr) stencil (ops/stencil.OFFSETS order); sf: the
    scaling-with-free-mask vector s*free (so Dirichlet rows drop out and
    the line systems keep their identity rows).  axis=-1 is r (offsets
    3/4), axis=-2 is z (offsets 1/2).  The scaled diagonal is 1 on free
    rows by construction and must be supplied as such to pcr_factor.
    """
    if axis == -1:
        up_k, lo_k = 3, 4
    elif axis == -2:
        up_k, lo_k = 1, 2
    else:
        raise ValueError(f"axis must be -1 (r) or -2 (z), got {axis}")

    # the zero-padded shift annihilates the boundary rows' outward
    # couplings exactly (shift brings in a 0 for the missing neighbor)
    u = sf * A[..., up_k, :, :] * _shift(sf, 1, axis)   # couples i -> i+1
    l = sf * A[..., lo_k, :, :] * _shift(sf, -1, axis)  # couples i -> i-1
    return l, u


def _shift(v: jnp.ndarray, d: int, axis: int) -> jnp.ndarray:
    """v shifted by d along axis, zeros shifted in (v[i] <- v[i+d]).

    Implemented as a single lax.pad with a negative low pad (crop d, append
    d zeros for d>0, and the mirror for d<0) rather than jnp.pad + slice:
    one XLA op, and it sidesteps a jaxlib CPU heap corruption observed with
    the pad-then-slice composition on narrow x64 arrays (eager positive
    shift of a (64, 4) f64 array along axis -2 corrupts the allocator after
    a few dozen dispatches — reproduced on jaxlib in this environment)."""
    cfg = [(0, 0, 0)] * v.ndim
    cfg[axis % v.ndim] = (-d, d, 0)
    return jax.lax.pad(v, jnp.zeros((), v.dtype), cfg)


def pcr_factor(l: jnp.ndarray, u: jnp.ndarray, axis: int = -1):
    """PCR factorization of unit-diagonal tridiagonal systems along ``axis``
    (vectorized over every other axis).

    Returns a list of (l_k, u_k, inv_alpha_k) per level — feed to
    :func:`pcr_apply`.  Levels run until the stride covers the axis length,
    so the rhs phase terminates with the exact solution (up to rounding).
    """
    n = l.shape[axis]
    levels = []
    s = 1
    while s < n:
        alpha = 1.0 - l * _shift(u, -s, axis) - u * _shift(l, s, axis)
        inv_a = 1.0 / alpha
        l_new = -l * _shift(l, -s, axis) * inv_a
        u_new = -u * _shift(u, s, axis) * inv_a
        levels.append((l, u, inv_a))
        l, u = l_new, u_new
        s *= 2
    return levels


def pcr_apply(levels, d: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Solve the factored tridiagonal systems: K levels of shifted
    multiply-adds on the rhs, then x = d."""
    s = 1
    for l_k, u_k, inv_a in levels:
        d = (d - l_k * _shift(d, -s, axis) - u_k * _shift(d, s, axis)) \
            * inv_a
        s *= 2
    return d


def pcr_fold(levels, axis: int = -1):
    """Fold the per-level diagonal scales out of a PCR factorization.

    The raw rhs phase is d' = inv_a_k · (d − l_k d₋ − u_k d₊): three factor
    planes per level. Diagonals commute through the shift operators by
    rescaling the coefficients — with g_k = ∏_{j<k} inv_a_j,

        l~_k = l_k · S₋(g_k) / g_k,   u~_k = u_k · S₊(g_k) / g_k,

    the apply becomes e' = e − l~_k e₋ − u~_k e₊ per level and one final
    x = g_K · e: TWO factor planes per level plus one diagonal plane —
    exactly the same operator in exact arithmetic, with a third less
    factor traffic per application. Returns
    ([(l~_k, u~_k), ...], g_K); g_K is None for a zero-level (N=1)
    factorization, where the apply is the identity.
    """
    if not levels:
        return [], None
    g = jnp.ones_like(levels[0][0])
    out = []
    s = 1
    for l_k, u_k, inv_a in levels:
        gsafe = jnp.where(g != 0, g, 1.0)
        out.append((l_k * _shift(g, -s, axis) / gsafe,
                    u_k * _shift(g, s, axis) / gsafe))
        g = inv_a * g
        s *= 2
    return out, g


def pcr_apply_folded(levels2, g: jnp.ndarray, d: jnp.ndarray,
                     axis: int = -1) -> jnp.ndarray:
    """Apply a folded factorization (:func:`pcr_fold`): K two-plane levels
    and one final diagonal multiply."""
    s = 1
    for l_k, u_k in levels2:
        d = d - l_k * _shift(d, -s, axis) - u_k * _shift(d, s, axis)
        s *= 2
    return d if g is None else g * d


def adi_preconditioner(A: jnp.ndarray, s: jnp.ndarray, free: jnp.ndarray):
    """Split-additive ADI composition of BOTH line block-Jacobi solves on
    the scaled system:  pre(r) = R r + Z r − r  (R = r-line, Z = z-line;
    the subtracted identity removes the doubly-counted unit diagonal).

    R and Z are SPD (principal-submatrix block Jacobi of the scaled SPD
    operator); the split form converges monotonically under PCG on the DAC
    operator. It costs one extra z-direction PCR rhs phase per
    application (no extra operator applies) for fewer iterations than
    rline alone, most on cold, deep solves."""
    R = line_preconditioner(A, s, free, axis=-1)
    Z = line_preconditioner(A, s, free, axis=-2)
    fm = free

    def pre(r):
        return R(r) + Z(r) - r * fm

    return pre


def line_preconditioner(A: jnp.ndarray, s: jnp.ndarray, free: jnp.ndarray,
                        axis: int = -1):
    """Build the r-line (axis=-1) or z-line (axis=-2) block-Jacobi
    preconditioner for the SCALED system  (s·A·s) y = b:

        pre(r) = T^{-1} r  with T the line-tridiagonal part of s·A·s
                 (unit diagonal on free rows, identity on Dirichlet rows).

    Returns a callable for ops.cg.pcg(precond=...).  The factorization is
    computed eagerly here (the operator is fixed for the whole transient);
    each application costs ~ceil(log2(N_axis)) shifted multiply-add passes.
    """
    sf = s * free
    l, u = line_couplings(A, sf, axis)
    levels = pcr_factor(l, u, axis=axis)
    levels2, g = pcr_fold(levels, axis=axis)
    fm = free

    def pre(r):
        return pcr_apply_folded(levels2, g, r, axis=axis) * fm

    return pre


def line_family_preconditioner(kind: str, A: jnp.ndarray, s: jnp.ndarray,
                               free: jnp.ndarray):
    """The line preconditioner named ``kind`` on the scaled system:
    'rline' / 'zline' (one line block-Jacobi solve) or 'adi' (both,
    split-additively). Any other name (jacobi, mg) gets None — those are
    built by the caller."""
    if kind == "adi":
        return adi_preconditioner(A, s, free)
    if kind in ("rline", "zline"):
        return line_preconditioner(A, s, free,
                                   axis=-1 if kind == "rline" else -2)
    return None
