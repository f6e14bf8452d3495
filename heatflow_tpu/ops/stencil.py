"""7-point stencil assembly and application on structured meshes.

The accelerator-side replacement for sparse-matrix assembly + MUMPS
(ref: run_no_diamond.py:331-344): on a tensor-product triangulated grid, every
P1 operator has a fixed 7-point sparsity, so ``A @ u`` becomes seven shifted
elementwise multiply-adds over (Nz, Nr) arrays — elementwise work that XLA
fuses, no gather/scatter, and trivial vmap over parameter-sweep batches.

Stencils are assembled *per material* with unit coefficients, so the operator
for any (κ_m, ρc_m, dt) combination — e.g. each config of a parameter sweep —
is a tiny linear combination computed on device (``combine_operator``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.mesh.structured import StructuredMesh
from heatflow_tpu.ops import p1

# Offsets (di, dj): result[i,j] couples to u[i+di, j+dj].
OFFSETS: tuple[tuple[int, int], ...] = (
    (0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1),
)
# Galerkin-coarsened (RAP) operators fill the full 3x3 neighborhood: the
# bilinear-transfer triple product adds the two anti-diagonal couplings.
OFFSETS9: tuple[tuple[int, int], ...] = OFFSETS + ((1, -1), (-1, 1))
_OFF_INDEX = {off: k for k, off in enumerate(OFFSETS)}


def offsets_for(n_points: int) -> tuple[tuple[int, int], ...]:
    if n_points == 7:
        return OFFSETS
    if n_points == 9:
        return OFFSETS9
    raise ValueError(f"unsupported stencil size {n_points} (7 or 9)")

# Grid positions of the three vertices of each triangle type within its quad.
_TRI_VPOS = {
    "lower": ((0, 0), (1, 0), (1, 1)),
    "upper": ((0, 0), (1, 1), (0, 1)),
}


def _tri_coords(mesh: StructuredMesh, kind: str) -> np.ndarray:
    """(Nz-1, Nr-1, 3, 2) vertex coordinates for all triangles of one type."""
    z, r = mesh.z, mesh.r
    nzc, nrc = len(z) - 1, len(r) - 1
    out = np.empty((nzc, nrc, 3, 2), dtype=np.float64)
    for a, (di, dj) in enumerate(_TRI_VPOS[kind]):
        out[:, :, a, 0] = z[di:di + nzc, None]
        out[:, :, a, 1] = r[None, dj:dj + nrc]
    return out


def _scatter_matrix(C: np.ndarray, E: np.ndarray, kind: str) -> None:
    """Accumulate element matrices E (Nz-1, Nr-1, 3, 3) into stencil C (7, Nz, Nr).

    Targets are unique per (a, b) pair across cells, so plain slice adds work —
    no atomic scatter needed.
    """
    nzc, nrc = E.shape[:2]
    vpos = _TRI_VPOS[kind]
    for a in range(3):
        pa = vpos[a]
        for b in range(3):
            pb = vpos[b]
            off = (pb[0] - pa[0], pb[1] - pa[1])
            k = _OFF_INDEX[off]
            C[k, pa[0]:pa[0] + nzc, pa[1]:pa[1] + nrc] += E[:, :, a, b]


def _scatter_vector_weighted(C: np.ndarray, w: np.ndarray, c: np.ndarray,
                             kind: str) -> None:
    """Accumulate rank-one per-triangle operators w_a c_b into stencil C.

    Used for the gradient-projection rhs operator: b_a += w_a Σ_b c_b u_b.
    """
    E = w[..., :, None] * c[..., None, :]
    _scatter_matrix(C, E, kind)


@dataclass
class StencilPack:
    """Assembled geometric stencils for a structured mesh.

    All arrays are numpy float64 on the host; move to device (and cast) via
    :meth:`device_put`.

    Attributes
    ----------
    K : (n_mats, 7, Nz, Nr)  r-weighted stiffness per material, unit κ
    M : (n_mats, 7, Nz, Nr)  r-weighted mass per material, unit ρc
    K_flat / M_flat : (n_mats, 7, Nz, Nr) unweighted variants (steady state /
        Cartesian problems)
    G_r : (7, Nz, Nr) radial-gradient projection rhs: b = G_r @ u gives
        b_a = ∫ (∂u/∂r) φ_a r dA  (ref: run_no_diamond.py:544-547)
    G_z : (7, Nz, Nr) same for ∂u/∂z
    M_proj : (7, Nz, Nr) r-weighted mass (Σ over materials) — the projection
        matrix A_proj of ref run_no_diamond.py:479-482
    """

    K: np.ndarray
    M: np.ndarray
    K_flat: np.ndarray
    M_flat: np.ndarray
    G_r: np.ndarray
    G_z: np.ndarray
    M_proj: np.ndarray

    def device_put(self, dtype=jnp.float32):
        return jax.tree.map(
            lambda x: jnp.asarray(x, dtype=dtype),
            {"K": self.K, "M": self.M, "G_r": self.G_r, "G_z": self.G_z,
             "M_proj": self.M_proj})


def assemble_stencils(mesh: StructuredMesh, *, backend: str = "auto"
                      ) -> StencilPack:
    """Assemble all geometric stencils for ``mesh`` (host-side, exact P1).

    backend: 'auto' tries the native C++ kernel (heatflow_tpu.native) and
    falls back to vectorized numpy; 'numpy' forces the fallback.
    """
    nz, nr = mesh.shape
    n_mats = len(mesh.material_tags)
    shape = (7, nz, nr)

    if backend == "auto":
        from heatflow_tpu.native import native_assemble_stencils
        out = native_assemble_stencils(mesh.z, mesh.r, mesh.cell_tags,
                                       n_mats)
        if out is not None:
            K, M, K_flat, M_flat, G_r, G_z = out
            return StencilPack(K=K, M=M, K_flat=K_flat, M_flat=M_flat,
                               G_r=G_r, G_z=G_z, M_proj=M.sum(axis=0))

    K = np.zeros((n_mats,) + shape)
    M = np.zeros((n_mats,) + shape)
    K_flat = np.zeros((n_mats,) + shape)
    M_flat = np.zeros((n_mats,) + shape)
    G_r = np.zeros(shape)
    G_z = np.zeros(shape)

    for kind in ("lower", "upper"):
        coords = _tri_coords(mesh, kind)
        Ke = p1.tri_stiffness_rw(coords)
        Me = p1.tri_mass_rw(coords)
        Kfe = p1.tri_stiffness(coords)
        Mfe = p1.tri_mass(coords)
        w = p1.tri_load_rw(coords)
        cr = p1.tri_dr_coeff(coords)
        cz = p1.tri_dz_coeff(coords)

        for m, tag in enumerate(sorted(mesh.material_tags.values())):
            sel = (mesh.cell_tags == tag)[..., None, None]
            _scatter_matrix(K[m], Ke * sel, kind)
            _scatter_matrix(M[m], Me * sel, kind)
            _scatter_matrix(K_flat[m], Kfe * sel, kind)
            _scatter_matrix(M_flat[m], Mfe * sel, kind)
        _scatter_vector_weighted(G_r, w, cr, kind)
        _scatter_vector_weighted(G_z, w, cz, kind)

    return StencilPack(K=K, M=M, K_flat=K_flat, M_flat=M_flat,
                       G_r=G_r, G_z=G_z, M_proj=M.sum(axis=0))


# ----------------------------------------------------------------------
# Device-side operations
# ----------------------------------------------------------------------

def _shifted(u: jnp.ndarray, di: int, dj: int) -> jnp.ndarray:
    """result[i, j] = u[i+di, j+dj], zero outside — via pad + static slice."""
    nz, nr = u.shape[-2], u.shape[-1]
    pad = [(0, 0)] * (u.ndim - 2) + [(1, 1), (1, 1)]
    up = jnp.pad(u, pad)
    return jax.lax.slice_in_dim(
        jax.lax.slice_in_dim(up, 1 + di, 1 + di + nz, axis=-2),
        1 + dj, 1 + dj + nr, axis=-1)


def apply_stencil(C: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Compute (A @ u) where A is a 7-point (or RAP 9-point) stencil.

    C : (..., 7|9, Nz, Nr) stencil coefficients
    u : (..., Nz, Nr) field
    Broadcasting over leading dims follows numpy rules (so a batched C with a
    batched u vmaps for free).
    """
    offs = offsets_for(C.shape[-3])
    out = C[..., 0, :, :] * u
    for k, (di, dj) in enumerate(offs[1:], start=1):
        out = out + C[..., k, :, :] * _shifted(u, di, dj)
    return out


def stencil_transpose_apply(C: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Compute (A^T @ u) for a stencil A (needed for adjoint/grad paths)."""
    offs = offsets_for(C.shape[-3])
    out = C[..., 0, :, :] * u
    for k, (di, dj) in enumerate(offs[1:], start=1):
        out = out + _shifted(C[..., k, :, :] * u, -di, -dj)
    return out


def material_combine(coeffs: jnp.ndarray, S: jnp.ndarray) -> jnp.ndarray:
    """Σ_m coeffs[..., m] · S[m], statically unrolled — NEVER a dot_general.

    The material contraction is tiny (n_mats ≤ ~9) but its output is the
    backward-Euler operator, whose symmetrically-scaled condition number is
    ~1e6. Expressed as an einsum, an accelerator's compiler may lower it to
    a matrix-unit dot_general at DEFAULT precision — reduced-precision
    inputs (bf16 or TF32), a ~1e-3 relative perturbation of the operator
    coefficients — *but only when the coefficients are batched* (B ≥ 2); at
    B = 1 the degenerate dot simplifies to full-f32 multiply-adds. The
    perturbation pushes the smallest eigenvalues of the scaled operator
    negative, so CG diverges on every lane of a batched
    sweep while the identical single config converges (the round-2
    "vmapped full-stepper divergence", root-caused via
    jax.default_matmul_precision('highest') restoring exact B=1/B=2
    iteration parity). An unrolled multiply-add chain is exact in f32 and
    is also the natively right lowering for a length-5 contraction:
    elementwise work, no matrix-unit round-trip
    (heatflow_tpu.devicecheck checks the compiled form on the device).
    """
    extra = S.ndim - 1
    def c(i):
        v = coeffs[..., i]
        return v.reshape(v.shape + (1,) * extra)
    out = c(0) * S[0]
    for i in range(1, S.shape[0]):
        out = out + c(i) * S[i]
    return out


@partial(jax.jit, static_argnames=())
def combine_operator(K: jnp.ndarray, M: jnp.ndarray, kappas: jnp.ndarray,
                     rho_cvs: jnp.ndarray, dt) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build (A, M_op) stencils for a backward-Euler step:

        A = Σ_m ρc_m M_m + dt Σ_m κ_m K_m        (lhs, ref run_no_diamond.py:278-281)
        M_op = Σ_m ρc_m M_m                       (rhs mass, ref :282-285)

    kappas / rho_cvs are (n_mats,) — or batched (..., n_mats) for vmapped
    sweeps (broadcasting over leading dims). The contraction is a
    statically-unrolled multiply-add, not an einsum — see
    :func:`material_combine` for why that is load-bearing.
    """
    M_op = material_combine(rho_cvs, M)
    A = M_op + dt * material_combine(kappas, K)
    return A, M_op


def stencil_to_coo(C: np.ndarray):
    """Expand a (7|9, Nz, Nr) stencil into COO triplets (rows, cols, vals)
    over flattened node ids — for scipy cross-validation and RAP products."""
    npts, nz, nr = C.shape
    rows, cols, vals = [], [], []
    ii, jj = np.meshgrid(np.arange(nz), np.arange(nr), indexing="ij")
    for k, (di, dj) in enumerate(offsets_for(npts)):
        it, jt = ii + di, jj + dj
        ok = (it >= 0) & (it < nz) & (jt >= 0) & (jt < nr)
        rows.append((ii * nr + jj)[ok])
        cols.append((it * nr + jt)[ok])
        vals.append(C[k][ok])
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals))


def sparse_to_stencil(A, shape: tuple[int, int], n_points: int = 9
                      ) -> np.ndarray:
    """scipy sparse (N, N) on the z-major flattened grid → (n_points, Nz, Nr)
    stencil. Raises if any non-negligible entry falls outside the offset
    pattern (a bilinear RAP product is provably 9-point; this guards it)."""
    nz, nr = shape
    A = A.tocoo()
    offs = offsets_for(n_points)
    ri, rj = A.row // nr, A.row % nr
    di = (A.col // nr) - ri
    dj = (A.col % nr) - rj
    ks = np.full(len(A.data), -1, dtype=np.int64)
    for k, (a, b) in enumerate(offs):
        ks[(di == a) & (dj == b)] = k
    outside = ks < 0
    if outside.any():
        scale = np.abs(A.data).max() or 1.0
        bad = np.abs(A.data[outside]).max()
        if bad > 1e-12 * scale:
            raise ValueError(
                f"{int(outside.sum())} entries outside the {n_points}-point "
                f"pattern (max |v| {bad:.3e})")
    C = np.zeros((n_points, nz, nr))
    sel = ~outside
    np.add.at(C, (ks[sel], ri[sel], rj[sel]), A.data[sel])
    return C
