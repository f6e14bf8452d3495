"""Grid-overlay operators: unstructured geometry at structured-stencil speed.

The ELL SpMV (ops/ell.py) gathers neighbor values by index for every apply.
When the mesh *topology* embeds in a 2D lattice (node positions may be
arbitrarily jittered, diagonals mixed per quad, grading arbitrary — only the
neighbor graph matters), the exactly assembled unstructured operator is a
permuted 9-point stencil. This module converts assembled EllOps to that form
so the whole unstructured feature surface runs through shifted multiply-adds
(ops/stencil.apply_stencil), with no gathers. (Whether the overlay still
beats ELL on the GPU is not measured.)

Meshes from mesh/unstructured_gen carry the overlay natively; imported
meshes can carry it as a mesh_overlay.npz sidecar. Arbitrary-topology gmsh
imports fall back to the ELL path.
"""

from __future__ import annotations

import numpy as np

from heatflow_tpu.ops.ell import EllOps
from heatflow_tpu.ops.stencil import OFFSETS9


def validate_overlay(n_nodes: int, overlay: dict) -> tuple[np.ndarray, tuple]:
    """Return (index (N,), shape) after checking the lattice is complete."""
    idx = np.asarray(overlay["index"], dtype=np.int64)
    shape = tuple(int(s) for s in overlay["shape"])
    if len(idx) != n_nodes or shape[0] * shape[1] != n_nodes:
        raise ValueError(f"overlay does not cover the mesh: {len(idx)} ids, "
                         f"lattice {shape}, {n_nodes} nodes")
    if len(np.unique(idx)) != n_nodes:
        raise ValueError("overlay index is not a bijection")
    return idx, shape


def _vals_to_stencil(cols: np.ndarray, vals: np.ndarray, idx: np.ndarray,
                     shape: tuple) -> np.ndarray:
    """(N, K) ELL values (+ shared cols) → (9, Nz, Nr) stencil over the
    lattice. Raises if any nonzero entry falls outside the 9-point pattern
    (i.e. the overlay is inconsistent with the mesh connectivity)."""
    nz, nr = shape
    ri, rj = idx // nr, idx % nr                   # (N,) row lattice coords
    ci = idx[cols] // nr                           # (N, K) col lattice coords
    cj = idx[cols] % nr
    di = ci - ri[:, None]
    dj = cj - rj[:, None]
    ks = np.full(cols.shape, -1, dtype=np.int64)
    for k, (a, b) in enumerate(OFFSETS9):
        ks[(di == a) & (dj == b)] = k
    bad = (ks < 0) & (vals != 0.0)
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} operator entries outside the 9-point lattice "
            "pattern — mesh topology does not match the overlay")
    C = np.zeros((9,) + shape)
    ok = ks >= 0
    np.add.at(C, (ks[ok], np.broadcast_to(ri[:, None], cols.shape)[ok],
                  np.broadcast_to(rj[:, None], cols.shape)[ok]), vals[ok])
    return C


def ell_to_stencils(ell: EllOps, overlay: dict) -> dict[str, np.ndarray]:
    """Convert the full assembled operator set to lattice 9-point stencils:
    {'K': (m,9,Nz,Nr), 'M': ..., 'Kf', 'Mf', 'G', 'Mp'}."""
    idx, shape = validate_overlay(ell.cols.shape[0], overlay)
    out = {}
    for name, v in (("K", ell.K_vals), ("M", ell.M_vals),
                    ("Kf", ell.Kf_vals), ("Mf", ell.Mf_vals)):
        if v is None:
            continue
        out[name] = np.stack([_vals_to_stencil(ell.cols, v[m], idx, shape)
                              for m in range(v.shape[0])])
    out["G"] = _vals_to_stencil(ell.cols, ell.G_vals, idx, shape)
    out["Mp"] = _vals_to_stencil(ell.cols, ell.Mp_vals, idx, shape)
    return out
