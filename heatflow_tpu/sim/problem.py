"""Problem setup: mesh + materials + BCs + heating → device-resident arrays.

Everything the hot loop needs is precomputed here once (stencils, masks,
watcher indices, radial-band bin segments, heating-curve arrays), so the
scan body is pure array math — the device-side analogue of the setup phase of
ref run_no_diamond.py:229-513.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax.numpy as jnp
import numpy as np

from heatflow_tpu.geometry import MaterialSpec
from heatflow_tpu.mesh.structured import StructuredMesh
from heatflow_tpu.ops.stencil import StencilPack, assemble_stencils
from heatflow_tpu.sim.bc import HeatingCurve, structured_row_mask

# Radial-gradient sampling constants (ref run_no_diamond.py:409,494-499)
BAND_RMAX = 0.25e-6     # radial band for z-binned averaging: 0 < r <= 0.25 µm
BIN_DZ = 0.2e-6         # z bin width 0.2 µm
AXIS_TOL = 1e-12        # r = 0 node tolerance for the raw CSV (ref :457)


@dataclass
class RadialSampling:
    """Precomputed segments for the two radial-gradient CSV outputs."""
    band_nodes: np.ndarray      # (nb,) flat node ids with 0 < r <= BAND_RMAX
    band_bin_ids: np.ndarray    # (nb,) bin index per band node
    bin_counts: np.ndarray      # (n_bins,)
    bin_centers: np.ndarray     # (n_bins,) z centers (CSV columns)
    axis_z: np.ndarray          # (Nz,) z coords of r=0 nodes (raw CSV columns)


@dataclass
class Problem2D:
    """A fully prepared axisymmetric transient heat-conduction problem."""

    mesh: StructuredMesh
    stencils: StencilPack                  # host (numpy, float64)
    heating: HeatingCurve
    dt: float
    num_steps: int
    ic_temp: float
    fwhm: float
    kappas: np.ndarray                     # (n_mats,) default material values
    rho_cvs: np.ndarray                    # (n_mats,)

    dirichlet_mask: np.ndarray             # (Nz, Nr) bool, all constrained dofs
    heat_mask: np.ndarray                  # (Nz, Nr) bool, heating line dofs
    r_sq: np.ndarray                       # (Nz, Nr) r² (for the Gaussian)

    watcher_names: list[str] = field(default_factory=list)
    watcher_idx: np.ndarray | None = None  # (W, 2) (i, j) grid indices
    radial: RadialSampling | None = None

    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def free_mask(self) -> np.ndarray:
        return ~self.dirichlet_mask

    def device_arrays(self, dtype=jnp.float32) -> dict[str, jnp.ndarray]:
        """Cast all hot-loop arrays to device arrays of ``dtype``."""
        st = self.stencils.device_put(dtype)
        out = dict(st)
        out["dirichlet"] = jnp.asarray(self.dirichlet_mask, dtype=dtype)
        out["free"] = jnp.asarray(self.free_mask, dtype=dtype)
        out["heat_profile_base"] = jnp.asarray(
            self.heat_mask.astype(np.float64), dtype=dtype)
        out["r_sq"] = jnp.asarray(self.r_sq, dtype=dtype)
        out["heat_t"] = jnp.asarray(self.heating.time, dtype=dtype)
        out["heat_T"] = jnp.asarray(self.heating.temp, dtype=dtype)
        out["kappas"] = jnp.asarray(self.kappas, dtype=dtype)
        out["rho_cvs"] = jnp.asarray(self.rho_cvs, dtype=dtype)
        if self.watcher_idx is not None and len(self.watcher_idx):
            nr = len(self.mesh.r)
            out["watch_flat"] = jnp.asarray(
                self.watcher_idx[:, 0] * nr + self.watcher_idx[:, 1])
        if self.radial is not None:
            out["band_nodes"] = jnp.asarray(self.radial.band_nodes)
            out["band_bins"] = jnp.asarray(self.radial.band_bin_ids)
            out["bin_counts"] = jnp.asarray(self.radial.bin_counts, dtype=dtype)
        return out


def initial_condition(mesh: StructuredMesh, init) -> np.ndarray:
    """Build a (Nz, Nr) initial temperature field from a scalar, a callable
    f(z, r) (vectorized or scalar), or an array — the input forms of the
    reference's Space.initial_condition (ref space_and_forms.py:231-266)."""
    nz, nr = mesh.shape
    if np.isscalar(init):
        return np.full((nz, nr), float(init))
    if callable(init):
        zz, rr = np.meshgrid(mesh.z, mesh.r, indexing="ij")
        try:
            out = np.asarray(init(zz, rr), dtype=float)
            if out.shape != (nz, nr):
                raise ValueError
            return out
        except Exception:
            out = np.empty((nz, nr))
            for i, z in enumerate(mesh.z):
                for j, r in enumerate(mesh.r):
                    out[i, j] = init(z, r)
            return out
    arr = np.asarray(init, dtype=float)
    if arr.size != nz * nr:
        raise ValueError("array length does not match the number of DOFs")
    return arr.reshape(nz, nr)


def _radial_sampling(mesh: StructuredMesh) -> RadialSampling:
    z, r = mesh.z, mesh.r
    nr = len(r)
    band_j = np.where((r > 0.0) & (r <= BAND_RMAX))[0]
    # flat ids of all (i, j) with j in band
    ii, jj = np.meshgrid(np.arange(len(z)), band_j, indexing="ij")
    band_nodes = (ii * nr + jj).ravel()
    band_z = z[ii.ravel()]

    edges = np.arange(z.min(), z.max() + BIN_DZ, BIN_DZ)
    raw_bin = np.searchsorted(edges, band_z) - 1
    valid = (raw_bin >= 0) & (raw_bin < len(edges) - 1)
    band_nodes = band_nodes[valid]
    raw_bin = raw_bin[valid]

    # keep only non-empty bins, in z order (ref run_no_diamond.py:507-513)
    used = np.unique(raw_bin)
    remap = -np.ones(len(edges) - 1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    bin_ids = remap[raw_bin]
    counts = np.bincount(bin_ids, minlength=len(used)).astype(np.float64)
    centers = 0.5 * (edges[used] + edges[used + 1])
    return RadialSampling(band_nodes=band_nodes, band_bin_ids=bin_ids,
                          bin_counts=counts, bin_centers=centers,
                          axis_z=z.copy())


def radial_band_analysis(mesh: StructuredMesh, band_width: float = 0.1e-6
                         ) -> dict:
    """The reference's β-clustering diagnostic of the radial sampling band
    (ref run_no_diamond.py:409-432): β = mean r of band nodes / band width.
    β≈1 ⇒ nodes clustered at the outer edge; β≈0.5 ⇒ uniform."""
    r = mesh.r
    band_j = np.where((r > 0.0) & (r <= band_width))[0]
    n_nodes = len(band_j) * len(mesh.z)
    if len(band_j) == 0:
        return {"n_band_nodes": 0, "band_width": band_width, "beta": np.nan,
                "verdict": "no nodes in band"}
    mean_r = float(r[band_j].mean())
    beta = mean_r / band_width
    if beta > 0.95:
        verdict = "clustered near the outer edge (β ≈ 1)"
    elif 0.45 < beta < 0.55:
        verdict = "uniformly distributed (β ≈ 0.5)"
    else:
        verdict = "neither fully clustered nor uniform"
    return {"n_band_nodes": n_nodes, "band_width": band_width,
            "mean_r": mean_r, "beta": beta, "verdict": verdict}


def build_problem(mesh: StructuredMesh,
                  heating: HeatingCurve,
                  cfg: dict,
                  *,
                  watcher_points: dict[str, tuple[float, float]] | None = None,
                  stencils: StencilPack | None = None) -> Problem2D:
    """Assemble a Problem2D from a mesh, heating curve and a reference-schema
    config (timing / heating sections + per-material properties)."""
    t_final = float(cfg["timing"]["t_final"])
    num_steps = int(cfg["timing"]["num_steps"])
    dt = t_final / num_steps
    ic_temp = float(cfg["heating"]["ic_temp"])
    fwhm = float(cfg["heating"]["fwhm"])

    mats = mesh.materials
    kappas = np.array([m.kappa for m in mats], dtype=np.float64)
    rho_cvs = np.array([m.rho_cv for m in mats], dtype=np.float64)

    if stencils is None:
        stencils = assemble_stencils(mesh)

    z, r = mesh.z, mesh.r
    # Fixed edges at ic_temp: left, right and top (r = rmax). The r = 0 axis
    # has no BC (natural axisymmetric condition). ref run_no_diamond.py:311-314
    # (note the reference names its top BC "bottom_bc" but locates 'top').
    edge_mask = (structured_row_mask(z, r, "left")
                 | structured_row_mask(z, r, "right")
                 | structured_row_mask(z, r, "top"))

    # Heating line: inner 'x' row at the p-side coupler's left edge, clipped
    # to |r| <= r_sample (length = 2·r_sample, center 0), ref :315-322;
    # custom layouts override via heating.z / heating.r_max (geometry.py).
    from heatflow_tpu.geometry import heating_line
    heat_z, heat_length = heating_line(cfg, mats)
    heat_mask = structured_row_mask(
        z, r, "x", coord=heat_z, center=0.0, length=heat_length)

    dirichlet = edge_mask | heat_mask
    rr = np.broadcast_to(r[None, :], (len(z), len(r)))
    r_sq = (rr ** 2).astype(np.float64)

    names: list[str] = []
    widx = None
    if watcher_points:
        names = list(watcher_points.keys())
        widx = np.array(
            [[int(np.argmin(np.abs(z - pz))), int(np.argmin(np.abs(r - pr)))]
             for pz, pr in watcher_points.values()], dtype=np.int64)

    return Problem2D(
        mesh=mesh, stencils=stencils, heating=heating, dt=dt,
        num_steps=num_steps, ic_temp=ic_temp, fwhm=fwhm, kappas=kappas,
        rho_cvs=rho_cvs, dirichlet_mask=dirichlet, heat_mask=heat_mask,
        r_sq=r_sq, watcher_names=names, watcher_idx=widx,
        radial=_radial_sampling(mesh))
