"""Transient solver on imported unstructured meshes (ELL operator path).

Runs the same backward-Euler / Gaussian-laser / watcher / radial-gradient
pipeline as the structured stepper but on an arbitrary P1 triangle mesh —
e.g. a gmsh .msh produced by the reference toolchain — enabling exact-mesh
parity runs (SURVEY.md §7 'Unstructured-mesh parity'). Node/cell semantics
follow the reference everywhere:

  * watcher points → nearest mesh node (ref run_no_diamond.py:397-401);
  * raw gradient CSV → nodes with |r| <= 1e-12 sorted by z (ref :457-465);
  * band CSV → 0.2 µm z-bins of band nodes 0 < r <= 0.25 µm (ref :494-513).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.mesh.msh_io import UnstructuredMesh
from heatflow_tpu.ops.cg import pcg, refined_solve
from heatflow_tpu.ops.ell import (EllOps, assemble_ell, ell_apply,
                                  ell_combine, ell_diag)
from heatflow_tpu.sim.bc import HeatingCurve, node_row_mask
from heatflow_tpu.sim.problem import AXIS_TOL, BAND_RMAX, BIN_DZ
from heatflow_tpu.sim.stepper import validate_refine
from heatflow_tpu.utils import resolve_solver


@dataclass
class ProblemUnstructured:
    mesh: UnstructuredMesh
    ell: EllOps
    heating: HeatingCurve
    dt: float
    num_steps: int
    ic_temp: float
    fwhm: float
    kappas: np.ndarray
    rho_cvs: np.ndarray
    dirichlet: np.ndarray            # (N,) bool
    heat_mask: np.ndarray            # (N,) bool
    watcher_names: list[str] = field(default_factory=list)
    watcher_nodes: np.ndarray | None = None
    band_nodes: np.ndarray | None = None
    band_bins: np.ndarray | None = None
    bin_counts: np.ndarray | None = None
    bin_centers: np.ndarray | None = None
    axis_nodes: np.ndarray | None = None
    axis_z: np.ndarray | None = None


def build_problem_unstructured(mesh: UnstructuredMesh, heating: HeatingCurve,
                               cfg: dict, *, watcher_points=None,
                               heat_coord: float | None = None,
                               heat_length: float | None = None
                               ) -> ProblemUnstructured:
    """Assemble the ELL problem. heat_coord/heat_length default to the
    config-derived p-side coupler line (requires reference-schema mats)."""
    from heatflow_tpu.config import mat_float
    nodes = mesh.nodes
    n_mats = len(mesh.material_tags) or int(mesh.cell_tags.max())
    tag_order = sorted(mesh.material_tags.items(), key=lambda kv: kv[1])
    if tag_order:
        kappas = np.array([mat_float(cfg, nm, "k") for nm, _ in tag_order])
        rho_cvs = np.array([mat_float(cfg, nm, "rho")
                            * mat_float(cfg, nm, "cv") for nm, _ in tag_order])
    else:
        raise ValueError("mesh lacks material name → tag mapping")

    if heat_coord is None or heat_length is None:
        from heatflow_tpu.geometry import heating_line
        cfg_coord, cfg_length = heating_line(cfg)
        heat_coord = cfg_coord if heat_coord is None else heat_coord
        heat_length = cfg_length if heat_length is None else heat_length

    edge = (node_row_mask(nodes, "left") | node_row_mask(nodes, "right")
            | node_row_mask(nodes, "top"))
    heat = node_row_mask(nodes, "x", coord=heat_coord, center=0.0,
                         length=heat_length)
    dirichlet = edge | heat

    names, widx = [], None
    if watcher_points:
        names = list(watcher_points.keys())
        pts = np.asarray(list(watcher_points.values()), float)
        d2 = ((nodes[None, :, :] - pts[:, None, :]) ** 2).sum(-1)
        widx = d2.argmin(axis=1)

    # radial sampling (reference node rules)
    r = nodes[:, 1]
    z = nodes[:, 0]
    axis_nodes = np.where(np.abs(r) <= AXIS_TOL)[0]
    order = np.argsort(z[axis_nodes])
    axis_nodes = axis_nodes[order]
    band_sel = np.where((r > 0.0) & (r <= BAND_RMAX))[0]
    edges = np.arange(z.min(), z.max() + BIN_DZ, BIN_DZ)
    raw_bin = np.searchsorted(edges, z[band_sel]) - 1
    valid = (raw_bin >= 0) & (raw_bin < len(edges) - 1)
    band_sel, raw_bin = band_sel[valid], raw_bin[valid]
    used = np.unique(raw_bin)
    remap = -np.ones(len(edges) - 1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    bins = remap[raw_bin]
    counts = np.bincount(bins, minlength=len(used)).astype(float)
    centers = 0.5 * (edges[used] + edges[used + 1])

    t_final = float(cfg["timing"]["t_final"])
    num_steps = int(cfg["timing"]["num_steps"])
    return ProblemUnstructured(
        mesh=mesh,
        ell=assemble_ell(mesh.nodes, mesh.cells, mesh.cell_tags, n_mats),
        heating=heating, dt=t_final / num_steps, num_steps=num_steps,
        ic_temp=float(cfg["heating"]["ic_temp"]),
        fwhm=float(cfg["heating"]["fwhm"]), kappas=kappas, rho_cvs=rho_cvs,
        dirichlet=dirichlet, heat_mask=heat, watcher_names=names,
        watcher_nodes=widx, band_nodes=band_sel, band_bins=bins,
        bin_counts=counts, bin_centers=centers, axis_nodes=axis_nodes,
        axis_z=z[axis_nodes])


def _overlay_prep(problem: ProblemUnstructured):
    """(idx, inv, shape, stencils) of the mesh's lattice embedding, or None
    when the mesh has no grid overlay. idx maps node id → flat lattice
    position; inv the reverse. The stencil conversion is cached on the
    problem (shared by the simulate and sweep paths)."""
    from heatflow_tpu.ops.overlay import ell_to_stencils, validate_overlay
    overlay = getattr(problem.mesh, "grid_overlay", None)
    if overlay is None:
        return None
    idx_np, oshape = validate_overlay(len(problem.mesh.nodes), overlay)
    stn = getattr(problem, "_overlay_stencils", None)
    if stn is None:
        stn = ell_to_stencils(problem.ell, overlay)
        problem._overlay_stencils = stn
    return idx_np, np.argsort(idx_np), oshape, stn


def check_unstructured_precondition(precondition: str) -> None:
    """The XLA engine's unstructured path preconditions with Jacobi
    scaling only: 'rline'/'adi' (line solves on the overlay lattice) have
    no implementation there, and a silent Jacobi run would misreport the
    requested preconditioner."""
    if precondition in ("rline", "adi"):
        raise ValueError(f"{precondition} preconditioning is not available "
                         "on unstructured problems; use "
                         "precondition='jacobi'")
    if precondition != "jacobi":
        raise ValueError(f"unknown precondition {precondition!r}")


def make_simulate_fn_unstructured(problem: ProblemUnstructured, *,
                                  dtype=jnp.float64, rtol=1e-11,
                                  maxiter=20000, fixed_iters=None,
                                  proj_rtol=None, proj_maxiter=400,
                                  record_gradient=True,
                                  record_fields=False, rtol_wrt="b",
                                  differentiable=False, solver="auto",
                                  warm_start="previous",
                                  precondition="jacobi", f64_refine=0):
    """Build a jittable simulate(kappas, rho_cvs, fwhm, u0, t0, source) on the
    ELL operator path — same surface as the structured
    ``stepper.make_simulate_fn`` (parameter overrides default to the
    problem's values; passing arrays makes it a sweep kernel, vmappable over
    any of the three material/laser parameters).

    differentiable=True swaps the implicit solve to
    ``pcg_solve`` (implicit differentiation via custom_linear_solve, one
    adjoint CG per step under grad) and drops the cg_iters trace output —
    the enabler for gradient-based experimental fitting on imported meshes.

    warm_start='extrapolate' seeds each step's CG with 2·u_n − u_{n−1}
    instead of u_n (same semantics as the structured stepper).

    f64_refine=N: mixed-precision iterative refinement — f64-operator
    residuals around the f32 correction solves, state carried in f64
    (same semantics as ``stepper.make_simulate_fn(f64_refine=N)``;
    requires x64, dtype f32).

    precondition: 'jacobi' only — the XLA engine has no line or multigrid
    preconditioner on unstructured meshes; 'rline'/'adi' raise.

    Memoized per problem (same convention as sweepkernel.make_sweep_fn):
    identical arguments return the same compiled callable — re-tracing a
    fresh jit per call costs far more than the run itself on small chunks.
    """
    if f64_refine:
        # refined inner solves stop wrt their own per-pass residual; the
        # outer rtol_wrt has no effect — normalize it out of the cache key
        rtol_wrt = "b"
    solver = resolve_solver(solver)
    cache_key = ("sim_fn", jnp.dtype(dtype).name, rtol, maxiter, fixed_iters,
                 proj_rtol, proj_maxiter, record_gradient, record_fields,
                 rtol_wrt, differentiable, solver, warm_start, precondition,
                 f64_refine)
    check_unstructured_precondition(precondition)
    cache = problem.__dict__.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if warm_start not in ("previous", "extrapolate"):
        # the unstructured stepper implements the linear seed only
        # ('extrapolate2' exists on the structured stepper alone) — raise
        # instead of silently degrading to 'previous'
        raise ValueError(f"unknown warm_start {warm_start!r} (use "
                         "'previous' or 'extrapolate')")
    if f64_refine:
        validate_refine(dtype)
        if differentiable or fixed_iters is not None:
            raise ValueError("f64_refine composes with the tolerance-based "
                             "non-differentiable solvers")
    cdt = jnp.float64 if f64_refine else dtype
    from heatflow_tpu.ops.cg import pcg_fixed, pcg_solve
    from heatflow_tpu.ops.stencil import apply_stencil, combine_operator
    nodes = problem.mesh.nodes
    n = len(nodes)
    dt = jnp.asarray(problem.dt, cdt)
    ic = jnp.asarray(problem.ic_temp, cdt)
    num_steps = int(problem.num_steps)
    n_bins = len(problem.bin_counts) if problem.bin_counts is not None else 0
    has_watch = problem.watcher_nodes is not None
    if proj_rtol is None:
        proj_rtol = rtol

    # Grid-overlay path (ops/overlay.py): when the mesh topology embeds
    # in a 2D lattice, the operators become permuted 9-point stencils
    # (shifted multiply-adds instead of gathers). All vectors live in
    # lattice ordering inside the core; node ordering at the boundaries.
    overlay = getattr(problem.mesh, "grid_overlay", None)
    if overlay is not None:
        idx_np, inv_np, oshape, stn = _overlay_prep(problem)
        remap = lambda v: np.asarray(v)[inv_np]
        node_ids = lambda ids: idx_np[np.asarray(ids)]
        dev = {"K": jnp.asarray(stn["K"], cdt),
               "M": jnp.asarray(stn["M"], cdt),
               "G": jnp.asarray(stn["G"], cdt),
               "Mp": jnp.asarray(stn["Mp"], cdt)}
    else:
        remap = lambda v: v
        node_ids = lambda ids: np.asarray(ids)
        # Large arrays enter the jitted core as ARGUMENTS, not closure
        # constants (closure constants trigger XLA constant folding).
        dev = problem.ell.device_put(cdt)
    dev.update({
        "free": jnp.asarray(remap(~problem.dirichlet), cdt),
        "dirich": jnp.asarray(remap(problem.dirichlet), cdt),
        "heat_t": jnp.asarray(problem.heating.time, cdt),
        "heat_T": jnp.asarray(problem.heating.temp, cdt),
        "r_sq": jnp.asarray(remap(nodes[:, 1] ** 2), cdt),
        "heat_f": jnp.asarray(remap(problem.heat_mask), cdt),
    })
    if overlay is not None:
        dev["to_node"] = jnp.asarray(idx_np)
        dev["to_latt"] = jnp.asarray(inv_np)
    if has_watch:
        dev["watch"] = jnp.asarray(node_ids(problem.watcher_nodes))
    if record_gradient:
        dev.update({
            "band_nodes": jnp.asarray(node_ids(problem.band_nodes)),
            "band_bins": jnp.asarray(problem.band_bins),
            "bin_counts": jnp.asarray(problem.bin_counts, cdt),
            "axis_nodes": jnp.asarray(node_ids(problem.axis_nodes)),
        })

    def _core(dev, kp, rc, fw, u0, t0, source):
        free, dirich = dev["free"], dev["dirich"]
        heat_t, heat_T = dev["heat_t"], dev["heat_T"]
        amp_offset = heat_T[0] - ic

        if overlay is not None:
            A9, M9 = combine_operator(dev["K"], dev["M"], kp, rc, dt)
            rs = lambda C, v: apply_stencil(C, v.reshape(oshape)).ravel()
            diag = A9[0].ravel()
            apply_A = lambda v: rs(A9, v)
            apply_M = lambda v: rs(M9, v)
            apply_Mp = lambda v: rs(dev["Mp"], v)
            apply_G = lambda v: rs(dev["G"], v)
            Mp_diag = dev["Mp"][0].ravel()
        else:
            cols = dev["cols"]
            A_vals, M_vals = ell_combine(dev["K"], dev["M"], kp, rc, dt)
            diag = (A_vals * dev["own"]).sum(-1)
            apply_A = lambda v: ell_apply(cols, A_vals, v)
            apply_M = lambda v: ell_apply(cols, M_vals, v)
            apply_Mp = lambda v: ell_apply(cols, dev["Mp"], v)
            apply_G = lambda v: ell_apply(cols, dev["G"], v)
            Mp_diag = (dev["Mp"] * dev["own"]).sum(-1)

        s = jax.lax.rsqrt(jnp.where(diag > 0, diag, 1.0)) * free + dirich
        apply_s = lambda y: s * apply_A(s * y)
        s_mp = jax.lax.rsqrt(jnp.where(Mp_diag > 0, Mp_diag, 1.0))
        apply_mp_s = lambda y: s_mp * apply_Mp(s_mp * y)

        if f64_refine:
            # f32 casts of the scaled system for the inner correction
            # solves; the f64 masters above compute only per-pass residuals
            s32 = s.astype(dtype)
            free32 = free.astype(dtype)
            s_mp32 = s_mp.astype(dtype)
            if overlay is not None:
                A9_32 = A9.astype(dtype)
                Mp32, G32 = dev["Mp"].astype(dtype), dev["G"].astype(dtype)
                apply_A32 = lambda v: apply_stencil(
                    A9_32, v.reshape(oshape)).ravel()
                apply_Mp32 = lambda v: apply_stencil(
                    Mp32, v.reshape(oshape)).ravel()
                apply_G32 = lambda v: apply_stencil(
                    G32, v.reshape(oshape)).ravel()
            else:
                A_vals32 = A_vals.astype(dtype)
                Mp32v, G32v = dev["Mp"].astype(dtype), dev["G"].astype(dtype)
                apply_A32 = lambda v: ell_apply(cols, A_vals32, v)
                apply_Mp32 = lambda v: ell_apply(cols, Mp32v, v)
                apply_G32 = lambda v: ell_apply(cols, G32v, v)
            apply_s32 = lambda y: s32 * apply_A32(s32 * y)
            apply_mp_s32 = lambda y: s_mp32 * apply_Mp32(s_mp32 * y)

        coeff = jnp.asarray(-4.0 * np.log(2.0), cdt) / (fw * fw)
        profile = jnp.exp(coeff * dev["r_sq"]) * dev["heat_f"]

        # volumetric source: rhs += dt ∫ f φ r dx = dt (M_proj @ f)
        b_src = 0.0 if source is None \
            else dt * apply_Mp(source)

        # affine-in-amplitude lift (see stepper._core): A g hoisted out of
        # the scan — one apply per transient instead of one per step
        g0 = ic * (dirich - profile)
        g1 = profile
        Ag0 = apply_A(g0)
        Ag1 = apply_A(g1)

        extrapolate = warm_start == "extrapolate"

        def step(carry, t):
            if extrapolate:
                u_prev, u_pp, gr_prev, gr_pp = carry
                seed = 2.0 * u_prev - u_pp
                # the projection seed rides the same knob (the gradient
                # field evolves as smoothly in time as u)
                gr_seed = 2.0 * gr_prev - gr_pp
            else:
                u_prev, gr_prev = carry
                seed = u_prev
                gr_seed = gr_prev
            amp = jnp.interp(t, heat_t, heat_T) - amp_offset
            g = g0 + amp * g1
            b = (apply_M(u_prev) + b_src - (Ag0 + amp * Ag1)) * s
            y0 = (seed / jnp.where(s > 0, s, 1.0)) * free
            if f64_refine:
                y, iters, _ = refined_solve(
                    apply_s, apply_s32, b * free, y0, free,
                    passes=f64_refine, rtol=rtol, maxiter=maxiter,
                    dtype=dtype)
                u = y * s * free + g
                outs = {"cg_iters": iters}
            elif differentiable:
                x = pcg_solve(apply_s, b * free, y0, mask=free, rtol=rtol,
                              maxiter=maxiter, rtol_wrt=rtol_wrt)
                u = x * s * free + g
                outs = {}
            else:
                if fixed_iters is not None:
                    sol = pcg_fixed(apply_s, b * free, y0, mask=free,
                                    iters=fixed_iters)
                else:
                    sol = pcg(apply_s, b * free, y0, mask=free, rtol=rtol,
                              maxiter=maxiter, rtol_wrt=rtol_wrt)
                u = sol.x * s * free + g
                outs = {"cg_iters": sol.iters}
            if has_watch:
                outs["watch"] = u[dev["watch"]]
            if record_gradient:
                if f64_refine:
                    # scaled mass solve is well-conditioned: f32 suffices
                    br = s_mp32 * apply_G32(u.astype(dtype))
                    gsol = pcg(apply_mp_s32, br, gr_seed / s_mp32,
                               rtol=proj_rtol, maxiter=proj_maxiter)
                    gr = gsol.x * s_mp32
                else:
                    br = s_mp * apply_G(u)
                    gsol = pcg(apply_mp_s, br, gr_seed / s_mp,
                               rtol=proj_rtol, maxiter=proj_maxiter)
                    gr = gsol.x * s_mp
                vals = gr[dev["band_nodes"]]
                sums = jax.ops.segment_sum(vals, dev["band_bins"],
                                           num_segments=n_bins)
                outs["band"] = sums / dev["bin_counts"]
                outs["axis"] = gr[dev["axis_nodes"]]
                outs["proj_iters"] = gsol.iters
            else:
                gr = gr_prev
            if record_fields:
                outs["field"] = u
            carry_out = (u, u_prev, gr, gr_prev) if extrapolate \
                else (u, gr)
            return carry_out, outs

        gr0 = jnp.zeros((n,), dtype)
        ts = jnp.arange(1, num_steps + 1, dtype=cdt) * dt + t0
        carry0 = (u0, u0, gr0, gr0) if extrapolate else (u0, gr0)
        carry_fin, ys = jax.lax.scan(step, carry0, ts)
        u_fin = carry_fin[0]
        ys["times"] = ts
        ys["final_u"] = u_fin
        return ys

    jitted = jax.jit(_core)

    def simulate(kappas=None, rho_cvs=None, fwhm=None, u0=None, t0=0.0,
                 source=None):
        kp = jnp.asarray(problem.kappas if kappas is None else kappas, cdt)
        rc = jnp.asarray(problem.rho_cvs if rho_cvs is None else rho_cvs,
                         cdt)
        fw = jnp.asarray(problem.fwhm if fwhm is None else fwhm, cdt)
        u0 = jnp.full((n,), ic, cdt) if u0 is None \
            else jnp.asarray(u0, cdt)
        src = None if source is None else jnp.asarray(source, cdt)
        if overlay is not None:
            # node ordering at the API boundary, lattice ordering inside
            u0 = u0[dev["to_latt"]]
            src = None if src is None else src[dev["to_latt"]]
        ys = jitted(dev, kp, rc, fw, u0, jnp.asarray(t0, cdt), src)
        if overlay is not None:
            ys["final_u"] = ys["final_u"][dev["to_node"]]
            if "field" in ys:
                ys["field"] = ys["field"][:, dev["to_node"]]
        return ys

    simulate.core = _core
    simulate.dev = dev
    cache[cache_key] = simulate
    return simulate


def make_sweep_fn_unstructured(problem: ProblemUnstructured, *,
                               vary_material: str = "p_sample",
                               dtype=jnp.float32, rtol: float = 1e-6,
                               maxiter: int = 4000,
                               fixed_iters: int | None = None,
                               warm_start: str = "previous",
                               solver: str = "auto",
                               record_gradient: bool = False,
                               mesh=None, rtol_wrt: str = "b",
                               precondition: str = "jacobi",
                               f64_refine: int = 0):
    """Batched sweep kernel on an imported unstructured mesh:
    simulate_batch(sample_k (B,), fwhm (B,)) -> watcher traces (B, S, W) —
    the unstructured mirror of ``sweepkernel.make_sweep_fn`` (one vmapped
    scan instead of one process per config, ref parameter_sweep.py:436-446).
    Differentiable in both inputs (except under ``f64_refine``). Memoized
    per problem like the structured maker.

    ``record_gradient=True``: each config additionally
    accumulates band/axis radial-gradient rows (the reference's per-run
    gradient CSVs, ref run_no_diamond.py:602-617); ``simulate_batch`` then
    returns the full dict instead of bare traces.

    ``mesh``: shard the config axis over the device mesh — unstructured
    sweeps fan out across chips exactly like structured ones (the
    reference's pool is mesh-kind-agnostic, ref parameter_sweep.py:436-446).
    Batch sizes must be a multiple of the 'config' axis (callers pad).

    ``rtol_wrt``, ``precondition`` ('jacobi' only, as in
    :func:`make_simulate_fn_unstructured`) and ``f64_refine`` (f32+x64:
    mixed-precision f64-residual refinement per lane) mirror the
    structured ``make_sweep_fn``."""
    if f64_refine:
        # refined inner solves stop wrt their own per-pass residual; the
        # outer rtol_wrt has no effect — normalize it out of the cache key
        rtol_wrt = "b"
    solver = resolve_solver(solver)
    cache_key = ("sweep_fn", vary_material, jnp.dtype(dtype).name, rtol,
                 maxiter, fixed_iters, warm_start, solver, record_gradient,
                 mesh, rtol_wrt, precondition, f64_refine)
    cache = problem.__dict__.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if warm_start not in ("previous", "extrapolate"):
        raise ValueError(f"unknown warm_start {warm_start!r} for sweep "
                         "engines (use 'previous' or 'extrapolate')")
    tag_order = sorted(problem.mesh.material_tags.items(),
                       key=lambda kv: kv[1])
    names = [nm for nm, _ in tag_order]
    m_idx = names.index(vary_material)
    if problem.watcher_nodes is None:
        raise ValueError("sweeps need watcher points on the problem")

    fn = make_simulate_fn_unstructured(
        problem, dtype=dtype, rtol=rtol, maxiter=maxiter,
        fixed_iters=fixed_iters, record_gradient=record_gradient,
        differentiable=(fixed_iters is None and not record_gradient
                        and not f64_refine),
        warm_start=warm_start, rtol_wrt=rtol_wrt,
        precondition=precondition, f64_refine=f64_refine)
    # refine carries fields/coefficients in f64 (the stepper's cdt)
    wdt = jnp.float64 if f64_refine else dtype
    base_k = jnp.asarray(problem.kappas, wdt)
    rc = jnp.asarray(problem.rho_cvs, wdt)
    n = len(problem.mesh.nodes)
    ic = jnp.asarray(problem.ic_temp, wdt)

    # dev enters as an argument (not a closure constant — see stepper note)
    def one(dev, k, f, u0, t0):
        kp = base_k.at[m_idx].set(k)
        ys = fn.core(dev, kp, rc, f, u0, t0, None)
        if record_gradient:
            return ys
        return ys["watch"], ys["final_u"]

    _batched = lambda dev, ks, fs, u0, t0: jax.vmap(
        lambda k, f, u: one(dev, k, f, u, t0))(ks, fs, u0)
    if mesh is None:
        batched = jax.jit(_batched)
    else:
        # config-axis GSPMD: per-config fields sharded, problem arrays
        # replicated — each device integrates its shard of configs
        from jax.sharding import NamedSharding, PartitionSpec as P
        rep_sh = jax.tree.map(lambda _: NamedSharding(mesh, P()), fn.dev)
        cfg_sh = NamedSharding(mesh, P("config"))
        fld_sh = NamedSharding(mesh, P("config", None))
        sc_sh = NamedSharding(mesh, P())
        batched = jax.jit(
            _batched,
            in_shardings=(rep_sh, cfg_sh, cfg_sh, fld_sh, sc_sh))

    def simulate_batch(sample_k, fwhm):
        B = len(np.asarray(sample_k))
        u0 = jnp.full((B, n), ic, wdt)
        out = batched(fn.dev, jnp.asarray(sample_k, wdt),
                      jnp.asarray(fwhm, wdt), u0,
                      jnp.asarray(0.0, wdt))
        if record_gradient:
            # host-side times: the device copy is sharded over configs, and
            # row 0 is not addressable on every process of a multihost run
            # (same fix as the structured recording maker)
            out["times"] = np.arange(1, problem.num_steps + 1) * problem.dt
            return out
        return out[0]

    simulate_batch.times = (np.arange(1, problem.num_steps + 1) * problem.dt)
    simulate_batch.watcher_names = list(problem.watcher_names)
    if record_gradient:
        simulate_batch.band_centers = problem.bin_centers
        simulate_batch.axis_z = problem.axis_z
    cache[cache_key] = simulate_batch
    return simulate_batch


def solve_steady_unstructured(problem: ProblemUnstructured,
                              bc_values: np.ndarray, *, f=None,
                              weighted: bool = False, dtype=jnp.float64,
                              rtol: float = 1e-11, maxiter: int = 50000):
    """Steady conduction solve Σ_m κ_m K_m u = f on the ELL operators with
    Dirichlet lifting — the unstructured mirror of ``steady.solve_steady``
    (ref space_and_forms.py:119-149)."""
    ell = problem.ell
    Ksrc = ell.K_vals if weighted else ell.Kf_vals
    if Ksrc is None:
        raise ValueError("ELL ops lack unweighted stiffness; re-assemble")
    cols = jnp.asarray(ell.cols)
    from heatflow_tpu.ops.stencil import material_combine
    K = material_combine(jnp.asarray(problem.kappas, dtype),
                         jnp.asarray(Ksrc, dtype))
    free = jnp.asarray(~problem.dirichlet, dtype)
    dirich = jnp.asarray(problem.dirichlet, dtype)
    g = jnp.asarray(bc_values, dtype) * dirich

    diag = ell_diag(ell.cols, K)
    s = jax.lax.rsqrt(jnp.where(diag > 0, diag, 1.0)) * free + dirich
    apply_s = lambda y: s * ell_apply(cols, K, s * y)

    if f is None:
        b = jnp.zeros_like(g)
    else:
        Msrc = ell.M_vals if weighted else ell.Mf_vals
        M_unit = jnp.einsum("mnk->nk", jnp.asarray(Msrc, dtype))
        b = ell_apply(cols, M_unit, jnp.asarray(f, dtype))

    b_lift = (b - ell_apply(cols, K, g)) * s * free
    sol = pcg(apply_s, b_lift, jnp.zeros_like(g), mask=free, rtol=rtol,
              maxiter=maxiter)
    u = sol.x * s * free + g
    return np.asarray(u), {"iters": int(sol.iters),
                           "residual": float(sol.residual),
                           "converged": bool(sol.converged)}
