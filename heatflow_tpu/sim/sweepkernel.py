"""Batched sweep kernel: thousands of transient runs per device via vmap.

The reference runs sweeps as a multiprocessing pool of full processes, one
config at a time (ref parameter_sweep.py:436-446, sweep_test.py:104-107).
Here a sweep config differs from the base problem only in the sample
conductivity and the laser FWHM (ref modify_config_for_parameters,
parameter_sweep.py:238-266 — width changes rebuild the mesh and form separate
width groups), so the batched operator is expressed as

    A_b = A_base + dt * Δκ_b * K_sample

which keeps per-config memory to the solution fields only — the stencils are
shared across the whole batch. The entire time loop for the whole batch is
one jitted scan; lanes that diverge produce NaNs and are reported as failed
runs rather than crashing the batch (ref :447-509's serial fallback).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.ops.cg import pcg_fixed, pcg_solve, refined_solve
from heatflow_tpu.ops.linesolve import line_family_preconditioner
from heatflow_tpu.ops.stencil import apply_stencil, combine_operator
from heatflow_tpu.sim.problem import Problem2D
from heatflow_tpu.sim.stepper import PRECONDITIONERS, validate_refine
from heatflow_tpu.utils import resolve_solver


def make_sweep_fn(problem: Problem2D, *, vary_material: str = "p_sample",
                  dtype=jnp.float32, rtol: float = 1e-6,
                  maxiter: int = 4000, fixed_iters: int | None = None,
                  precondition: str = "jacobi",
                  num_steps: int | None = None, mesh=None,
                  solver: str = "auto", warm_start: str = "previous",
                  rtol_wrt: str = "b", f64_refine: int = 0):
    """Build simulate_batch(sample_k (B,), fwhm (B,)) -> watcher traces
    (B, S, W). vmappable/shardable along B; differentiable in both inputs
    (except under ``f64_refine``).

    ``simulate_batch.segment(ks, fs, u0, step0, u_pp=None)`` additionally
    returns the final and penultimate fields, enabling time-chunked
    execution of very large batches with exact warm-start history across
    chunks — set ``num_steps`` to the chunk length.

    ``mesh``: a ``jax.sharding.Mesh`` with a 'config' axis (and optionally a
    'z' axis, see parallel.config_mesh). The batch axis is sharded over
    'config' — each device integrates its shard of configs with no
    communication (the replacement for the reference's process pool, ref
    parameter_sweep.py:436-446) — and, when the grid divides, the field's z
    axis over 'z' with XLA-inserted halo exchange. Batch size must be a
    multiple of the 'config' axis size (callers pad).

    ``rtol_wrt``: "b" (default) stops each solve at ||r|| <= rtol·||b|| —
    with warm starts late steps stop almost immediately, the throughput
    regime. "r0" ties the tolerance to the warm-start residual (the
    increment scale) — the accuracy regime, with a smaller worst-lane
    deviation at a higher cost.

    ``solver``: 'auto' or 'xla' — both name the one XLA engine
    (:func:`heatflow_tpu.utils.resolve_solver`).

    ``warm_start='extrapolate'``: seed each step's CG with 2·u_n − u_{n−1}
    instead of u_n — free per iteration, and with ``fixed_iters`` it buys
    the same accuracy at a smaller iteration budget.

    ``f64_refine=N`` (dtype f32, needs x64): mixed-precision sweeps — every
    lane's step runs N passes of f64-operator residual around an f32
    correction solve (:func:`heatflow_tpu.ops.cg.refined_solve`), carrying
    fields in f64 (the sweep twin of
    ``stepper.make_simulate_fn(f64_refine=N)``). Breaks the f32
    representation floor per sweep lane.

    The built function is memoized on ``problem.extras`` keyed by every
    argument: repeated calls with identical parameters return the SAME
    compiled callable instead of re-tracing. Mutating the problem in place
    after the first call does not invalidate the cache; build a new
    Problem2D instead.
    """
    if f64_refine:
        # the refined inner correction solves stop wrt their own rhs (the
        # per-pass residual — increment-relative by construction), so the
        # outer rtol_wrt has no effect; normalize it out of the cache key
        rtol_wrt = "b"
    solver = resolve_solver(solver)
    cache_key = ("sweep_fn", vary_material, jnp.dtype(dtype).name, rtol,
                 maxiter, fixed_iters, precondition,
                 int(problem.num_steps if num_steps is None else num_steps),
                 mesh, solver, warm_start, rtol_wrt, f64_refine)
    cache = problem.extras.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if warm_start not in ("previous", "extrapolate"):
        # the sweep engines implement the linear seed only ('extrapolate2'
        # exists on the structured stepper alone) — raise instead of
        # silently degrading a typo'd/unsupported seed to 'previous'
        raise ValueError(f"unknown warm_start {warm_start!r} for sweep "
                         "engines (use 'previous' or 'extrapolate')")
    if precondition not in PRECONDITIONERS:
        raise ValueError(f"unknown precondition {precondition!r}")
    if f64_refine:
        validate_refine(dtype)
        if fixed_iters is not None:
            raise ValueError("f64_refine composes with the tolerance-based "
                             "solves (no fixed_iters)")
    # refine carries fields and residuals in f64: assemble the master
    # operator and the scan constants at f64; the f32 correction operands
    # are cast per config inside one_config
    wdt = jnp.float64 if f64_refine else dtype
    dev = problem.device_arrays(wdt)
    num_steps = int(problem.num_steps if num_steps is None else num_steps)
    dt = jnp.asarray(problem.dt, wdt)
    ic = jnp.asarray(problem.ic_temp, wdt)
    nz, nr = problem.mesh.shape
    if "watch_flat" not in dev:
        raise ValueError("sweeps need watcher points on the problem")

    # stencil slots are ordered by tag, i.e. by material insertion order
    m_idx = list(problem.mesh.material_tags).index(vary_material)
    base_k = float(problem.kappas[m_idx])

    A0, M_op = combine_operator(dev["K"], dev["M"], dev["kappas"],
                                dev["rho_cvs"], dt)
    # Arrays enter the jitted core as ARGUMENTS (not closure constants) to
    # avoid XLA constant-folding the whole operator at compile time.
    ops = {"A0": A0, "M_op": M_op, "K_var": dev["K"][m_idx],
           "free": dev["free"], "dirich": dev["dirichlet"],
           "base": dev["heat_profile_base"], "r_sq": dev["r_sq"],
           "heat_t": dev["heat_t"], "heat_T": dev["heat_T"],
           "watch": dev["watch_flat"], "mg": None}

    mg_shapes = None
    if precondition == "mg":
        from heatflow_tpu.ops.multigrid import build_hierarchy, device_levels
        hierarchy = build_hierarchy(problem.mesh, problem.dirichlet_mask,
                                    stencils=problem.stencils)
        mg_base, mg_shapes = [], []
        for lv in device_levels(hierarchy, dtype):
            mg_shapes.append(lv.pop("shape"))  # static, stays out of jit args
            A_l, _ = combine_operator(lv["K"], lv["M"], dev["kappas"],
                                      dev["rho_cvs"], dt)
            mg_base.append({**lv, "A0": A_l})
        ops["mg"] = mg_base

    extrapolate = warm_start == "extrapolate"

    def one_config(ops, sample_k, fwhm, u0=None, step0=0, u_pp=None):
        # wdt (not dtype): under f64_refine the ops/state are f64
        free, dirich = ops["free"], ops["dirich"]
        dk = (jnp.asarray(sample_k, wdt) - base_k) * dt
        apply_A = lambda v: (apply_stencil(ops["A0"], v)
                             + dk * apply_stencil(ops["K_var"], v))
        diag = ops["A0"][0] + dk * ops["K_var"][0]
        s = jax.lax.rsqrt(jnp.where(diag > 0, diag, 1.0)) * free + dirich
        apply_s = lambda y: s * apply_A(s * y)

        # the preconditioner acts on the system the CG solves: under
        # f64_refine the f32 casts of this config's scaled system (the f64
        # master computes only residuals)
        A_p, s_p, free_p = ops["A0"] + dk * ops["K_var"], s, free
        if f64_refine:
            A_p, s_p, free_p = (A_p.astype(dtype), s.astype(dtype),
                                free.astype(dtype))
            apply_s32 = lambda y: s_p * apply_stencil(A_p, s_p * y)
        if ops["mg"] is not None:
            from heatflow_tpu.ops.multigrid import make_vcycle
            level_ops = [{**lv, "A": (lv["A0"] + dk * lv["K"][m_idx]
                                      ).astype(A_p.dtype), "shape": shp}
                         for lv, shp in zip(ops["mg"], mg_shapes)]
            vcycle = make_vcycle(level_ops, nu_pre=1, nu_post=1)
            inv_s = 1.0 / jnp.where(s_p > 0, s_p, 1.0)
            pre = lambda r: inv_s * vcycle(inv_s * r)
        else:
            # per-config line factorization (the operator depends on
            # sample_k) — ~log2(N) elementwise passes, negligible against
            # a transient; vmaps over the config batch like the rest
            pre = line_family_preconditioner(precondition, A_p, s_p, free_p)

        amp_offset = ops["heat_T"][0] - ic
        coeff = jnp.asarray(-4.0 * np.log(2.0), wdt) / (fwhm * fwhm)
        profile = jnp.exp(coeff * ops["r_sq"]) * ops["base"]
        # the Dirichlet lift is affine in the interpolated amplitude:
        # g(t) = g0 + amp(t)·g1, so A g is precomputed ONCE per scan
        g0 = ic * (dirich - profile)
        g1 = profile
        Ag0 = apply_A(g0)
        Ag1 = apply_A(g1)

        def step(carry, t):
            u_prev, u_pp = carry
            amp = jnp.interp(t, ops["heat_t"], ops["heat_T"]) - amp_offset
            g = g0 + amp * g1
            b = (apply_stencil(ops["M_op"], u_prev)
                 - (Ag0 + amp * Ag1)) * s * free
            seed = 2.0 * u_prev - u_pp if extrapolate else u_prev
            y0 = (seed / jnp.where(s > 0, s, 1.0)) * free
            if f64_refine:
                x = refined_solve(apply_s, apply_s32, b, y0, free,
                                  passes=f64_refine, rtol=rtol,
                                  maxiter=maxiter, dtype=dtype,
                                  precond=pre)[0]
            elif fixed_iters is not None:
                x = pcg_fixed(apply_s, b, y0, precond=pre, mask=free,
                              iters=fixed_iters).x
            else:
                x = pcg_solve(apply_s, b, y0, precond=pre, mask=free,
                              rtol=rtol, maxiter=maxiter, rtol_wrt=rtol_wrt)
            u = x * s * free + g
            return (u, u_prev), u.reshape(-1)[ops["watch"]]

        u0 = jnp.full((nz, nr), ic, wdt) if u0 is None \
            else jnp.asarray(u0, wdt)
        u_pp = u0 if u_pp is None else jnp.asarray(u_pp, wdt)
        # times formed as (step0 + i)·dt in ONE rounding so a chunked run's
        # absolute times are bitwise those of the unchunked scan (adding
        # t0 = step0·dt separately rounds twice and the 1-ulp difference is
        # amplified by the gain-2 extrapolated seed)
        ts = (jnp.arange(1, num_steps + 1, dtype=wdt)
              + jnp.asarray(step0, wdt)) * dt
        (u_fin, u_pen), traces = jax.lax.scan(step, (u0, u_pp), ts)
        return traces, u_fin, u_pen

    _batched = lambda ops, ks, fs: jax.vmap(
        lambda k, f: one_config(ops, k, f)[0])(ks, fs)
    _batched_seg = lambda ops, ks, fs, u0, u_pp, step0: jax.vmap(
        lambda k, f, u, up: one_config(ops, k, f, u, step0, up)
    )(ks, fs, u0, u_pp)

    if mesh is None:
        batched = jax.jit(_batched)
        batched_seg = jax.jit(_batched_seg)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        z_shards = mesh.shape["z"] if "z" in mesh.axis_names else 1
        z_ok = z_shards > 1 and nz % z_shards == 0
        z_ax = "z" if z_ok else None

        def op_spec(x):
            nd = jnp.ndim(x)
            if nd == 3:                       # (7, Nz, Nr) stencils
                return P(None, z_ax, None)
            if nd == 2:                       # (Nz, Nr) masks/profiles
                return P(z_ax, None)
            return P()                        # curves, watcher ids

        def mg_level_spec(nz_l):
            # shard a coarse level along z only while its grid still divides
            # the axis; deeper (odd-sized) levels are replicated — GSPMD
            # inserts the gather at the level boundary, and coarse grids are
            # tiny so the communication is negligible
            z_l = z_ax if (z_ok and nz_l % z_shards == 0) else None

            def spec(x):
                nd = jnp.ndim(x)
                if nd == 4:                   # (n_mats, 7/9, Nz_l, Nr_l)
                    return P(None, None, z_l, None)
                if nd == 3:                   # combined operator A0
                    return P(None, z_l, None)
                if nd == 2 and x.shape[0] == nz_l:   # free mask
                    return P(z_l, None)
                return P()                    # 1D transfer index/weight rows

            return spec

        mg_sh = None
        if ops["mg"] is not None:
            mg_sh = [jax.tree.map(
                lambda x, sp=mg_level_spec(shp[0]): NamedSharding(mesh, sp(x)),
                lv) for lv, shp in zip(ops["mg"], mg_shapes)]
        ops_sh = jax.tree.map(
            lambda x: NamedSharding(mesh, op_spec(x)),
            {**ops, "mg": None})
        ops_sh["mg"] = mg_sh
        cfg_sh = NamedSharding(mesh, P("config"))
        field_sh = NamedSharding(mesh, P("config", z_ax, None))
        scalar_sh = NamedSharding(mesh, P())
        batched = jax.jit(_batched,
                          in_shardings=(ops_sh, cfg_sh, cfg_sh),
                          out_shardings=cfg_sh)
        batched_seg = jax.jit(_batched_seg,
                              in_shardings=(ops_sh, cfg_sh, cfg_sh,
                                            field_sh, field_sh, scalar_sh),
                              out_shardings=(cfg_sh, field_sh, field_sh))

    def simulate_batch(sample_k, fwhm):
        return batched(ops, jnp.asarray(sample_k, wdt),
                       jnp.asarray(fwhm, wdt))

    def segment(sample_k, fwhm, u0, step0, u_pp=None):
        """(traces (B, S, W), u_fin, u_penultimate) for one time chunk
        starting after integer step offset ``step0`` (times are formed as
        (step0+i)·dt on device so chunked runs hit the unchunked absolute
        times bitwise). Pass the previous chunk's u_penultimate as
        ``u_pp`` so warm_start='extrapolate' seeds the chunk's first step
        from real history (omitted: seeds from u0, i.e. a fresh start)."""
        u0 = jnp.asarray(u0, wdt)
        u_pp = u0 if u_pp is None else jnp.asarray(u_pp, wdt)
        return batched_seg(ops, jnp.asarray(sample_k, wdt),
                           jnp.asarray(fwhm, wdt), u0, u_pp,
                           jnp.asarray(step0, wdt))

    simulate_batch.segment = segment
    simulate_batch.one_config = lambda k, f: one_config(ops, k, f)[0]
    simulate_batch.shape = (nz, nr)
    simulate_batch.ic_temp = float(problem.ic_temp)
    simulate_batch.dt = float(problem.dt)
    simulate_batch.times = (np.arange(1, num_steps + 1) * problem.dt)
    cache[cache_key] = simulate_batch
    return simulate_batch


def make_sweep_fn_recording(problem: Problem2D, *,
                            vary_material: str = "p_sample",
                            dtype=jnp.float32, rtol: float = 1e-6,
                            maxiter: int = 4000,
                            fixed_iters: int | None = None,
                            warm_start: str = "previous", mesh=None,
                            rtol_wrt: str = "b", f64_refine: int = 0,
                            solver: str = "auto",
                            precondition: str = "jacobi",
                            proj_rtol: float = 1e-11,
                            proj_maxiter: int = 400):
    """Full-surface sweep: the COMPLETE stepper (watcher + radial-gradient
    accumulation, per-step r-weighted L2 projection) vmapped over configs —
    the artifact-parity mode matching the reference, where every sweep run
    writes radial_gradient[_raw].csv (ref parameter_sweep.py:157-166 →
    run_no_diamond.py:602-617). Costs one extra projection solve per step
    per config vs ``make_sweep_fn``; use it when sweep members feed the
    2D→fit→1D pipeline. Returns simulate_batch(ks, fs) -> dict with
    ``watch`` (B, S, W), ``band`` (B, S, n_bins), ``axis`` (B, S, Nz).

    ``mesh``: shard the batch over the mesh's 'config' axis (batch size
    must be a multiple of the axis size — callers pad).

    Batched coefficients must not reach the material contraction as a
    ``dot_general``: at default precision an accelerator may run it with
    reduced-precision inputs, and the perturbed backward-Euler operator
    (scaled condition ~1e6) goes indefinite, so CG hits maxiter on every
    lane of a batch while the identical single config converges.
    ``ops.stencil.material_combine`` is a statically-unrolled
    multiply-add, exact in f32; lowering-level regression tests pin the
    no-dot_general property (tests/test_round3_fixes.py)."""
    from heatflow_tpu.sim.stepper import make_simulate_fn
    if f64_refine:
        rtol_wrt = "b"   # no effect on refined inner solves (see above)
    solver = resolve_solver(solver)
    cache_key = ("sweep_fn_rec", vary_material, jnp.dtype(dtype).name, rtol,
                 maxiter, fixed_iters, warm_start, mesh, rtol_wrt,
                 f64_refine, solver, precondition, proj_rtol, proj_maxiter)
    cache = problem.extras.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if problem.radial is None:
        raise ValueError("gradient-recording sweeps need radial sampling "
                         "on the problem")
    # rtol_wrt defaults to 'b' to match the plain sweep path's stopping
    # rule, so toggling record_gradient does not change watcher traces at
    # a given rtol; 'r0' selects the increment-relative accuracy regime.
    # f64_refine vmaps the refined stepper (the XLA-path inner corrector;
    # dtype/x64/fixed_iters validated in make_simulate_fn) — artifact-
    # parity sweeps with f64-operator trajectories per lane.
    fn = make_simulate_fn(problem, dtype=dtype, rtol=rtol, maxiter=maxiter,
                          fixed_iters=fixed_iters, record_gradient=True,
                          warm_start=warm_start, rtol_wrt=rtol_wrt,
                          f64_refine=f64_refine, precondition=precondition,
                          proj_rtol=proj_rtol, proj_maxiter=proj_maxiter)
    m_idx = list(problem.mesh.material_tags).index(vary_material)
    # refine carries fields/coefficients in f64 (stepper cdt)
    wdt = jnp.float64 if f64_refine else dtype
    base_kp = np.asarray(problem.kappas, float)
    rc = jnp.asarray(problem.rho_cvs, wdt)
    nz, nr = problem.mesh.shape
    ic = jnp.asarray(problem.ic_temp, wdt)

    def _batched(dev, mg, kps, fs, u0):
        return jax.vmap(
            lambda kp, f, u: fn.core(dev, mg, kp, rc, f, u,
                                     jnp.asarray(0.0, wdt), None),
            in_axes=(0, 0, 0))(kps, fs, u0)

    if mesh is None:
        batched = jax.jit(_batched)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        rep = NamedSharding(mesh, P())
        cfg_sh = NamedSharding(mesh, P("config"))
        batched = jax.jit(
            _batched,
            in_shardings=(jax.tree.map(lambda _: rep, fn.dev),
                          jax.tree.map(lambda _: rep, fn.mg),
                          cfg_sh, cfg_sh,
                          NamedSharding(mesh, P("config", None, None))),
            out_shardings=cfg_sh)

    def simulate_batch(sample_k, fwhm):
        B = len(np.asarray(sample_k))
        kps = np.repeat(base_kp[None], B, axis=0)
        kps[:, m_idx] = np.asarray(sample_k)
        u0 = jnp.full((B, nz, nr), ic, wdt)
        ys = batched(fn.dev, fn.mg, jnp.asarray(kps, wdt),
                     jnp.asarray(fwhm, wdt), u0)
        # host-side times: the device copy is sharded over configs, and
        # row 0 is not addressable on every process of a multihost run
        ys["times"] = np.arange(1, problem.num_steps + 1) * problem.dt
        return ys

    simulate_batch.times = (np.arange(1, problem.num_steps + 1) * problem.dt)
    simulate_batch.band_centers = problem.radial.bin_centers
    simulate_batch.axis_z = problem.radial.axis_z
    simulate_batch.watcher_names = list(problem.watcher_names)
    cache[cache_key] = simulate_batch
    return simulate_batch


def balanced_chunk_len(total: int, step_chunk: int) -> int:
    """Balance chunk lengths over ceil(total/step_chunk) chunks: a ragged
    final chunk re-runs the FULL compiled segment and discards the surplus
    steps (each a real solve: 40 steps at step_chunk=25 as 25+25-keep-15
    do 50 steps of work). Ceil-balancing
    (40 -> 20+20) never exceeds step_chunk, keeps one compile, and cuts the
    discarded surplus to < n_chunks steps total."""
    total = int(total)
    n_chunks = max(1, -(-total // max(1, int(step_chunk))))
    return min(-(-total // n_chunks), total)


def run_sweep_time_chunked(problem: Problem2D, sample_k, fwhm, *,
                           step_chunk: int = 10, dtype=jnp.float32,
                           fixed_iters: int | None = None,
                           rtol: float = 1e-5, maxiter: int = 4000,
                           precondition: str = "jacobi",
                           verbose: bool = False, mesh=None,
                           solver: str = "auto", warm_start: str = "previous",
                           rtol_wrt: str = "b", f64_refine: int = 0):
    """Run the full transient for a (possibly very large) batch with bounded
    device-call durations: the whole batch stays resident while time is
    integrated chunk by chunk. Returns traces (B, num_steps, W). Structured
    problems only.

    ``step_chunk`` is an upper bound on steps per device call; the actual
    chunk length is ceil-balanced over the resulting number of chunks
    (e.g. 40 steps at step_chunk=25 run as 20+20, not 25+25-discard-10),
    since a ragged tail re-runs the full compiled segment.

    ``mesh``: shard the batch axis over the mesh's 'config' devices (the
    batch is padded to a multiple of the axis size and sliced back).

    ``warm_start='extrapolate'`` is exact across chunk boundaries: the
    penultimate field of each chunk is threaded into the next, so the
    chunked trajectory equals the unchunked one bitwise (pinned in
    tests/test_warmstart.py).

    ``rtol_wrt`` and ``f64_refine`` thread into the underlying sweep
    maker — chunked mixed-precision sweeps carry the
    f64 fields across chunk boundaries exactly
    (tests/test_sweep_refine.py)."""
    total = int(problem.num_steps)
    chunk_len = balanced_chunk_len(total, step_chunk)
    if not isinstance(problem, Problem2D):
        raise ValueError("time-chunked sweeps need a structured problem "
                         "(the unstructured sweep maker has no segment API)")
    fn = make_sweep_fn(problem, dtype=dtype, fixed_iters=fixed_iters,
                       rtol=rtol, maxiter=maxiter,
                       precondition=precondition, num_steps=chunk_len,
                       mesh=mesh, solver=solver, warm_start=warm_start,
                       rtol_wrt=rtol_wrt, f64_refine=f64_refine)
    sample_k = np.asarray(sample_k)
    fwhm = np.asarray(fwhm)
    B = len(sample_k)
    if mesh is not None:
        from heatflow_tpu.utils import pad_to_multiple
        nc = mesh.shape["config"]
        sample_k = pad_to_multiple(sample_k, nc)
        fwhm = pad_to_multiple(fwhm, nc)
    nz, nr = fn.shape
    # segment() casts its field inputs to the maker's working dtype (f64
    # under refine), so plain-dtype init buffers are correct here
    u = jnp.full((len(sample_k), nz, nr), fn.ic_temp, dtype)
    u_pp = u
    pieces = []
    done = 0
    while done < total:
        n = min(chunk_len, total - done)
        # A ragged final chunk runs the same compiled full-length segment and
        # keeps only its first n steps (the discarded steps integrate past
        # t_final, where the heating interp clamps) — exactly one compile per
        # sweep shape instead of a recompile for the tail.
        tr, u, u_pp = fn.segment(sample_k, fwhm, u, done, u_pp)
        tr.block_until_ready()
        pieces.append(np.asarray(tr)[:, :n])
        done += n
        if verbose:
            print(f"  time chunk done: {done}/{total} steps")
    return np.concatenate(pieces, axis=1)[:B]


def normalized_oside_residuals(times, traces, exp_time, exp_oside_normed,
                               pside_col: int = 0, oside_col: int = 1):
    """Per-experimental-point residuals of the reference's fit metric
    (normalized o-side trace minus experiment, ref no_diamond.py:65-99):
    traces (..., S, W) -> residuals (..., N_exp). Differentiable — the
    Jacobian ∂residuals/∂(κ, FWHM) through the implicit-diff solve is what
    parameter standard errors are built from (drivers/fit.py)."""
    pside = traces[..., pside_col]
    oside = traces[..., oside_col]
    span = pside.max(axis=-1) - pside.min(axis=-1)
    # a flat p-side trace (e.g. the zero-amplitude FWHM corner of a sweep
    # box) has no normalization scale; surface +inf residuals — a
    # diagnosable "degenerate heating" signal — instead of 0/0 NaNs. The
    # where-inside-where keeps gradients NaN-free on the live branch.
    degenerate = span <= 0
    denom = jnp.where(degenerate, 1.0, span)
    normed = (oside - oside[..., :1]) / denom[..., None]

    def interp_one(vals):
        return jnp.interp(exp_time, times, vals)

    flat = normed.reshape((-1, normed.shape[-1]))
    sim_at_exp = jax.vmap(interp_one)(flat)
    sim_at_exp = sim_at_exp.reshape(normed.shape[:-1] + (len(exp_time),))
    res = sim_at_exp - exp_oside_normed
    return jnp.where(degenerate[..., None], jnp.inf, res)


def normalized_oside_rmse(times, traces, exp_time, exp_oside_normed,
                          pside_col: int = 0, oside_col: int = 1):
    """On-device sweep objective: the reference's fit metric — normalized
    o-side RMSE against the experimental trace (ref no_diamond.py:65-99,
    analysis_utils.py:66-93). traces: (..., S, W). Differentiable, so sweeps
    can be replaced by gradient-based fitting."""
    err = normalized_oside_residuals(times, traces, exp_time,
                                     exp_oside_normed, pside_col, oside_col)
    return jnp.sqrt(jnp.mean(err * err, axis=-1))
