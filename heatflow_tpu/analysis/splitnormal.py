"""Split-normal (two-sided Gaussian) fitting of radial-gradient profiles.

Reference: gaussian_fit_analysis.py:24-201 fits, per timestep, the 5-parameter
model (amplitude, center, sigma_left, sigma_right, offset) with
scipy.curve_fit and a ±amplitude initial-guess race; a second pass re-fits
only the amplitude with shape parameters frozen to their time averages; the
fitted curves export to a gradient-format CSV consumed by the corrected 1D
model (ref no_diamond_1d.py:41-54).

Accelerator re-design: a damped Gauss-Newton (Levenberg-Marquardt) solver with
analytic Jacobians, vmapped over (timestep × initial guess) so the entire
time series fits in one jitted call; the amplitude-only pass is solved in
closed form (it is linear least squares).
"""

from __future__ import annotations

import argparse
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "split_normal_function",
    "fit_split_normal_to_profile",
    "fit_split_normal_amplitude_only",
    "analyze_split_normal_fits",
    "analyze_split_normal_fits_amplitude_only",
    "save_fitted_curves_csv",
    "save_fit_results",
    "plot_split_normal_analysis",
    "plot_fit_comparison",
    "plot_comparison_raw_vs_amp_only",
    "plot_residual_analysis",
]


def split_normal_function(r, amplitude, center, sigma_left, sigma_right,
                          offset=0.0):
    """Two-sided Gaussian: different widths left/right of center
    (ref gaussian_fit_analysis.py:24-52)."""
    r = np.asarray(r) if not isinstance(r, jnp.ndarray) else r
    sig = jnp.where(r < center, sigma_left, sigma_right) \
        if isinstance(r, jnp.ndarray) else \
        np.where(r < center, sigma_left, sigma_right)
    xp = jnp if isinstance(r, jnp.ndarray) else np
    return amplitude * xp.exp(-0.5 * ((r - center) / sig) ** 2) + offset


def generalized_gaussian_function(r, amplitude, center, sigma_left,
                                  sigma_right, power, offset=0.0):
    """Split generalized Gaussian: A·exp(-0.5 |(r-c)/σ±|^p) + offset — the
    6-parameter variant behind the reference's generalized_gaussian_fit_*
    artifacts (power = 2 recovers the split normal)."""
    xp = jnp if isinstance(r, jnp.ndarray) else np
    sig = xp.where(r < center, sigma_left, sigma_right)
    u = xp.abs((r - center) / sig)
    return amplitude * xp.exp(-0.5 * u ** power) + offset


def fit_generalized_gaussian_to_profile(radial_positions, gradient_values):
    """Fit the 6-parameter generalized Gaussian: split-normal LM fit first,
    then a scalar search over the exponent with amplitude re-solved in
    closed form. Returns ([amp, center, sl, sr, power, offset], rmse)."""
    r = np.asarray(radial_positions, float)
    y = np.asarray(gradient_values, float)
    params, _ = fit_split_normal_to_profile(r, y)
    amp, c, sl, sr, off = params
    valid = np.isfinite(y) & np.isfinite(r)
    rv, yv = r[valid], y[valid]
    best = (params + [2.0], np.inf)
    for p in np.linspace(0.8, 4.0, 33):
        basis = generalized_gaussian_function(rv, 1.0, c, sl, sr, p, 0.0)
        denom = basis @ basis
        a = float(basis @ (yv - off)) / denom if denom > 0 else 0.0
        rmse = float(np.sqrt(np.mean((yv - (a * basis + off)) ** 2)))
        if rmse < best[1]:
            best = ([a, c, sl, sr, float(p), off], rmse)
    return best


def _model_and_jac(params, r):
    amp, c, sl, sr, off = params
    sig = jnp.where(r < c, sl, sr)
    u = (r - c) / sig
    e = jnp.exp(-0.5 * u * u)
    f = amp * e + off
    d_amp = e
    d_c = amp * e * u / sig
    d_sig = amp * e * u * u / sig
    d_sl = jnp.where(r < c, d_sig, 0.0)
    d_sr = jnp.where(r < c, 0.0, d_sig)
    d_off = jnp.ones_like(r)
    J = jnp.stack([d_amp, d_c, d_sl, d_sr, d_off], axis=-1)
    return f, J


def _project(params, r_lo, r_hi):
    amp, c, sl, sr, off = params
    r_range = r_hi - r_lo
    return jnp.stack([amp, jnp.clip(c, r_lo, r_hi),
                      jnp.clip(sl, 1e-12, r_range),
                      jnp.clip(sr, 1e-12, r_range), off])


def normal_equations(J, w, res):
    """Gauss-Newton gradient ``Jᵀ res`` and normal matrix ``Jᵀ diag(w) J``.
    Full-precision contractions: at default precision a GPU may run an f32
    matmul in TF32 (~3 significant digits), too coarse for the LM step."""
    g = jnp.matmul(J.T, res, precision="highest")
    H = jnp.matmul((J * w[:, None]).T, J, precision="highest")
    return g, H


@partial(jax.jit, static_argnames=("iters",))
def _lm_fit(r, y, p0, r_lo, r_hi, iters: int = 60):
    """Levenberg-Marquardt on the 5-parameter model, masked-NaN aware."""
    valid = jnp.isfinite(y) & jnp.isfinite(r)
    w = valid.astype(y.dtype)
    y0 = jnp.where(valid, y, 0.0)

    def body(state, _):
        p, lam, best_p, best_err = state
        f, J = _model_and_jac(p, r)
        res = (y0 - jnp.where(valid, f, 0.0)) * w
        g, H = normal_equations(J, w, res)
        step = jnp.linalg.solve(H + lam * jnp.diag(jnp.diag(H))
                                + 1e-30 * jnp.eye(5), g)
        p_new = _project(p + step, r_lo, r_hi)
        f_new, _ = _model_and_jac(p_new, r)
        err_new = jnp.sum(((y0 - f_new) * w) ** 2)
        err_old = jnp.sum(res ** 2)
        improved = err_new < err_old
        p = jnp.where(improved, p_new, p)
        lam = jnp.where(improved, lam * 0.5, lam * 2.5)
        lam = jnp.clip(lam, 1e-12, 1e12)
        better = err_new < best_err
        best_p = jnp.where(better, p_new, best_p)
        best_err = jnp.where(better, err_new, best_err)
        return (p, lam, best_p, best_err), None

    init_err = jnp.sum(((y0 - _model_and_jac(p0, r)[0]) * w) ** 2)
    state = (p0, jnp.asarray(1e-3, y.dtype), p0, init_err)
    (p, _lam, best_p, best_err), _ = jax.lax.scan(body, state, None,
                                                  length=iters)
    n = jnp.maximum(jnp.sum(w), 1.0)
    rmse = jnp.sqrt(best_err / n)
    return best_p, rmse


@partial(jax.jit, static_argnames=("sweeps", "probes"))
def _minimax_refine(r, y, p0, r_lo, r_hi, sweeps: int = 40,
                    probes: int = 16):
    """True minimax polishing: minimize max|y - f(p)| by cyclic coordinate
    search with a shrinking bracket (the jit/vmap-friendly equivalent of the
    reference's Powell minimize on max_abs_error,
    ref gaussian_fit_analysis.py:91-96). Warm-started from the LM solution.
    """
    valid = jnp.isfinite(y) & jnp.isfinite(r)
    w = valid.astype(y.dtype)
    y0 = jnp.where(valid, y, 0.0)

    def maxerr(p):
        f, _ = _model_and_jac(p, r)
        return jnp.max(jnp.abs(y0 - jnp.where(valid, f, 0.0)) * w)

    # per-parameter step scales: fractions of the parameter magnitudes
    data_scale = jnp.max(jnp.abs(y0)) + 1e-30
    span = r_hi - r_lo
    base = jnp.stack([jnp.abs(p0[0]) + 0.1 * data_scale,
                      0.25 * span,
                      jnp.abs(p0[2]) + 0.05 * span,
                      jnp.abs(p0[3]) + 0.05 * span,
                      jnp.abs(p0[4]) + 0.1 * data_scale])
    offsets = jnp.linspace(-1.0, 1.0, probes)   # symmetric probe grid

    def coord_step(carry, _):
        p, step, j = carry

        def probe(off):
            cand = _project(p.at[j].add(off * step[j]), r_lo, r_hi)
            return maxerr(cand)

        errs = jax.vmap(probe)(offsets)
        k = jnp.argmin(errs)
        best = _project(p.at[j].add(offsets[k] * step[j]), r_lo, r_hi)
        improved = errs[k] < maxerr(p)
        p = jnp.where(improved, best, p)
        # after a full cycle over the 5 coordinates, shrink the bracket
        step = jnp.where(j == 4, step * 0.7, step)
        return (p, step, (j + 1) % 5), None

    init = (p0, 0.5 * base, jnp.asarray(0))
    (p, _s, _j), _ = jax.lax.scan(coord_step, init, None, length=5 * sweeps)
    return p, maxerr(p)


def _initial_guesses(r, y):
    valid = np.isfinite(y) & np.isfinite(r)
    rv, yv = r[valid], y[valid]
    amp_abs = float(np.abs(yv.max() - yv.min()))
    center = float(rv[np.argmax(np.abs(yv))])
    sigma = float(np.std(rv) / 4) if np.std(rv) > 0 else 1e-6
    offset = float(yv.min())
    return [np.array([amp_abs, center, sigma, sigma, offset]),
            np.array([-amp_abs, center, sigma, sigma, offset])]


def fit_split_normal_to_profile(radial_positions, gradient_values,
                                initial_guess=None, fit_method="rmse"):
    """Fit one profile; returns (params list, error) — the reference's
    single-profile API (ref :55-103). The ±amplitude guess race is kept.

    fit_method='maxerr' performs a true minimax optimization (coordinate-
    search polish of max|err| warm-started from the LM/RMSE solution),
    matching the reference's Powell minimize on max_abs_error (ref :91-96)
    rather than merely re-scoring the RMSE optimum."""
    r = np.asarray(radial_positions, float)
    y = np.asarray(gradient_values, float)
    valid = np.isfinite(y) & np.isfinite(r)
    if valid.sum() < 4:
        return [0.0, 0.0, 1.0, 1.0, 0.0], np.inf
    guesses = ([np.asarray(initial_guess, float)] if initial_guess is not None
               else _initial_guesses(r, y))
    r_lo, r_hi = float(r[valid].min()), float(r[valid].max())
    best = ([0.0, 0.0, 1.0, 1.0, 0.0], np.inf)
    for g in guesses:
        p, rmse = _lm_fit(jnp.asarray(r), jnp.asarray(y), jnp.asarray(g),
                          r_lo, r_hi)
        if fit_method == "maxerr":
            p, err = _minimax_refine(jnp.asarray(r), jnp.asarray(y), p,
                                     r_lo, r_hi)
            p, err = np.asarray(p), float(err)
        else:
            p, err = np.asarray(p), float(rmse)
        if err < best[1]:
            best = (list(map(float, p)), err)
    return best


def fit_split_normal_amplitude_only(radial_positions, gradient_values,
                                    fixed_params):
    """Amplitude-only refit with frozen shape — linear least squares, solved
    in closed form (ref :106-126 uses curve_fit for the same problem)."""
    center, sigma_left, sigma_right, offset = fixed_params
    r = np.asarray(radial_positions, float)
    y = np.asarray(gradient_values, float)
    valid = np.isfinite(y) & np.isfinite(r)
    if valid.sum() < 4:
        return 0.0, np.inf
    rv, yv = r[valid], y[valid]
    basis = split_normal_function(rv, 1.0, center, sigma_left, sigma_right,
                                  0.0)
    denom = float(basis @ basis)
    amp = float(basis @ (yv - offset)) / denom if denom > 0 else 0.0
    rmse = float(np.sqrt(np.mean((yv - (amp * basis + offset)) ** 2)))
    return amp, rmse


def analyze_split_normal_fits(plotter, fit_method="rmse") -> dict:
    """Fit every timestep (ref :129-176). All timesteps and both initial
    guesses fit in one vmapped LM call."""
    times = np.asarray(plotter.time_values, float)
    r = np.asarray(plotter.radial_positions, float)
    grid = plotter.data.iloc[:, 1:].to_numpy(float)

    guesses = np.stack([np.stack(_initial_guesses(r, row)) for row in grid])
    r_lo, r_hi = float(np.nanmin(r)), float(np.nanmax(r))

    fit2 = jax.vmap(lambda y, gs: jax.vmap(
        lambda g: _lm_fit(jnp.asarray(r), y, g, r_lo, r_hi))(gs))
    ps, rmses = fit2(jnp.asarray(grid), jnp.asarray(guesses))
    if fit_method == "maxerr":
        # vmapped minimax polish of every (timestep × guess) LM solution
        refine2 = jax.vmap(lambda y, pp: jax.vmap(
            lambda p: _minimax_refine(jnp.asarray(r), y, p, r_lo, r_hi))(pp))
        ps, rmses = refine2(jnp.asarray(grid), ps)
    ps, rmses = np.asarray(ps), np.asarray(rmses)
    pick = rmses.argmin(axis=1)
    params = ps[np.arange(len(times)), pick]
    errs = rmses[np.arange(len(times)), pick]

    r2 = np.empty(len(times))
    for i, row in enumerate(grid):
        valid = np.isfinite(row)
        f = split_normal_function(r[valid], *params[i])
        ss_res = np.sum((row[valid] - f) ** 2)
        ss_tot = np.sum((row[valid] - row[valid].mean()) ** 2)
        r2[i] = 1 - ss_res / ss_tot if ss_tot > 0 else 0.0

    return {
        "time_values": times,
        "amplitudes": params[:, 0], "centers": params[:, 1],
        "sigma_lefts": params[:, 2], "sigma_rights": params[:, 3],
        "offsets": params[:, 4], "rmse_values": errs,
        "r_squared_values": r2,
    }


def analyze_split_normal_fits_amplitude_only(plotter, avg_center,
                                             avg_sigma_left, avg_sigma_right,
                                             avg_offset) -> dict:
    """Amplitude-only pass with frozen averaged shape (ref :179-201)."""
    times = np.asarray(plotter.time_values, float)
    r = np.asarray(plotter.radial_positions, float)
    grid = plotter.data.iloc[:, 1:].to_numpy(float)
    amps, rmses = [], []
    for row in grid:
        a, e = fit_split_normal_amplitude_only(
            r, row, [avg_center, avg_sigma_left, avg_sigma_right, avg_offset])
        amps.append(a)
        rmses.append(e)
    return {"time_values": times, "amplitudes": np.asarray(amps),
            "center": avg_center, "sigma_left": avg_sigma_left,
            "sigma_right": avg_sigma_right, "offset": avg_offset,
            "rmse_values": np.asarray(rmses)}


def save_fitted_curves_csv(results: dict, radial_positions, path: str):
    """Write fitted curves in the gradient-CSV format so run_1d can consume
    them as a radial_gradient_path (ref :431-440, no_diamond_1d.py:41)."""
    from heatflow_tpu.io.csvio import write_gradient_csv
    r = np.asarray(radial_positions, float)
    times = results["time_values"]
    if "centers" in results:
        rows = np.stack([
            split_normal_function(r, a, c, sl, sr, o)
            for a, c, sl, sr, o in zip(
                results["amplitudes"], results["centers"],
                results["sigma_lefts"], results["sigma_rights"],
                results["offsets"])])
    else:
        rows = np.stack([
            split_normal_function(r, a, results["center"],
                                  results["sigma_left"],
                                  results["sigma_right"], results["offset"])
            for a in results["amplitudes"]])
    write_gradient_csv(path, times, r, rows)


def plot_split_normal_analysis(results, save_path=None, show_plot=True):
    """Parameter-evolution panel (ref :204-428, condensed)."""
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    t = results["time_values"]
    panels = [("amplitudes", "Amplitude (K/m)"),
              ("centers", "Center (m)"), ("sigma_lefts", "σ_left (m)"),
              ("sigma_rights", "σ_right (m)"), ("offsets", "Offset (K/m)"),
              ("rmse_values", "Fit RMSE (K/m)")]
    for ax, (key, label) in zip(axes.ravel(), panels):
        if key in results:
            ax.plot(t, results[key], "o-", ms=3)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)
    fig.suptitle("Split-normal fit evolution")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    if show_plot:
        plt.show()
    else:
        plt.close(fig)
    return fig, axes


def save_fit_results(results: dict, output_path: str) -> None:
    """Export the per-timestep fit parameters/quality as a CSV
    (ref gaussian_fit_analysis.py:356-379: columns time, amplitude, center,
    sigma_left, sigma_right, offset, rmse, r_squared)."""
    import pandas as pd
    pd.DataFrame({
        "time": results["time_values"],
        "amplitude": results["amplitudes"],
        "center": results["centers"],
        "sigma_left": results["sigma_lefts"],
        "sigma_right": results["sigma_rights"],
        "offset": results["offsets"],
        "rmse": results["rmse_values"],
        "r_squared": results["r_squared_values"],
    }).to_csv(output_path, index=False)
    print(f"Split Normal fit results saved to: {output_path}")


def plot_fit_comparison(plotter, results, time_indices, save_path=None,
                        show_plot=True):
    """Fitted curve vs raw data at chosen timesteps — the visual check
    that a fit is trustworthy at a given time
    (ref gaussian_fit_analysis.py:282-353)."""
    import matplotlib.pyplot as plt
    r = np.asarray(plotter.radial_positions, float)
    grid = plotter.data.iloc[:, 1:].to_numpy(float)
    fig, ax = plt.subplots(figsize=(12, 8))
    colors = plt.get_cmap("viridis")(np.linspace(0, 1,
                                                 max(len(time_indices), 1)))
    for i, ti in enumerate(time_indices):
        if ti >= len(results["time_values"]):
            continue
        t = results["time_values"][ti]
        ax.plot(r, grid[ti, :], "o", color=colors[i], markersize=4,
                alpha=0.7, label=f"t={t:.2e}s (data)")
        f = split_normal_function(
            r, results["amplitudes"][ti], results["centers"][ti],
            results["sigma_lefts"][ti], results["sigma_rights"][ti],
            results["offsets"][ti])
        ax.plot(r, f, "-", color=colors[i], linewidth=2, alpha=0.8,
                label=(f"t={t:.2e}s (fit, "
                       f"RMSE={results['rmse_values'][ti]:.2e}, "
                       f"R²={results['r_squared_values'][ti]:.3f})"))
    ax.set_xlabel("Radial Position (m)", fontsize=12)
    ax.set_ylabel("Radial Temperature Gradient (K/m)", fontsize=12)
    ax.set_title("Split Normal Fit Comparison at Selected Time Points",
                 fontsize=14, fontweight="bold")
    ax.grid(True, alpha=0.3)
    ax.legend(bbox_to_anchor=(1.05, 1), loc="upper left", fontsize=10)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
        print(f"Fit comparison plot saved to: {save_path}")
    if show_plot:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def plot_comparison_raw_vs_amp_only(plotter, raw_results, amp_only_results,
                                    time_indices, save_path=None,
                                    show_plot=True):
    """Data + full fit + amplitude-only fit side by side at chosen
    timesteps (ref gaussian_fit_analysis.py:382-428). ``amp_only_results``
    carries scalar shape parameters (center/sigma_left/sigma_right/offset)
    as produced by :func:`analyze_split_normal_fits_amplitude_only`."""
    import matplotlib.pyplot as plt
    r = np.asarray(plotter.radial_positions, float)
    grid = plotter.data.iloc[:, 1:].to_numpy(float)
    fig, ax = plt.subplots(figsize=(12, 8))
    colors = plt.get_cmap("tab10")(np.linspace(0, 1,
                                               max(len(time_indices), 1)))
    for i, ti in enumerate(time_indices):
        if ti >= len(raw_results["time_values"]):
            continue
        t = raw_results["time_values"][ti]
        ax.scatter(r, grid[ti, :], color=colors[i], s=18, alpha=0.6,
                   label=f"t={t:.2e}s (data)")
        f_raw = split_normal_function(
            r, raw_results["amplitudes"][ti], raw_results["centers"][ti],
            raw_results["sigma_lefts"][ti], raw_results["sigma_rights"][ti],
            raw_results["offsets"][ti])
        ax.plot(r, f_raw, color=colors[i], linestyle="-", linewidth=2,
                alpha=0.8, label=(f"t={t:.2e}s (raw, "
                                  f"RMSE={raw_results['rmse_values'][ti]:.1e})"))
        f_amp = split_normal_function(
            r, amp_only_results["amplitudes"][ti],
            amp_only_results["center"], amp_only_results["sigma_left"],
            amp_only_results["sigma_right"], amp_only_results["offset"])
        ax.plot(r, f_amp, color=colors[i], linestyle="--", linewidth=2,
                alpha=0.8,
                label=(f"t={t:.2e}s (amp-only, "
                       f"RMSE={amp_only_results['rmse_values'][ti]:.1e})"))
    ax.set_xlabel("Radial Position (m)", fontsize=12)
    ax.set_ylabel("Radial Temperature Gradient (K/m)", fontsize=12)
    ax.set_title("Raw vs Amplitude-Only Split Normal Fit Comparison",
                 fontsize=14, fontweight="bold")
    ax.grid(True, alpha=0.3)
    ax.legend(bbox_to_anchor=(1.05, 1), loc="upper left", fontsize=10)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
        print(f"Raw vs amplitude-only comparison plot saved to: {save_path}")
    if show_plot:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def plot_residual_analysis(plotter, results, save_path=None, show_plot=True):
    import matplotlib.pyplot as plt
    r = np.asarray(plotter.radial_positions, float)
    grid = plotter.data.iloc[:, 1:].to_numpy(float)
    resid = np.stack([
        grid[i] - split_normal_function(
            r, results["amplitudes"][i], results["centers"][i],
            results["sigma_lefts"][i], results["sigma_rights"][i],
            results["offsets"][i])
        for i in range(len(results["time_values"]))])
    fig, ax = plt.subplots(figsize=(10, 6))
    vmax = np.abs(resid).max()
    im = ax.pcolormesh(r, results["time_values"], resid, cmap="RdBu_r",
                       vmin=-vmax, vmax=vmax, shading="nearest")
    fig.colorbar(im, ax=ax, label="Residual (K/m)")
    ax.set_xlabel("Radial Position (m)")
    ax.set_ylabel("Time (s)")
    ax.set_title("Split-normal fit residuals")
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    if show_plot:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def main(argv=None):
    """CLI with the reference's full flag surface
    (ref gaussian_fit_analysis.py:481-625) plus this repo's earlier
    condensed flags kept as aliases. The flow matches the reference: full
    per-timestep fit → summary stats → amplitude-only pass with
    time-averaged shape → analysis / comparison / raw-vs-amp plots →
    optional results + fitted-curve CSV exports."""
    from heatflow_tpu.analysis.radial import RadialGradientPlotter
    p = argparse.ArgumentParser(
        description="Gaussian fitting analysis for radial gradient data")
    p.add_argument("data_path", type=str)
    p.add_argument("--fit-method", choices=["rmse", "maxerr"],
                   default="rmse")
    p.add_argument("--save-results", type=str, default=None,
                   help="Path to save fitting results CSV")
    p.add_argument("--save-analysis-plot", type=str, default=None)
    p.add_argument("--save-comparison-plot", type=str, default=None,
                   help="Path to save fit comparison plot")
    p.add_argument("--time-indices", type=int, nargs="+",
                   default=[0, 10, 20, 30],
                   help="Time indices for comparison plot")
    p.add_argument("--compare-steps", type=int, nargs="+", default=None,
                   help="Time indices for raw vs amplitude-only comparison "
                        "plot (default: every 5th step)")
    p.add_argument("--save-compare-plot", type=str, default=None,
                   help="Path to save raw vs amplitude-only comparison plot")
    p.add_argument("--save-fitted-csv-full", type=str, default=None,
                   help="full-parameter fitted curves (gradient CSV format)")
    p.add_argument("--save-fitted-csv-amp", type=str, default=None,
                   help="amplitude-only fitted curves (gradient CSV format)")
    p.add_argument("--no-show", action="store_true")
    # condensed aliases from earlier rounds
    p.add_argument("--amplitude-only", action="store_true",
                   help="alias: route --save-csv to the amplitude-only pass")
    p.add_argument("--save-csv", type=str, default=None,
                   help="alias for --save-fitted-csv-full "
                        "(--save-fitted-csv-amp with --amplitude-only)")
    p.add_argument("--save-plots", type=str, default=None,
                   help="alias for --save-analysis-plot")
    args = p.parse_args(argv)
    show = not args.no_show

    plotter = RadialGradientPlotter(args.data_path)
    results = analyze_split_normal_fits(plotter, fit_method=args.fit_method)

    print("\nSplit Normal Fitting Summary:")
    print(f"  Average RMSE: {np.mean(results['rmse_values']):.2e} K/m")
    print(f"  Average R²: {np.mean(results['r_squared_values']):.3f}")
    t_best = results["time_values"][np.argmax(results["r_squared_values"])]
    t_worst = results["time_values"][np.argmin(results["r_squared_values"])]
    print(f"  Best fit time: t={t_best:.2e}s")
    print(f"  Worst fit time: t={t_worst:.2e}s")
    print("Total RMSE summed across all time steps: "
          f"{np.sum(results['rmse_values']):.2e} K/m")

    avg_center = float(np.mean(results["centers"]))
    avg_sl = float(np.mean(results["sigma_lefts"]))
    avg_sr = float(np.mean(results["sigma_rights"]))
    avg_off = float(np.mean(results["offsets"]))
    print("\nAveraged parameters (excluding amplitude):")
    print(f"  center: {avg_center:.3e}, sigma_left: {avg_sl:.3e}, "
          f"sigma_right: {avg_sr:.3e}, offset: {avg_off:.3e}")
    amp_only = analyze_split_normal_fits_amplitude_only(
        plotter, avg_center, avg_sl, avg_sr, avg_off)
    print("Total RMSE (amplitude-only fit): "
          f"{np.sum(amp_only['rmse_values']):.2e} K/m")

    analysis_path = args.save_analysis_plot or args.save_plots
    if analysis_path or show:
        plot_split_normal_analysis(results, save_path=analysis_path,
                                   show_plot=show)
    if args.save_comparison_plot or show:
        plot_fit_comparison(plotter, results, args.time_indices,
                            save_path=args.save_comparison_plot,
                            show_plot=show)
    compare_idx = (args.compare_steps if args.compare_steps
                   else list(range(0, len(results["time_values"]), 5)))
    if args.save_compare_plot or show:
        plot_comparison_raw_vs_amp_only(plotter, results, amp_only,
                                        compare_idx,
                                        save_path=args.save_compare_plot,
                                        show_plot=show)
    if args.save_results:
        save_fit_results(results, args.save_results)
    csv_full = args.save_fitted_csv_full or (
        None if args.amplitude_only else args.save_csv)
    csv_amp = args.save_fitted_csv_amp or (
        args.save_csv if args.amplitude_only else None)
    if csv_full:
        save_fitted_curves_csv(results, plotter.radial_positions, csv_full)
        print(f"Saved fitted curves to: {csv_full}")
    if csv_amp:
        save_fitted_curves_csv(amp_only, plotter.radial_positions, csv_amp)
        print(f"Saved fitted curves to: {csv_amp}")


if __name__ == "__main__":
    main()
