"""Engine/preconditioner resolution edge cases.

1. The XLA engine is the only one: ``solver='vmem'`` (the retired Pallas
   engine) raises, and 'auto'/'xla' build the XLA engine with every
   preconditioner, including under a z-sharding device mesh.
2. ``precondition='zline'`` and ``'mg'`` are applied, not dropped.
3. Unstructured problems precondition with Jacobi scaling only: asking for
   rline/adi raises instead of silently running unpreconditioned; the
   drivers' DEFAULTED preconditioner resolves to jacobi there.
4. Sweep-driver rtol defaults are width-independent — the resolution used
   to mutate its own "was rtol given?" check inside the width loop, so
   recording sweeps lost the tighter 1e-5 default from width 2 on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.sim.bc import HeatingCurve
from heatflow_tpu.sim.problem import build_problem
from heatflow_tpu.sim.stepper import make_simulate_fn
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg


@pytest.fixture()
def tiny_problem(tmp_path):
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(str(heat_csv)), cfg,
                            watcher_points=coupler_watcher_points(cfg))
    return cfg, problem


def test_zline_vmem_raises_auto_falls_back(tiny_problem):
    _cfg, problem = tiny_problem
    with pytest.raises(ValueError, match="unknown solver 'vmem'"):
        make_simulate_fn(problem, dtype=jnp.float32, solver="vmem",
                         precondition="zline", maxiter=7702)

    # 'auto' builds the XLA engine, which applies the preconditioner
    fn = make_simulate_fn(problem, dtype=jnp.float32, solver="auto",
                          precondition="zline", rtol=1e-4, maxiter=7703)
    ys = fn()
    assert np.isfinite(np.asarray(ys["watch"])).all()
    assert np.asarray(ys["cg_iters"]).max() > 0


def test_mesh_with_auto_resolves_to_xla(tiny_problem):
    """run2d --z-shards N with the default solver='auto' builds and runs
    the XLA engine."""
    from heatflow_tpu.parallel.sharding import config_mesh
    _cfg, problem = tiny_problem
    nz = problem.mesh.shape[0]
    zs = 2 if nz % 2 == 0 else 1
    if zs == 1:
        pytest.skip("odd Nz in fixture")
    dmesh = config_mesh(zs, z_shards=zs)

    fn = make_simulate_fn(problem, dtype=jnp.float32, solver="auto",
                          mesh=dmesh, rtol=1e-4, maxiter=7704,
                          record_gradient=False)
    ys = fn()
    assert np.isfinite(np.asarray(ys["watch"])).all()

    # the retired engine's name is rejected with a device mesh too
    with pytest.raises(ValueError, match="unknown solver"):
        make_simulate_fn(problem, dtype=jnp.float32, solver="vmem",
                         mesh=dmesh, maxiter=7705)


def test_unstructured_rline_requires_vmem_engine(tmp_path):
    from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
    from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                               make_simulate_fn_unstructured)
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    domain, mats = build_layout(cfg)
    umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=7)
    problem = build_problem_unstructured(
        umesh, HeatingCurve.from_csv(str(heat_csv)), cfg,
        watcher_points=coupler_watcher_points(cfg))

    # the XLA engine has no line solve on unstructured meshes; the maker
    # must refuse rather than silently run unpreconditioned
    for prec in ("rline", "adi"):
        with pytest.raises(ValueError, match="not available on "
                                             "unstructured"):
            make_simulate_fn_unstructured(problem, dtype=jnp.float32,
                                          solver="auto", precondition=prec,
                                          maxiter=7706)

    # the drivers' DEFAULT therefore resolves to jacobi here
    from heatflow_tpu.utils import resolve_recording_precondition
    assert resolve_recording_precondition(
        True, jnp.float32, unstructured=True) == "jacobi"

    # the unstructured stepper/sweep makers implement the linear seed
    # only — unknown/unsupported warm starts raise instead of silently
    # degrading to 'previous' (review-pass 3)
    from heatflow_tpu.sim.unstructured import make_sweep_fn_unstructured
    with pytest.raises(ValueError, match="warm_start"):
        make_simulate_fn_unstructured(problem, warm_start="extrapolate2")
    with pytest.raises(ValueError, match="warm_start"):
        make_sweep_fn_unstructured(problem, warm_start="extrapolate2")

    # recording outputs carry host-side times (a sharded device row is not
    # addressable on every process of a multihost run)
    fn = make_sweep_fn_unstructured(problem, dtype=jnp.float64, rtol=1e-8,
                                    record_gradient=True)
    out = fn(np.array([3.0]), np.array([4e-6]))
    assert isinstance(out["times"], np.ndarray) and out["times"].ndim == 1
    np.testing.assert_allclose(
        out["times"], np.arange(1, problem.num_steps + 1) * problem.dt)


def test_sweep_rtol_defaults_width_independent(tmp_path, monkeypatch):
    """Recording sweeps stop at rtol 1e-5 (the measured accuracy knee) for
    EVERY width group, not just the first."""
    import heatflow_tpu.sim.sweepkernel as sk
    from heatflow_tpu.drivers.sweep import run_parameter_sweep

    seen = []
    real = sk.make_sweep_fn_recording

    def spy(problem, **kw):
        seen.append(kw.get("rtol"))
        return real(problem, **kw)

    monkeypatch.setattr(sk, "make_sweep_fn_recording", spy)

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 2
    cfg_path = tmp_path / "base.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    width = float(cfg["mats"]["p_sample"]["z"])

    results, failed = run_parameter_sweep(
        str(cfg_path), str(tmp_path / "out"), (4e-6, 4e-6), (3.0, 3.0),
        (width, 1.5 * width), (1, 1, 2),
        base_mesh_folder=str(tmp_path / "meshes"), suppress_print=True,
        dtype=jnp.float32, record_gradient=True, precondition="jacobi")
    assert len(results) == 2 and not failed
    assert seen == [1e-5, 1e-5]


def test_inner_seed_validated_even_without_refine(tiny_problem):
    """7. inner_seed typos raise even when f64_refine=0 (the normalization
    to 'zero' used to run before validation, silently accepting any
    string whenever refinement was off)."""
    _cfg, problem = tiny_problem
    with pytest.raises(ValueError, match="inner_seed"):
        make_simulate_fn(problem, dtype=jnp.float32, f64_refine=0,
                         inner_seed="cary", maxiter=7703)


def test_mg_vmem_raises_auto_falls_back(tiny_problem):
    """``solver='vmem'`` is rejected, and ``'auto'`` builds the XLA engine
    with the mg V-cycle applied."""
    _cfg, problem = tiny_problem
    with pytest.raises(ValueError, match="unknown solver"):
        make_simulate_fn(problem, dtype=jnp.float32, solver="vmem",
                         precondition="mg", maxiter=7707)

    fn = make_simulate_fn(problem, dtype=jnp.float32, solver="auto",
                          precondition="mg", rtol=1e-4, maxiter=7708)
    ys = fn()
    assert np.isfinite(np.asarray(ys["watch"])).all()


def test_sweep_driver_resolver_routes_mg_to_xla(tiny_problem):
    """--precondition mg under the sweep driver's solver='auto' default
    builds the XLA sweep engine with the V-cycle."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn
    from heatflow_tpu.utils import resolve_solver
    _cfg, problem = tiny_problem
    assert resolve_solver("auto") == resolve_solver("xla") == "xla"
    tr = np.asarray(make_sweep_fn(problem, dtype=jnp.float32, rtol=1e-4,
                                  precondition="mg")(np.array([3.0]),
                                                     np.array([4e-6])))
    assert np.isfinite(tr).all()


def test_sweep_xla_rline_is_applied(tiny_problem):
    """Review-pass 3: the plain sweep maker's XLA path used to silently
    ignore precondition='rline' (only mg built a ``pre``). Now the line
    preconditioner is factored per config: at a tiny fixed budget the
    preconditioned traces must DIFFER from jacobi's (it actually runs),
    and at tight tolerance they must agree with the converged solution."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn
    _cfg, problem = tiny_problem
    ks = np.array([3.0, 9.0])
    fs = np.array([4e-6, 4e-6])
    f_j3 = make_sweep_fn(problem, dtype=jnp.float64, solver="xla",
                         fixed_iters=3, precondition="jacobi")
    f_r3 = make_sweep_fn(problem, dtype=jnp.float64, solver="xla",
                         fixed_iters=3, precondition="rline")
    f_jt = make_sweep_fn(problem, dtype=jnp.float64, solver="xla",
                         rtol=1e-12, maxiter=5000, precondition="jacobi")
    f_rt = make_sweep_fn(problem, dtype=jnp.float64, solver="xla",
                         rtol=1e-12, maxiter=5000, precondition="rline")
    tj3 = np.asarray(f_j3(ks, fs))
    tr3 = np.asarray(f_r3(ks, fs))
    tjt = np.asarray(f_jt(ks, fs))
    trt = np.asarray(f_rt(ks, fs))
    assert not np.allclose(tr3, tj3)          # the preconditioner runs
    rng = np.ptp(tjt) or 1.0
    assert np.max(np.abs(trt - tjt)) / rng < 1e-8   # and solves correctly


def test_sweep_makers_reject_unknown_warm_start(tiny_problem):
    """Review-pass 3: the sweep engines implement 'previous'/'extrapolate'
    only; 'extrapolate2' (stepper-only) and typos used to silently degrade
    to 'previous' — benchmark comparisons would measure the wrong seed."""
    from heatflow_tpu.sim.sweepkernel import (make_sweep_fn,
                                              make_sweep_fn_recording)
    _cfg, problem = tiny_problem
    with pytest.raises(ValueError, match="warm_start"):
        make_sweep_fn(problem, warm_start="extrapolate2")
    with pytest.raises(ValueError, match="warm_start"):
        make_sweep_fn(problem, warm_start="extrapolat")
    with pytest.raises(ValueError, match="warm_start"):
        make_sweep_fn_recording(problem, warm_start="extrapolat")
    with pytest.raises(ValueError, match="precondition"):
        make_sweep_fn(problem, precondition="r-line")
