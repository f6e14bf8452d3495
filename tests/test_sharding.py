"""Multi-device sharding on the virtual 8-device CPU mesh: config-batch
parallelism and z-domain decomposition (XLA halo exchange)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from heatflow_tpu.geometry import build_layout
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.ops.stencil import apply_stencil, assemble_stencils, \
    combine_operator
from heatflow_tpu.parallel.sharding import (batch_step_sharded, config_mesh,
                                            shard_batch)
from tests.fixtures import tiny_no_diamond_cfg

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def system():
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh)
    kp = np.array([m.kappa for m in mats])
    rc = np.array([m.rho_cv for m in mats])
    return mesh, pack, kp, rc


def test_sharded_stencil_apply_matches_single_device(system):
    """z-sharded apply must equal the unsharded result — validates the
    XLA-inserted halo exchange."""
    mesh, pack, kp, rc = system
    A, _ = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M),
                            jnp.asarray(kp), jnp.asarray(rc), 1e-7)
    nz, nr = mesh.shape
    pad = (-nz) % 2
    A = jnp.pad(A, ((0, 0), (0, pad), (0, 0)))
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((nz + pad, nr)))
    y_ref = np.asarray(apply_stencil(A, u))

    dmesh = config_mesh(8, z_shards=2)
    with dmesh:
        A_s = jax.device_put(A, NamedSharding(dmesh, P(None, "z", None)))
        u_s = jax.device_put(u, NamedSharding(dmesh, P("z", None)))
        f = jax.jit(apply_stencil,
                    out_shardings=NamedSharding(dmesh, P("z", None)))
        y = np.asarray(f(A_s, u_s))
    np.testing.assert_allclose(y, y_ref, rtol=1e-12,
                               atol=1e-12 * np.abs(y_ref).max())


def test_batch_step_sharded_matches_unsharded(system):
    mesh, pack, kp, rc = system
    nz, nr = mesh.shape
    pad = (-nz) % 2
    B = 8
    kb = np.tile(kp, (B, 1))
    kb[:, 2] *= np.linspace(0.5, 2.0, B)
    A, M_op = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M),
                               jnp.asarray(kb), jnp.asarray(np.tile(rc, (B, 1))),
                               1e-7)
    A = jnp.pad(A, ((0, 0), (0, 0), (0, pad), (0, 0)))
    M_op = jnp.pad(M_op, ((0, 0), (0, 0), (0, pad), (0, 0)))
    free = np.ones((nz + pad, nr), np.float64)
    free[0, :] = free[-1 - pad:, :] = 0.0
    g = np.zeros((B, nz + pad, nr))
    g[:, 0, :] = 350.0
    u = np.full((B, nz + pad, nr), 300.0)

    # unsharded reference via the same building block on one device
    dmesh1 = config_mesh(1, z_shards=1)
    with dmesh1:
        step1 = batch_step_sharded(dmesh1, iters=6)
        a1, m1, u1, g1 = shard_batch(dmesh1, (A, M_op, u, g))
        f1 = jax.device_put(jnp.asarray(free), NamedSharding(
            dmesh1, P("z", None)))
        ref = np.asarray(step1(a1, m1, f1, g1, u1))

    dmesh = config_mesh(8, z_shards=2)
    with dmesh:
        step = batch_step_sharded(dmesh, iters=6)
        a2, m2, u2, g2 = shard_batch(dmesh, (A, M_op, u, g))
        f2 = jax.device_put(jnp.asarray(free), NamedSharding(
            dmesh, P("z", None)))
        out = np.asarray(step(a2, m2, f2, g2, u2))
    np.testing.assert_allclose(out, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


# ----------------------------------------------------------------------
# production sweep path (VERDICT r1 item 2): multi-step scans with watcher
# accumulation, sharded through make_sweep_fn / run_parameter_sweep
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_problem(tmp_path_factory):
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from tests.fixtures import synthetic_heating
    root = tmp_path_factory.mktemp("shsweep")
    heat_csv = root / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 5
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    heating = HeatingCurve.from_csv(str(heat_csv))
    problem = build_problem(mesh, heating, cfg,
                            watcher_points={"p": (0.0, 0.0),
                                            "o": (1e-6, 0.0)})
    return cfg, problem, str(heat_csv)


def test_make_sweep_fn_sharded_scan_matches_unsharded(sweep_problem):
    """Full multi-step scan with watcher accumulation under config x z
    sharding equals the single-device run (not just one step, not just
    finiteness)."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn
    _cfg, problem, _ = sweep_problem
    B = 8
    ks = np.linspace(2.0, 8.0, B)
    fs = np.linspace(4e-6, 9e-6, B)
    ref = np.asarray(make_sweep_fn(problem, dtype=jnp.float64,
                                   fixed_iters=10)(ks, fs))
    nz = problem.mesh.shape[0]
    zs = 2 if nz % 2 == 0 else 1
    dmesh = config_mesh(8, z_shards=zs)
    sh = np.asarray(make_sweep_fn(problem, dtype=jnp.float64,
                                  fixed_iters=10, mesh=dmesh)(ks, fs))
    np.testing.assert_allclose(sh, ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())


def test_mg_preconditioned_sweep_sharded_matches_unsharded(sweep_problem):
    """RAP-MG-preconditioned sweeps compose with (config, z) sharding: fine
    levels are z-sharded while odd-sized coarse levels stay replicated
    (GSPMD inserts the transfers), and the result equals the single-device
    run — closing the 'MG coarse grids are not z-sharded' gap."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn
    _cfg, problem, _ = sweep_problem
    B = 8
    ks = np.linspace(2.0, 8.0, B)
    fs = np.linspace(4e-6, 9e-6, B)
    ref = np.asarray(make_sweep_fn(problem, dtype=jnp.float64, fixed_iters=6,
                                   precondition="mg")(ks, fs))
    nz = problem.mesh.shape[0]
    zs = 2 if nz % 2 == 0 else 1
    dmesh = config_mesh(8, z_shards=zs)
    sh = np.asarray(make_sweep_fn(problem, dtype=jnp.float64, fixed_iters=6,
                                  precondition="mg", mesh=dmesh)(ks, fs))
    np.testing.assert_allclose(sh, ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())


def test_time_chunked_sharded_matches_unsharded(sweep_problem):
    """The resident time-chunked runner shards its batch axis (with padding
    to the config-axis size) and matches the unsharded result."""
    from heatflow_tpu.sim.sweepkernel import run_sweep_time_chunked
    _cfg, problem, _ = sweep_problem
    ks = np.linspace(2.0, 8.0, 5)          # 5 configs → padded to 8
    fs = np.linspace(4e-6, 9e-6, 5)
    ref = run_sweep_time_chunked(problem, ks, fs, step_chunk=2,
                                 fixed_iters=10, dtype=jnp.float64)
    dmesh = config_mesh(8, z_shards=1)
    sh = run_sweep_time_chunked(problem, ks, fs, step_chunk=2,
                                fixed_iters=10, dtype=jnp.float64,
                                mesh=dmesh)
    assert sh.shape == ref.shape == (5, problem.num_steps, 2)
    np.testing.assert_allclose(sh, ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())


def test_run_parameter_sweep_driver_sharded(sweep_problem, tmp_path):
    """The PRODUCTION driver path: run_parameter_sweep over all 8 virtual
    devices matches the single-device run and reports honest metadata."""
    import json
    from heatflow_tpu.drivers.sweep import run_parameter_sweep
    cfg, _problem, _heat = sweep_problem

    kwargs = dict(fwhm_range=(4e-6, 9e-6), k_range=(2.0, 8.0),
                  width_range=(1.84e-6, 1.84e-6), num_points=(2, 3, 1),
                  suppress_print=True, dtype=jnp.float64,
                  save_run_dirs=True)
    out1 = str(tmp_path / "single")
    r1, f1 = run_parameter_sweep(cfg, out1,
                                 base_mesh_folder=str(tmp_path / "m1"),
                                 devices=[jax.devices()[0]], **kwargs)
    out8 = str(tmp_path / "sharded")
    r8, f8 = run_parameter_sweep(cfg, out8,
                                 base_mesh_folder=str(tmp_path / "m8"),
                                 devices=jax.devices(), **kwargs)
    assert len(r1) == len(r8) == 6 and not f1 and not f8

    import pandas as pd
    for rec1, rec8 in zip(r1, r8):
        assert rec1["run_name"] == rec8["run_name"]
        a = pd.read_csv(f"{out1}/{rec1['run_name']}/watcher_points.csv")
        b = pd.read_csv(f"{out8}/{rec8['run_name']}/watcher_points.csv")
        np.testing.assert_allclose(b.to_numpy(), a.to_numpy(), rtol=1e-9)

    meta = json.load(open(f"{out8}/sweep_metadata.json"))
    assert "sharded over 8 devices" in meta["engine"]
    assert len(meta["devices"]) == 8


def test_single_problem_z_sharded_stepper_matches(sweep_problem):
    """SURVEY §2.3 item 2: make_simulate_fn(mesh=...) shards ONE problem's
    z axis over the devices — the FULL stepper including the per-step
    gradient projection and band/axis accumulation must equal the
    single-device run."""
    from heatflow_tpu.sim.stepper import make_simulate_fn
    _cfg, problem, _ = sweep_problem
    nz = problem.mesh.shape[0]
    zs = 2 if nz % 2 == 0 else 1
    if zs == 1:
        pytest.skip("odd Nz in fixture")
    ref = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                           record_gradient=True)()
    dmesh = config_mesh(zs, z_shards=zs)
    got = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                           record_gradient=True, mesh=dmesh)()
    for key in ("watch", "band", "axis", "final_u"):
        a, b = np.asarray(ref[key]), np.asarray(got[key])
        np.testing.assert_allclose(b, a, rtol=1e-11,
                                   atol=1e-11 * max(1.0, np.abs(a).max()))

    # rline preconditioning composes with z-sharding (PCR shifts run along
    # the replicated r axis; factors shard along z with the operator)
    got_r = make_simulate_fn(problem, dtype=jnp.float64, rtol=1e-11,
                             record_gradient=True, mesh=dmesh,
                             precondition="rline")()
    np.testing.assert_allclose(
        np.asarray(got_r["watch"]), np.asarray(ref["watch"]), rtol=1e-9,
        atol=1e-9 * np.abs(np.asarray(ref["watch"])).max())

    with pytest.raises(ValueError, match="unknown solver"):
        make_simulate_fn(problem, dtype=jnp.float32, solver="vmem",
                         mesh=dmesh)
