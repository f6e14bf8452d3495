"""Real multi-process ('multi-host') execution: two OS processes join one
jax.distributed runtime over localhost (the CPU stand-in for a multi-host cluster's
DCN), shard a production sweep batch over the global 8-device mesh, and the
gathered traces must match a single-process run."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sweep_matches_single_process(tmp_path):
    from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg
    heat_csv = str(tmp_path / "heat.csv")
    synthetic_heating(heat_csv)
    out = str(tmp_path / "traces.npz")
    port = _free_port()

    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "multihost_worker.py"),
         str(rank), str(port), heat_csv, out],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost workers timed out")
        logs.append(stdout.decode(errors="replace"))
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"

    got = np.load(out)

    # single-process references on the same problems
    import jax
    jax.config.update("jax_platforms", "cpu")
    from heatflow_tpu.geometry import build_layout
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.sim.sweepkernel import (make_sweep_fn,
                                              make_sweep_fn_recording)
    from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                               make_sweep_fn_unstructured)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = heat_csv
    cfg["timing"]["num_steps"] = 4
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    heating = HeatingCurve.from_csv(heat_csv)
    wp = {"p": (0.0, 0.0), "o": (1e-6, 0.0)}
    problem = build_problem(mesh, heating, cfg, watcher_points=wp)
    ks = np.linspace(2.0, 8.0, 6)
    fs = np.linspace(4e-6, 9e-6, 6)
    ref = np.asarray(make_sweep_fn(problem, dtype=np.float64,
                                   fixed_iters=10)(ks, fs))
    np.testing.assert_allclose(got["traces"], ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())

    rec = make_sweep_fn_recording(problem, dtype=np.float64,
                                  rtol=1e-10)(ks, fs)
    for key, name in (("rec_watch", "watch"), ("rec_band", "band"),
                      ("rec_axis", "axis")):
        r = np.asarray(rec[name])
        np.testing.assert_allclose(
            got[key], r, rtol=1e-8, atol=1e-8 * max(1.0, np.abs(r).max()))

    umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=7)
    uproblem = build_problem_unstructured(umesh, heating, cfg,
                                          watcher_points=wp)
    uref = np.asarray(make_sweep_fn_unstructured(
        uproblem, dtype=np.float64, fixed_iters=10)(ks, fs))
    np.testing.assert_allclose(got["utraces"], uref, rtol=1e-11,
                               atol=1e-11 * np.abs(uref).max())
