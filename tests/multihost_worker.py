"""Worker for tests/test_multihost.py: one process of a 2-process CPU
'multi-host' run. Every process executes this same SPMD program."""

import os
import sys

rank = int(sys.argv[1])
port = sys.argv[2]
heat_csv = sys.argv[3]
out_path = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from heatflow_tpu.parallel import multihost  # noqa: E402

multihost.initialize(coordinator_address=f"localhost:{port}",
                     num_processes=2, process_id=rank)
assert len(jax.devices()) == 8, jax.devices()
assert len(jax.local_devices()) == 4

from heatflow_tpu.geometry import build_layout  # noqa: E402
from heatflow_tpu.mesh.structured import build_structured_mesh  # noqa: E402
from heatflow_tpu.sim.bc import HeatingCurve  # noqa: E402
from heatflow_tpu.sim.problem import build_problem  # noqa: E402
from tests.fixtures import tiny_no_diamond_cfg  # noqa: E402

cfg = tiny_no_diamond_cfg(coarse=3.0)
cfg["heating"]["file"] = heat_csv
cfg["timing"]["num_steps"] = 4
domain, mats = build_layout(cfg)
mesh = build_structured_mesh(domain, mats)
heating = HeatingCurve.from_csv(heat_csv)
problem = build_problem(mesh, heating, cfg,
                        watcher_points={"p": (0.0, 0.0), "o": (1e-6, 0.0)})

ks = np.linspace(2.0, 8.0, 6)       # 6 configs → padded to 8 internally
fs = np.linspace(4e-6, 9e-6, 6)
traces = multihost.run_sweep_multihost(problem, ks, fs, fixed_iters=10,
                                       dtype=np.float64)
assert traces.shape == (6, 4, 2), traces.shape

# artifact-parity (recording) sweep over the same 2-process mesh: full
# per-run artifact set sharded over DCN (ref parameter_sweep.py:157-166)
rec = multihost.run_sweep_multihost(problem, ks, fs, dtype=np.float64,
                                    rtol=1e-10, maxiter=4000,
                                    record_gradient=True)
assert rec["watch"].shape == (6, 4, 2), rec["watch"].shape
assert rec["band"].shape[0] == 6 and rec["axis"].shape[0] == 6

# unstructured (overlay) sweep — the reference fan-out is
# mesh-kind-agnostic, so the multihost path must be too
from heatflow_tpu.mesh.unstructured_gen import \
    build_unstructured_mesh  # noqa: E402
from heatflow_tpu.sim.unstructured import \
    build_problem_unstructured  # noqa: E402

umesh = build_unstructured_mesh(domain, mats, jitter=0.25, seed=7)
uproblem = build_problem_unstructured(
    umesh, heating, cfg,
    watcher_points={"p": (0.0, 0.0), "o": (1e-6, 0.0)})
utraces = multihost.run_sweep_multihost(uproblem, ks, fs, fixed_iters=10,
                                        dtype=np.float64)
assert utraces.shape == (6, 4, 2), utraces.shape

# mixed-precision refined sweep over the 2-process mesh (f32 lanes +
# f64-operator residual refinement)
import jax.numpy as jnp  # noqa: E402

rtraces = multihost.run_sweep_multihost(uproblem, ks, fs,
                                        dtype=jnp.float32, rtol=1e-5,
                                        maxiter=4000, f64_refine=2)
assert rtraces.shape == (6, 4, 2), rtraces.shape
assert np.isfinite(rtraces).all()
utruth = multihost.run_sweep_multihost(uproblem, ks, fs,
                                       dtype=np.float64, rtol=1e-11,
                                       maxiter=8000)
assert np.abs(rtraces - utruth).max() < 1e-3  # refined ≡ f64 per lane

if rank == 0:
    np.savez(out_path, traces=traces, rec_watch=rec["watch"],
             rec_band=rec["band"], rec_axis=rec["axis"], utraces=utraces,
             rtraces=rtraces)
print(f"rank {rank} OK")
