"""Multi-host (DCN) execution of sweep batches.

The reference's only parallelism is a single-machine process pool
(ref parameter_sweep.py:436-446). Scaling past one host means: every host
runs the same program (SPMD), jax.distributed wires the hosts into one
runtime, the global device mesh spans all devices, and the sweep's batch
axis is sharded over it — configs ride on hosts, nothing crosses the
inter-host network during the solve except the initial shard placement and
the final gather.

The same code path runs multi-process on CPU (JAX's distributed runtime is
backend-agnostic), which is how tests/test_multihost.py exercises a real
2-process run on this single machine.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join this process into a multi-host JAX runtime.

    Pass the arguments explicitly (coordinator 'host:port') unless the
    cluster environment lets jax.distributed detect them."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_config_mesh(z_shards: int = 1) -> Mesh:
    """A ('config', 'z') mesh over ALL devices of the distributed runtime
    (jax.devices() is global after initialize())."""
    from heatflow_tpu.parallel.sharding import config_mesh
    return config_mesh(devices=jax.devices(), z_shards=z_shards)


def distribute_batch(mesh: Mesh, full_batch: np.ndarray):
    """Place a full (replicated-on-every-host) batch array as a global jax
    Array sharded over the mesh's 'config' axis.

    Every process passes the SAME full batch (configs are cheap scalars);
    each host materializes only its local shard. Batch length must divide
    the 'config' axis size (pad like drivers/sweep.py does)."""
    sharding = NamedSharding(mesh, P("config"))
    full_batch = np.asarray(full_batch)

    def cb(index):
        return full_batch[index]

    return jax.make_array_from_callback(full_batch.shape, sharding, cb)


def gather_to_all(x) -> np.ndarray:
    """Replicate a sharded result to every process (the final result gather
    — the only DCN collective a sweep needs)."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def run_sweep_multihost(problem, sample_k, fwhm, *, dtype=None,
                        fixed_iters: int | None = None, rtol: float = 1e-6,
                        maxiter: int = 4000, num_steps: int | None = None,
                        z_shards: int = 1, solver: str = "auto",
                        warm_start: str = "previous",
                        record_gradient: bool = False,
                        rtol_wrt: str = "b", f64_refine: int = 0,
                        precondition: str = "jacobi"):
    """SPMD sweep over all hosts/devices: every process calls this with the
    same arguments; returns the full (B, S, W) traces on every process —
    or, with ``record_gradient=True``, the full artifact dict (watch /
    band / axis), matching the reference's per-run artifact set
    (ref parameter_sweep.py:157-166).

    Dispatches on the problem kind (structured Problem2D or overlay
    ProblemUnstructured — the reference's fan-out is mesh-kind-agnostic,
    ref :436-446) and composes the single-host pieces: global mesh +
    sharded batch placement + the production sweep makers + allgather."""
    import jax.numpy as jnp
    from heatflow_tpu.sim.sweepkernel import (make_sweep_fn,
                                              make_sweep_fn_recording)
    from heatflow_tpu.sim.unstructured import (ProblemUnstructured,
                                               make_sweep_fn_unstructured)

    dtype = dtype or jnp.float32
    mesh = global_config_mesh(z_shards=z_shards)
    nc = mesh.shape["config"]
    from heatflow_tpu.utils import pad_to_multiple
    ks = np.asarray(sample_k)
    fs = np.asarray(fwhm)
    B = len(ks)
    ks = pad_to_multiple(ks, nc)
    fs = pad_to_multiple(fs, nc)

    if isinstance(problem, ProblemUnstructured):
        if num_steps is not None:
            # the unstructured maker has no segment API — silently
            # running the full transient would break the (B, num_steps, W)
            # shape contract of time-chunked callers
            raise ValueError("num_steps on unstructured multihost sweeps "
                             "is not supported (no segmented unstructured "
                             "engine)")
        fn = make_sweep_fn_unstructured(
            problem, dtype=dtype, fixed_iters=fixed_iters, rtol=rtol,
            maxiter=maxiter, warm_start=warm_start, solver=solver,
            record_gradient=record_gradient, rtol_wrt=rtol_wrt,
            f64_refine=f64_refine, precondition=precondition, mesh=mesh)
        # the jitted cores carry explicit in_shardings, so plain (padded)
        # numpy inputs are placed as global sharded arrays at dispatch
        out = fn(ks, fs)
    elif record_gradient:
        fn = make_sweep_fn_recording(
            problem, dtype=dtype, fixed_iters=fixed_iters, rtol=rtol,
            maxiter=maxiter, warm_start=warm_start, mesh=mesh,
            rtol_wrt=rtol_wrt, f64_refine=f64_refine, solver=solver,
            precondition=precondition)
        out = fn(ks, fs)
    else:
        fn = make_sweep_fn(problem, dtype=dtype, fixed_iters=fixed_iters,
                           rtol=rtol, maxiter=maxiter, num_steps=num_steps,
                           mesh=mesh, solver=solver, warm_start=warm_start,
                           rtol_wrt=rtol_wrt, f64_refine=f64_refine,
                           precondition=precondition)
        out = fn(distribute_batch(mesh, ks), distribute_batch(mesh, fs))
    if isinstance(out, dict):
        res = {k: gather_to_all(v)[:B] for k, v in out.items()
               if k in ("watch", "band", "axis")}
        res["times"] = np.asarray(out["times"])
        return res
    return gather_to_all(out)[:B]
