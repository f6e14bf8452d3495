"""Multi-chip sharding for sweeps and domain decomposition.

The reference's only real parallelism is a multiprocessing pool over configs
(ref parameter_sweep.py:436-446). The device-mesh replacements:

  * **config axis (dp analogue)** — vmapped sweep batches sharded over the
    device mesh's 'config' axis; each chip integrates its shard of configs
    independently; the only collective is the final result gather.
  * **spatial axis (sp analogue)** — the (Nz, Nr) field's z dimension sharded
    over the 'z' axis; the 7-point stencil's shifted reads become
    XLA-inserted halo exchanges (collective-permute between devices) under
    GSPMD — no manual ghost updates (replacing PETSc
    ghostUpdate/scatter_forward, ref run_no_diamond.py:538-541).

Both compose in a single 2D mesh ('config', 'z').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from heatflow_tpu.ops.cg import pcg_fixed
from heatflow_tpu.ops.stencil import apply_stencil


def config_mesh(n_devices: int | None = None, *, z_shards: int = 1,
                devices=None) -> Mesh:
    """Build a ('config', 'z') device mesh. z_shards=1 → pure config
    parallelism."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % z_shards:
        raise ValueError(f"{n} devices not divisible into z_shards={z_shards}")
    arr = np.array(devs).reshape(n // z_shards, z_shards)
    return Mesh(arr, ("config", "z"))


def shard_batch(mesh: Mesh, tree):
    """Place a pytree of batched arrays: axis 0 over 'config'; for rank-3+
    field-like arrays (B, Nz, ...) the Nz axis over 'z'."""
    def put(x):
        x = jnp.asarray(x)
        if x.ndim >= 3:
            # (B, ..., Nz, Nr): batch over 'config', the Nz axis (always
            # second-to-last) over 'z'
            spec = P("config", *([None] * (x.ndim - 3)), "z", None)
        elif x.ndim >= 1:
            spec = P("config")
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)


def batch_step_sharded(mesh: Mesh, *, iters: int = 8):
    """A jitted batched backward-Euler step over per-config operators with
    ('config', 'z') sharding — the multi-chip building block validated by
    ``__graft_entry__.dryrun_multichip``.

    Takes (A, M_op, free, g, u) with A/M_op (B, 7, Nz, Nr), free (Nz, Nr),
    g/u (B, Nz, Nr); returns u_next (B, Nz, Nr).
    """

    def one(A, M_op, free, g, u):
        s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free \
            + (1.0 - free)
        apply_s = lambda y: s * apply_stencil(A, s * y)
        b = (apply_stencil(M_op, u) - apply_stencil(A, g)) * s
        y0 = (u / jnp.where(s > 0, s, 1.0)) * free
        sol = pcg_fixed(apply_s, b, y0, mask=free, iters=iters)
        return sol.x * s * free + g

    def batched(A, M_op, free, g, u):
        return jax.vmap(one, in_axes=(0, 0, None, 0, 0))(A, M_op, free, g, u)

    field = NamedSharding(mesh, P("config", "z", None))
    op = NamedSharding(mesh, P("config", None, "z", None))  # (B,7,Nz,Nr)
    shared = NamedSharding(mesh, P("z", None))
    return jax.jit(batched,
                   in_shardings=(op, op, shared, field, field),
                   out_shardings=field)
