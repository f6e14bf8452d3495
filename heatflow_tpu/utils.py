"""Small shared utilities: profiling and timing.

The reference's observability is wall-clock prints (SURVEY §5.1); here the
same summaries exist in the drivers plus real profiler traces on demand.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def profile_trace(outdir: str | None):
    """Capture a jax.profiler trace (viewable in TensorBoard/Perfetto) around
    the wrapped block when ``outdir`` is given; no-op otherwise."""
    if not outdir:
        yield
        return
    import jax
    jax.profiler.start_trace(outdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        print(f"Profiler trace written to {outdir}")


class StepTimer:
    """Wall-clock section timer with the reference's summary format."""

    def __init__(self):
        self.t0 = time.time()
        self.marks: dict[str, float] = {}

    def mark(self, name: str):
        self.marks[name] = time.time()

    def summary(self, num_steps: int) -> str:
        total = time.time() - self.t0
        lines = ["--- Timing Summary ---", f"Total time: {total:.2f} s"]
        prev = self.t0
        for name, t in self.marks.items():
            lines.append(f"{name}: {t - prev:.2f} s")
            prev = t
        if num_steps:
            lines.append(f"Average time per step: {total / num_steps:.4f} s")
        lines.append("----------------------")
        return "\n".join(lines)


def pad_to_multiple(arr, m: int):
    """Pad a 1D batch array to a multiple of m by repeating its last element
    (padded lanes recompute the last config and are sliced away by callers —
    the sweep/fit/multihost batch-sharding convention)."""
    import numpy as np
    arr = np.asarray(arr)
    pad = (-len(arr)) % m
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad)])
    return arr


def resolve_solver(solver: str) -> str:
    """The engine a ``solver`` option names. The XLA engine (``ops/cg.py``
    CG with the ``ops/linesolve.py`` / ``ops/multigrid.py``
    preconditioners, vmapped for sweeps) is the only one, on every backend,
    dtype, preconditioner and mesh kind: 'auto' and 'xla' both name it."""
    if solver not in ("auto", "xla"):
        raise ValueError(f"unknown solver {solver!r}: the XLA engine is the "
                         "only one ('auto' or 'xla')")
    return "xla"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself, and no
    other directory is set), else ``<checkout>/.jax_cache`` — a fixed path,
    since a cache directory that moves is never hit again."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(root, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path


def resolve_recording_precondition(record_gradient: bool, dtype,
                                   *, fixed_iters=None,
                                   batched: bool = False,
                                   unstructured: bool = False,
                                   f64_refine: int = 0,
                                   rtol_wrt: str = "r0") -> str:
    """Driver-default CG preconditioner per regime.

    Structured SINGLE runs at f32 with tolerance stopping get a line
    preconditioner regardless of recording:

    - plain pure-f32: **'adi'** — under wrt-r0 stopping with extrapolated
      seeds rline grinds near the f32 floor on late steps while adi
      converges before the floor bites. Chosen ONLY under the driver's
      wrt-'r0' stopping: a non-default ``rtol_wrt`` falls back to rline
      (recording) / jacobi, since adi's unconverged error under loose
      wrt-'b' stopping is far larger than jacobi/rline's at equal rtol;
    - with ``f64_refine`` (inner solves unit-normalized — no floor
      grind): **'rline'**.

    Recording runs additionally NEED the line preconditioner for
    artifact quality: jacobi-CG's unconverged f32 error concentrates in
    exactly the near-axis radial modes the gradient artifacts amplify by
    ~1/h_r — the raw-axis CSV (ref run_no_diamond.py:610-617) picks up
    spurious spikes.

    Batched sweeps keep 'rline' when recording and 'jacobi' for plain
    sweeps. f64 runs converge past every such sensitivity and keep
    'jacobi'; a fixed iteration budget keeps 'jacobi'; unstructured
    meshes keep 'jacobi' (the XLA engine has no line solve on them).

    These defaults were chosen from measurements on the previous
    accelerator; re-ranking them on the GPU is open work (ROADMAP).
    """
    import jax.numpy as jnp
    if not (jnp.dtype(dtype) == jnp.float32 and fixed_iters is None
            and not unstructured):
        return "jacobi"
    if batched:
        return "rline" if record_gradient else "jacobi"
    if f64_refine:
        return "rline"
    if rtol_wrt != "r0":
        return "rline" if record_gradient else "jacobi"
    return "adi"
