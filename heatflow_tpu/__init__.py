"""heatflow_tpu — a JAX framework for transient heat conduction in
laser-heated diamond-anvil-cell (DAC) experiments, run on GPUs.

A ground-up JAX/XLA re-design of the capabilities of ``cebarker1000/heatflow``
(FEniCSx/PETSc/gmsh based): axisymmetric transient heat conduction on
multi-material meshes, time-dependent Gaussian laser boundary conditions driven
by experimental data, radial-gradient extraction, a 1D reduced model with
radial correction, massively-parallel parameter sweeps, and an
experimental-fit analysis pipeline.

Design (accelerator-first, not a port):
  * meshes are device-resident arrays built from a graded structured grid;
  * the implicit operator is a 7-point stencil with per-node coefficients
    (elementwise work — no scatter in the hot loop);
  * backward-Euler steps are preconditioned-CG solves inside ``lax.scan``;
  * parameter sweeps are ``vmap``-ed batches sharded over a device mesh
    (replacing the reference's multiprocessing pool,
    ref: parameter_sweep.py:436-446);
  * an unstructured ELL-SpMV path covers imported gmsh ``.msh`` meshes.
"""

__version__ = "0.1.0"

from heatflow_tpu.config import load_config
from heatflow_tpu.geometry import build_layout, MaterialSpec
from heatflow_tpu.mesh.structured import build_structured_mesh

__all__ = [
    "load_config",
    "build_layout",
    "MaterialSpec",
    "build_structured_mesh",
    "__version__",
]
