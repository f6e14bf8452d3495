#!/usr/bin/env python
"""Gradient-based experimental fit: time to fit, on the GPU.

The reference's fitting is brute-force grid scans minimizing the normalized
o-side RMSE (ref sweep_test.py:96-115, analysis_utils.py:66-93). This
repo's fit (drivers/fit.py) is a coarse vmapped sweep plus Adam refinement
through the implicit-diff solve (``custom_linear_solve`` in reverse mode).

Protocol: cfgs/geballe_no_diamond_read_flux.yaml (real Geballe heating and
o-side data), its full mesh, (kappa, FWHM) free over the default search
box, f32 with the fit's converging defaults (resolve_fit_solver: rtol 1e-5
wrt r0). One row per preconditioner: wall seconds, best RMSE and the fitted
(kappa, FWHM), each line naming the device.

Usage: python benchmarks/bench_fit.py [--adam-steps 30]
           [--preconditioners jacobi,rline]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    default="cfgs/geballe_no_diamond_read_flux.yaml")
    ap.add_argument("--adam-steps", type=int, default=30)
    ap.add_argument("--coarse", type=int, nargs=2, default=[8, 6])
    ap.add_argument("--n-starts", type=int, default=2)
    ap.add_argument("--preconditioners", default="jacobi,rline")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from heatflow_tpu.config import load_config
    from heatflow_tpu.drivers.fit import fit_parameters
    from heatflow_tpu.geometry import build_layout, coupler_watcher_points
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.utils import enable_compilation_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError("bench_fit measures the GPU; JAX's default "
                           f"device is {devs[0].platform}")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    enable_compilation_cache()

    cfg = load_config(os.path.join(ROOT, args.config))
    cfg["heating"]["file"] = os.path.join(ROOT, cfg["heating"]["file"])
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    problem = build_problem(mesh, heating, cfg,
                            watcher_points=coupler_watcher_points(cfg))

    for prec in args.preconditioners.split(","):
        t0 = time.perf_counter()
        res = fit_parameters(problem, coarse=tuple(args.coarse),
                             n_starts=args.n_starts,
                             adam_steps=args.adam_steps,
                             dtype=jnp.float32, uncertainty=False,
                             precondition=prec)
        print(json.dumps({"precondition": prec,
                          "wall_s": time.perf_counter() - t0,
                          "rmse": res.rmse, "k": res.k, "fwhm": res.fwhm,
                          "device": device}), flush=True)


if __name__ == "__main__":
    main()
