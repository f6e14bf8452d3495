"""IR-absorber stack with a steady-state warm start — the script form of the
reference's with_ir_steady.ipynb / with_gasket.ipynb workflow (hand-built
Material bounds → steady solve → steady state as the transient's initial
condition → pulsed heating), expressed through the framework's custom
(explicit-bounds) layout.

Reference parity: the notebooks build free-form stacks with raw
``Material(name, [zmin,zmax,rmin,rmax], props, mesh_size)`` calls
(ref mesh_and_materials/materials.py:16-34; with_ir_steady.ipynb geometry
cells), solve steady state via ``build_steady_state_variational_forms``
(ref space/space_and_forms.py:119-149), verify it is reproduced by the
transient solver, then run the pulsed transient from it.
"""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:
    import heatflow_tpu  # noqa: F401  (pip-installed)
except ImportError:      # source checkout without an install
    import sys
    sys.path.insert(0, ROOT)

um = 1e-6


def main():
    import jax
    import numpy as np

    # steady-vs-transient agreement is checked tightly below — run in
    # strict f64
    jax.config.update("jax_enable_x64", True)

    from heatflow_tpu.config import validate_config
    from heatflow_tpu.geometry import build_layout
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.sim.steady import solve_steady, steady_heating_values
    from heatflow_tpu.sim.stepper import run_transient

    # Free-form stack: insulator / coupler / sample with an embedded
    # IR-absorber layer / sample / insulator. The canonical 5/9-material
    # layouts cannot express the mid-sample absorber — explicit bounds can
    # (YAML configs do the same with mats.<name>.bounds; see cfgs and
    # docs/PARITY.md).
    cfg = {
        "mats": {
            "p_ins": {"rho": 4131, "cv": 668, "k": 10, "mesh": 0.4 * um,
                      "bounds": [-4.0 * um, -1.0 * um, 0.0, 6.0 * um]},
            "p_coupler": {"rho": 26504, "cv": 130, "k": 352,
                          "mesh": 0.1 * um,
                          "bounds": [-1.0 * um, -0.9 * um, 0.0, 6.0 * um]},
            "sample_left": {"rho": 5164, "cv": 1158, "k": 3.8,
                            "mesh": 0.3 * um,
                            "bounds": [-0.9 * um, 0.0, 0.0, 6.0 * um]},
            "ir_absorber": {"rho": 19300, "cv": 132, "k": 310,
                            "mesh": 0.1 * um,
                            "bounds": [0.0, 0.2 * um, 0.0, 6.0 * um]},
            "sample_right": {"rho": 5164, "cv": 1158, "k": 3.8,
                             "mesh": 0.3 * um,
                             "bounds": [0.2 * um, 1.1 * um, 0.0, 6.0 * um]},
            "o_ins": {"rho": 4131, "cv": 668, "k": 10, "mesh": 0.5 * um,
                      "bounds": [1.1 * um, 4.1 * um, 0.0, 6.0 * um]},
        },
        "heating": {"fwhm": 6.0e-6, "ic_temp": 300.0,
                    "file": os.path.join(ROOT, "experimental_data",
                                         "geballe_heat_data.csv"),
                    "z": -1.0 * um, "r_max": 5.0 * um},
        "timing": {"t_final": 7.5e-6, "num_steps": 50},
        "io": {"mesh_path": "meshes/with_ir"},
    }
    validate_config(cfg, require_heating_file=True)

    domain, mats = build_layout(cfg)       # auto-detects the custom layout
    mesh = build_structured_mesh(domain, mats)
    print(f"Mesh: {mesh.shape[0]} x {mesh.shape[1]} = {mesh.num_nodes} "
          f"nodes; materials: {[m.name for m in mats]}")

    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    problem = build_problem(mesh, heating, cfg,
                            watcher_points={"ir": (0.1 * um, 0.0),
                                            "oside": (1.5 * um, 0.0)})

    # 1) steady state with the laser held at the pulse's peak level
    #    (ref with_gasket.ipynb cell 16 / space_and_forms.py:119-149)
    offset = heating.amplitude_offset(problem.ic_temp)
    amp_peak = float(heating.temp.max()) - offset
    bc = steady_heating_values(problem, amplitude=amp_peak)
    # weighted=True: the axisymmetric (r-weighted) steady operator —
    # consistent with the transient form, so the hold-check below
    # converges to it exactly
    u_ss, info = solve_steady(problem, bc, weighted=True)
    print(f"Steady solve at held amplitude {amp_peak:.0f} K: "
          f"{info['iters']} CG iters, converged={info['converged']}, "
          f"T range [{u_ss.min():.1f}, {u_ss.max():.1f}] K")

    # 2) check the transient solver reproduces the steady state when driven
    #    with a constant curve at the same level (ref with_ir_steady.ipynb
    #    cell 22). The amp-offset normalization (ref
    #    run_no_diamond.py:299-301) pins the t=0 sample to ic, so the curve
    #    starts at ic and jumps immediately.
    hold_curve = HeatingCurve(time=np.array([0.0, 1e-12, 1.0]),
                              temp=np.array([problem.ic_temp, amp_peak,
                                             amp_peak]))
    hold_problem = build_problem(mesh, hold_curve, cfg)
    res_hold = run_transient(hold_problem, record_gradient=False, u0=u_ss)
    drift = np.abs(res_hold.final_u - u_ss).max()
    print(f"Transient holds the steady state to {drift:.2e} K over "
          f"{problem.num_steps} steps (should be ~solver tolerance)")
    assert drift < 1e-3, "transient failed to reproduce the steady state"

    # 3) pulsed transient from the steady start — the production workflow
    res = run_transient(problem, record_gradient=False, u0=u_ss)
    print(f"Pulsed run from steady IC: ir watcher peak "
          f"{res.watcher[:, 0].max():.1f} K, oside peak "
          f"{res.watcher[:, 1].max():.1f} K")
    return res


if __name__ == "__main__":
    main()
