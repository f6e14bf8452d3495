"""Round-3 fixes, part 1: the f32 B>=2 batched-operator divergence.

Root cause (round-3 diagnosis): the material contraction in
``combine_operator`` (and the ELL/tridiag variants), written as
``jnp.einsum("...m,mkij->...kij", coeffs, S)``, lowers on an accelerator to
a matrix-unit dot_general at DEFAULT precision — reduced-precision inputs
(bf16 or TF32) — *only when the
coefficient array is batched* (B >= 2); at B = 1 the degenerate dot
simplifies to full-f32 multiply-adds. The resulting ~4e-3 relative
perturbation of the backward-Euler operator (scaled condition ~1e6) makes it
indefinite, so CG diverges identically on every lane of a batched sweep
while the same single config converges (ref sweep semantics:
parameter_sweep.py:157-166). Fix: statically-unrolled elementwise multiply-add
(``ops.stencil.material_combine``). These tests pin the fix at the lowering
level, which reproduces on CPU where the numeric failure does not; the
compiled form on a GPU is checked by heatflow_tpu.devicecheck.
"""

import jax
import jax.numpy as jnp
import numpy as np

from heatflow_tpu.ops.ell import ell_combine
from heatflow_tpu.ops.stencil import combine_operator, material_combine
from heatflow_tpu.ops.tridiag import combine_tridiag


def _rand(shape, seed):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape), jnp.float32)


def test_material_combine_matches_einsum_reference():
    coeffs = _rand((3, 5), 0)          # batched (B=3, n_mats=5)
    S = _rand((5, 7, 6, 9), 1)
    out = material_combine(coeffs, S)
    ref = np.einsum("bm,mkij->bkij", np.asarray(coeffs, np.float64),
                    np.asarray(S, np.float64))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)
    # unbatched coefficients broadcast the same way
    out1 = material_combine(coeffs[0], S)
    np.testing.assert_allclose(np.asarray(out1), ref[0], rtol=1e-5,
                               atol=1e-5)


def test_batched_combine_matches_per_lane_bitwise():
    """B=2 duplicate lanes must equal the B=1 result exactly — the failure
    mode was a *different compiled computation* at B>=2, not lane mixing."""
    K, M = _rand((4, 7, 8, 10), 2), jnp.abs(_rand((4, 7, 8, 10), 3))
    kp, rc = jnp.abs(_rand((4,), 4)), jnp.abs(_rand((4,), 5))
    dt = jnp.float32(0.3)
    A1, M1 = combine_operator(K, M, kp, rc, dt)
    A2, M2 = combine_operator(K, M, jnp.stack([kp, kp]),
                              jnp.stack([rc, rc]), dt)
    assert np.array_equal(np.asarray(A2[0]), np.asarray(A1))
    assert np.array_equal(np.asarray(A2[1]), np.asarray(A1))
    assert np.array_equal(np.asarray(M2[0]), np.asarray(M1))


def _assert_no_dot(lowered_text, label):
    assert "dot_general" not in lowered_text and "dot(" not in lowered_text, \
        f"{label} lowers to a dot — reduced-precision trap (see module " \
        "docstring)"


def test_combine_lowerings_contain_no_dot():
    """The load-bearing property: no variant of the material combine may
    lower to a dot_general, batched or not."""
    dt = jnp.float32(0.5)

    K = jax.ShapeDtypeStruct((5, 7, 16, 20), jnp.float32)
    M = jax.ShapeDtypeStruct((5, 7, 16, 20), jnp.float32)
    for cshape in [(5,), (2, 5), (64, 5)]:
        c = jax.ShapeDtypeStruct(cshape, jnp.float32)
        txt = jax.jit(combine_operator).lower(K, M, c, c, dt).as_text()
        _assert_no_dot(txt, f"combine_operator coeffs{cshape}")

    Ke = jax.ShapeDtypeStruct((5, 30, 9), jnp.float32)
    Me = jax.ShapeDtypeStruct((5, 30, 9), jnp.float32)
    c = jax.ShapeDtypeStruct((2, 5), jnp.float32)
    txt = jax.jit(ell_combine).lower(Ke, Me, c, c, dt).as_text()
    _assert_no_dot(txt, "ell_combine batched")

    Kt = jax.ShapeDtypeStruct((5, 3, 17), jnp.float32)
    Mt = jax.ShapeDtypeStruct((5, 3, 17), jnp.float32)
    txt = jax.jit(combine_tridiag).lower(Kt, Mt, c, c, dt).as_text()
    _assert_no_dot(txt, "combine_tridiag batched")


def test_vmapped_full_core_lowering_has_no_dot(tmp_path):
    """End-to-end guard: the vmapped recording-sweep core (the composition
    that actually diverged) must contain no dot_general anywhere."""
    from heatflow_tpu.geometry import build_layout
    from heatflow_tpu.mesh.structured import build_structured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.sim.stepper import make_simulate_fn
    from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat_csv)
    cfg["timing"]["num_steps"] = 3
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(str(heat_csv)), cfg,
                            watcher_points={"p": (0.0, 0.0)})
    fn = make_simulate_fn(problem, dtype=jnp.float32, rtol=1e-4,
                          record_gradient=True, rtol_wrt="b")
    rc = jnp.asarray(problem.rho_cvs, jnp.float32)
    nz, nr = mesh.shape

    def batched(kps, u0):
        return jax.vmap(
            lambda kp, u: fn.core(fn.dev, fn.mg, kp, rc,
                                  jnp.float32(problem.fwhm), u,
                                  jnp.float32(0.0), None))(kps, u0)

    kps = jax.ShapeDtypeStruct((2, len(problem.kappas)), jnp.float32)
    u0 = jax.ShapeDtypeStruct((2, nz, nr), jnp.float32)
    txt = jax.jit(batched).lower(kps, u0).as_text()
    _assert_no_dot(txt, "vmapped full stepper core")
