"""Golden acceptance test (config 1, BASELINE.json:7): one implicit
Newton+CG step of the 2D block drop must match the independent dense numpy
reference — Newton/CG iteration counts and end-of-step positions
(BASELINE.json:5 acceptance, applied against tests/reference_mpm.py since
the reference mount is empty; SURVEY.md §7 hard part 7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation
from hot_mpm.sim.simulation import advance_one_step

from reference_mpm import advance_one_step_ref


def _impact_state(scene, dt):
    """Run the JAX sim until the implicit solve engages, return that state."""
    sim = Simulation(
        scene["cfg"], scene["state"], scene["model"], scene["colliders"]
    )
    for _ in range(300):
        stats = sim.step(dt)
        if int(stats.newton_iters) >= 2:
            return sim.state
    raise AssertionError("impact never engaged the Newton solve")


def test_single_step_matches_dense_reference():
    import dataclasses

    res = 32
    dt = 4e-3
    scene = build_scene("block_drop_2d", res=res, dtype=jnp.float64)
    # config 1 is the PLAIN Newton + mass-Jacobi-PCG rung of the acceptance
    # ladder — the dense numpy reference implements exactly that
    scene["cfg"] = dataclasses.replace(
        scene["cfg"],
        solver=dataclasses.replace(scene["cfg"].solver, preconditioner="jacobi"),
    )
    state = _impact_state(scene, dt)
    cfg = scene["cfg"]

    # --- JAX step
    step = jax.jit(
        functools.partial(
            advance_one_step,
            cfg=cfg,
            model=scene["model"],
            colliders=scene["colliders"],
            plasticity=None,
        )
    )
    new_state, stats = step(state, jnp.float64(dt), jnp.float64(0.0))

    # --- reference step from the same state
    ref = advance_one_step_ref(
        np.asarray(state.x),
        np.asarray(state.v),
        np.asarray(state.C),
        np.asarray(state.F),
        np.asarray(state.m),
        np.asarray(state.V0),
        np.asarray(state.mu),
        np.asarray(state.lam),
        dx=cfg.dx,
        res=cfg.grid_res[:2],
        dt=dt,
        gravity=cfg.gravity[:2],
        floor_y=0.15,
        cn_eps=cfg.solver.cn_eps,
        cg_tol=cfg.solver.cg_tol,
        max_newton=cfg.solver.max_newton,
        max_cg=cfg.solver.max_cg,
    )

    assert int(stats.newton_iters) == ref.newton_iters, (
        f"newton {int(stats.newton_iters)} vs ref {ref.newton_iters}"
    )
    # total CG iterations (sum over Newton its); +-1 slack for fp-boundary
    # termination differences between XLA and numpy reduction orders
    assert abs(int(stats.cg_iters) - sum(ref.cg_iters)) <= 1, (
        f"cg {int(stats.cg_iters)} vs ref {sum(ref.cg_iters)} ({ref.cg_iters})"
    )
    np.testing.assert_allclose(
        float(stats.cn_residual), ref.cn_residual, rtol=1e-6, atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(new_state.x), ref.x, atol=1e-10)
    np.testing.assert_allclose(np.asarray(new_state.v), ref.v, atol=1e-8)
    np.testing.assert_allclose(np.asarray(new_state.F), ref.F, atol=1e-8)


def test_single_step_cubic_matches_dense_reference():
    """Same golden acceptance, CUBIC B-spline transfers (SURVEY.md #13's
    4-wide kernel family): identical Newton/CG counts + positions vs the
    independently generalized numpy reference."""
    import dataclasses

    res = 32
    dt = 4e-3
    scene = build_scene("block_drop_2d", res=res, dtype=jnp.float64)
    scene["cfg"] = dataclasses.replace(
        scene["cfg"],
        transfer_kernel="cubic",
        solver=dataclasses.replace(scene["cfg"].solver, preconditioner="jacobi"),
    )
    state = _impact_state(scene, dt)
    cfg = scene["cfg"]

    step = jax.jit(
        functools.partial(
            advance_one_step,
            cfg=cfg,
            model=scene["model"],
            colliders=scene["colliders"],
            plasticity=None,
        )
    )
    new_state, stats = step(state, jnp.float64(dt), jnp.float64(0.0))

    ref = advance_one_step_ref(
        np.asarray(state.x),
        np.asarray(state.v),
        np.asarray(state.C),
        np.asarray(state.F),
        np.asarray(state.m),
        np.asarray(state.V0),
        np.asarray(state.mu),
        np.asarray(state.lam),
        dx=cfg.dx,
        res=cfg.grid_res[:2],
        dt=dt,
        gravity=cfg.gravity[:2],
        floor_y=0.15,
        cn_eps=cfg.solver.cn_eps,
        cg_tol=cfg.solver.cg_tol,
        max_newton=cfg.solver.max_newton,
        max_cg=cfg.solver.max_cg,
        kernel="cubic",
    )

    assert int(stats.newton_iters) == ref.newton_iters
    assert abs(int(stats.cg_iters) - sum(ref.cg_iters)) <= 1
    np.testing.assert_allclose(np.asarray(new_state.x), ref.x, atol=1e-10)
    np.testing.assert_allclose(np.asarray(new_state.v), ref.v, atol=1e-8)
    np.testing.assert_allclose(np.asarray(new_state.F), ref.F, atol=1e-8)
