"""Tests for reference-parity extras: explicit integrator, LBFGS baseline,
coarse-CG multigrid option, DiffTest, OBJ mesh sampling.
"""

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation
from hot_mpm.utils.config import config_from_overrides


def test_explicit_integrator_free_fall_and_impact():
    scene = build_scene("block_drop_2d", res=32, E=1e4, dtype=jnp.float64)
    cfg = config_from_overrides(scene["cfg"], {"solver.integrator": "explicit"})
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    for _ in range(200):
        sim.step(5e-4)  # explicit needs small dt
    x = np.asarray(sim.state.x)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > 0.15 - 2 * cfg.dx  # resting on the floor
    assert all(r["newton_iters"] == 0 for r in sim.metrics.records)


def test_lbfgs_matches_newton_trajectory():
    """LBFGS-H baseline converges and lands near the Newton trajectory."""
    states = {}
    for solver in ("newton", "lbfgs"):
        scene = build_scene("block_drop_2d", res=32, E=1e5, dtype=jnp.float64)
        cfg = config_from_overrides(
            scene["cfg"], {"solver.nonlinear": solver, "solver.max_cg": 300}
        )
        sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
        for _ in range(60):
            sim.step(4e-3)
        assert all(r["converged"] for r in sim.metrics.records), solver
        states[solver] = np.asarray(sim.state.x)
    # same CN tolerance -> same physics within the tolerance's slack
    diff = np.abs(states["newton"] - states["lbfgs"]).max()
    assert diff < 5e-3, diff


def test_coarse_cg_multigrid():
    scene = build_scene("block_drop_2d", res=32, E=1e7, dtype=jnp.float64)
    cfg = config_from_overrides(
        scene["cfg"],
        {
            "solver.preconditioner": "multigrid",
            "solver.multigrid.levels": 3,
            "solver.multigrid.coarse_solver": "cg",
        },
    )
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    for _ in range(60):
        sim.step(4e-3)
    assert all(r["converged"] for r in sim.metrics.records)


def test_difftest_orders():
    """FD refinement sweep shows ~2nd-order consistency of E -> r -> H."""
    from hot_mpm.ops import transfer
    from hot_mpm.sim import collision
    from hot_mpm.sim import objective as obj_mod
    from hot_mpm.sim.difftest import run_difftest

    scene = build_scene("block_drop_2d", res=24, E=1e5, dtype=jnp.float64)
    cfg = scene["cfg"]
    state = scene["state"]
    rng = np.random.default_rng(5)
    state = state.replace(
        F=state.F + 0.05 * jnp.asarray(rng.standard_normal(state.F.shape))
    )
    res = cfg.grid_res[:2]
    dx, dt = cfg.dx, 3e-3
    n_nodes = transfer.n_nodes_of(res)
    st = transfer.particle_stencil(state.x, dx, res)
    gm, gmv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    active = gm > 0
    vg = gmv * jnp.where(active, 1.0 / jnp.maximum(gm, 1e-30), 0.0)[:, None]
    proj = jnp.broadcast_to(jnp.eye(2), (n_nodes, 2, 2))
    obj = obj_mod.make_objective(
        scene["model"], st, state.F, state.V0, state.mu, state.lam, gm, vg,
        proj, dt, dx,
    )
    out = run_difftest(scene["model"], obj, vg, verbose=False)
    # orders should approach 2 in the refinement regime before fp noise
    og = [o for o in out["order_grad"][:4] if np.isfinite(o)]
    oh = [o for o in out["order_hess"][:4] if np.isfinite(o)]
    assert np.mean(og) > 1.7, out["order_grad"]
    assert np.mean(oh) > 1.7, out["order_hess"]


def test_obj_mesh_sampling(tmp_path):
    from hot_mpm.io.mesh import load_obj, points_inside_mesh, sample_mesh

    # unit cube OBJ
    cube = """
v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\nv 1 1 1\nv 0 1 1
f 1 3 2\nf 1 4 3\nf 5 6 7\nf 5 7 8\nf 1 2 6\nf 1 6 5\nf 2 3 7\nf 2 7 6
f 3 4 8\nf 3 8 7\nf 4 1 5\nf 4 5 8
"""
    p = tmp_path / "cube.obj"
    p.write_text(cube.strip() + "\n")
    verts, faces = load_obj(str(p))
    assert verts.shape == (8, 3) and faces.shape == (12, 3)

    pts = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [-0.1, 0.2, 0.3],
                    [0.9, 0.9, 0.9]])
    inside = points_inside_mesh(pts, verts, faces)
    np.testing.assert_array_equal(inside, [True, False, False, True])

    key = jax.random.PRNGKey(0)
    x, vol = sample_mesh(key, str(p), dx=0.125, particles_per_cell=2,
                         scale=0.5, translate=(0.25, 0.25, 0.25))
    x = np.asarray(x)
    assert len(x) > 0
    assert (x.min(0) >= 0.24).all() and (x.max(0) <= 0.76).all()
