"""Simulation integration tests: conservation, determinism, restart,
boundary behavior (the reference's regression style, SURVEY.md §4 —
plus the automated checks it lacked).
"""

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.io import load_checkpoint, save_checkpoint
from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation


def small_drop(dtype=jnp.float64):
    scene = build_scene("block_drop_2d", res=32, dtype=dtype)
    return scene


def make_sim(scene):
    return Simulation(
        scene["cfg"], scene["state"], scene["model"], scene["colliders"],
        plasticity=scene["plasticity"],
    )


def test_free_fall_matches_analytics():
    """Before contact the block is in rigid free fall: v = g t, x = x0 - g t^2/2."""
    scene = small_drop()
    sim = make_sim(scene)
    x0 = np.asarray(sim.state.x).copy()
    n_steps, dt = 10, 5e-3
    for _ in range(n_steps):
        sim.step(dt)
    t_total = n_steps * dt
    x = np.asarray(sim.state.x)
    v = np.asarray(sim.state.v)
    np.testing.assert_allclose(v[:, 1], -9.81 * t_total, rtol=1e-6)
    # discrete backward-Euler drop: dx = -g dt^2 * (1 + 2 + ... + n)
    drop = -9.81 * dt * dt * (n_steps * (n_steps + 1) / 2)
    np.testing.assert_allclose(x[:, 1] - x0[:, 1], drop, rtol=1e-6)
    # horizontal drift ~ 0
    np.testing.assert_allclose(x[:, 0], x0[:, 0], atol=1e-10)


def test_impact_converges_and_settles():
    scene = small_drop()
    sim = make_sim(scene)
    for _ in range(120):
        sim.step()
    recs = sim.metrics.records
    assert all(r["converged"] for r in recs), "Newton failed to converge"
    assert any(r["newton_iters"] > 0 for r in recs), "implicit solve never engaged"
    x = np.asarray(sim.state.x)
    assert np.isfinite(x).all()
    # settled on the floor (0.15), not sunk below more than ~a cell
    assert x[:, 1].min() > 0.15 - 1.5 * scene["cfg"].dx
    # kinetic energy decayed after settling
    assert recs[-1]["kinetic_energy"] < 0.1 * max(r["kinetic_energy"] for r in recs)


def test_determinism_bitwise():
    """Same scene, two runs -> bitwise-identical state (SURVEY.md §5.2)."""
    runs = []
    for _ in range(2):
        sim = make_sim(small_drop())
        for _ in range(40):
            sim.step(4e-3)
        runs.append(jax.tree_util.tree_map(np.asarray, sim.state))
    for a, b in zip(jax.tree_util.tree_leaves(runs[0]), jax.tree_util.tree_leaves(runs[1])):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_restart_exact(tmp_path):
    """Restart mid-run reproduces the uninterrupted trajectory bitwise."""
    sim = make_sim(small_drop())
    for _ in range(20):
        sim.step(4e-3)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, sim.state, sim.t, sim.step_count)
    for _ in range(10):
        sim.step(4e-3)
    straight = jax.tree_util.tree_map(np.asarray, sim.state)

    state2, t2, sc2 = load_checkpoint(path)
    sim2 = make_sim(small_drop())
    sim2.state, sim2.t, sim2.step_count = state2, t2, sc2
    for _ in range(10):
        sim2.step(4e-3)
    resumed = jax.tree_util.tree_map(np.asarray, sim2.state)
    for a, b in zip(jax.tree_util.tree_leaves(straight), jax.tree_util.tree_leaves(resumed)):
        np.testing.assert_array_equal(a, b)


def test_fault_injection_dt_retry():
    """SURVEY.md §5.3 fault-injection hook: corrupt the state, verify the
    NaN sentinel catches it, then checkpoint-resume recovers the run."""
    import jax.numpy as jnp

    from hot_mpm.io import load_checkpoint, save_checkpoint

    sim = make_sim(small_drop())
    for _ in range(10):
        sim.step(4e-3)
    # checkpoint before the fault
    import tempfile, os
    d = tempfile.mkdtemp()
    path = os.path.join(d, "pre_fault.npz")
    save_checkpoint(path, sim.state, sim.t, sim.step_count)

    # inject: blow up one particle's deformation gradient
    F_bad = sim.state.F.at[0].set(jnp.nan)
    sim.state = sim.state.replace(F=F_bad)
    stats = sim.step(4e-3)
    # sentinel fired: retries were attempted (NaN can't be fixed by dt, so
    # all retries burn, but the run surfaces the event instead of silently
    # propagating)
    assert sim.retry_count > 0

    # recovery: resume from the checkpoint and continue cleanly
    sim.state, sim.t, sim.step_count = load_checkpoint(path)
    sim.retry_count = 0
    for _ in range(5):
        sim.step(4e-3)
    assert sim.retry_count == 0
    assert bool(jnp.all(jnp.isfinite(sim.state.x)))


def test_energy_dissipation_monotone_after_settle():
    """Backward Euler is dissipative: total (kin + potential) energy must not
    blow up; tracks the reference's energy-sanity logging (component #31)."""
    sim = make_sim(small_drop())
    total = []
    for _ in range(100):
        sim.step()
        r = sim.metrics.records[-1]
        total.append(r["kinetic_energy"] + r["potential_energy"])
    e0_fall = total[5]
    assert max(total) < 50 * max(e0_fall, 1e-6), "energy blew up"
    assert np.isfinite(total).all()


def test_binned_slot_step_matches_scatter():
    """The slot-major binned solve path (transfer_impl='binned') takes the
    same trajectory as the plain scatter path — through impact, where the
    implicit solve does real work (docs/KERNEL_PLAN.md slot-major layout)."""
    import dataclasses

    scene_a = small_drop()
    sim_a = make_sim(scene_a)

    scene_b = small_drop()
    # slot_major=True: explicitly exercise the slot-major layout (opt-in
    # since the 2026-08-19 A/B showed the padding tax costs 26% end-to-end)
    from hot_mpm.utils.config import config_from_overrides

    cfg_b = config_from_overrides(scene_b["cfg"], {"solver.slot_major": True})
    cfg_b = dataclasses.replace(cfg_b, transfer_impl="binned")
    sim_b = Simulation(
        cfg_b, scene_b["state"], scene_b["model"], scene_b["colliders"],
        plasticity=scene_b["plasticity"],
    )
    assert sim_b._plan.bin_caps is not None

    for k in range(12):
        sa = sim_a.step(6e-3)
        sb = sim_b.step(6e-3)
        assert int(sa.newton_iters) == int(sb.newton_iters), f"step {k}"
        assert int(sa.cg_iters) == int(sb.cg_iters), f"step {k}"
    np.testing.assert_allclose(
        np.asarray(sim_b.state.x), np.asarray(sim_a.state.x), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(sim_b.state.v), np.asarray(sim_a.state.v), atol=1e-8
    )


def test_binned_slot_step_multigrid_matches():
    """Slot-major solve + MG preconditioner (ctx re-permuted to particle
    order for the hierarchy) == scatter path with MG."""
    import dataclasses

    def mg_sim(impl):
        scene = small_drop()
        sol = dataclasses.replace(scene["cfg"].solver, preconditioner="multigrid",
                                  slot_major=(impl == "binned"))
        cfg = dataclasses.replace(scene["cfg"], solver=sol, transfer_impl=impl)
        return Simulation(
            cfg, scene["state"], scene["model"], scene["colliders"],
            plasticity=scene["plasticity"],
        )

    sim_a = mg_sim("scatter")
    sim_b = mg_sim("binned")
    for k in range(6):
        sa = sim_a.step(6e-3)
        sb = sim_b.step(6e-3)
        assert int(sa.newton_iters) == int(sb.newton_iters), f"step {k}"
        assert int(sa.cg_iters) == int(sb.cg_iters), f"step {k}"
    np.testing.assert_allclose(
        np.asarray(sim_b.state.x), np.asarray(sim_a.state.x), atol=1e-9
    )


def test_bin_overflow_regrows_and_matches():
    """Static bin tables are sized tight and REGROWN on overflow (SURVEY.md
    §7 hard-part 2's capacity policy): force a tiny per-cell cap, verify the
    step recompiles with larger caps and still matches the scatter path."""
    import dataclasses

    scene_a = small_drop()
    sim_a = make_sim(scene_a)

    scene_b = small_drop()
    cfg_b = dataclasses.replace(
        scene_b["cfg"], transfer_impl="binned", bin_cap=1
    )
    sim_b = Simulation(
        cfg_b, scene_b["state"], scene_b["model"], scene_b["colliders"],
        plasticity=scene_b["plasticity"],
    )
    caps0 = sim_b._plan.bin_caps
    assert caps0[1] == 1  # deliberately too small

    for k in range(3):
        sa = sim_a.step(6e-3)
        sb = sim_b.step(6e-3)
        assert int(sa.newton_iters) == int(sb.newton_iters), f"step {k}"
    assert sim_b._plan.bin_caps[1] > 1  # regrow happened
    np.testing.assert_allclose(
        np.asarray(sim_b.state.x), np.asarray(sim_a.state.x), atol=1e-9
    )


def test_cylinder_collider_sdf_and_sampling():
    """Cylinder level set (SURVEY #16): sign classification, |normal| = 1,
    normal == finite-difference gradient of phi, and seeding stays inside."""
    import numpy as np
    from hot_mpm.sim.collision import Cylinder
    from hot_mpm.sim.seeding import sample_cylinder

    cyl = Cylinder(center=(0.5, 0.5, 0.5), axis=(0.0, 0.0, 1.0),
                   radius=0.2, half_height=0.1)
    pts = jnp.asarray([
        [0.5, 0.5, 0.5],     # center: inside
        [0.75, 0.5, 0.5],    # radially outside
        [0.5, 0.5, 0.7],     # above cap
        [0.66, 0.5, 0.54],   # inside near wall
        [0.8, 0.5, 0.8],     # outside corner
    ])
    phi = np.asarray(cyl.phi(pts, 0.0))
    assert phi[0] < 0 and phi[3] < 0
    assert phi[1] > 0 and phi[2] > 0 and phi[4] > 0
    np.testing.assert_allclose(phi[1], 0.05, atol=1e-6)
    np.testing.assert_allclose(phi[2], 0.1, atol=1e-6)
    n = np.asarray(cyl.normal(pts, 0.0))
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-6)
    # FD gradient check away from the inside ridge
    eps = 1e-4
    for p in [pts[1], pts[2], pts[4], pts[3]]:
        g = []
        for a in range(3):
            dp = jnp.zeros(3).at[a].set(eps)
            g.append(float(cyl.phi((p + dp)[None], 0.0)[0]
                           - cyl.phi((p - dp)[None], 0.0)[0]) / (2 * eps))
        gn = np.asarray(g) / np.linalg.norm(g)
        pn = np.asarray(cyl.normal(p[None], 0.0)[0])
        np.testing.assert_allclose(pn, gn, atol=1e-3)

    x, vol = sample_cylinder(jax.random.PRNGKey(0), (0.5, 0.5, 0.5),
                             (0.0, 0.0, 1.0), 0.2, 0.1, 1.0 / 32, 8)
    assert x.shape[0] > 100 and vol > 0
    assert float(jnp.max(cyl.phi(x, 0.0))) < 0


def test_vtk_writer_native_matches_python(tmp_path):
    """VTK frame writer (SURVEY #17 VtkIO): native C++ and the Python
    fallback must produce identical bytes; header must parse."""
    import numpy as np
    from hot_mpm import native

    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 3)).astype(np.float32)
    v = rng.standard_normal((37, 3)).astype(np.float32)
    p_native = tmp_path / "a.vtk"
    p_py = tmp_path / "b.vtk"
    native.write_vtk(str(p_native), x, v)
    lib = native._LIB
    try:
        native._LIB = None          # force the fallback
        native._TRIED = True
        native.write_vtk(str(p_py), x, v)
    finally:
        native._LIB = lib
        native._TRIED = True
    a, b = p_native.read_bytes(), p_py.read_bytes()
    assert a == b
    assert a.startswith(b"# vtk DataFile Version 3.0")
    assert b"POINTS 37 float" in a and b"VECTORS v float" in a


def test_wheel_scene_spins_and_steps():
    """wheel_3d: rigid initial spin (|v| = omega*r), and the implicit step
    runs with plasticity engaged."""
    scene = build_scene("wheel_3d", res=24, ppc=2)
    st = scene["state"]
    import numpy as np
    rel = np.asarray(st.x) - np.asarray([0.5, 0.42, 0.5])
    r = np.linalg.norm(rel[:, :2], axis=-1)
    speed = np.linalg.norm(np.asarray(st.v), axis=-1)
    np.testing.assert_allclose(speed, 8.0 * np.pi * r, rtol=1e-5)
    sim = Simulation(scene["cfg"], st, scene["model"], scene["colliders"],
                     plasticity=scene["plasticity"])
    for _ in range(3):
        stats = sim.step(1e-3)
    assert bool(stats.converged)
    assert np.isfinite(np.asarray(sim.state.x)).all()


def test_boards_and_chain_scenes_step():
    """Paper-suite breadth scenes (SURVEY.md #33): boards (thin stiff
    elastoplastic plates) and chain (falling ring sections) build and
    survive implicit steps with finite state."""
    import numpy as np

    for name, kwargs, steps in (
        ("boards_3d", dict(res=32, ppc=2), 3),
        ("chain_2d", dict(res=48), 6),
    ):
        scene = build_scene(name, dtype=jnp.float64, **kwargs)
        assert scene["state"].n > 100, name
        sim = make_sim(scene)
        for _ in range(steps):
            stats = sim.step(2e-3)
        assert bool(stats.converged), name
        assert np.all(np.isfinite(np.asarray(sim.state.x))), name
