"""Fully-sharded step tests: the shard_map P2G+Newton+G2P pipeline must
reproduce the single-device step on CPU-simulated meshes (configs 4-5
partitioned-grid correctness, BASELINE.json:10).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hot_mpm.parallel.mesh import loop_mesh_width, make_mesh
from hot_mpm.parallel.sharded_step import make_sharded_step
from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation
from hot_mpm.sim.simulation import advance_one_step


def test_sharded_step_3d_matches_single_device():
    scene = build_scene("twisting_bar_3d", res=16, ppc=2)
    cfg = scene["cfg"]
    step_ref = jax.jit(
        functools.partial(
            advance_one_step, cfg=cfg, model=scene["model"],
            colliders=scene["colliders"], plasticity=None,
        )
    )
    mesh = make_mesh((loop_mesh_width(4),), ("x",))
    step_sh = make_sharded_step(
        mesh, cfg, scene["model"], scene["colliders"], n_max=scene["state"].n
    )
    s_ref = s_sh = scene["state"]
    t = 0.0
    for _ in range(5):
        s_ref, st_ref = step_ref(s_ref, jnp.float32(1e-3), jnp.float32(t))
        s_sh, st_sh = step_sh(s_sh, jnp.float32(1e-3), jnp.float32(t))
        t += 1e-3
        assert int(st_sh.newton_iters) == int(st_ref.newton_iters)
    np.testing.assert_allclose(np.asarray(s_sh.x), np.asarray(s_ref.x), atol=2e-6)
    np.testing.assert_allclose(np.asarray(s_sh.F), np.asarray(s_ref.F), atol=2e-5)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_step_matches_single_device(n_devices):
    scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
    cfg = scene["cfg"]

    # single-device trajectory
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    n_steps = 60  # through impact
    for _ in range(n_steps):
        sim.step(4e-3)
    ref = jax.tree_util.tree_map(np.asarray, sim.state)
    ref_cg = sum(r["cg_iters"] for r in sim.metrics.records)
    ref_newton = sum(r["newton_iters"] for r in sim.metrics.records)

    # sharded trajectory
    mesh = make_mesh((loop_mesh_width(n_devices),), ("x",))
    step = make_sharded_step(
        mesh, cfg, scene["model"], scene["colliders"],
        n_max=scene["state"].n,  # worst case: everything on one slab
    )
    state = scene["state"]
    tot_newton = tot_cg = 0
    t = 0.0
    for _ in range(n_steps):
        state, stats = step(state, jnp.float64(4e-3), jnp.float64(t))
        assert not bool(stats.partition_overflow)
        assert bool(stats.converged)
        tot_newton += int(stats.newton_iters)
        tot_cg += int(stats.cg_iters)
        t += 4e-3

    assert tot_newton == ref_newton, (tot_newton, ref_newton)
    assert abs(tot_cg - ref_cg) <= 2, (tot_cg, ref_cg)
    np.testing.assert_allclose(np.asarray(state.x), ref.x, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.v), ref.v, atol=1e-8)
    np.testing.assert_allclose(np.asarray(state.F), ref.F, atol=1e-8)


@pytest.mark.parametrize("coarse_solver,assembled", [
    ("direct", False), ("smoother", False), ("direct", True),
])
def test_sharded_step_multigrid_matches(coarse_solver, assembled):
    """Sharded MG preconditioner (slab levels + halo collectives +
    agglomerated coarsest solve, parallel/sharded_mg) == single-device MG:
    identical Newton/CG counts and trajectories through impact.

    assembled=True additionally exercises the distributed explicit-BSR
    levels (per-device partial operators over extended slabs, supertile
    SpMV smoothing) — the operator must be identical to the matrix-free
    quadrature path, so iteration counts still match the single-device
    MATRIX-FREE reference in f64."""
    import dataclasses

    scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
    # quadrature coarsening: the assembled operator == the matrix-free one,
    # so the single-device MATRIX-FREE reference matches exactly (the
    # galerkin default has a different — better — coarse correction and is
    # pinned against single-device galerkin in its own test below)
    mgc = dataclasses.replace(
        scene["cfg"].solver.multigrid, levels=2, coarse_solver=coarse_solver,
        assembled=assembled, coarsening="quadrature",
    )
    sol = dataclasses.replace(
        scene["cfg"].solver, preconditioner="multigrid", multigrid=mgc
    )
    cfg = dataclasses.replace(scene["cfg"], solver=sol)

    # single-device reference always runs MATRIX-FREE quadrature levels, so
    # assembled=True proves cross-path operator equality end to end
    mgc_ref = dataclasses.replace(mgc, assembled=False)
    cfg_ref = dataclasses.replace(
        cfg, solver=dataclasses.replace(sol, multigrid=mgc_ref)
    )
    sim = Simulation(cfg_ref, scene["state"], scene["model"], scene["colliders"])
    n_steps = 58
    for _ in range(n_steps):
        sim.step(5e-3)
    ref = jax.tree_util.tree_map(np.asarray, sim.state)
    ref_cg = sum(r["cg_iters"] for r in sim.metrics.records)
    ref_newton = sum(r["newton_iters"] for r in sim.metrics.records)
    assert ref_newton > 0  # impact engaged the solver

    mesh = make_mesh((loop_mesh_width(4),), ("x",))
    step = make_sharded_step(
        mesh, cfg, scene["model"], scene["colliders"], n_max=scene["state"].n
    )
    state = scene["state"]
    tot_newton = tot_cg = 0
    t = 0.0
    for _ in range(n_steps):
        state, stats = step(state, jnp.float64(5e-3), jnp.float64(t))
        tot_newton += int(stats.newton_iters)
        tot_cg += int(stats.cg_iters)
        t += 5e-3

    assert tot_newton == ref_newton, (tot_newton, ref_newton)
    assert abs(tot_cg - ref_cg) <= 2, (tot_cg, ref_cg)
    np.testing.assert_allclose(np.asarray(state.x), ref.x, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.v), ref.v, atol=1e-8)


def test_sharded_mg_binned_assembly_and_overflow_flag():
    """Assembled sharded MG with the scatter-free binned assembly:
    (a) adequate mg_bin_caps -> same trajectory as the matrix-free
    single-device reference and grid_overflow stays False;
    (b) undersized caps -> stats.grid_overflow flips True instead of
    silently dropping particles' Hessian blocks (ADVICE r1 #1)."""
    import dataclasses

    scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
    mgc = dataclasses.replace(
        scene["cfg"].solver.multigrid, levels=2, coarse_solver="direct",
        assembled=True, coarsening="quadrature",
    )
    sol = dataclasses.replace(
        scene["cfg"].solver, preconditioner="multigrid", multigrid=mgc
    )
    cfg = dataclasses.replace(scene["cfg"], solver=sol)
    n = scene["state"].n

    # single-device matrix-free reference
    mgc_ref = dataclasses.replace(mgc, assembled=False)
    cfg_ref = dataclasses.replace(
        cfg, solver=dataclasses.replace(sol, multigrid=mgc_ref)
    )
    sim = Simulation(cfg_ref, scene["state"], scene["model"], scene["colliders"])
    n_steps = 58
    for _ in range(n_steps):
        sim.step(5e-3)
    ref = jax.tree_util.tree_map(np.asarray, sim.state)
    ref_newton = sum(r["newton_iters"] for r in sim.metrics.records)
    assert ref_newton > 0

    mesh = make_mesh((loop_mesh_width(4),), ("x",))
    step = make_sharded_step(
        mesh, cfg, scene["model"], scene["colliders"], n_max=n,
        mg_bin_caps=((512, n), (512, n)),
    )
    state = scene["state"]
    tot_newton = 0
    t = 0.0
    for _ in range(n_steps):
        state, stats = step(state, jnp.float64(5e-3), jnp.float64(t))
        assert not bool(stats.grid_overflow)
        tot_newton += int(stats.newton_iters)
        t += 5e-3
    assert tot_newton == ref_newton, (tot_newton, ref_newton)
    np.testing.assert_allclose(np.asarray(state.x), ref.x, atol=1e-9)

    # undersized per-cell cap: the flag must fire on the first step
    step_bad = make_sharded_step(
        mesh, cfg, scene["model"], scene["colliders"], n_max=n,
        mg_bin_caps=((512, 1), (512, 1)),
    )
    _, stats_bad = step_bad(scene["state"], jnp.float64(5e-3), jnp.float64(0.0))
    assert bool(stats_bad.grid_overflow)


def test_sharded_galerkin_mg_matches_single_device():
    """Galerkin-coarsened sharded MG (per-device RAP of the level-0 partial,
    3-plane coarse halos, mass inside the partials, agglomerated Galerkin
    coarse factor) == the single-device galerkin assembled MG: identical
    Newton/CG counts and trajectories (VERDICT r1 #5)."""
    import dataclasses

    scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
    mgc = dataclasses.replace(
        scene["cfg"].solver.multigrid, levels=2, coarse_solver="direct",
        assembled=True, coarsening="galerkin",
    )
    sol = dataclasses.replace(
        scene["cfg"].solver, preconditioner="multigrid", multigrid=mgc
    )
    cfg = dataclasses.replace(scene["cfg"], solver=sol)

    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    n_steps = 58
    for _ in range(n_steps):
        sim.step(5e-3)
    ref = jax.tree_util.tree_map(np.asarray, sim.state)
    ref_cg = sum(r["cg_iters"] for r in sim.metrics.records)
    ref_newton = sum(r["newton_iters"] for r in sim.metrics.records)
    assert ref_newton > 0

    mesh = make_mesh((loop_mesh_width(4),), ("x",))
    step = make_sharded_step(
        mesh, cfg, scene["model"], scene["colliders"], n_max=scene["state"].n
    )
    state = scene["state"]
    tot_newton = tot_cg = 0
    t = 0.0
    for _ in range(n_steps):
        state, stats = step(state, jnp.float64(5e-3), jnp.float64(t))
        tot_newton += int(stats.newton_iters)
        tot_cg += int(stats.cg_iters)
        t += 5e-3
    assert tot_newton == ref_newton, (tot_newton, ref_newton)
    assert abs(tot_cg - ref_cg) <= 2, (tot_cg, ref_cg)
    np.testing.assert_allclose(np.asarray(state.x), ref.x, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.v), ref.v, atol=1e-8)


def test_migrating_step_matches_single_device():
    """Neighbor-local migration (VERDICT r1 #9): particles translated in +x
    cross slab boundaries over many steps; the persistent-layout migrating
    step reproduces the single-device trajectory exactly, with zero global
    repartitions, and its compiled HLO contains NO sort and NO all-gather
    over particles."""
    import dataclasses

    from hot_mpm.parallel.sharded_step import (
        ShardedSimulation, make_migrating_step, partition_with_ids,
    )

    scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
    # horizontal drift so particles cross x-slabs (the partition axis)
    state = scene["state"].replace(
        v=scene["state"].v + jnp.asarray([0.35, 0.0])[None, :]
    )
    cfg = scene["cfg"]

    # single-device reference
    sim = Simulation(cfg, state, scene["model"], scene["colliders"])
    n_steps = 72
    for _ in range(n_steps):
        sim.step(4e-3)
    ref = jax.tree_util.tree_map(np.asarray, sim.state)
    ref_newton = sum(r["newton_iters"] for r in sim.metrics.records)
    assert ref_newton > 0

    mesh = make_mesh((loop_mesh_width(4),), ("x",))
    ssim = ShardedSimulation(
        mesh, cfg, state, scene["model"], scene["colliders"],
        n_max=state.n, migrate_cap=state.n // 2,
    )
    tot_newton = 0
    for _ in range(n_steps):
        stats = ssim.step(4e-3)
        assert bool(stats.converged)
        tot_newton += int(stats.newton_iters)
    assert ssim.repartitions == 0
    assert tot_newton == ref_newton, (tot_newton, ref_newton)
    out = jax.tree_util.tree_map(np.asarray, ssim.state)
    np.testing.assert_allclose(out.x, ref.x, atol=1e-9)
    np.testing.assert_allclose(out.v, ref.v, atol=1e-8)
    np.testing.assert_allclose(out.F, ref.F, atol=1e-8)

    # every particle id is still present exactly once
    ids = np.asarray(ssim.ids).reshape(-1)
    ids = ids[ids >= 0]
    assert len(ids) == state.n and len(np.unique(ids)) == state.n

    # HLO audit: no argsort / particle all-gather inside the compiled step
    step = make_migrating_step(
        mesh, cfg, scene["model"], scene["colliders"], n_max=state.n,
        migrate_cap=64,
    )
    blocks, ids0, _ = partition_with_ids(state, cfg, 4, state.n)
    txt = jax.jit(step).lower(
        blocks, ids0, jnp.float64(4e-3), jnp.float64(0.0)
    ).as_text()
    # the only admissible sorts are tiny per-particle lane sorts (the SVD
    # orders 2 singular values along dimension 1); a global particle
    # repartition would sort along dimension 0
    import re

    for m in re.finditer(r'stablehlo\.sort[^{]*dimension = (\d+)', txt):
        assert m.group(1) != "0", "global dim-0 sort leaked into the step"
    assert "all_gather" not in txt and "all-gather" not in txt, (
        "all-gather leaked into the step"
    )


def test_migrating_step_overflow_fallback():
    """An undersized migrate_cap flips the overflow flag and the host
    wrapper recovers via one global repartition."""
    from hot_mpm.parallel.sharded_step import ShardedSimulation

    scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
    state = scene["state"].replace(
        v=scene["state"].v + jnp.asarray([0.6, 0.0])[None, :]
    )
    ssim = ShardedSimulation(
        make_mesh((loop_mesh_width(4),), ("x",)), scene["cfg"], state, scene["model"],
        scene["colliders"], n_max=state.n, migrate_cap=1,
    )
    for _ in range(40):
        ssim.step(4e-3)
    assert ssim.repartitions > 0


def test_overlap_halo_matches():
    """overlap_halo=True (linearity-split halo overlap) == the plain
    exchange: identical trajectories and iteration counts."""
    import dataclasses

    scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
    cfg = scene["cfg"]
    mesh = make_mesh((loop_mesh_width(4),), ("x",))
    results = {}
    for ov in (False, True):
        c = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, overlap_halo=ov)
        )
        step = make_sharded_step(
            mesh, c, scene["model"], scene["colliders"], n_max=scene["state"].n
        )
        state = scene["state"]
        tot = 0
        t = 0.0
        for _ in range(60):
            state, stats = step(state, jnp.float64(4e-3), jnp.float64(t))
            tot += int(stats.cg_iters)
            t += 4e-3
        results[ov] = (np.asarray(state.x), tot)
    assert results[True][1] == results[False][1]
    np.testing.assert_allclose(results[True][0], results[False][0], atol=1e-11)


def test_migration_tight_cap_soak():
    """Tight-capacity migration soak (VERDICT r2 #9): with migrate_cap
    sized near the actual per-step crossing rate (not n/2), a drifting
    scene runs 60 steps with ZERO global repartitions and conserves every
    particle id; the trajectory is bit-identical to a generous-cap run
    (capacity only changes buffer sizes, never values)."""
    from hot_mpm.parallel.sharded_step import ShardedSimulation

    scene = build_scene("block_drop_2d", res=16, dtype=jnp.float64)
    state = scene["state"].replace(
        v=scene["state"].v + jnp.asarray([0.3, 0.0])[None, :]
    )
    cfg = scene["cfg"]
    mesh = make_mesh((loop_mesh_width(4),), ("x",))
    n = state.n
    # crossing-rate cap: particles drift ~v*dt per step; only the boundary
    # sliver crosses. Empirically < n//16 per step here; cap at n//12.
    runs = {}
    for name, cap in (("tight", max(8, n // 12)), ("generous", n // 2)):
        ssim = ShardedSimulation(
            mesh, cfg, state, scene["model"], scene["colliders"],
            n_max=n, migrate_cap=cap,
        )
        for _ in range(60):
            stats = ssim.step(4e-3)
            assert bool(stats.converged)
        assert ssim.repartitions == 0, (name, cap)
        ids = np.asarray(ssim.ids).reshape(-1)
        ids = ids[ids >= 0]
        assert len(ids) == n and len(np.unique(ids)) == n, name
        runs[name] = jax.tree_util.tree_map(np.asarray, ssim.state)
    np.testing.assert_array_equal(runs["tight"].x, runs["generous"].x)
    np.testing.assert_array_equal(runs["tight"].F, runs["generous"].F)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Multi-host checkpoint contract (SURVEY.md §5.4, VERDICT r2 #8):
    save per-process shards mid-run, restore into a FRESH ShardedSimulation,
    and continue — the resumed trajectory equals the uninterrupted one
    exactly (the checkpoint carries the full particle SoA; grid state is
    derived, as in the reference's writeState/readState)."""
    from hot_mpm.parallel.distributed import checkpoint_spec
    from hot_mpm.parallel.sharded_step import ShardedSimulation

    scene = build_scene("block_drop_2d", res=16, dtype=jnp.float64)
    cfg = scene["cfg"]
    D = loop_mesh_width(4)
    mesh = make_mesh((D,), ("x",))
    rows, n_rows = checkpoint_spec(mesh)
    # single process owns every block row
    assert n_rows == D and tuple(rows) == tuple(range(D))

    def new_sim():
        return ShardedSimulation(
            mesh, cfg, scene["state"], scene["model"], scene["colliders"],
            n_max=scene["state"].n, migrate_cap=scene["state"].n // 2,
        )

    ref = new_sim()
    for _ in range(20):
        ref.step(4e-3)

    a = new_sim()
    for _ in range(10):
        a.step(4e-3)
    ckpt = str(tmp_path / "ckpt")
    a.save_checkpoint(ckpt)

    b = new_sim()
    b.restore(ckpt)
    assert b.t == a.t
    for _ in range(10):
        b.step(4e-3)

    out = jax.tree_util.tree_map(np.asarray, b.state)
    exp = jax.tree_util.tree_map(np.asarray, ref.state)
    np.testing.assert_array_equal(out.x, exp.x)
    np.testing.assert_array_equal(out.v, exp.v)
    np.testing.assert_array_equal(out.F, exp.F)


def test_cli_mesh_launch(tmp_path):
    """CLI multi-device path (VERDICT r2 #8): `--set mesh.shape="(-1,)"`
    routes through distributed.initialize + mesh_from_config +
    ShardedSimulation, writes frames and per-process checkpoint shards."""
    import os

    from hot_mpm.cli import main

    out = str(tmp_path / "run")
    rc = main([
        "--scene", "block_drop_2d", "--frames", "1",
        "-o", out, "--quiet",
        "--set", "mesh.shape=(-1,)",
        "--set", "frame_dt=0.008",
        "--set", "max_dt=0.004",
        "--scene-arg", "res=16",
        "--frame-format", "npz",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "frame_00000.npz"))
    assert os.path.exists(
        os.path.join(out, "ckpt_00000", "shard_p0000.npz")
    )
