"""Multigrid tests (SURVEY.md §4.3 + config-3 acceptance,
BASELINE.json:9): transfer operators are adjoint, the V-cycle contracts
the residual, and MG-PCG beats Jacobi-PCG in CG iterations at matched
tolerance — with iteration counts roughly resolution-independent.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hot_mpm.ops import transfer
from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation
from hot_mpm.solver import multigrid as mg_mod
from hot_mpm.utils.config import config_from_overrides


def _run(precon, res=48, E=1e7, steps=75, dt=4e-3, levels=3):
    scene = build_scene("block_drop_2d", res=res, E=E, dtype=jnp.float64)
    cfg = config_from_overrides(
        scene["cfg"],
        {"solver.preconditioner": precon, "solver.multigrid.levels": levels},
    )
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    tot_cg = tot_newton = 0
    for _ in range(steps):
        stats = sim.step(dt)
        tot_newton += int(stats.newton_iters)
        tot_cg += int(stats.cg_iters)
    assert all(r["converged"] for r in sim.metrics.records)
    return tot_newton, tot_cg


def test_restrict_prolong_adjoint(rng):
    """<R r, e> == <r, P e> — needed for SPD preconditioning."""
    res = (32, 32)
    dx = 1.0 / 32
    cres = mg_mod.coarse_res(res)
    node_pos = transfer.node_positions(res, dx, jnp.float64)
    embed = transfer.particle_stencil(node_pos, 2 * dx, cres)
    nc = transfer.n_nodes_of(cres)
    r = jnp.asarray(rng.standard_normal((transfer.n_nodes_of(res), 2)))
    e = jnp.asarray(rng.standard_normal((nc, 2)))
    lhs = jnp.sum(mg_mod.restrict(embed, r, nc) * e)
    rhs = jnp.sum(r * mg_mod.prolong(embed, e))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_mg_beats_jacobi_in_cg_iterations():
    """Config-3-style acceptance: MG-PCG cuts total CG iterations by >= 3x
    on a stiff scene at matched tolerances."""
    _, cg_jac = _run("jacobi")
    _, cg_mg = _run("multigrid")
    assert cg_mg * 3 <= cg_jac, f"MG {cg_mg} vs Jacobi {cg_jac}"


def _linear_system(res, E=1e7, dt=4e-3, levels=3):
    """One fixed Hessian system A dv = b from the state right after floor
    impact (a physically smooth deformation — what MG is designed for),
    plus both preconditioner closures. Isolates the preconditioner property
    from trajectory/forcing noise."""
    from hot_mpm.sim import collision, objective as obj_mod

    scene = build_scene("block_drop_2d", res=res, E=E, dtype=jnp.float64)
    cfg = scene["cfg"]
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    for _ in range(300):
        if int(sim.step(dt).newton_iters) >= 2:
            break
    state = sim.state
    grid_res = cfg.grid_res[:2]
    dx = cfg.dx
    n_nodes = transfer.n_nodes_of(grid_res)
    st = transfer.particle_stencil(state.x, dx, grid_res)
    gm, gmv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    active = gm > 0
    vg = gmv * jnp.where(active, 1.0 / jnp.maximum(gm, 1e-30), 0.0)[:, None]
    v_star = vg + dt * jnp.asarray([0.0, -9.81])
    node_pos = transfer.node_positions(grid_res, dx, jnp.float64)
    proj, v_bc, constrained = collision.grid_boundary_conditions(
        node_pos, 0.0, scene["colliders"], grid_v=v_star, boundary_margin=2,
        res=grid_res, dx=dx,
    )
    from hot_mpm.sim.collision import apply_bc_to_velocity

    v0 = apply_bc_to_velocity(v_star, proj, v_bc)
    obj = obj_mod.make_objective(
        scene["model"], st, state.F, state.V0, state.mu, state.lam, gm,
        v_star, proj, dt, dx,
    )
    hess = obj_mod.build_hessian(scene["model"], obj, v0)
    b = obj_mod.project(obj, -obj_mod.residual(scene["model"], obj, v0))

    mgs = mg_mod.build_static(state.x, state.m, grid_res, dx, levels,
                              constrained, jnp.float64)

    def make_prec_mg(**mg_overrides):
        import dataclasses

        mcfg = dataclasses.replace(cfg.solver.multigrid, **mg_overrides)
        pre = mg_mod.build_precond(mgs, state.F, hess.ctx, state.V0, dt,
                                   mcfg, 2)
        return lambda r: mg_mod.mg_precondition(mgs, pre, state.F, state.V0,
                                                dt, mcfg, r)

    mult = lambda w: obj_mod.multiply(obj, hess, w)
    project = lambda r: obj_mod.project(obj, r)
    prec_mg = make_prec_mg()
    prec_jac = lambda r: obj_mod.mass_precondition(obj, r)
    return mult, project, prec_mg, prec_jac, b, make_prec_mg


def test_mg_iterations_resolution_independent():
    """HOT's headline property: at fixed tolerance on impact-state systems,
    MG-PCG needs several-fold fewer iterations than Jacobi-PCG at every
    resolution, and its count stops growing at fine resolution (measured
    baseline: MG 20/85/71 vs Jacobi 107/321/319 at 32/64/96)."""
    from hot_mpm.solver.cg import cg_solve

    iters = {}
    for res in (64, 96):
        mult, project, prec_mg, prec_jac, b, _ = _linear_system(res)
        r_mg = cg_solve(mult, b, precondition=prec_mg, project=project,
                        tol=1e-8, max_iters=3000)
        r_jac = cg_solve(mult, b, precondition=prec_jac, project=project,
                         tol=1e-8, max_iters=3000)
        assert bool(r_mg.converged) and bool(r_jac.converged)
        iters[res] = (int(r_mg.iters), int(r_jac.iters))
    for res, (mg_i, jac_i) in iters.items():
        assert mg_i * 3 <= jac_i, iters
    # near-resolution-independence: no further growth from 64 -> 96
    assert iters[96][0] <= 1.3 * iters[64][0], iters


def test_mg_direct_coarse_solver():
    """coarse_solver="direct" (dense Cholesky of the agglomerated coarsest
    operator — the reference's Eigen LDLT option): MG-PCG must converge and
    need no more iterations than the smoother-coarse V-cycle."""
    from hot_mpm.solver.cg import cg_solve

    mult, project, prec_sm, _, b, make_prec = _linear_system(48)
    prec_dir = make_prec(coarse_solver="direct")
    r_dir = cg_solve(mult, b, precondition=prec_dir, project=project,
                     tol=1e-8, max_iters=3000)
    r_sm = cg_solve(mult, b, precondition=prec_sm, project=project,
                    tol=1e-8, max_iters=3000)
    assert bool(r_dir.converged)
    assert int(r_dir.iters) <= int(r_sm.iters) + 2, (
        int(r_dir.iters), int(r_sm.iters),
    )


def test_vcycle_contracts_residual(rng):
    """One V-cycle as a stationary iteration must reduce |r| substantially
    on the free subspace (smoke test of smoother + coarse correction)."""
    from hot_mpm.models import constitutive as cm
    from hot_mpm.sim import collision, objective as obj_mod
    from hot_mpm.sim.simulation import advance_one_step

    scene = build_scene("block_drop_2d", res=32, E=1e6, dtype=jnp.float64)
    cfg = scene["cfg"]
    state = scene["state"]
    # deform slightly so the elastic term is nontrivial
    state = state.replace(
        F=state.F + 0.02 * jnp.asarray(rng.standard_normal(state.F.shape))
    )
    res = cfg.grid_res[:2]
    dx, dt = cfg.dx, 2e-3
    n_nodes = transfer.n_nodes_of(res)
    st = transfer.particle_stencil(state.x, dx, res)
    gm, gmv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    active = gm > 0
    vg = gmv * jnp.where(active, 1.0 / jnp.maximum(gm, 1e-30), 0.0)[:, None]
    node_pos = transfer.node_positions(res, dx, jnp.float64)
    proj, _, constrained = collision.grid_boundary_conditions(
        node_pos, 0.0, scene["colliders"], grid_v=vg, boundary_margin=2,
        res=res, dx=dx,
    )
    obj = obj_mod.make_objective(
        scene["model"], st, state.F, state.V0, state.mu, state.lam, gm, vg,
        proj, dt, dx,
    )
    hess = obj_mod.build_hessian(scene["model"], obj, vg)
    mgs = mg_mod.build_static(
        state.x, state.m, res, dx, 3, constrained, jnp.float64
    )
    mcfg = cfg.solver.multigrid
    pre = mg_mod.build_precond(mgs, state.F, hess.ctx, state.V0, dt, mcfg, 2)

    b = obj_mod.project(obj, jnp.asarray(rng.standard_normal((n_nodes, 2))))
    # stationary iteration x_{k+1} = x_k + Vcycle(b - A x_k)
    x = jnp.zeros_like(b)
    norms = []
    for _ in range(3):
        r = obj_mod.project(obj, b - obj_mod.multiply(obj, hess, x))
        norms.append(float(jnp.linalg.norm(r)))
        x = x + mg_mod.mg_precondition(mgs, pre, state.F, state.V0, dt, mcfg, r)
    r = obj_mod.project(obj, b - obj_mod.multiply(obj, hess, x))
    norms.append(float(jnp.linalg.norm(r)))
    # 3 cycles should reduce the residual by >= 10x overall
    assert norms[-1] < 0.1 * norms[0], norms


def test_assembled_vcycle_matches_matrix_free(rng):
    """Assembled levels (explicit tile-row BSR + supertile SpMV smoothers)
    must produce the same V-cycle output as the matrix-free quadrature
    path — it is the same operator, assembled once per Newton iteration."""
    from hot_mpm.sim import objective as obj_mod
    from hot_mpm.utils.config import MultigridConfig

    scene = build_scene("block_drop_2d", res=32, E=1e6, dtype=jnp.float64)
    cfg = scene["cfg"]
    state = scene["state"]
    state = state.replace(
        F=state.F + 0.02 * jnp.asarray(rng.standard_normal(state.F.shape))
    )
    res = cfg.grid_res[:2]
    dx, dt = cfg.dx, 2e-3
    n_nodes = transfer.n_nodes_of(res)
    st = transfer.particle_stencil(state.x, dx, res)
    gm, gmv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    vg = gmv * jnp.where(gm > 0, 1.0 / jnp.maximum(gm, 1e-30), 0.0)[:, None]
    obj = obj_mod.make_objective(
        scene["model"], st, state.F, state.V0, state.mu, state.lam, gm, vg,
        jnp.broadcast_to(jnp.eye(2, dtype=jnp.float64), (n_nodes, 2, 2)),
        dt, dx,
    )
    hess = obj_mod.build_hessian(scene["model"], obj, vg)
    cons = jnp.zeros((n_nodes,), bool)
    # quadrature coarsening: ONLY that mode builds the identical operator
    # on both paths (galerkin replaces coarse ops with P^T A P)
    mcfg = MultigridConfig(levels=3, coarse_solver="direct",
                           coarsening="quadrature")

    mgs_mf = mg_mod.build_static(state.x, state.m, res, dx, 3, cons, jnp.float64)
    pre_mf = mg_mod.build_precond(mgs_mf, state.F, hess.ctx, state.V0, dt, mcfg, 2)

    mgs_a = mg_mod.build_static(
        state.x, state.m, res, dx, 3, cons, jnp.float64,
        bin_caps=(2048, 16), mg_tile_caps=(96, 48, 24),
    )
    assert not bool(mgs_a.overflow)
    assert mgs_a.levels[0].mat_sym is not None
    pre_a = mg_mod.build_precond(mgs_a, state.F, hess.ctx, state.V0, dt, mcfg, 2)

    r = jnp.asarray(rng.standard_normal((n_nodes, 2)))
    r = jnp.where(mgs_mf.levels[0].free[:, None], r, 0.0)
    z_mf = mg_mod.mg_precondition(mgs_mf, pre_mf, state.F, state.V0, dt, mcfg, r)
    z_a = mg_mod.mg_precondition(mgs_a, pre_a, state.F, state.V0, dt, mcfg, r)
    np.testing.assert_allclose(np.asarray(z_a), np.asarray(z_mf),
                               rtol=1e-8, atol=1e-8 * float(jnp.abs(z_mf).max()))


def test_assembled_step_matches_matrix_free_mg():
    """End-to-end: the assembled-MG step reproduces the matrix-free-MG
    step's trajectory and iteration counts through impact."""
    import dataclasses

    def run(assembled):
        scene = build_scene("block_drop_2d", res=48, E=1e7, dtype=jnp.float64)
        cfg = config_from_overrides(
            scene["cfg"],
            {"solver.preconditioner": "multigrid",
             "solver.multigrid.assembled": assembled,
             "solver.multigrid.coarsening": "quadrature"},
        )
        cfg = dataclasses.replace(cfg, transfer_impl="binned")
        sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
        counts = []
        for _ in range(70):
            s = sim.step(4e-3)
            counts.append((int(s.newton_iters), int(s.cg_iters)))
        assert all(r.get("converged", True) for r in sim.metrics.records)
        return np.asarray(sim.state.x), counts

    x_mf, c_mf = run(False)
    x_a, c_a = run(True)
    # the operator is identical (see test_assembled_vcycle_matches_matrix_
    # free); over a trajectory, CN-terminated inexact solves legitimately
    # flip +-1 iteration at thresholds and drift O(cn_eps) in velocity, so
    # assert comparable solver cost and sub-cell position agreement.
    n_a = sum(n for n, _ in c_a)
    n_mf = sum(n for n, _ in c_mf)
    assert abs(n_a - n_mf) <= max(2, 0.2 * n_mf), (c_a, c_mf)
    cg_a = sum(c for _, c in c_a)
    cg_mf = sum(c for _, c in c_mf)
    assert abs(cg_a - cg_mf) <= max(4, 0.3 * cg_mf), (cg_a, cg_mf)
    dx = 1.0 / 48
    np.testing.assert_allclose(x_a, x_mf, rtol=0, atol=0.5 * dx)


def test_galerkin_hierarchy_consistency_and_contraction():
    """The Galerkin MG mode (coarsening='galerkin'):

    1. its level-1 operator equals R A_0 P through the V-cycle's own
       transfer kernels (the consistency that makes corrections safe);
    2. its V-cycle CONTRACTS the residual on the BC-heavy twisting-bar
       state where the rediscretized hierarchy diverges (vred ~ 114 was
       the round-2 bug: MG-PCG took 5x MORE CG iterations than
       block-Jacobi there);
    3. MG-PCG with it beats block-Jacobi PCG in CG iterations.
    """
    import dataclasses

    from hot_mpm.sim import collision
    from hot_mpm.sim import objective as obj_mod
    from hot_mpm.solver.cg import cg_solve
    from hot_mpm.utils.config import MultigridConfig

    scene = build_scene("twisting_bar_3d", res=16, ppc=4, dtype=jnp.float64)
    cfg = scene["cfg"]
    model = scene["model"]
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    for _ in range(3):
        sim.step(8e-3)
    state = sim.state
    t = jnp.float64(sim.t)
    dim, res, dx = 3, cfg.grid_res[:3], cfg.dx
    dt = jnp.float64(8e-3)
    n_nodes = transfer.n_nodes_of(res)
    st = transfer.particle_stencil(state.x, dx, res)
    gm, gmv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    active = gm > 0
    vg = gmv * jnp.where(active, 1.0 / jnp.maximum(gm, 1e-30), 0.0)[:, None]
    node_pos = transfer.node_positions(res, dx, state.x.dtype)
    proj, v_bc, cons = collision.grid_boundary_conditions(
        node_pos, t, scene["colliders"], grid_v=vg, boundary_margin=2,
        res=res, dx=dx)
    v0 = collision.apply_bc_to_velocity(vg, proj, v_bc)
    obj = obj_mod.make_objective(model, st, state.F, state.V0, state.mu,
                                 state.lam, gm, v0, proj, dt, dx)
    r, hess = obj_mod.linearize(model, obj, v0)
    mul = lambda w: obj_mod.multiply(obj, hess, w)
    prj = lambda z: obj_mod.project(obj, z)

    mcfg = MultigridConfig(levels=2, coarse_solver="direct",
                           coarsening="galerkin")
    mgs = mg_mod.build_static(
        state.x, state.m, res, dx, 2, cons, jnp.float64,
        bin_caps=(4096, 16), mg_tile_caps=(80, 27),
    )
    assert not bool(mgs.overflow)
    pre = mg_mod.build_precond(mgs, state.F, hess.ctx, state.V0, dt, mcfg, dim)

    # 1. consistency: A_1 e == R (A_0 (P e)) on free coarse vectors
    from hot_mpm.ops import bsr as bsr_mod

    lvl0, lvl1 = mgs.levels
    n_c = lvl1.grid_m.shape[0]
    rng = np.random.default_rng(0)
    e = jnp.asarray(rng.standard_normal((n_c, dim)))
    e = jnp.where(lvl1.free[:, None], e, 0.0)
    q1 = mg_mod.level_multiply_any(lvl1, pre.mats[1], state.F, hess.ctx,
                                   state.V0, dt, e)
    q1 = jnp.where(lvl1.free[:, None], q1, 0.0)
    Pe = mg_mod.prolong(mgs.embeds[0], e)
    APe = mg_mod.level_multiply_any(lvl0, pre.mats[0], state.F, hess.ctx,
                                    state.V0, dt, Pe)
    APe = jnp.where(lvl0.active[:, None], APe, 0.0)
    q2 = mg_mod.restrict(mgs.embeds[0], APe, n_c)
    q2 = jnp.where(lvl1.free[:, None], q2, 0.0)
    # inactive fine nodes: A acts as identity on them in level_multiply_any
    # while PᵀAP treats them as zero rows — compare on the active support
    scale = float(jnp.abs(q2).max())
    np.testing.assert_allclose(np.asarray(q1), np.asarray(q2),
                               rtol=0, atol=1e-8 * scale)

    # 2. contraction
    z = mg_mod.mg_precondition(mgs, pre, state.F, state.V0, dt, mcfg, prj(-r))
    vred = float(jnp.linalg.norm(prj(-r - mul(z))) / jnp.linalg.norm(r))
    assert vred < 0.7, vred

    # 3. CG iteration win vs block-Jacobi
    D = obj_mod.elastic_block_diag(st, state.F, hess.ctx, state.V0, dt, gm,
                                   active, dim)
    Dinv = jnp.linalg.inv(D)
    out_j = cg_solve(lambda w: prj(mul(w)), -r,
                     precondition=lambda z_: jnp.einsum('nij,nj->ni', Dinv, z_),
                     project=prj, tol=1e-3, max_iters=800)
    out_mg = cg_solve(
        lambda w: prj(mul(w)), -r,
        precondition=lambda z_: mg_mod.mg_precondition(
            mgs, pre, state.F, state.V0, dt, mcfg, z_),
        project=prj, tol=1e-3, max_iters=800)
    assert int(out_mg.iters) < int(out_j.iters), (
        int(out_mg.iters), int(out_j.iters))


def test_colored_gs_smoother():
    """smoother='colored_gs' (reference component #36's colored-GS knob):
    the palindromic parity-colored GS sweep is a symmetric smoother, so
    MG-PCG with it converges at matched tolerance in the same ballpark as
    the Chebyshev-smoothed cycle, and far below Jacobi-PCG."""
    from hot_mpm.solver.cg import cg_solve

    mult, project, prec_cheb, prec_jac, b, make_prec = _linear_system(48)
    prec_gs = make_prec(smoother="colored_gs", pre_smooth=1, post_smooth=1)
    r_gs = cg_solve(mult, b, precondition=prec_gs, project=project,
                    tol=1e-8, max_iters=3000)
    r_cheb = cg_solve(mult, b, precondition=prec_cheb, project=project,
                      tol=1e-8, max_iters=3000)
    r_jac = cg_solve(mult, b, precondition=prec_jac, project=project,
                     tol=1e-8, max_iters=3000)
    assert bool(r_gs.converged)
    assert int(r_gs.iters) <= 2 * int(r_cheb.iters), (
        int(r_gs.iters), int(r_cheb.iters),
    )
    assert 2 * int(r_gs.iters) <= int(r_jac.iters), (
        int(r_gs.iters), int(r_jac.iters),
    )


def _bar_system(res_n=16, levels=3, dt_f=8e-3):
    """Shared twisting-bar Newton system + galerkin MG statics (f64)."""
    import dataclasses

    from hot_mpm.sim import collision
    from hot_mpm.sim import objective as obj_mod
    from hot_mpm.utils.config import MultigridConfig

    scene = build_scene("twisting_bar_3d", res=res_n, ppc=4, dtype=jnp.float64)
    cfg = scene["cfg"]
    model = scene["model"]
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    for _ in range(3):
        sim.step(dt_f)
    state = sim.state
    t = jnp.float64(sim.t)
    dim, res, dx = 3, cfg.grid_res[:3], cfg.dx
    dt = jnp.float64(dt_f)
    n_nodes = transfer.n_nodes_of(res)
    st = transfer.particle_stencil(state.x, dx, res)
    gm, gmv = transfer.p2g_mass_momentum(st, state.v, state.C, state.m,
                                         n_nodes)
    active = gm > 0
    vg = gmv * jnp.where(active, 1.0 / jnp.maximum(gm, 1e-30), 0.0)[:, None]
    node_pos = transfer.node_positions(res, dx, state.x.dtype)
    proj, v_bc, cons = collision.grid_boundary_conditions(
        node_pos, t, scene["colliders"], grid_v=vg, boundary_margin=2,
        res=res, dx=dx)
    v0 = collision.apply_bc_to_velocity(vg, proj, v_bc)
    obj = obj_mod.make_objective(model, st, state.F, state.V0, state.mu,
                                 state.lam, gm, v0, proj, dt, dx)
    r, hess = obj_mod.linearize(model, obj, v0)
    mgs = mg_mod.build_static(
        state.x, state.m, res, dx, levels, cons, jnp.float64,
        bin_caps=(4096, 16), mg_tile_caps=(80, 27, 27)[:levels],
    )
    assert not bool(mgs.overflow)
    mul = lambda w: obj_mod.multiply(obj, hess, w)
    prj = lambda z: obj_mod.project(obj, z)
    return dict(state=state, hess=hess, r=r, mul=mul, prj=prj, mgs=mgs,
                dt=dt, dim=dim)


def test_rap_max_half_truncation_guard():
    """MultigridConfig.rap_max_half (the deep-stencil truncation lever,
    BASELINE.md round-3 lever 3): the truncated near-Galerkin hierarchy
    (a) keeps every deep level's stencil at the cap, (b) still CONTRACTS
    the residual, and (c) costs at most 1.5x the exact hierarchy's CG
    iterations at matched tolerance — the CG-count guard that makes the
    knob safe to enable for build-time wins."""
    from hot_mpm.solver.cg import cg_solve
    from hot_mpm.utils.config import MultigridConfig

    s = _bar_system(res_n=16, levels=3)
    mgs, state, hess = s["mgs"], s["state"], s["hess"]
    dt, dim, r = s["dt"], s["dim"], s["r"]
    mul, prj = s["mul"], s["prj"]

    def solve(mcfg):
        pre = mg_mod.build_precond(mgs, state.F, hess.ctx, state.V0, dt,
                                   mcfg, dim)
        out = cg_solve(
            lambda w: prj(mul(w)), -r,
            precondition=lambda z_: mg_mod.mg_precondition(
                mgs, pre, state.F, state.V0, dt, mcfg, z_),
            project=prj, tol=1e-6, max_iters=400)
        return pre, out

    exact_cfg = MultigridConfig(levels=3, coarse_solver="direct",
                                coarsening="galerkin")
    trunc_cfg = MultigridConfig(levels=3, coarse_solver="direct",
                                coarsening="galerkin", rap_max_half=2)
    pre_e, out_e = solve(exact_cfg)
    pre_t, out_t = solve(trunc_cfg)

    # (a) stencil halves: exact grows 2 -> 3 -> 4; truncated stays at 2
    assert pre_e.mats[1].half == 3 and pre_e.mats[2].half == 4
    assert pre_t.mats[1].half == 2 and pre_t.mats[2].half == 2

    # truncated operator stays symmetric: <e, A f> == <f, A e> on the
    # level-1 active support
    lvl1 = mgs.levels[1]
    rng = np.random.default_rng(1)
    n_c = lvl1.grid_m.shape[0]
    e = jnp.where(lvl1.free[:, None],
                  jnp.asarray(rng.standard_normal((n_c, dim))), 0.0)
    f = jnp.where(lvl1.free[:, None],
                  jnp.asarray(rng.standard_normal((n_c, dim))), 0.0)
    Ae = mg_mod.level_multiply_any(lvl1, pre_t.mats[1], state.F, hess.ctx,
                                   state.V0, dt, e)
    Af = mg_mod.level_multiply_any(lvl1, pre_t.mats[1], state.F, hess.ctx,
                                   state.V0, dt, f)
    lhs = float(jnp.vdot(jnp.where(lvl1.free[:, None], Ae, 0.0), f))
    rhs = float(jnp.vdot(jnp.where(lvl1.free[:, None], Af, 0.0), e))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    # (b) both converge; (c) the CG-count guard
    assert bool(out_e.converged) and bool(out_t.converged)
    assert int(out_t.iters) <= max(int(out_e.iters) * 3 // 2,
                                   int(out_e.iters) + 2), (
        int(out_t.iters), int(out_e.iters))


def test_rap_refresh_lagged():
    """MultigridConfig.rap_refresh='lagged' (BASELINE.md round-3 lever 2):
    build_precond(reuse=base) keeps the deep RAP chain + coarse factor
    from the base build and re-assembles only the first assembled level —
    at the SAME linearization point the result preconditions identically,
    and the end-to-end lagged step converges with a bounded CG overhead."""
    import dataclasses

    from hot_mpm.solver.cg import cg_solve
    from hot_mpm.utils.config import MultigridConfig, config_from_overrides

    s = _bar_system(res_n=16, levels=3)
    mgs, state, hess = s["mgs"], s["state"], s["hess"]
    dt, dim, r = s["dt"], s["dim"], s["r"]
    mul, prj = s["mul"], s["prj"]

    mcfg = MultigridConfig(levels=3, coarse_solver="direct",
                           coarsening="galerkin", rap_refresh="lagged")
    base = mg_mod.build_precond(mgs, state.F, hess.ctx, state.V0, dt, mcfg,
                                dim)
    re = mg_mod.build_precond(mgs, state.F, hess.ctx, state.V0, dt, mcfg,
                              dim, reuse=base)
    # deep mats/factor reused verbatim; level-0 rebuilt (equal values at
    # the same linearization point)
    for l in (1, 2):
        np.testing.assert_array_equal(np.asarray(re.mats[l].vals),
                                      np.asarray(base.mats[l].vals))
    np.testing.assert_allclose(np.asarray(re.mats[0].vals),
                               np.asarray(base.mats[0].vals), rtol=1e-12)
    z_b = mg_mod.mg_precondition(mgs, base, state.F, state.V0, dt, mcfg,
                                 prj(-r))
    z_r = mg_mod.mg_precondition(mgs, re, state.F, state.V0, dt, mcfg,
                                 prj(-r))
    np.testing.assert_allclose(np.asarray(z_r), np.asarray(z_b), rtol=1e-10)

    # end-to-end: the lagged simulation step converges with CG counts
    # within 2x of the exact refresh
    def run(refresh):
        scene = build_scene("twisting_bar_3d", res=16, ppc=4,
                            dtype=jnp.float64)
        cfg = config_from_overrides(
            scene["cfg"],
            {"solver.preconditioner": "multigrid",
             "solver.multigrid.levels": 2,
             "solver.multigrid.coarse_solver": "direct",
             "solver.multigrid.coarsening": "galerkin",
             "solver.multigrid.rap_refresh": refresh})
        sim = Simulation(cfg, scene["state"], scene["model"],
                         scene["colliders"])
        cg = 0
        for _ in range(3):
            stats = sim.step(8e-3)
            cg += int(stats.cg_iters)
        assert all(rec["converged"] for rec in sim.metrics.records)
        return cg

    cg_newton = run("newton")
    cg_lagged = run("lagged")
    assert cg_lagged <= max(2 * cg_newton, cg_newton + 4), (
        cg_lagged, cg_newton)
