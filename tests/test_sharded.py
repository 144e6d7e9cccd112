"""Distributed-solve tests on a CPU-simulated 8-device mesh
(SURVEY.md §4.4): the shard_map halo-exchange CG must reproduce the
single-device solver exactly — same iterations, same solution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hot_mpm.ops import transfer
from hot_mpm.parallel.halo import exchange_halo, fold_halo
from hot_mpm.parallel.mesh import loop_mesh_width, make_mesh
from hot_mpm.parallel.sharded import partition_system, sharded_cg_solve
from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation, collision
from hot_mpm.sim import objective as obj_mod
from hot_mpm.solver.cg import cg_solve


def _impact_system(res=32, E=1e6, dt=4e-3):
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
    proj, v_bc, _ = collision.grid_boundary_conditions(
        node_pos, 0.0, scene["colliders"], grid_v=v_star, boundary_margin=2,
        res=grid_res, dx=dx,
    )
    v0 = collision.apply_bc_to_velocity(v_star, proj, v_bc)
    obj = obj_mod.make_objective(
        scene["model"], st, state.F, state.V0, state.mu, state.lam, gm,
        v_star, proj, dt, dx,
    )
    hess = obj_mod.build_hessian(scene["model"], obj, v0)
    b = obj_mod.project(obj, -obj_mod.residual(scene["model"], obj, v0))
    return dict(
        st=st, state=state, obj=obj, hess=hess, b=b, gm=gm, active=active,
        proj=proj, dt=dt, grid_res=grid_res,
    )


def test_halo_exchange_roundtrip(rng):
    """fold_halo is the adjoint of exchange_halo: <E(x), y> == <x, F(y)>."""
    D = loop_mesh_width(8)
    mesh = make_mesh((D,), ("x",))
    P_, W = 4, 6
    x_loc = jnp.asarray(rng.standard_normal((D, P_, W)))
    y_ext = jnp.asarray(rng.standard_normal((D, P_ + 4, W)))

    import functools
    from jax.sharding import PartitionSpec as P

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P(), P()),
    )
    def both(xl, yl):
        ex = exchange_halo(xl[0], "x", D, 2)
        fo = fold_halo(yl[0], "x", D, 2)
        lhs = jax.lax.psum(jnp.sum(ex * yl[0]), "x")
        rhs = jax.lax.psum(jnp.sum(xl[0] * fo), "x")
        return lhs, rhs

    lhs, rhs = both(x_loc, y_ext)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_cg_matches_single_device(n_devices):
    parts = _impact_system()
    obj, hess, b = parts["obj"], parts["hess"], parts["b"]

    ref = cg_solve(
        lambda w: obj_mod.multiply(obj, hess, w),
        b,
        precondition=lambda r: obj_mod.mass_precondition(obj, r),
        project=lambda r: obj_mod.project(obj, r),
        tol=1e-8,
        max_iters=1000,
    )

    n_devices = loop_mesh_width(n_devices)
    mesh = make_mesh((n_devices,), ("x",))
    sys, geom, overflow = partition_system(
        parts["st"], parts["state"].F, hess.ctx, parts["state"].V0,
        parts["gm"], parts["active"], parts["proj"], parts["dt"],
        parts["grid_res"], n_devices,
    )
    assert not overflow
    x, iters, residual = sharded_cg_solve(
        mesh, sys, geom, b, tol=1e-8, max_iters=1000
    )
    assert int(iters) == int(ref.iters), (int(iters), int(ref.iters))
    # agreement is bounded by the CG tolerance (1e-8), not machine eps:
    # the two runs sum halo contributions in different orders
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), atol=3e-9)
