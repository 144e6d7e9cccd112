"""Sparse tile-grid tests: activation correctness, compacted-id transfer
equivalence with the dense backend, end-to-end trajectory equality
(SURVEY.md §7 stage-2 acceptance style).
"""

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.grid import sparse as sp
from hot_mpm.ops import transfer
from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation
from hot_mpm.utils.config import config_from_overrides


def test_activation_covers_all_stencil_tiles(rng):
    res = (64, 64)
    dx = 1.0 / 64
    x = jnp.asarray(rng.uniform(3 * dx, 60 * dx, (200, 2)))
    g = sp.build_tile_grid(x, dx, res, capacity=256)
    assert not bool(g.overflow)
    # every stencil node of every particle must land in an active tile
    st = sp.sparse_stencil(x, dx, g)
    assert bool(jnp.all(st.node_ids < g.dump)), "stencil node hit the dump slot"


def test_sparse_dense_p2g_equal(rng):
    res = (48, 48)
    dx = 1.0 / 48
    n = 300
    x = jnp.asarray(rng.uniform(3 * dx, 44 * dx, (n, 2)))
    v = jnp.asarray(rng.standard_normal((n, 2)))
    C = jnp.asarray(rng.standard_normal((n, 2, 2)))
    m = jnp.asarray(rng.uniform(0.5, 2.0, (n,)))

    std = transfer.particle_stencil(x, dx, res)
    gm_d, gmv_d = transfer.p2g_mass_momentum(std, v, C, m, transfer.n_nodes_of(res))

    g = sp.build_tile_grid(x, dx, res, capacity=256)
    sts = sp.sparse_stencil(x, dx, g)
    gm_s, gmv_s = transfer.p2g_mass_momentum(sts, v, C, m, g.n_cnodes)
    gm_sd = sp.compact_to_dense(g, gm_s[:, None])[:, 0]
    gmv_sd = sp.compact_to_dense(g, gmv_s)

    np.testing.assert_allclose(gm_sd, gm_d, atol=1e-12)
    np.testing.assert_allclose(gmv_sd, gmv_d, atol=1e-12)


def test_overflow_flag(rng):
    res = (64, 64)
    dx = 1.0 / 64
    x = jnp.asarray(rng.uniform(3 * dx, 60 * dx, (500, 2)))
    g = sp.build_tile_grid(x, dx, res, capacity=4)
    assert bool(g.overflow)


def test_sparse_backend_matches_dense_trajectory():
    """Full sim: sparse and dense backends produce identical (f64) paths,
    with both Jacobi and multigrid preconditioners."""
    for precon in ("jacobi", "multigrid"):
        states = {}
        cg = {}
        for backend in ("dense", "sparse"):
            scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
            cfg = config_from_overrides(
                scene["cfg"],
                {
                    "grid_backend": backend,
                    "tile_capacity": 128,
                    "solver.preconditioner": precon,
                    "solver.multigrid.levels": 2,
                },
            )
            sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
            for _ in range(70):
                sim.step(4e-3)
            states[backend] = np.asarray(sim.state.x)
            cg[backend] = sum(r["cg_iters"] for r in sim.metrics.records)
            assert all(r["converged"] for r in sim.metrics.records)
        np.testing.assert_allclose(
            states["sparse"], states["dense"], atol=1e-10,
            err_msg=f"preconditioner={precon}, cg={cg}",
        )


def test_sparse_3d_runs():
    scene = build_scene("twisting_bar_3d", res=32, ppc=4)
    cfg = config_from_overrides(
        scene["cfg"], {"grid_backend": "sparse", "tile_capacity": 512}
    )
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    for _ in range(3):
        stats = sim.step(1e-3)
    assert bool(jnp.all(jnp.isfinite(sim.state.x)))
    assert int(stats.active_tiles) > 0


def test_tile_binned_scatter_gather_match(rng):
    """Tile-local binned transfers (ops.tile_transfer) == plain compacted
    scatter_sum/gather for both 2D and 3D random particle sets."""
    from hot_mpm.ops import bsr_tiled, tile_transfer

    for dim, res_n, n in ((2, 32, 400), (3, 16, 300)):
        res = (res_n,) * dim
        dx = 1.0 / res_n
        lo, hi = 2.5 * dx, (res_n - 3.5) * dx
        x = jnp.asarray(rng.uniform(lo, hi, size=(n, dim)))
        tg = sp.build_tile_grid(x, dx, res, capacity=256)
        assert not bool(tg.overflow)
        st = sp.sparse_stencil(x, dx, tg)
        nbr = bsr_tiled.tile_neighbors(tg)
        bins = tile_transfer.sparse_bins(x, dx, tg, cells_cap=512, cap=32)
        assert not bool(bins.overflow)

        s = st.wn.shape[1]
        vals = jnp.asarray(rng.standard_normal((n, s, 3)))
        want = transfer.scatter_sum(st.node_ids, vals, tg.n_cnodes)
        got = tile_transfer.tile_binned_scatter(bins, tg, nbr, vals)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-12)

        g = jnp.asarray(rng.standard_normal((tg.n_cnodes, 2)))
        g = g.at[tg.dump].set(0.0)  # dump row is zero by construction
        want_g = transfer.gather(g, st.node_ids)
        got_g = tile_transfer.tile_window_gather(bins, tg, nbr, g)
        np.testing.assert_allclose(np.asarray(got_g), np.asarray(want_g),
                                   atol=0)


def test_sparse_tile_binned_matches_scatter_trajectory():
    """Sparse backend with transfer_impl='binned' (ops.tile_transfer) ==
    sparse scatter path == dense path: identical f64 trajectories and
    iteration counts through impact (the config-5 composition of
    VERDICT r1 #4)."""
    states = {}
    iters = {}
    for impl in ("scatter", "binned"):
        scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
        cfg = config_from_overrides(
            scene["cfg"],
            {
                "grid_backend": "sparse",
                "tile_capacity": 128,
                "transfer_impl": impl,
            },
        )
        sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
        for _ in range(70):
            sim.step(4e-3)
        states[impl] = np.asarray(sim.state.x)
        iters[impl] = (
            sum(r["newton_iters"] for r in sim.metrics.records),
            sum(r["cg_iters"] for r in sim.metrics.records),
        )
        assert all(r["converged"] for r in sim.metrics.records)
    assert iters["binned"][0] == iters["scatter"][0]
    assert abs(iters["binned"][1] - iters["scatter"][1]) <= 2
    np.testing.assert_allclose(states["binned"], states["scatter"], atol=1e-9)


def test_sparse_tile_binned_3d_runs():
    scene = build_scene("twisting_bar_3d", res=32, ppc=4)
    cfg = config_from_overrides(
        scene["cfg"],
        {"grid_backend": "sparse", "tile_capacity": 512,
         "transfer_impl": "binned"},
    )
    sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
    for _ in range(3):
        stats = sim.step(1e-3)
    assert bool(jnp.all(jnp.isfinite(sim.state.x)))
    assert int(stats.active_tiles) > 0


def test_tiled_mode_assembly_matches_matrix_free(rng):
    """assemble_hessian_modes_tiled on the compacted tile structure ==
    the matrix-free quadrature apply on compacted vectors (2D + 3D)."""
    from hot_mpm.models import constitutive as cm
    from hot_mpm.ops import bsr_tiled, tile_transfer
    from hot_mpm.sim import objective as obj_mod

    model = cm.FixedCorotated()
    for dim, res_n, n in ((2, 32, 300), (3, 16, 200)):
        res = (res_n,) * dim
        dx = 1.0 / res_n
        lo, hi = 2.5 * dx, (res_n - 3.5) * dx
        x = jnp.asarray(rng.uniform(lo, hi, size=(n, dim)))
        F = jnp.asarray(
            np.eye(dim)[None] + 0.1 * rng.standard_normal((n, dim, dim))
        )
        V0 = jnp.asarray(rng.uniform(0.5, 1.5, (n,)))
        mu = jnp.full((n,), 30.0)
        lam = jnp.full((n,), 50.0)
        m = jnp.asarray(rng.uniform(0.5, 2.0, (n,)))
        dt = 1e-2

        tg = sp.build_tile_grid(x, dx, res, capacity=256)
        st = sp.sparse_stencil(x, dx, tg)
        nbr = bsr_tiled.tile_neighbors(tg)
        bins = tile_transfer.sparse_bins(x, dx, tg, cells_cap=512, cap=32)
        assert not bool(bins.overflow)
        grid_m = transfer.scatter_sum(st.node_ids, st.wn * m[:, None],
                                      tg.n_cnodes)
        active = grid_m > 0

        ctx = jax.vmap(lambda f, m_, l_: cm.hessian_context(model, f, m_, l_))(
            F, mu, lam
        )
        mat = bsr_tiled.structure_tiled(tg)
        mat = bsr_tiled.assemble_hessian_modes_tiled(
            mat, bins, tg, st, F, ctx, V0, dt, grid_m
        )

        w = jnp.asarray(rng.standard_normal((tg.n_cnodes, dim)))
        w = w.at[tg.dump].set(0.0)
        want = obj_mod.elastic_hessian_apply(
            st, F, ctx, V0, dt, grid_m, active, w
        )
        y_rows = bsr_tiled.spmv_tiled(mat, tg, nbr, w[:-1])
        got = jnp.concatenate([y_rows, jnp.zeros((1, dim))], axis=0)
        got = jnp.where(active[:, None], got, w)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-8)


def test_rap_tiled_matches_dense_on_active_tiles(rng):
    """spgemm.rap with coarse_tgrid == dense rap on every coarse row that
    lies inside an active coarse tile (rows outside are the documented
    subspace drop)."""
    from hot_mpm.models import constitutive as cm
    from hot_mpm.ops import bsr, bsr_tiled, spgemm, tile_transfer

    model = cm.FixedCorotated()
    dim, res_n, n = 2, 32, 300
    res = (res_n,) * dim
    dx = 1.0 / res_n
    lo, hi = 2.5 * dx, (res_n - 3.5) * dx
    x = jnp.asarray(rng.uniform(lo, hi, size=(n, dim)))
    F = jnp.asarray(np.eye(dim)[None] + 0.1 * rng.standard_normal((n, dim, dim)))
    V0 = jnp.asarray(rng.uniform(0.5, 1.5, (n,)))
    mu = jnp.full((n,), 30.0)
    lam = jnp.full((n,), 50.0)
    m = jnp.asarray(rng.uniform(0.5, 2.0, (n,)))
    dt = 1e-2

    tg = sp.build_tile_grid(x, dx, res, capacity=256)
    st = sp.sparse_stencil(x, dx, tg)
    bins = tile_transfer.sparse_bins(x, dx, tg, cells_cap=512, cap=32)
    grid_m = transfer.scatter_sum(st.node_ids, st.wn * m[:, None], tg.n_cnodes)
    ctx = jax.vmap(lambda f, m_, l_: cm.hessian_context(model, f, m_, l_))(
        F, mu, lam
    )
    A = bsr_tiled.structure_tiled(tg)
    A = bsr_tiled.assemble_hessian_modes_tiled(
        A, bins, tg, st, F, ctx, V0, dt, grid_m
    )

    cres = tuple(r // 2 for r in res)
    cdx = 2 * dx
    tg_c = sp.build_tile_grid(x, cdx, cres, capacity=128)
    Ac_tiled = spgemm.rap(A, cres, None, 0, coarse_tgrid=tg_c)

    n_coarse = transfer.n_nodes_of(cres)
    Ac_dense = spgemm.rap(A, cres, jnp.ones((n_coarse,), bool), n_coarse)

    # compare row blocks through the dense node ids
    node_of_t = np.asarray(Ac_tiled.node_of)
    row_of_d = np.asarray(Ac_dense.row_of)
    vt = np.asarray(Ac_tiled.vals).reshape(Ac_tiled.n_rows, Ac_tiled.K, -1)
    vd = np.asarray(Ac_dense.vals).reshape(Ac_dense.n_rows, Ac_dense.K, -1)
    ct = np.asarray(Ac_tiled.col_row)
    cd = np.asarray(Ac_dense.col_row)
    checked = 0
    for r_t in range(vt.shape[0]):
        nd = node_of_t[r_t]
        if nd >= n_coarse:
            continue
        r_d = row_of_d[nd]
        assert r_d >= 0
        for k in range(vt.shape[1]):
            if ct[r_t, k] >= 0 and cd[r_d, k] >= 0:
                np.testing.assert_allclose(vt[r_t, k], vd[r_d, k],
                                           rtol=1e-6, atol=1e-9)
                checked += 1
    assert checked > 100


def test_sparse_assembled_galerkin_mg_trajectory():
    """Sparse backend + assembled Galerkin MG (the config-5 composition):
    same trajectory as the dense assembled Galerkin MG. Two hierarchies:
    compact->dense tail (auto switch, direct coarse) and all-compact
    (sparse_dense_switch=1, smoother coarse)."""
    cases = {
        "dense": {"grid_backend": "dense"},
        "sparse_tail": {"grid_backend": "sparse", "tile_capacity": 128},
        "sparse_all_compact": {
            "grid_backend": "sparse", "tile_capacity": 128,
            "solver.multigrid.sparse_dense_switch": 1,
            "solver.multigrid.coarse_solver": "smoother",
        },
        # matrix-free finest + assembled coarser levels (the >=256^3
        # memory configuration: the finest explicit BSR doesn't fit HBM);
        # the first assembled level is built by the composed-stencil EXACT
        # Galerkin path (ops.composed, auto-enabled via
        # _choose_mg_composed_caps), deeper ones RAP
        "sparse_mf_finest": {
            "grid_backend": "sparse", "tile_capacity": 128,
            "solver.multigrid.assembled_from_level": 1,
        },
    }
    states = {}
    iters = {}
    for name, over in cases.items():
        scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
        base = {
            "transfer_impl": "binned",
            "solver.preconditioner": "multigrid",
            "solver.multigrid.levels": 3,
            "solver.multigrid.assembled": True,
        }
        base.update(over)
        cfg = config_from_overrides(scene["cfg"], base)
        sim = Simulation(cfg, scene["state"], scene["model"], scene["colliders"])
        for _ in range(70):
            sim.step(4e-3)
        if name == "sparse_mf_finest":
            # pin the intended mechanism: the first assembled level must
            # come from the composed exact-Galerkin path (ops.composed),
            # not quadrature rediscretization — the loose iteration bounds
            # below are for SUBSPACE drops (compact tiles), nothing else
            assert sim._plan.mg_composed_caps is not None
        states[name] = np.asarray(sim.state.x)
        recs = [r for r in sim.metrics.records if "newton_iters" in r]
        iters[name] = (
            sum(r["newton_iters"] for r in recs),
            sum(r["cg_iters"] for r in recs),
        )
        assert all(r["converged"] for r in recs), name
    for name in ("sparse_tail", "sparse_all_compact"):
        assert iters[name][0] == iters["dense"][0], (name, iters)
        # CG counts may differ slightly: compact hierarchies drop coarse
        # rows outside active tiles (subspace Galerkin)
        assert abs(iters[name][1] - iters["dense"][1]) <= 0.1 * iters["dense"][1] + 5, (name, iters)
    # mf-finest: level 1 is exact composed Galerkin, but the compact tiles
    # drop overhang coarse rows (subspace Galerkin) and the finest level
    # smooths matrix-free — a different preconditioner; measured 13/21 vs
    # 11/11 here; bound it loosely and require convergence
    assert iters["sparse_mf_finest"][0] <= iters["dense"][0] + 4, iters
    assert iters["sparse_mf_finest"][1] <= 3 * iters["dense"][1] + 5, iters
    # positions agree to CG-tolerance level, not bitwise: compact
    # hierarchies drop overhang coarse rows (subspace Galerkin) and the
    # mf-finest hierarchy smooths its finest level matrix-free, so the
    # preconditioner differs and CG returns a different iterate within
    # cg_tol (measured 8e-7 / 3e-5 over 70 steps; iteration counts above)
    for name in ("sparse_tail", "sparse_all_compact", "sparse_mf_finest"):
        atol = 2e-4 if name == "sparse_mf_finest" else 5e-6
        np.testing.assert_allclose(states[name], states["dense"], atol=atol,
                                   err_msg=f"{name}, iters={iters}")
