"""Krylov + Newton solver unit tests."""

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.solver.cg import cg_solve, minres_solve
from hot_mpm.solver.newton import newton_solve


def spd_system(rng, n=64, cond=100.0):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.geomspace(1.0, cond, n)
    A = jnp.asarray(Q @ np.diag(w) @ Q.T)
    b = jnp.asarray(rng.standard_normal(n))
    return A, b


def test_cg_solves_spd(rng):
    A, b = spd_system(rng)
    res = cg_solve(lambda x: A @ x, b, tol=1e-12, max_iters=500)
    want = jnp.linalg.solve(A, b)
    np.testing.assert_allclose(res.x, want, atol=1e-8)
    assert bool(res.converged)


def test_cg_preconditioning_cuts_iterations(rng):
    A, b = spd_system(rng, cond=1e4)
    plain = cg_solve(lambda x: A @ x, b, tol=1e-10, max_iters=2000)
    diag = jnp.diagonal(A)
    pre = cg_solve(
        lambda x: A @ x, b, precondition=lambda r: r / diag, tol=1e-10, max_iters=2000
    )
    # exact-inverse preconditioner sanity
    Ainv = jnp.linalg.inv(A)
    exact = cg_solve(
        lambda x: A @ x, b, precondition=lambda r: Ainv @ r, tol=1e-10, max_iters=2000
    )
    assert int(exact.iters) <= 3
    assert bool(pre.converged) and bool(plain.converged)


def test_cg_projection_constraints(rng):
    """Projected CG solves the constrained subproblem, leaving masked DoFs 0."""
    A, b = spd_system(rng, n=40)
    mask = jnp.asarray(rng.uniform(size=40) > 0.3)

    def project(r):
        return jnp.where(mask, r, 0.0)

    def mult(x):
        # identity on constrained dofs, A on free ones
        return jnp.where(mask, A @ x, x)

    res = cg_solve(mult, b, project=project, tol=1e-12, max_iters=500)
    # solution restricted to free rows satisfies the reduced system
    r = project(b - A @ res.x)
    assert float(jnp.linalg.norm(r)) < 1e-7 * float(jnp.linalg.norm(b))
    np.testing.assert_allclose(res.x * (~mask), 0.0, atol=1e-12)


def test_minres_on_indefinite(rng):
    n = 50
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([np.geomspace(1, 50, n - 5), -np.geomspace(1, 5, 5)])
    A = jnp.asarray(Q @ np.diag(w) @ Q.T)
    b = jnp.asarray(rng.standard_normal(n))
    res = minres_solve(lambda x: A @ x, b, tol=1e-10, max_iters=1000)
    np.testing.assert_allclose(res.x, jnp.linalg.solve(A, b), atol=1e-6)


def test_newton_on_rosenbrock_like(rng):
    """Newton driver on a convex quartic: grad/Hess supplied analytically."""
    n = 20
    A, _ = spd_system(rng, n=n, cond=50.0)
    x_star = jnp.asarray(rng.standard_normal(n))

    # E(x) = 1/4 |x - x*|^4_A-ish: grad = A(x-x*) (1 + |x-x*|^2)
    def grad(x):
        d = x - x_star
        return A @ d * (1.0 + jnp.dot(d, d))

    # hessian "state" must be an array pytree (it rides the Newton carry)
    def mult(x, w):
        d = x - x_star
        s = 1.0 + jnp.dot(d, d)
        return A @ w * s + A @ d * 2.0 * jnp.dot(d, w)

    res = newton_solve(
        residual=grad,
        build_hessian=lambda x: x,
        multiply=mult,
        project=lambda r: r,
        precondition=lambda h, r: r,
        cn_norm=lambda r: jnp.linalg.norm(r),
        v0=jnp.zeros(n),
        max_newton=50,
        cn_eps=1e-10,
        cg_tol=1e-10,
        max_cg=500,
    )
    np.testing.assert_allclose(res.v, x_star, atol=1e-6)
    assert bool(res.converged)
    # quadratic-ish convergence: few iterations
    assert int(res.iters) < 30


def test_precond_refresh_step_lag():
    """precond_refresh='step' (lagged preconditioner): the preconditioner
    is built once per step at v0 and reused across Newton iterations — CG
    must still converge (SPD preserved) to the same trajectory within
    solver tolerance, with at most moderately more CG iterations."""
    import dataclasses

    import numpy as np
    import jax
    import jax.numpy as jnp

    from hot_mpm.scenes import build_scene
    from hot_mpm.sim import Simulation

    runs = {}
    for refresh in ("newton", "step"):
        scene = build_scene("block_drop_2d", res=32, dtype=jnp.float64)
        cfg = scene["cfg"]
        cfg = dataclasses.replace(
            cfg,
            solver=dataclasses.replace(
                cfg.solver, preconditioner="multigrid",
                precond_refresh=refresh,
            ),
        )
        sim = Simulation(cfg, scene["state"], scene["model"],
                         scene["colliders"])
        for _ in range(60):
            sim.step(4e-3)
        recs = sim.metrics.records
        assert all(r["converged"] for r in recs), refresh
        runs[refresh] = (
            np.asarray(sim.state.x),
            sum(r["newton_iters"] for r in recs),
            sum(r["cg_iters"] for r in recs),
        )
    x_n, newton_n, cg_n = runs["newton"]
    x_s, newton_s, cg_s = runs["step"]
    assert newton_s <= newton_n + 3, (newton_s, newton_n)
    assert cg_s <= 2 * cg_n + 10, (cg_s, cg_n)
    np.testing.assert_allclose(x_s, x_n, atol=5e-5)


def test_sym_block_inv_fp32_scales():
    """sym_block_inv must stay finite in fp32 across extreme block scales
    (tiny-mass boundary blocks m*I with m ~ 1e-30 underflow a naive
    adjugate determinant — the round-3 on-chip nonfinite bug)."""
    import numpy as np
    import jax.numpy as jnp

    from hot_mpm.sim.objective import sym_block_inv

    rng = np.random.default_rng(0)
    for d in (2, 3):
        A = rng.standard_normal((64, d, d))
        spd = (A @ np.swapaxes(A, 1, 2) + 3 * np.eye(d)).astype(np.float32)
        scales = np.concatenate(
            [np.full(32, 1e-30), np.logspace(-8, 8, 32)]
        ).astype(np.float32)
        D = jnp.asarray(spd * scales[:, None, None])
        Dinv = sym_block_inv(D)
        assert bool(jnp.all(jnp.isfinite(Dinv))), d
        eye = np.einsum("nij,njk->nik", np.asarray(D, np.float64),
                        np.asarray(Dinv, np.float64))
        np.testing.assert_allclose(
            eye, np.broadcast_to(np.eye(d), eye.shape), atol=2e-3
        )


def test_elastic_block_diag_mode_form(rng):
    """The flat rank-1-mode block-diagonal equals the direct
    apply_hessian-column construction."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hot_mpm.models import constitutive as cm
    from hot_mpm.ops import transfer
    from hot_mpm.scenes import build_scene
    from hot_mpm.sim import objective as obj_mod

    for name, dim in (("block_drop_2d", 2), ("twisting_bar_3d", 3)):
        kwargs = dict(res=16, ppc=2) if dim == 3 else dict(res=24)
        scene = build_scene(name, **kwargs)
        state = scene["state"]
        model = scene["model"]
        cfg = scene["cfg"]
        res = cfg.grid_res[:dim]
        n = state.n
        F = jnp.asarray(
            np.asarray(state.F)
            + 0.05 * rng.standard_normal(state.F.shape), jnp.float64)
        ctx = jax.vmap(
            lambda f, m_, l_: cm.hessian_context(model, f, m_, l_)
        )(F, state.mu.astype(jnp.float64), state.lam.astype(jnp.float64))
        st = transfer.particle_stencil(
            jnp.asarray(state.x, jnp.float64), cfg.dx, res)
        n_nodes = transfer.n_nodes_of(res)
        gm = jnp.ones((n_nodes,), jnp.float64)
        active = jnp.ones((n_nodes,), bool)
        dt = jnp.float64(2e-3)
        V0 = jnp.asarray(state.V0, jnp.float64)

        got = obj_mod.elastic_block_diag(st, F, ctx, V0, dt, gm, active, dim)

        # direct reference: 81 apply_hessian columns per particle
        def per_particle(gwn_p, F_p, ctx_p, V0_p):
            g = gwn_p @ F_p
            eye = jnp.eye(dim, dtype=F_p.dtype)

            def block_for_node(gk):
                def col(a):
                    dF = dt * jnp.outer(eye[a], gk)
                    dP = cm.apply_hessian(ctx_p, dF)
                    return dt * (dP @ gk)

                return V0_p * jnp.stack([col(a) for a in range(dim)], axis=1)

            return jax.vmap(block_for_node)(g)

        blocks = jax.vmap(per_particle)(st.gwn, F, ctx, V0)
        K = transfer.scatter_sum(
            st.node_ids, blocks.reshape(n, -1, dim * dim), n_nodes
        ).reshape(-1, dim, dim)
        want = gm[:, None, None] * jnp.eye(dim, dtype=K.dtype)[None] + K
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-8, atol=1e-10)
