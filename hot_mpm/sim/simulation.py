"""The MPM time step and frame loop.

Reference equivalents: Lib/MPM/MpmSimulationBase::advanceOneTimeStep
(component #24; call stack SURVEY.md §3.2) + Lib/Ziran/Sim/SimulationBase
frame loop (component #22). One full implicit step — P2G, grid BC, inexact
Newton with CN termination, G2P, plasticity, advection — is a single
jit-compiled function; the host loop only chooses dt (CFL) and does IO.

Design notes:
  * dense logical grid, flattened (n_nodes, ...) arrays; sparse tiling
    layers under the same interface later (SURVEY.md §7 stage 2).
  * dt is a traced scalar — CFL-rate dt changes do NOT recompile.
  * all particle loops are vmaps; all grid loops are array ops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from hot_mpm.models import constitutive as cm
from hot_mpm.models import plasticity as plast
from hot_mpm.ops import transfer
from hot_mpm.sim import capacity
from hot_mpm.sim import collision
from hot_mpm.sim import objective as obj_mod
from hot_mpm.sim.state import ParticleState
from hot_mpm.solver.newton import NewtonResult, newton_solve
from hot_mpm.utils.config import SimConfig
from hot_mpm.utils.metrics import MetricsLogger
from hot_mpm.utils.timing import PhaseTimer


class StepStats(NamedTuple):
    newton_iters: jax.Array
    cg_iters: jax.Array
    cn_residual: jax.Array
    cn_residual0: jax.Array
    converged: jax.Array
    max_velocity: jax.Array
    kinetic_energy: jax.Array
    potential_energy: jax.Array
    active_nodes: jax.Array
    active_tiles: jax.Array     # sparse backend only (0 for dense)
    grid_overflow: jax.Array    # tile capacity exceeded -> host must regrow


def advance_one_step(
    state: ParticleState,
    dt,
    t,
    *,
    cfg: SimConfig,
    model,
    colliders: Sequence[collision.Collider],
    plasticity: Optional[str] = None,
    bin_caps: Optional[Tuple[int, int]] = None,  # (cells_capacity, per-cell cap)
    mg_tile_caps: Optional[Tuple[int, ...]] = None,  # per-MG-level tile caps
    bsr_tile_cap: Optional[int] = None,  # tile cap for the explicit outer BSR
    mg_coarse_cap: Optional[int] = None,  # active-row cap of the dense coarse factor
    mg_bin_caps: Optional[Tuple[Tuple[int, int], ...]] = None,  # exact per-MG-level bin caps
    mg_composed_caps: Optional[Tuple[int, int]] = None,  # composed-Galerkin bins
    mg_ncomposed_caps: Optional[Tuple[int, int]] = None,
) -> Tuple[ParticleState, StepStats]:
    """One implicit backward-Euler MPM step (pure function; jit over it).

    Mirrors SURVEY.md §3.2's stack: sort/activate is implicit in the dense
    grid; P2G -> grid BC -> Newton (CN) -> G2P -> plasticity -> advect.

    All contractions are traced at full fp32 matmul precision: a float32
    matmul left to the backend's default may run in TF32 on the GPU
    (about three decimal digits), which stalls Newton at CN ~ 1e-1.
    """
    with jax.default_matmul_precision("highest"):
        return _advance_one_step_impl(
            state, dt, t, cfg=cfg, model=model, colliders=colliders,
            plasticity=plasticity, bin_caps=bin_caps, mg_tile_caps=mg_tile_caps,
            bsr_tile_cap=bsr_tile_cap, mg_coarse_cap=mg_coarse_cap,
            mg_bin_caps=mg_bin_caps, mg_composed_caps=mg_composed_caps,
            mg_ncomposed_caps=mg_ncomposed_caps,
        )


def _advance_one_step_impl(
    state: ParticleState,
    dt,
    t,
    *,
    cfg: SimConfig,
    model,
    colliders: Sequence[collision.Collider],
    plasticity: Optional[str] = None,
    bin_caps: Optional[Tuple[int, int]] = None,
    mg_tile_caps: Optional[Tuple[int, ...]] = None,
    bsr_tile_cap: Optional[int] = None,
    mg_coarse_cap: Optional[int] = None,
    mg_bin_caps: Optional[Tuple[Tuple[int, int], ...]] = None,
    mg_composed_caps: Optional[Tuple[int, int]] = None,
    mg_ncomposed_caps: Optional[Tuple[int, int]] = None,
) -> Tuple[ParticleState, StepStats]:
    dim = cfg.dim
    res = cfg.grid_res[:dim]
    dx = cfg.dx
    dtype = state.x.dtype
    gravity = jnp.asarray(cfg.gravity[:dim], dtype)

    # ---- grid activation + P2G -------------------------------------------
    if cfg.grid_backend == "sparse":
        from hot_mpm.grid import sparse as sparse_mod

        if cfg.transfer_kernel != "quadratic":
            raise NotImplementedError(
                "cubic transfers require the dense grid backend"
            )
        tgrid = sparse_mod.build_tile_grid(state.x, dx, res, cfg.tile_capacity)
        st = sparse_mod.sparse_stencil(state.x, dx, tgrid)
        n_nodes = tgrid.n_cnodes
        node_pos = sparse_mod.node_positions(tgrid, dx, dtype)
        grid_overflow = tgrid.overflow
        n_tiles = tgrid.n_active
    else:
        tgrid = None
        n_nodes = transfer.n_nodes_of(res)
        st = transfer.particle_stencil(state.x, dx, res,
                                       kernel=cfg.transfer_kernel)
        node_pos = transfer.node_positions(res, dx, dtype)
        grid_overflow = jnp.zeros((), bool)
        n_tiles = jnp.zeros((), jnp.int32)
    # scatter implementation: cell-binned (scatter-free) vs plain scatter-add.
    # The planner may plan bins for the assembled multigrid alone
    # (capacity._binned_transfers); the transfers use them only when
    # transfer_impl asks for it.
    use_binned = (bin_caps is not None and cfg.grid_backend == "dense"
                  and cfg.transfer_impl == "binned")
    # sparse backend: tile-local binned transfers (ops.tile_transfer) — the
    # scatter-free path without materializing the dense logical grid
    use_tile_binned = bin_caps is not None and cfg.grid_backend == "sparse"
    # slot-major solve layout: only the matrix-free Newton path consumes it
    # (the explicit-BSR assembly and LBFGS baselines stay particle-ordered)
    # slot-major is opt-in: its padded slots multiply per-row work (the
    # "padding tax", docs/KERNEL_PLAN.md)
    use_slots = (
        cfg.solver.slot_major is True
        and use_binned and cfg.solver.matrix_free
        and cfg.solver.integrator != "explicit"
        and cfg.solver.nonlinear == "newton"
    )
    bins = None
    if use_binned:
        bins = transfer.bin_particles(state.x, dx, res, bin_caps[0], bin_caps[1])
        scatter = transfer.make_binned_scatter(bins, res)
        gather_st = transfer.make_binned_gather(bins, res)
        bin_overflow = bins.overflow
    elif use_tile_binned:
        from hot_mpm.ops import bsr_tiled, tile_transfer

        t_nbr = bsr_tiled.tile_neighbors(tgrid)
        bins = tile_transfer.sparse_bins(state.x, dx, tgrid,
                                         bin_caps[0], bin_caps[1])
        scatter = tile_transfer.make_tile_scatter(bins, tgrid, t_nbr)
        gather_st = tile_transfer.make_tile_gather(bins, tgrid, t_nbr)
        bin_overflow = bins.overflow
    else:
        scatter = transfer.default_scatter
        gather_st = transfer.default_gather_stencil
        bin_overflow = jnp.zeros((), bool)
    grid_overflow = jnp.logical_or(grid_overflow, bin_overflow)

    if use_slots:
        # SLOT-MAJOR solve-time layout (docs/KERNEL_PLAN.md): permute every
        # per-particle array the implicit solve touches into slot order with
        # ONE gather; all solve transfers then run with exactly one
        # latency-bound op per direction (see transfer.slot_order).
        eye_d = jnp.eye(dim, dtype=dtype)
        (v_s, C_s, m1_s, F_s, V0_s, mu_s, lam_s, wn_s, gwn_s, rel_s), slot_valid = (
            transfer.slot_order(
                bins,
                [state.v, state.C, state.m[:, None], state.F,
                 state.V0[:, None], state.mu[:, None], state.lam[:, None],
                 st.wn, st.gwn, st.rel],
            )
        )
        # padding slots: F -> identity so SVD chains stay NaN-free (their
        # weights/volumes are zero, so they contribute nothing)
        F_s = jnp.where(slot_valid[:, None, None], F_s, eye_d[None])
        sol_st = transfer.Stencil(
            node_ids=jnp.zeros(wn_s.shape, jnp.int32), wn=wn_s, gwn=gwn_s,
            rel=rel_s,
        )
        sol_scatter = transfer.make_slot_scatter(bins, res)
        sol_gather = transfer.make_slot_gather(bins, res)
        sol_F, sol_V0 = F_s, V0_s[:, 0]
        sol_mu, sol_lam = mu_s[:, 0], lam_s[:, 0]
        grid_m, grid_mv = transfer.p2g_mass_momentum(
            sol_st, v_s, C_s, m1_s[:, 0], n_nodes, scatter=sol_scatter
        )
    else:
        sol_st, sol_scatter, sol_gather = st, scatter, gather_st
        sol_F, sol_V0, sol_mu, sol_lam = state.F, state.V0, state.mu, state.lam
        grid_m, grid_mv = transfer.p2g_mass_momentum(
            st, state.v, state.C, state.m, n_nodes, scatter=scatter
        )

    active = grid_m > 0
    inv_m = jnp.where(active, 1.0 / jnp.maximum(grid_m, 1e-30), 0.0)
    v_grid = grid_mv * inv_m[:, None]

    # ---- grid BC ----------------------------------------------------------
    v_star = v_grid + dt * gravity[None, :]
    proj, v_bc, _ = collision.grid_boundary_conditions(
        node_pos, t, colliders, grid_v=v_star, boundary_margin=2, res=res, dx=dx
    )
    # initial iterate satisfies the constraints
    v0 = collision.apply_bc_to_velocity(v_star, proj, v_bc)

    # ---- implicit solve ---------------------------------------------------
    # The objective runs on the SLOT-MAJOR arrays when binned (sol_*); on
    # other paths sol_* alias the particle-order arrays.
    sol = cfg.solver
    objective = obj_mod.make_objective(
        model, sol_st, sol_F, sol_V0, sol_mu, sol_lam,
        grid_m, v_star, proj, dt, dx, scatter=sol_scatter,
    )

    # Hessian representation: matrix-free (HOT's --matfree) or explicit BSR
    if sol.matrix_free:
        build_hess = lambda v: (
            obj_mod.build_hessian(model, objective, v,
                                  project_spd=sol.project_hessian,
                                  gather_st=sol_gather),
            None,
        )
        multiply = lambda hp, w: obj_mod.multiply(objective, hp[0], w,
                                                  scatter=sol_scatter,
                                                  gather_st=sol_gather)

        def lin(v):
            # fused residual + Hessian (one SVD chain per Newton iteration)
            r, hess = obj_mod.linearize(
                model, objective, v, project_spd=sol.project_hessian,
                scatter=sol_scatter, gather_st=sol_gather,
            )
            return r, (hess, None)
    else:
        lin = None
        from hot_mpm.ops import bsr as bsr_mod

        if cfg.grid_backend == "sparse":
            raise NotImplementedError(
                "explicit BSR currently requires the dense grid backend"
            )
        if cfg.transfer_kernel != "quadratic":
            raise NotImplementedError(
                "explicit BSR assembles the 5-wide quadratic structure; "
                "use matrix_free=True with cubic transfers"
            )
        use_tiled_bsr = bsr_tile_cap is not None and bsr_tile_cap > 0
        if use_tiled_bsr:
            # tile-row layout + supertile-window SpMV (ops.bsr_tiled): one
            # whole-tile gather instead of n_rows * K tiny row gathers
            # (docs/KERNEL_PLAN.md "Dynamic indexing")
            from hot_mpm.grid import sparse as sparse_mod
            from hot_mpm.ops import bsr_tiled

            btg = sparse_mod.build_tile_grid(state.x, dx, res, bsr_tile_cap)
            mat0 = bsr_tiled.structure_tiled(btg)
            bnbr = bsr_tiled.tile_neighbors(btg)
            grid_overflow = jnp.logical_or(grid_overflow, btg.overflow)
        else:
            capacity = sol.bsr_capacity or n_nodes
            mat0 = bsr_mod.structure(active, res, capacity)

        def build_hess(v):
            hess = obj_mod.build_hessian(
                model, objective, v, project_spd=sol.project_hessian
            )
            if bins is not None:
                # scatter-free rank-1-mode assembly: one batched matmul per
                # cell instead of the colliding per-particle block scatter
                # (docs/KERNEL_PLAN.md "Dynamic indexing")
                mat = bsr_mod.assemble_hessian_modes(
                    mat0, bins, st, state.F, hess.ctx, state.V0, dt, grid_m
                )
            else:
                mat = bsr_mod.assemble_hessian(
                    mat0, st, state.F, hess.ctx, state.V0, dt, grid_m
                )
            return (hess, mat)

        def multiply(hp, w):
            _, mat = hp
            rows = bsr_mod.grid_vector_to_rows(mat, w)
            if use_tiled_bsr:
                y_rows = bsr_tiled.spmv_tiled(mat, btg, bnbr, rows)
            else:
                y_rows = bsr_mod.spmv(mat, rows)
            y = bsr_mod.rows_to_grid_vector(mat, y_rows, n_nodes)
            return jnp.where(active[:, None], y, w)

    refresh_precond = None
    if sol.preconditioner == "none":
        build_precond = lambda hp: None
        precond = lambda pstate, r: r
    elif sol.preconditioner == "jacobi":
        # mass Jacobi (HOT's plain-PCG baseline class, component #38)
        build_precond = lambda hp: None
        precond = lambda pstate, r: obj_mod.mass_precondition(objective, r)
    elif sol.preconditioner == "block_jacobi":
        # block-diagonal of M + dt^2 K (HOT's --Ainv option)
        def build_precond(hp):
            D = obj_mod.elastic_block_diag(
                sol_st, sol_F, hp[0].ctx, sol_V0, dt, grid_m, active, dim,
                scatter=sol_scatter,
            )
            return obj_mod.sym_block_inv(D)

        precond = lambda Dinv, r: jnp.einsum("nij,nj->ni", Dinv, r)
    elif sol.preconditioner == "multigrid":
        from hot_mpm.solver import multigrid as mg_mod

        _, _, constrained = collision.grid_boundary_conditions(
            node_pos, t, colliders, grid_v=v_star, boundary_margin=2, res=res, dx=dx
        )
        if sol.multigrid.assembled and cfg.transfer_kernel != "quadratic":
            raise NotImplementedError(
                "assembled MG levels use the 5-wide quadratic BSR; run the "
                "matrix-free MG (multigrid.assembled=False) with cubic"
            )
        mg_static = mg_mod.build_static(
            state.x, state.m, res, dx, sol.multigrid.levels, constrained, dtype,
            tile_capacity=(cfg.tile_capacity if cfg.grid_backend == "sparse" else 0),
            bin_caps=bin_caps,
            mg_tile_caps=mg_tile_caps,
            mg_bin_caps=mg_bin_caps,
            kernel=cfg.transfer_kernel,
            dense_switch=sol.multigrid.sparse_dense_switch,
            assembled_from=sol.multigrid.assembled_from_level,
            mg_composed_caps=mg_composed_caps,
            mg_ncomposed_caps=mg_ncomposed_caps,
        )
        if mg_static.overflow is not None:
            grid_overflow = jnp.logical_or(grid_overflow, mg_static.overflow)
        mgc = sol.multigrid
        if mgc.coarse_capacity is None and mg_coarse_cap is not None:
            import dataclasses as _dc

            mgc = _dc.replace(mgc, coarse_capacity=mg_coarse_cap)
        if mgc.coarse_solver == "direct" and mgc.coarse_capacity is not None:
            # active coarsest rows beyond the static capacity would be
            # silently dropped from the factor -> flag for host regrow
            grid_overflow = jnp.logical_or(
                grid_overflow,
                jnp.sum(mg_static.levels[-1].active) > mgc.coarse_capacity,
            )

        def _ctx_particle_order(ctx):
            # the MG hierarchy is particle-indexed; under the slot-major
            # solve the finest-level ctx arrives slot-ordered — permute it
            # back with ONE packed gather per Newton iteration
            if not use_slots:
                return ctx
            n = state.x.shape[0]
            U, V, A, bp, bm = transfer.particle_order(
                bins, [ctx.U, ctx.V, ctx.A, ctx.b_plus, ctx.b_minus], n
            )
            return cm.HessianContext(U=U, V=V, A=A, b_plus=bp, b_minus=bm)

        def build_precond(hp):
            return mg_mod.build_precond(
                mg_static, state.F, _ctx_particle_order(hp[0].ctx), state.V0,
                dt, mgc, dim
            )

        if mgc.rap_refresh == "lagged" and mgc.assembled:
            # per-Newton partial refresh: first assembled level + smoother
            # data fresh, deep RAP chain + coarse factor from the v0 build
            def refresh_precond(hp, base):
                return mg_mod.build_precond(
                    mg_static, state.F, _ctx_particle_order(hp[0].ctx),
                    state.V0, dt, mgc, dim, reuse=base
                )
        else:
            refresh_precond = None

        def precond(pstate, r):
            return mg_mod.mg_precondition(
                mg_static, pstate, state.F, state.V0, dt, mgc, r
            )
    else:
        raise ValueError(f"unknown preconditioner '{sol.preconditioner}'")

    if sol.integrator == "explicit":
        # symplectic-Euler grid update (reference: the explicit path of
        # MpmSimulationBase::advanceOneTimeStep — forces at F_n, no solve)
        P = jax.vmap(lambda f, m_, l_: cm.first_piola(model, f, m_, l_))(
            state.F, state.mu, state.lam
        )
        PFt = P @ jnp.swapaxes(state.F, -1, -2)
        f_grid = transfer.scatter_force(st, PFt, state.V0, n_nodes, scatter=scatter)
        v_solved = v_star + dt * f_grid * inv_m[:, None]
        result = NewtonResult(
            v=v_solved,
            iters=jnp.zeros((), jnp.int32),
            cg_iters=jnp.zeros((), jnp.int32),
            cn_residual=jnp.zeros((), dtype),
            cn_residual0=jnp.zeros((), dtype),
            converged=jnp.ones((), bool),
            cn_history=jnp.zeros((sol.max_newton + 1,), dtype),
        )
    elif sol.nonlinear == "lbfgs":
        # quasi-Newton baseline (the paper's LBFGS-H comparison solver)
        from hot_mpm.solver.lbfgs import lbfgs_solve

        lres = lbfgs_solve(
            energy=lambda v: obj_mod.energy(model, objective, v),
            gradient=lambda v: obj_mod.residual(
                model, objective, v, scatter=scatter, gather_st=gather_st
            ),
            project=lambda r: obj_mod.project(objective, r),
            precondition=lambda r: obj_mod.mass_precondition(objective, r),
            cn_norm=lambda r: obj_mod.cn_norm(objective, r),
            v0=v0,
            history=sol.lbfgs_history,
            max_iters=sol.max_cg,
            cn_eps=sol.cn_eps if sol.use_cn else 0.0,
        )
        result = NewtonResult(
            v=lres.v,
            iters=lres.iters,
            cg_iters=lres.iters,
            cn_residual=lres.grad_norm,
            cn_residual0=lres.grad_norm,
            converged=lres.converged,
            cn_history=jnp.zeros((sol.max_newton + 1,), dtype),
        )
    else:
        result: NewtonResult = newton_solve(
            residual=lambda v: obj_mod.residual(model, objective, v,
                                                scatter=sol_scatter,
                                                gather_st=sol_gather),
            build_hessian=build_hess,
            multiply=multiply,
            project=lambda r: obj_mod.project(objective, r),
            precondition=precond,
            build_preconditioner=build_precond,
            cn_norm=lambda r: obj_mod.cn_norm(objective, r),
            v0=v0,
            max_newton=sol.max_newton,
            cn_eps=sol.cn_eps if sol.use_cn else 0.0,
            abs_tol=sol.abs_tol,
            cg_tol=sol.cg_tol,
            max_cg=sol.max_cg,
            adaptive_forcing=sol.adaptive_forcing,
            linear_solver=sol.linear_solver,
            energy=lambda v: obj_mod.energy(model, objective, v,
                                            gather_st=sol_gather),
            line_search=sol.line_search,
            precond_refresh=sol.precond_refresh,
            refresh_preconditioner=refresh_precond,
            linearize=lin,
        )
    v_new = collision.apply_bc_to_velocity(result.v, proj, v_bc)

    # ---- G2P + state update ----------------------------------------------
    from hot_mpm.ops.bspline import apic_d_inv_factor

    d_inv = apic_d_inv_factor(cfg.transfer_kernel)
    v_pic, grad_v, C_new = transfer.g2p(st, v_new, dx, gather_st=gather_st,
                                        d_inv_factor=d_inv)
    if cfg.transfer == "flip":
        v_old_interp, _, _ = transfer.g2p(st, v_grid, dx, gather_st=gather_st,
                                          d_inv_factor=d_inv)
        v_p = (1.0 - cfg.flip_ratio) * v_pic + cfg.flip_ratio * (
            state.v + (v_pic - v_old_interp)
        )
        C_next = jnp.zeros_like(state.C)
    else:  # APIC
        v_p = v_pic
        C_next = C_new

    eye = jnp.eye(dim, dtype=dtype)
    F_new = (eye[None] + dt * grad_v) @ state.F

    Jp_new = state.Jp
    if plasticity == "von_mises":
        F_new = jax.vmap(plast.VonMisesHencky.project)(
            F_new, state.mu, state.lam, state.yield_stress
        )
    elif plasticity == "snow":
        F_new, jp_ratio = jax.vmap(plast.SnowPlasticity.project)(F_new)
        Jp_new = state.Jp * jp_ratio
    elif plasticity == "drucker_prager":
        alpha = plast.DruckerPrager.alpha_from_friction_angle(30.0)
        F_new = jax.vmap(lambda f, m_, l_: plast.DruckerPrager.project(f, m_, l_, alpha))(
            F_new, state.mu, state.lam
        )

    x_new = state.x + dt * v_pic
    # keep particles inside the valid domain (one stencil-cell margin)
    lo = 2.0 * dx
    hi = (jnp.asarray(res, dtype) - 3.0) * dx
    x_new = jnp.clip(x_new, lo, hi[None, :])

    new_state = state.replace(x=x_new, v=v_p, C=C_next, F=F_new, Jp=Jp_new)

    # ---- diagnostics ------------------------------------------------------
    if cfg.compute_energy:
        psi = jax.vmap(lambda f, m_, l_: cm.psi_from_F(model, f, m_, l_))(
            F_new, state.mu, state.lam
        )
        potential = jnp.sum(state.V0 * psi)
    else:
        # the energy diagnostic costs one more SVD sweep over all
        # particles; large-scale configs turn it off (cfg.compute_energy)
        potential = jnp.zeros((), dtype)
    stats = StepStats(
        newton_iters=result.iters,
        cg_iters=result.cg_iters,
        cn_residual=result.cn_residual,
        cn_residual0=result.cn_residual0,
        converged=result.converged,
        max_velocity=jnp.max(jnp.linalg.norm(v_p, axis=-1)),
        kinetic_energy=0.5 * jnp.sum(state.m * jnp.sum(v_p * v_p, axis=-1)),
        potential_energy=potential,
        active_nodes=jnp.sum(active),
        active_tiles=n_tiles,
        grid_overflow=grid_overflow,
    )
    return new_state, stats


class Simulation:
    """Frame loop driver (reference: SimulationBase::simulate, component #22).

    Owns the jitted step, CFL dt control, metrics, and frame IO hooks.
    """

    def __init__(
        self,
        cfg: SimConfig,
        state: ParticleState,
        model,
        colliders: Sequence[collision.Collider] = (),
        plasticity: Optional[str] = None,
        metrics: Optional[MetricsLogger] = None,
    ):
        self.cfg = cfg
        self.state = state
        self.model = model
        self.colliders = tuple(colliders)
        self.plasticity = plasticity
        self.metrics = metrics or MetricsLogger()
        self.timer = PhaseTimer()
        self.t = 0.0
        self.step_count = 0
        self.retry_count = 0
        self._rebuild_step(capacity.plan_capacities(cfg, state.x))

    def _rebuild_step(self, plan: capacity.CapacityPlan):
        """(Re)trace the step program with the plan's static capacities
        (one planner for all six tables — hot_mpm.sim.capacity)."""
        self._plan = plan
        self._step = jax.jit(
            functools.partial(
                advance_one_step,
                cfg=self.cfg,
                model=self.model,
                colliders=self.colliders,
                plasticity=self.plasticity,
                bin_caps=plan.bin_caps,
                mg_tile_caps=plan.mg_tile_caps,
                bsr_tile_cap=plan.bsr_tile_cap,
                mg_coarse_cap=plan.mg_coarse_cap,
                mg_bin_caps=plan.mg_bin_caps,
                mg_composed_caps=plan.mg_composed_caps,
                mg_ncomposed_caps=plan.mg_ncomposed_caps,
            )
        )

    def compute_dt(self) -> float:
        """CFL-rate dt (reference: calculateDt): particles move <= cfl cells."""
        vmax = float(jnp.max(jnp.linalg.norm(self.state.v, axis=-1)))
        # gravity-inflated bound, as the reference does for free fall
        g = float(jnp.linalg.norm(jnp.asarray(self.cfg.gravity[: self.cfg.dim])))
        vmax = vmax + g * self.cfg.max_dt
        dt_cfl = self.cfg.cfl * self.cfg.dx / max(vmax, 1e-6)
        return float(min(self.cfg.max_dt, max(self.cfg.min_dt, dt_cfl)))

    def step(self, dt: Optional[float] = None) -> StepStats:
        """One time step with failure sentinels (SURVEY.md §5.3): if the
        Newton solve diverges or the state goes non-finite, the step is
        retried from the saved state at halved dt (scientifically necessary
        at CFL-rate stepping; also the recovery path for fault injection)."""
        dt = self.compute_dt() if dt is None else dt
        prev_state = self.state
        attempt = 0
        regrows = 0
        while True:
            with self.timer.scope("advance_one_step"):
                new_state, stats = self._step(prev_state, dt, self.t)
                jax.block_until_ready(new_state.x)
            if bool(stats.grid_overflow):
                # capacity policy (SURVEY.md §7 hard-part 2): static tables
                # are sized tight; on overflow, regrow + recompile (amortized)
                # and redo the step — the overflowed result dropped particles.
                old = self._plan
                if old == capacity.CapacityPlan() or regrows >= 8:
                    raise RuntimeError(
                        f"sparse tile capacity exceeded ({int(stats.active_tiles)}"
                        f" of {self.cfg.tile_capacity} tiles); raise "
                        "cfg.tile_capacity"
                    )
                regrows += 1
                # re-measure the CURRENT particle layout with headroom; the
                # single grow rule forces strict growth so the retried step
                # cannot overflow on the same layout again
                fresh = capacity.plan_capacities(self.cfg, prev_state.x,
                                                 grow=1.3)
                plan = capacity.grow_plan(fresh, old)
                self.metrics.log(event="bin_regrow",
                                 old=list(old.bin_caps or ()),
                                 new=list(plan.bin_caps or ()),
                                 mg=list(plan.mg_tile_caps or ()),
                                 bsr=plan.bsr_tile_cap,
                                 mg_coarse=plan.mg_coarse_cap)
                self._rebuild_step(plan)
                continue
            finite = bool(jnp.isfinite(stats.cn_residual)) and bool(
                jnp.all(jnp.isfinite(new_state.x))
            )
            if finite and (bool(stats.converged) or attempt >= self.cfg.solver.dt_retries):
                break
            if attempt >= self.cfg.solver.dt_retries:
                # retries exhausted on a still-non-finite state (e.g. a NaN
                # injected into F — dt halving cannot fix it): give up and
                # surface the event rather than spinning forever; the caller
                # recovers via checkpoint-resume (SURVEY.md §5.3).
                self.metrics.log(event="nonfinite_give_up", dt=dt)
                break
            attempt += 1
            dt = dt * 0.5
            self.retry_count += 1
            # the failed attempt's solver state says why it was retried
            self.metrics.log(event="dt_retry", attempt=attempt, dt=dt,
                             finite=finite, newton_iters=stats.newton_iters,
                             cg_iters=stats.cg_iters,
                             cn_residual=stats.cn_residual)
        self.state = new_state
        self.t += dt
        self.step_count += 1
        self.metrics.log(
            step=self.step_count,
            t=self.t,
            dt=dt,
            newton_iters=stats.newton_iters,
            cg_iters=stats.cg_iters,
            cn_residual=stats.cn_residual,
            converged=stats.converged,
            max_velocity=stats.max_velocity,
            kinetic_energy=stats.kinetic_energy,
            potential_energy=stats.potential_energy,
            active_nodes=stats.active_nodes,
            active_tiles=stats.active_tiles,
        )
        return stats

    def advance_frame(self, frame_callback: Optional[Callable] = None):
        """Advance one output frame of duration cfg.frame_dt."""
        t_end = self.t + self.cfg.frame_dt
        while self.t < t_end - 1e-12:
            dt = min(self.compute_dt(), t_end - self.t)
            self.step(dt)
        if frame_callback is not None:
            frame_callback(self)

    def run(self, frames: int, frame_callback: Optional[Callable] = None):
        for _ in range(frames):
            self.advance_frame(frame_callback)
