"""Fully sharded implicit MPM step: P2G, Newton solve, and G2P all under
shard_map with explicit halo exchange.

This is the stage-5 capability (SURVEY.md §7, BASELINE.json configs 4-5):
grid x-planes slab-partitioned over mesh axis 'x'; particles live on the
device owning their base plane and are re-partitioned globally between
steps (they move). Inside shard_map everything is local + neighbor
ppermute ghosts + psum reductions:

  P2G   -> scatter into the extended slab, fold ghosts to owners
  BC    -> evaluated at locally-reconstructed global node positions
  Newton-> newton_solve(axis_name=...): CN norms, CG dots, and residual
           norms psum so every device executes identical trip counts
  G2P   -> exchange ghosts, gather locally

Padding particle slots carry zero mass/volume and sit at their device's
slab center, so they are exact no-ops everywhere. Verified identical to
the single-device step on CPU-simulated meshes (tests/test_sharded_step.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from hot_mpm.models import constitutive as cm
from hot_mpm.models import plasticity as plast
from hot_mpm.ops import transfer
from hot_mpm.ops.bspline import quadratic_bspline_weights, stencil_offsets, tensor_weights
from hot_mpm.parallel.halo import exchange_halo, fold_halo
from hot_mpm.sim import collision
from hot_mpm.sim import objective as obj_mod
from hot_mpm.sim.state import ParticleState
from hot_mpm.solver.newton import newton_solve
from hot_mpm.utils.config import SimConfig

HALO = 2


class ShardedStepStats(NamedTuple):
    newton_iters: jax.Array
    cg_iters: jax.Array
    cn_residual: jax.Array
    converged: jax.Array
    partition_overflow: jax.Array
    # any device's MG bin/tile capacities overflowed this step (assembled
    # sharded MG) — the operator silently dropped contributions; the caller
    # must regrow caps and redo the step, like the single-device regrow path
    # (None default avoids creating a device array at import time)
    grid_overflow: object = None


def _partition_state(state: ParticleState, dx, res, D: int, n_max: int):
    """Global stage: particles -> (D, n_max) padded blocks + inverse map."""
    planes = res[0] // D
    base = jnp.floor(state.x[:, 0] / dx - 0.5).astype(jnp.int32)
    base = jnp.clip(base, 0, res[0] - 1)
    dev = jnp.clip(base // planes, 0, D - 1)
    n = state.n

    order = jnp.argsort(dev, stable=True)
    dev_sorted = dev[order]
    pos = jnp.arange(n) - jnp.searchsorted(dev_sorted, dev_sorted, side="left")
    overflow = jnp.any(pos >= n_max)
    slot_sorted = dev_sorted * n_max + jnp.minimum(pos, n_max - 1)
    slot_sorted = jnp.where(pos < n_max, slot_sorted, D * n_max)
    # slot of each ORIGINAL particle
    slot_of = jnp.zeros((n + 1,), jnp.int32).at[
        jnp.minimum(order, n - 1)
    ].set(slot_sorted.astype(jnp.int32))[:n]

    dim = state.dim
    # per-device padding position: slab center (keeps local ids in range)
    dev_ids = jnp.arange(D, dtype=state.x.dtype)
    pad_x0 = (dev_ids * planes + planes * 0.5) * dx
    pad_pos = jnp.stack(
        [jnp.broadcast_to(pad_x0[:, None], (D, n_max))]
        + [jnp.full((D, n_max), 0.5 * res[k] * dx, state.x.dtype)
           for k in range(1, dim)],
        axis=-1,
    )

    def fill(a, pad):
        out = jnp.concatenate(
            [jnp.broadcast_to(jnp.asarray(pad, a.dtype), (D * n_max,) + a.shape[1:]).reshape(D * n_max, *a.shape[1:]),
             jnp.zeros((1,) + a.shape[1:], a.dtype)],
            axis=0,
        )
        out = out.at[slot_of].set(a)
        return out[:-1].reshape((D, n_max) + a.shape[1:])

    eye = jnp.eye(dim, dtype=state.F.dtype)
    x_f = fill(state.x, 0.0)
    m_f = fill(state.m, 0.0)
    blocks = ParticleState(
        x=jnp.where((m_f > 0)[..., None], x_f, pad_pos),
        v=fill(state.v, 0.0),
        Cf=fill(state.Cf, 0.0),
        Ff=fill(state.Ff, eye.reshape(-1)),
        m=fill(state.m, 0.0),
        V0=fill(state.V0, 0.0),
        mu=fill(state.mu, 0.0),
        lam=fill(state.lam, 0.0),
        yield_stress=fill(state.yield_stress, jnp.inf),
        Jp=fill(state.Jp, 1.0),
    )
    return blocks, slot_of, overflow


def _unpartition(blocks: ParticleState, slot_of):
    def pick(a):
        flat = a.reshape((-1,) + a.shape[2:])
        return flat[slot_of]

    return jax.tree_util.tree_map(pick, blocks)


def _local_positions(dev, planes, res, dx, dtype):
    """Global positions of this slab's nodes, (local_nodes, dim)."""
    dim = len(res)
    rest_res = res[1:]
    plane_nodes = 1
    for r in rest_res:
        plane_nodes *= int(r)
    p_idx = jax.lax.broadcasted_iota(jnp.int32, (planes, plane_nodes), 0)
    r_idx = jax.lax.broadcasted_iota(jnp.int32, (planes, plane_nodes), 1)
    coords = [dev * planes + p_idx]
    rem = r_idx
    strides = []
    s = 1
    for r in reversed(rest_res):
        strides.append(s)
        s *= int(r)
    strides = strides[::-1]
    for k in range(dim - 1):
        coords.append(rem // strides[k])
        rem = rem - (rem // strides[k]) * strides[k]
    pos = jnp.stack([c.reshape(-1).astype(dtype) * dx for c in coords], axis=-1)
    return pos


def make_sharded_step(mesh: Mesh, cfg: SimConfig, model,
                      colliders: Sequence[collision.Collider], n_max: int,
                      plasticity=None, axis: str = "x", mg_bin_caps=None):
    """Build the jitted fully-sharded step: (state, dt, t) -> (state, stats).

    mg_bin_caps: per-MG-level (cells_cap, cap) for the scatter-free binned
    assembly of assembled MG levels (cfg.solver.multigrid.assembled); None
    uses the colliding-scatter assembly.
    """
    physics = _make_local_physics(mesh, cfg, model, colliders, plasticity,
                                  axis, mg_bin_caps)
    D = mesh.shape[axis]
    res = cfg.grid_res[:cfg.dim]
    dx = cfg.dx

    def local_step(blocks, dt, t):
        ps: ParticleState = jax.tree_util.tree_map(lambda a: a[0], blocks)
        out, stats = physics(ps, dt, t)
        out = jax.tree_util.tree_map(lambda a: a[None], out)
        return out, stats

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=(P(axis), P()),
    )

    @jax.jit
    def step(state: ParticleState, dt, t):
        with jax.default_matmul_precision("highest"):
            blocks, slot_of, overflow = _partition_state(state, dx, res, D, n_max)
            new_blocks, stats = sharded(blocks, dt, t)
            new_state = _unpartition(new_blocks, slot_of)
            stats = stats._replace(partition_overflow=overflow)
            return new_state, stats

    return step


def _make_local_physics(mesh: Mesh, cfg: SimConfig, model,
                        colliders: Sequence[collision.Collider],
                        plasticity=None, axis: str = "x", mg_bin_caps=None):
    """The per-device step physics (P2G -> BC -> Newton -> G2P -> advect)
    as a closure over static scene config; runs INSIDE shard_map on this
    device's padded local particles. Shared by the globally-repartitioning
    step (make_sharded_step) and the neighbor-migrating step
    (make_migrating_step)."""
    D = mesh.shape[axis]
    dim = cfg.dim
    res = cfg.grid_res[:dim]
    assert cfg.transfer_kernel == "quadratic", (
        "the sharded step builds quadratic (3-wide, HALO=2) stencils"
    )
    assert res[0] % D == 0
    planes = res[0] // D
    plane_nodes = 1
    for r in res[1:]:
        plane_nodes *= int(r)
    local_nodes = planes * plane_nodes
    ext_nodes = (planes + 2 * HALO) * plane_nodes
    dx = cfg.dx
    sol = cfg.solver

    def physics(ps: ParticleState, dt, t):
        dev = jax.lax.axis_index(axis)
        dtype = ps.x.dtype
        gravity = jnp.asarray(cfg.gravity[:dim], dtype)

        # ---- local stencil (ids into the EXTENDED slab) ------------------
        base, w, dw = quadratic_bspline_weights(ps.x, dx)
        wn, gwn = tensor_weights(w, dw)
        offs = stencil_offsets(dim)
        res_arr = jnp.asarray(res, jnp.int32)
        coords = jnp.clip(base[:, None, :] + offs[None], 0, res_arr - 1)
        lplane = coords[..., 0] - dev * planes + HALO
        rest = jnp.zeros(coords.shape[:-1], jnp.int32)
        strides = []
        s = 1
        for r in reversed(res[1:]):
            strides.append(s)
            s *= int(r)
        strides = strides[::-1]
        for k in range(dim - 1):
            rest = rest + coords[..., k + 1] * strides[k]
        lids = jnp.clip(lplane, 0, planes + 2 * HALO - 1) * plane_nodes + rest
        rel = coords.astype(dtype) * dx - ps.x[:, None, :]
        st = transfer.Stencil(node_ids=lids, wn=wn, gwn=gwn, rel=rel)

        def scatter_fold(values):
            ext = transfer.scatter_sum(st.node_ids, values, ext_nodes)
            extp = ext.reshape((planes + 2 * HALO, plane_nodes) + ext.shape[1:])
            return fold_halo(extp, axis, D, HALO).reshape(
                (local_nodes,) + ext.shape[1:]
            )

        def gather_ext(v_local):
            vp = v_local.reshape((planes, plane_nodes) + v_local.shape[1:])
            ext = exchange_halo(vp, axis, D, HALO)
            return ext.reshape((ext_nodes,) + v_local.shape[1:])

        # ---- P2G ---------------------------------------------------------
        # flat column forms shared with the single-device path
        # (transfer.apic_momentum_vals etc.): no (n, d, s, d) broadcast
        # temps at any spelling, and identical fp association both paths
        mw, mv_vals = transfer.apic_momentum_vals(st, ps.v, ps.C, ps.m)
        grid_m = scatter_fold(mw)
        grid_mv = scatter_fold(mv_vals)
        active = grid_m > 0
        inv_m = jnp.where(active, 1.0 / jnp.maximum(grid_m, 1e-30), 0.0)
        v_grid = grid_mv * inv_m[:, None]
        v_star = v_grid + dt * gravity[None, :]

        # ---- BC ----------------------------------------------------------
        node_pos = _local_positions(dev, planes, res, dx, dtype)
        proj, v_bc, _ = collision.grid_boundary_conditions(
            node_pos, t, colliders, grid_v=v_star, boundary_margin=2,
            res=res, dx=dx,
        )
        v0 = collision.apply_bc_to_velocity(v_star, proj, v_bc)

        # ---- objective closures (local + halo) ---------------------------
        stiff = ps.V0 * (2.0 * ps.mu + ps.lam) / dx
        f_char = scatter_fold(st.wn * stiff[:, None])
        cn_scale = jnp.maximum(dt * f_char, grid_m * dx / dt)
        cn_scale = jnp.where(active, cn_scale, 1.0)

        def project_r(r):
            r = jnp.einsum("nij,nj->ni", proj, r)
            return jnp.where(active[:, None], r, 0.0)

        def grad_of(v_local):
            vi = gather_ext(v_local)[st.node_ids]
            return transfer.grad_from_vi(st, vi)

        def linearize(v_local):
            F_new = (jnp.eye(dim, dtype=dtype)[None] + dt * grad_of(v_local)) @ ps.F
            Pstress, ctx = jax.vmap(
                lambda f, m_, l_: cm.stress_and_hessian(
                    model, f, m_, l_, project=sol.project_hessian
                )
            )(F_new, ps.mu, ps.lam)
            PFt = Pstress @ jnp.swapaxes(ps.F, -1, -2)
            f = scatter_fold(transfer.force_contrib(st, PFt, ps.V0))
            r = grid_m[:, None] * (v_local - v_star) - dt * f
            return project_r(r), ctx

        def _contrib_chain(ctx, ext_flat):
            """Per-particle Hessian-apply contributions from an extended-
            slab vector; LINEAR in ext_flat (ctx fixed)."""
            vi = ext_flat[st.node_ids]
            grad = transfer.grad_from_vi(st, vi)
            dF = dt * (grad @ ps.F)
            dP = jax.vmap(cm.apply_hessian)(ctx, dF)
            dPFt = dP @ jnp.swapaxes(ps.F, -1, -2)
            return transfer.force_contrib(st, dPFt, ps.V0)

        def multiply(ctx, w_local):
            if sol.overlap_halo:
                # linearity split (SURVEY.md §5.8 overlap design): the
                # local-data chain has NO dependency on the ppermute, so
                # XLA's latency-hiding scheduler overlaps the exchange with
                # it; the ghost chain contributes only near slab boundaries
                from hot_mpm.parallel.halo import _shift

                vp = w_local.reshape(planes, plane_nodes, dim)
                zeros_h = jnp.zeros((HALO, plane_nodes, dim), w_local.dtype)
                ext0 = jnp.concatenate([zeros_h, vp, zeros_h], axis=0)
                ghost_lo = _shift(vp[-HALO:], axis, +1, D)
                ghost_hi = _shift(vp[:HALO], axis, -1, D)
                gext = jnp.concatenate(
                    [ghost_lo, jnp.zeros_like(vp), ghost_hi], axis=0
                )
                contrib = (
                    _contrib_chain(ctx, ext0.reshape(ext_nodes, dim))
                    + _contrib_chain(ctx, gext.reshape(ext_nodes, dim))
                )
                df = scatter_fold(contrib)
            else:
                contrib = _contrib_chain(ctx, gather_ext(w_local))
                df = scatter_fold(contrib)
            out = grid_m[:, None] * w_local - dt * df
            return jnp.where(active[:, None], out, w_local)

        def cn_norm(r):
            scaled = r / cn_scale[:, None]
            num = jax.lax.psum(jnp.sum(scaled * scaled), axis)
            den = jax.lax.psum(jnp.sum(active), axis)
            return jnp.sqrt(num / jnp.maximum(den, 1).astype(r.dtype))

        # ---- preconditioner (mirrors the single-device options) ----------
        # block_jacobi: per-node (d, d) diagonal blocks of M + dt^2 K,
        # assembled with the SAME halo-folded scatter as the forces, so
        # boundary-node blocks match the single-device operator exactly;
        # application is purely node-local (no communication per CG iter).
        # multigrid: the sharded node-embedding hierarchy — slab-partitioned
        # fine levels with halo collectives, agglomerated coarsest solve
        # (parallel.sharded_mg; SURVEY.md §5.7's design).
        grid_overflow = jnp.zeros((), bool)
        if sol.preconditioner == "multigrid":
            from hot_mpm.parallel import sharded_mg as smg_mod

            _, _, constrained = collision.grid_boundary_conditions(
                node_pos, t, colliders, grid_v=v_star, boundary_margin=2,
                res=res, dx=dx,
            )
            mg_tile_caps = None
            if sol.multigrid.assembled:
                # dense tiling of each level's extended slab: exact
                # capacity, no overflow path needed
                caps = []
                cur = tuple(res)
                for _l in range(sol.multigrid.levels):
                    planes_l = cur[0] // D
                    ext = (planes_l + 2 * HALO,) + cur[1:]
                    cap = 1
                    for e in ext:
                        cap *= -(-int(e) // 4)
                    caps.append(cap)
                    cur = tuple((r + 1) // 2 for r in cur)
                mg_tile_caps = tuple(caps)
            smg = smg_mod.build_static(
                ps.x, ps.m, dev, res, dx, sol.multigrid.levels, constrained,
                axis, D, dtype, mg_tile_caps=mg_tile_caps,
                mg_bin_caps=mg_bin_caps,
                galerkin=(sol.multigrid.assembled
                          and sol.multigrid.coarsening == "galerkin"),
            )
            if smg.overflow is not None:
                # replicate across the mesh so the stats out-spec holds
                grid_overflow = jax.lax.psum(
                    smg.overflow.astype(jnp.int32), axis
                ) > 0
            if (sol.multigrid.coarse_solver == "direct"
                    and sol.multigrid.coarse_capacity):
                # active coarse rows beyond coarse_capacity are dropped by
                # the agglomerated factor (zero coarse correction there) —
                # surface it instead of silently degrading MG convergence.
                # grid_m holds owned planes only, so the global active
                # count is the psum of local counts.
                n_act_c = jax.lax.psum(
                    jnp.sum((smg.levels[-1].grid_m > 0).astype(jnp.int32)),
                    axis,
                )
                grid_overflow = jnp.logical_or(
                    grid_overflow,
                    n_act_c > sol.multigrid.coarse_capacity,
                )

            def build_preconditioner(ctx):
                return smg_mod.build_precond(
                    smg, ps.F, ctx, ps.V0, dt, sol.multigrid, dim, axis, D
                )

            def precondition(pstate, r):
                return smg_mod.mg_precondition(
                    smg, pstate, ps.F, ps.V0, dt, sol.multigrid, r, axis, D
                )
        elif sol.preconditioner == "block_jacobi":

            def build_preconditioner(ctx):
                D_blocks = obj_mod.elastic_block_diag(
                    st, ps.F, ctx, ps.V0, dt, grid_m, active, dim,
                    scatter=lambda _st, values, _n: scatter_fold(values),
                )
                return obj_mod.sym_block_inv(D_blocks)

            precondition = lambda Dinv, r: jnp.einsum("nij,nj->ni", Dinv, r)
        else:
            build_preconditioner = lambda ctx: None
            precondition = lambda _, r: jnp.where(
                active[:, None], r * inv_m[:, None], r
            )

        result = newton_solve(
            linearize=linearize,
            multiply=multiply,
            project=project_r,
            precondition=precondition,
            build_preconditioner=build_preconditioner,
            cn_norm=cn_norm,
            v0=v0,
            max_newton=sol.max_newton,
            cn_eps=sol.cn_eps if sol.use_cn else 0.0,
            abs_tol=sol.abs_tol,
            cg_tol=sol.cg_tol,
            max_cg=sol.max_cg,
            adaptive_forcing=sol.adaptive_forcing,
            axis_name=axis,
            precond_refresh=sol.precond_refresh,
        )
        v_new = collision.apply_bc_to_velocity(result.v, proj, v_bc)

        # ---- G2P + update ------------------------------------------------
        vi = gather_ext(v_new)[st.node_ids]
        v_pic, grad_v, C_new = transfer.g2p_from_vi(st, vi, dx)
        F_new = (jnp.eye(dim, dtype=dtype)[None] + dt * grad_v) @ ps.F
        if plasticity == "von_mises":
            F_new = jax.vmap(plast.VonMisesHencky.project)(
                F_new, ps.mu, ps.lam, ps.yield_stress
            )
        x_new = ps.x + dt * v_pic
        lo = 2.0 * dx
        hi = (jnp.asarray(res, dtype) - 3.0) * dx
        x_new = jnp.clip(x_new, lo, hi[None, :])
        # padding rows (m == 0): freeze them at their pad position
        is_pad = ps.m <= 0
        x_new = jnp.where(is_pad[:, None], ps.x, x_new)
        v_out = jnp.where(is_pad[:, None], 0.0, v_pic)

        out = ps.replace(x=x_new, v=v_out, C=C_new, F=F_new)
        stats = ShardedStepStats(
            newton_iters=result.iters,
            cg_iters=result.cg_iters,
            cn_residual=result.cn_residual,
            converged=result.converged,
            partition_overflow=jnp.zeros((), bool),
            grid_overflow=grid_overflow,
        )
        return out, stats

    return physics


# ---------------------------------------------------------------------------
# neighbor-local particle migration (VERDICT r1 #9)
# ---------------------------------------------------------------------------
#
# The globally-repartitioning step above materializes one argsort + full
# gather over ALL particles per step — correct, but a non-starter at 10M
# particles x multi-host. Under CFL stepping a particle moves < 1 cell per
# step, so between steps it can only cross into the IMMEDIATELY adjacent
# slab (planes >= 2 per device). The migrating step keeps the (D, n_max)
# block layout persistent across steps and exchanges only the particles
# that crossed a slab boundary: two fixed-capacity ppermute buffers per
# step, no global collective over particles anywhere. A per-particle id
# array rides along so callers can reconstruct a stable ordering for IO.


class MigratingStepStats(NamedTuple):
    newton_iters: jax.Array
    cg_iters: jax.Array
    cn_residual: jax.Array
    converged: jax.Array
    # any device's send buffer (migrate_cap) or free-slot pool overflowed,
    # or a particle crossed >1 slab in one step — the caller must fall back
    # to one global repartition and retry
    migrate_overflow: jax.Array
    grid_overflow: object = None


def _pad_template(ps: ParticleState, pad_x, dim):
    """Field values a freed slot takes (mass 0 => exact no-op)."""
    eye = jnp.eye(dim, dtype=ps.F.dtype)
    return dict(
        x=pad_x, v=jnp.zeros((dim,), ps.v.dtype),
        Cf=jnp.zeros((dim * dim,), ps.Cf.dtype),
        Ff=eye.reshape(-1), m=jnp.zeros((), ps.m.dtype),
        V0=jnp.zeros((), ps.V0.dtype),
        mu=jnp.zeros((), ps.mu.dtype), lam=jnp.zeros((), ps.lam.dtype),
        yield_stress=jnp.full((), jnp.inf, ps.yield_stress.dtype),
        Jp=jnp.ones((), ps.Jp.dtype),
    )


def _migrate(ps: ParticleState, ids, dev, planes, dx, res, D, M, axis):
    """Exchange boundary-crossing particles with slab neighbors.

    ps/ids: this device's (n_max,) local particles after advection.
    M: static migration capacity per direction. Returns (ps, ids, overflow).
    """
    n_max = ps.m.shape[0]
    dim = ps.dim
    is_pad = ps.m <= 0
    base = jnp.clip(
        jnp.floor(ps.x[:, 0] / dx - 0.5).astype(jnp.int32), 0, res[0] - 1
    )
    dest = jnp.clip(base // planes, 0, D - 1)
    shift = jnp.where(is_pad, 0, dest - dev)
    far = jnp.abs(shift) > 1            # CFL guarantees this never happens;
                                        # flagged -> host global repartition
    send_l = shift == -1
    send_r = shift == 1
    overflow = (
        jnp.any(far)
        | (jnp.sum(send_l) > M)
        | (jnp.sum(send_r) > M)
    )

    idx_l = jnp.nonzero(send_l, size=M, fill_value=n_max)[0]
    idx_r = jnp.nonzero(send_r, size=M, fill_value=n_max)[0]

    # pack: fields + ids, one pad row appended (picked by fill slots)
    pad_x = jnp.concatenate(
        [((dev.astype(ps.x.dtype) + 0.5) * planes * dx)[None],
         jnp.full((dim - 1,), 0.5 * res[1] * dx, ps.x.dtype)]
    )
    pad = _pad_template(ps, pad_x, dim)

    def pack(a, field, idx):
        ap = jnp.concatenate([a, jnp.asarray(pad[field], a.dtype)[None]], 0)
        return ap[idx]

    fields = ("x", "v", "Cf", "Ff", "m", "V0", "mu", "lam", "yield_stress",
              "Jp")
    buf_l = ParticleState(**{f: pack(getattr(ps, f), f, idx_l) for f in fields})
    buf_r = ParticleState(**{f: pack(getattr(ps, f), f, idx_r) for f in fields})
    ids_pad = jnp.concatenate([ids, jnp.full((1,), -1, ids.dtype)])
    ids_l = ids_pad[idx_l]
    ids_r = ids_pad[idx_r]

    # neighbor exchange (edge devices receive empty buffers)
    from hot_mpm.parallel.halo import _shift as ppshift

    recv_from_r = ppshift((buf_l, ids_l), axis, -1, D)   # right nbr's left-bound
    recv_from_l = ppshift((buf_r, ids_r), axis, +1, D)   # left nbr's right-bound
    arr = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b], axis=0),
        recv_from_l[0], recv_from_r[0],
    )
    arr_ids = jnp.concatenate([recv_from_l[1], recv_from_r[1]])
    arr_valid = arr.m > 0

    # departed slots become pads
    departed = send_l | send_r

    def clear(a, field):
        pv = jnp.asarray(pad[field], a.dtype)
        shape = (n_max,) + pv.shape
        return jnp.where(
            departed.reshape((n_max,) + (1,) * pv.ndim), 
            jnp.broadcast_to(pv[None], shape), a,
        )

    ps = ParticleState(**{f: clear(getattr(ps, f), f) for f in fields})
    ids = jnp.where(departed, -1, ids)

    # place arrivals into free slots
    free = is_pad | departed
    overflow = overflow | (jnp.sum(arr_valid) > jnp.sum(free))
    free_idx = jnp.nonzero(free, size=2 * M, fill_value=n_max)[0]
    pos = jnp.cumsum(arr_valid) - 1
    target = jnp.where(
        arr_valid, free_idx[jnp.clip(pos, 0, 2 * M - 1)], n_max
    )

    def place(a, v):
        ap = jnp.concatenate([a, a[:1]], axis=0)       # discard row
        return ap.at[target].set(v)[:n_max]

    ps = jax.tree_util.tree_map(place, ps, arr)
    ids = place(ids, arr_ids)
    return ps, ids, overflow


def make_migrating_step(mesh: Mesh, cfg: SimConfig, model,
                        colliders: Sequence[collision.Collider], n_max: int,
                        migrate_cap: int, plasticity=None, axis: str = "x",
                        mg_bin_caps=None):
    """Jitted persistent-layout step: (blocks, ids, dt, t) ->
    (blocks, ids, stats). blocks stay (D, n_max)-partitioned across steps;
    only boundary-crossing particles move, via two ppermute buffers of
    static capacity `migrate_cap`. No argsort / all-gather over particles
    anywhere in the compiled program (asserted in tests)."""
    physics = _make_local_physics(mesh, cfg, model, colliders, plasticity,
                                  axis, mg_bin_caps)
    D = mesh.shape[axis]
    res = cfg.grid_res[:cfg.dim]
    planes = res[0] // D
    dx = cfg.dx

    def local_step(blocks, ids, dt, t):
        ps: ParticleState = jax.tree_util.tree_map(lambda a: a[0], blocks)
        ids0 = ids[0]
        dev = jax.lax.axis_index(axis)
        out, stats = physics(ps, dt, t)
        out, ids1, mig_overflow = _migrate(
            out, ids0, dev, planes, dx, res, D, migrate_cap, axis
        )
        mig_overflow = jax.lax.psum(mig_overflow.astype(jnp.int32), axis) > 0
        go = stats.grid_overflow
        mstats = MigratingStepStats(
            newton_iters=stats.newton_iters,
            cg_iters=stats.cg_iters,
            cn_residual=stats.cn_residual,
            converged=stats.converged,
            migrate_overflow=mig_overflow,
            grid_overflow=go,
        )
        out = jax.tree_util.tree_map(lambda a: a[None], out)
        return out, ids1[None], mstats

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P()),
    )

    @jax.jit
    def step(blocks, ids, dt, t):
        with jax.default_matmul_precision("highest"):
            return sharded(blocks, ids, dt, t)

    return step


def make_plain_block_step(mesh: Mesh, cfg: SimConfig, model,
                          colliders, plasticity=None, axis: str = "x",
                          mg_bin_caps=None):
    """Physics-only block step (no migration): outputs keep particles in
    their old slots, possibly off-slab — the caller must globally
    repartition before the next step. Used as the migrating step's
    overflow fallback (a capacity overflow means >migrate_cap particles
    crossed in ONE step; only a global repartition of the OUTPUT can place
    them all)."""
    physics = _make_local_physics(mesh, cfg, model, colliders, plasticity,
                                  axis, mg_bin_caps)

    def local_step(blocks, dt, t):
        ps: ParticleState = jax.tree_util.tree_map(lambda a: a[0], blocks)
        out, stats = physics(ps, dt, t)
        return jax.tree_util.tree_map(lambda a: a[None], out), stats

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=(P(axis), P()),
    )

    @jax.jit
    def step(blocks, dt, t):
        with jax.default_matmul_precision("highest"):
            return sharded(blocks, dt, t)

    return step


def partition_with_ids(state: ParticleState, cfg: SimConfig, D: int,
                       n_max: int):
    """Initial (or fallback) global partition: (blocks, ids) for the
    migrating step. ids[d, j] = original particle index, -1 for pads."""
    res = cfg.grid_res[:cfg.dim]
    blocks, slot_of, overflow = _partition_state(state, cfg.dx, res, D, n_max)
    ids = jnp.full((D * n_max + 1,), -1, jnp.int32)
    ids = ids.at[slot_of].set(jnp.arange(state.n, dtype=jnp.int32))
    return blocks, ids[:-1].reshape(D, n_max), overflow


def gather_with_ids(blocks: ParticleState, ids, n: int) -> ParticleState:
    """Blocks -> flat state in ORIGINAL particle order (for IO/comparison)."""
    flat_ids = ids.reshape(-1)
    valid = flat_ids >= 0
    # invalid (pad) entries write into a trailing drop row, not slot 0
    slot_of_id = jnp.zeros((n + 1,), jnp.int32)
    slot_of_id = slot_of_id.at[jnp.where(valid, flat_ids, n)].set(
        jnp.arange(flat_ids.shape[0], dtype=jnp.int32)
    )[:n]

    def pick(a):
        return a.reshape((-1,) + a.shape[2:])[slot_of_id]

    return jax.tree_util.tree_map(pick, blocks)


class ShardedSimulation:
    """Host driver for the migrating sharded step (the distributed analog
    of sim.Simulation): holds the persistent (D, n_max) block layout, runs
    the neighbor-local migration step, and falls back to ONE global
    repartition + retry when a migration capacity overflows (same
    static-capacity policy as the single-device regrow path)."""

    def __init__(self, mesh: Mesh, cfg: SimConfig, state: ParticleState,
                 model, colliders, n_max: int = None, migrate_cap: int = None,
                 plasticity=None, axis: str = "x", mg_bin_caps=None):
        import numpy as np

        self.mesh = mesh
        self.cfg = cfg
        self.axis = axis
        D = mesh.shape[axis]
        self.D = D
        self.n = state.n
        res = cfg.grid_res[:cfg.dim]
        planes = res[0] // D
        if n_max is None:
            # worst slab occupancy of the initial layout + headroom
            base = np.clip(
                np.floor(np.asarray(state.x[:, 0]) / cfg.dx - 0.5).astype(int),
                0, res[0] - 1,
            )
            counts = np.bincount(np.clip(base // planes, 0, D - 1),
                                 minlength=D)
            n_max = int(1.5 * counts.max()) + 64
        if migrate_cap is None:
            migrate_cap = max(64, n_max // 8)
        self.n_max = n_max
        self.migrate_cap = migrate_cap
        self._step = make_migrating_step(
            mesh, cfg, model, colliders, n_max, migrate_cap,
            plasticity=plasticity, axis=axis, mg_bin_caps=mg_bin_caps,
        )
        self._model = model
        self._colliders = colliders
        self._plasticity = plasticity
        self._mg_bin_caps = mg_bin_caps
        self._plain = None   # fallback step, built on first overflow
        self.blocks, self.ids, of = partition_with_ids(state, cfg, D, n_max)
        if bool(of):
            raise ValueError(
                f"n_max={n_max} too small for the initial particle layout"
            )
        self.t = 0.0
        self.step_count = 0
        self.repartitions = 0

    def step(self, dt: float) -> MigratingStepStats:
        t = jnp.asarray(self.t, self.blocks.x.dtype)
        dt = jnp.asarray(dt, self.blocks.x.dtype)
        blocks, ids, stats = self._step(self.blocks, self.ids, dt, t)
        if bool(stats.migrate_overflow):
            # >migrate_cap particles crossed a slab boundary this step (or a
            # free-slot pool filled): the migrated output dropped particles,
            # so discard it, redo the step WITHOUT migration from the saved
            # pre-step layout, and globally repartition the result
            if self._plain is None:
                self._plain = make_plain_block_step(
                    self.mesh, self.cfg, self._model, self._colliders,
                    plasticity=self._plasticity, axis=self.axis,
                    mg_bin_caps=self._mg_bin_caps,
                )
            out_blocks, pstats = self._plain(self.blocks, dt, t)
            state = gather_with_ids(out_blocks, self.ids, self.n)
            blocks, ids, of = partition_with_ids(
                state, self.cfg, self.D, self.n_max
            )
            if bool(of):
                raise RuntimeError(
                    f"slab occupancy exceeded n_max={self.n_max}; raise n_max"
                )
            self.repartitions += 1
            stats = MigratingStepStats(
                newton_iters=pstats.newton_iters,
                cg_iters=pstats.cg_iters,
                cn_residual=pstats.cn_residual,
                converged=pstats.converged,
                migrate_overflow=jnp.zeros((), bool),
                grid_overflow=pstats.grid_overflow,
            )
        self.blocks, self.ids = blocks, ids
        self.t += float(dt)
        return stats

    @property
    def state(self) -> ParticleState:
        """Flat particle state in ORIGINAL particle order (IO/comparison)."""
        return gather_with_ids(self.blocks, self.ids, self.n)

    def compute_dt(self) -> float:
        """CFL-rate dt over the global particle set (mirrors
        Simulation.compute_dt; pad slots have zero velocity)."""
        cfg = self.cfg
        vmax = float(jnp.max(jnp.linalg.norm(
            self.blocks.v.reshape(-1, cfg.dim), axis=-1)))
        g = float(jnp.linalg.norm(jnp.asarray(cfg.gravity[: cfg.dim])))
        vmax = vmax + g * cfg.max_dt
        dt_cfl = cfg.cfl * cfg.dx / max(vmax, 1e-6)
        return float(min(cfg.max_dt, max(cfg.min_dt, dt_cfl)))

    def advance_frame(self) -> None:
        """Advance one output frame of duration cfg.frame_dt."""
        t_end = self.t + self.cfg.frame_dt
        while self.t < t_end - 1e-12:
            dt = min(self.compute_dt(), t_end - self.t)
            self.step(dt)
            self.step_count += 1

    def save_checkpoint(self, dirpath: str) -> None:
        save_sharded_checkpoint(
            dirpath, self.blocks, self.ids, self.t, self.step_count,
            self.mesh, axis=self.axis,
        )

    def restore(self, dirpath: str) -> None:
        """Restore blocks/ids/t from a sharded checkpoint directory
        (written for the same mesh shape and n_max)."""
        blocks, ids, t, step_count = load_sharded_checkpoint(
            dirpath, self.mesh, axis=self.axis
        )
        assert ids.shape == self.ids.shape, (ids.shape, self.ids.shape)
        self.blocks, self.ids = blocks, ids
        self.t, self.step_count = t, step_count


# ---------------------------------------------------------------------------
# multi-host checkpoint/restore (SURVEY.md §5.4; VERDICT r2 #8)
# ---------------------------------------------------------------------------
#
# Layout contract (parallel.distributed.checkpoint_spec): each process
# saves exactly the (D, n_max) block rows of its LOCAL devices to its own
# shard_pXXXX.npz — no cross-host gathers. Restore reads every shard file,
# reassembles the (D, n_max) arrays, and device_puts them into the mesh
# sharding. Grid state is derived, exactly as the reference's
# writeState/readState dumps only particle attributes (components #4/#22).


def save_sharded_checkpoint(dirpath: str, blocks: ParticleState, ids,
                            t: float, step_count: int, mesh: Mesh,
                            axis: str = "x") -> None:
    import dataclasses
    import os

    import numpy as np

    from hot_mpm.parallel.distributed import checkpoint_spec

    rows, n_rows = checkpoint_spec(mesh, axis)
    os.makedirs(dirpath, exist_ok=True)

    def local_rows(arr):
        # fetch only this process's block rows via addressable shards
        # (np.asarray of the whole array would fail multi-host)
        got = {}
        for sh in arr.addressable_shards:
            r0 = sh.index[0].start or 0
            data = np.asarray(sh.data)
            for i in range(data.shape[0]):
                got[r0 + i] = data[i]
        return np.stack([got[r] for r in rows])

    payload = {
        f.name: local_rows(getattr(blocks, f.name))
        for f in dataclasses.fields(blocks)
    }
    payload["__ids"] = local_rows(ids)
    np.savez_compressed(
        os.path.join(dirpath, f"shard_p{jax.process_index():04d}.npz"),
        __rows=np.asarray(rows, np.int64), __n_rows=n_rows,
        __t=t, __step_count=step_count, **payload,
    )


def load_sharded_checkpoint(dirpath: str, mesh: Mesh, axis: str = "x"):
    """Reassemble (blocks, ids, t, step_count) from every process's shard
    file and place them into the mesh sharding. All shard files must be
    visible to every process (shared filesystem, the standard multi-host
    checkpoint arrangement)."""
    import dataclasses
    import glob
    import os

    import numpy as np
    from jax.sharding import NamedSharding

    files = sorted(glob.glob(os.path.join(dirpath, "shard_p*.npz")))
    assert files, f"no shard files in {dirpath}"
    field_names = [f.name for f in dataclasses.fields(ParticleState)]
    full = {name: {} for name in field_names + ["__ids"]}
    t = step_count = n_rows = None
    for path in files:
        data = np.load(path)
        rows = data["__rows"]
        n_rows = int(data["__n_rows"])
        t, step_count = float(data["__t"]), int(data["__step_count"])
        for name in field_names + ["__ids"]:
            arr = data[name]
            for i, r in enumerate(rows):
                full[name][int(r)] = arr[i]
    assert all(len(v) == n_rows for v in full.values()), (
        f"missing shard rows: have {[len(v) for v in full.values()]} of {n_rows}"
    )

    def assemble(name):
        return np.stack([full[name][r] for r in range(n_rows)])

    sharding = NamedSharding(mesh, P(axis))
    blocks = ParticleState(**{
        name: jax.device_put(jnp.asarray(assemble(name)), sharding)
        for name in field_names
    })
    ids = jax.device_put(jnp.asarray(assemble("__ids")), sharding)
    return blocks, ids, t, step_count
