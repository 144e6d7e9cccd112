"""Sharded node-embedding multigrid: slab-partitioned levels with halo
collectives + an agglomerated dense-Cholesky coarsest solve.

Reference equivalents: HOT's MG hierarchy and V-cycle (components #35/#36,
SURVEY.md §3.4) — which are shared-memory only. This module is the
distributed design SURVEY.md §5.7/§5.8 prescribes:

  * fine levels: neighbor-only halo exchange (ppermute) around every
    level's scatter/gather — the same slab decomposition as the sharded
    step, at 2^l coarser spacing (slab planes halve per level);
  * coarsest level: latency-bound, so it is AGGLOMERATED — the dense
    BC-projected operator is assembled from each device's local particle
    quadrature and psum'd; every device factors the (small) matrix and
    solves the replicated system, paying one all_gather of the coarse
    residual instead of O(iters) neighbor hops ("coarse levels
    agglomerated to avoid latency domination").

All functions here run INSIDE shard_map (they use axis_name collectives).
Level topology is static given (res, D, levels): slab planes per level
must stay divisible by D and >= halo width for distributed levels — pick
`levels` accordingly (asserted at build).

Verified identical (iteration counts + trajectories) to the single-device
MG-preconditioned step in tests/test_sharded_step.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hot_mpm.ops import transfer
from hot_mpm.ops.bspline import quadratic_bspline_weights, stencil_offsets, tensor_weights
from hot_mpm.parallel.halo import exchange_halo, fold_halo
from hot_mpm.sim import objective as obj_mod
from hot_mpm.solver import multigrid as mg_mod
from hot_mpm.utils.config import MultigridConfig

HALO = 2


class SMGLevel(NamedTuple):
    st: transfer.Stencil    # local particles -> EXTENDED-slab node ids
    gids: jax.Array         # (n, 3^dim) GLOBAL flat node ids (coarse solve)
    grid_m: jax.Array       # (local_nodes,)
    active: jax.Array
    free: jax.Array
    planes: int             # owned x-planes on this device (static)
    plane_nodes: int        # nodes per plane (static)
    res: Tuple[int, ...]    # global level resolution (static)
    dx: float
    # assembled-operator extras (None unless mg_tile_caps requested them):
    # LOCAL tile grid + symbolic BSR over the EXTENDED slab (this device's
    # partial operator A_d; A = sum_d A_d by quadrature additivity, so the
    # distributed SpMV is exchange -> local supertile SpMV -> fold)
    tgrid: object = None
    mat_sym: object = None
    nbr: object = None
    bins: object = None     # CellBins of local particles in the ext slab
    # halo width of this level's extended slab (static). 2 for quadrature
    # levels; 3 for Galerkin coarse levels — the embedding of a fine halo
    # row reaches ceil((H_f+1)/2)+2 - planes... concretely one plane beyond
    # a 2-halo, and a 3-halo is the fixed point of the recursion.
    halo: int = HALO
    # unfolded mass scatter over the EXTENDED slab (level 0, assembled
    # mode): lets build_precond put inertia INSIDE the partial operator so
    # Galerkin coarse ops inherit P^T M P (sum over devices is exact by
    # particle additivity)
    ext_mass: object = None


class SMGStatic(NamedTuple):
    levels: Tuple[SMGLevel, ...]
    embeds: Tuple[transfer.Stencil, ...]  # owned level-l nodes -> level-(l+1)
                                          # extended-slab ids
    # OR of per-level bin/tile-grid overflow flags on THIS device (None when
    # nothing capacity-bounded was built); callers must psum/any across the
    # mesh before acting on it. Undersized mg_bin_caps would silently drop
    # real particles' Hessian blocks from the distributed operator — this
    # flag is what lets the host regrow instead.
    overflow: object = None


class SMGPrecond(NamedTuple):
    diag_inv: Tuple[jax.Array, ...]
    lmax: Tuple[jax.Array, ...]
    ctx: object
    coarse_chol: object = None
    # assembled mode: per-level LOCAL BSR partial operators (tile-row order
    # over the extended slab), rebuilt once per Newton iteration
    mats: Tuple[object, ...] = ()


def _rest_strides(res):
    strides = []
    s = 1
    for r in reversed(res[1:]):
        strides.append(s)
        s *= int(r)
    return strides[::-1]


def _local_stencil(x, dev, dx_l, res_l, planes_l, dtype, halo: int = HALO):
    """Particle stencil with ids into this device's EXTENDED slab at level
    spacing dx_l (mirrors sharded_step's finest-level stencil)."""
    dim = x.shape[-1]
    plane_nodes = 1
    for r in res_l[1:]:
        plane_nodes *= int(r)
    base, w, dw = quadratic_bspline_weights(x, dx_l)
    wn, gwn = tensor_weights(w, dw)
    offs = stencil_offsets(dim)
    res_arr = jnp.asarray(res_l, jnp.int32)
    coords = jnp.clip(base[:, None, :] + offs[None], 0, res_arr - 1)
    lplane = coords[..., 0] - dev * planes_l + halo
    rest = jnp.zeros(coords.shape[:-1], jnp.int32)
    strides = _rest_strides(res_l)
    for k in range(dim - 1):
        rest = rest + coords[..., k + 1] * strides[k]
    lids = jnp.clip(lplane, 0, planes_l + 2 * halo - 1) * plane_nodes + rest
    gids = coords[..., 0] * plane_nodes + rest               # GLOBAL flat ids
    rel = coords.astype(dtype) * dx_l - x[:, None, :]
    return (transfer.Stencil(node_ids=lids, wn=wn, gwn=gwn, rel=rel),
            gids, plane_nodes)


def make_level_ops(level: SMGLevel, axis: str, D: int):
    """(scatter, gather_st) closures with halo fold/exchange for this level
    — drop-ins for obj_mod.elastic_hessian_apply / elastic_block_diag."""
    planes, plane_nodes = level.planes, level.plane_nodes
    halo = level.halo
    ext_nodes = (planes + 2 * halo) * plane_nodes
    local_nodes = planes * plane_nodes

    def scatter(st, values, _n_nodes):
        ext = transfer.scatter_sum(st.node_ids, values, ext_nodes)
        extp = ext.reshape((planes + 2 * halo, plane_nodes) + ext.shape[1:])
        return fold_halo(extp, axis, D, halo).reshape(
            (local_nodes,) + ext.shape[1:]
        )

    def gather_st(st, v_local):
        vp = v_local.reshape((planes, plane_nodes) + v_local.shape[1:])
        ext = exchange_halo(vp, axis, D, halo)
        return ext.reshape((ext_nodes,) + v_local.shape[1:])[st.node_ids]

    return scatter, gather_st


def build_static(ps_x, ps_m, dev, res, dx, n_levels: int, constrained0,
                 axis: str, D: int, dtype, mg_tile_caps=None,
                 mg_bin_caps=None, galerkin: bool = False) -> SMGStatic:
    """Per-step hierarchy from this device's (padded) local particles.

    constrained0: (local_nodes_0,) bool — finest-level Dirichlet mask.
    Padding particles carry m == 0 so they never activate nodes.

    mg_tile_caps: per-level static tile capacities — requests ASSEMBLED
    levels: each level gets a LOCAL tile grid + symbolic tile-row BSR over
    its EXTENDED slab, so build_precond can assemble this device's partial
    operator A_d once per Newton iteration and smoothers run on the
    supertile SpMV (exchange -> local SpMV -> fold; A = sum_d A_d).
    mg_bin_caps: per-level (cells_cap, cap) CellBins capacities for the
    scatter-free binned assembly (None entries fall back to the colliding-
    scatter assembly).

    galerkin (assembled mode): coarse operators will come from the
    structured SpGEMM RAP of the finest partial (build_precond), so coarse
    levels get NO tile grid/bins and a WIDER (3-plane) halo — the
    embedding of a fine halo row reaches one plane beyond a 2-halo, and 3
    is the fixed point of the recursion. Level 0 additionally records its
    UNFOLDED extended-slab mass so inertia can live INSIDE the partial
    operator (P^T M P then distributes over devices exactly).
    """
    if mg_tile_caps is not None:
        from hot_mpm.grid import sparse as sparse_mod
        from hot_mpm.ops import bsr_tiled

    levels = []
    embeds = []
    track_overflow = mg_tile_caps is not None or mg_bin_caps is not None
    overflow = jnp.zeros((), bool) if track_overflow else None
    real = ps_m > 0   # padding slots carry m == 0 and sit at the slab
                      # center — keep them out of bins/caps entirely
    cur_res = tuple(res)
    cur_dx = dx
    cons = constrained0
    for l in range(n_levels):
        halo_l = 3 if (galerkin and l > 0) else HALO
        planes_l = cur_res[0] // D
        assert cur_res[0] % D == 0 and planes_l >= halo_l, (
            f"level {l}: res_x={cur_res[0]} not slab-divisible over {D} "
            f"devices with halo {halo_l}; lower cfg.solver.multigrid.levels"
        )
        st, gids, plane_nodes = _local_stencil(
            ps_x, dev, cur_dx, cur_res, planes_l, dtype, halo=halo_l
        )
        tg_l = mat_l = nbr_l = bins_l = ext_mass_l = None
        if mg_tile_caps is not None and not (galerkin and l > 0):
            # local frame: shift x so the extended slab starts at plane 0
            # (an integer-cell shift — B-spline weights are unchanged, and
            # the shifted base coords match st's extended-slab ids)
            shift = jnp.zeros((len(cur_res),), dtype).at[0].set(
                (dev * planes_l - halo_l) * cur_dx
            )
            x_local = ps_x - shift[None, :]
            res_ext = (planes_l + 2 * halo_l,) + tuple(cur_res[1:])
            tg_l = sparse_mod.build_tile_grid(
                x_local, cur_dx, res_ext, int(mg_tile_caps[l])
            )
            mat_l = bsr_tiled.structure_tiled(tg_l)
            nbr_l = bsr_tiled.tile_neighbors(tg_l)
            overflow = jnp.logical_or(overflow, tg_l.overflow)
            if mg_bin_caps is not None and mg_bin_caps[l] is not None:
                cells_cap, cap = mg_bin_caps[l]
                bins_l = transfer.bin_particles(
                    x_local, cur_dx, res_ext, int(cells_cap), int(cap),
                    valid=real,
                )
                overflow = jnp.logical_or(overflow, bins_l.overflow)
            if galerkin and l == 0:
                ext_nodes_l = (planes_l + 2 * halo_l) * plane_nodes
                ext_mass_l = transfer.scatter_sum(
                    st.node_ids, st.wn * ps_m[:, None], ext_nodes_l
                )
        lvl = SMGLevel(st=st, gids=gids, grid_m=None, active=None, free=None,
                       planes=planes_l, plane_nodes=plane_nodes,
                       res=cur_res, dx=cur_dx, tgrid=tg_l, mat_sym=mat_l,
                       nbr=nbr_l, bins=bins_l, halo=halo_l,
                       ext_mass=ext_mass_l)
        scatter, _ = make_level_ops(lvl, axis, D)
        grid_m = scatter(st, st.wn * ps_m[:, None], 0)
        active = grid_m > 0
        free = jnp.logical_and(active, jnp.logical_not(cons))
        lvl = lvl._replace(grid_m=grid_m, active=active, free=free)
        levels.append(lvl)
        if l == n_levels - 1:
            break
        # embedding: OWNED level-l nodes as particles of level l+1
        nxt_res = mg_mod.coarse_res(cur_res)
        nxt_dx = cur_dx * 2.0
        planes_n = nxt_res[0] // D
        halo_n = 3 if galerkin else HALO
        node_pos = _owned_positions(dev, planes_l, cur_res, cur_dx, dtype)
        embed, _, pn_n = _local_stencil(node_pos, dev, nxt_dx, nxt_res,
                                        planes_n, dtype, halo=halo_n)
        # inactive fine nodes must not pollute coarse sums
        embed = embed._replace(wn=jnp.where(active[:, None], embed.wn, 0.0))
        embeds.append(embed)
        # propagate the constraint mask (same rule as single-device MG)
        nxt_lvl = SMGLevel(st=None, gids=None, grid_m=None, active=None,
                           free=None, planes=planes_n, plane_nodes=pn_n,
                           res=nxt_res, dx=nxt_dx, halo=halo_n)
        c_scatter, _ = make_level_ops(nxt_lvl, axis, D)
        w_total = c_scatter(embed, embed.wn, 0)
        w_cons = c_scatter(
            embed, embed.wn * cons[:, None].astype(embed.wn.dtype), 0
        )
        cons = w_cons > 0.25 * jnp.maximum(w_total, 1e-30)
        cur_res, cur_dx = nxt_res, nxt_dx
    return SMGStatic(levels=tuple(levels), embeds=tuple(embeds),
                     overflow=overflow)


def _owned_positions(dev, planes, res, dx_l, dtype):
    dim = len(res)
    plane_nodes = 1
    for r in res[1:]:
        plane_nodes *= int(r)
    p_idx = jax.lax.broadcasted_iota(jnp.int32, (planes, plane_nodes), 0)
    r_idx = jax.lax.broadcasted_iota(jnp.int32, (planes, plane_nodes), 1)
    coords = [dev * planes + p_idx]
    strides = _rest_strides(res)
    rem = r_idx
    for k in range(dim - 1):
        coords.append(rem // strides[k])
        rem = rem - (rem // strides[k]) * strides[k]
    return jnp.stack(
        [c.reshape(-1).astype(dtype) * dx_l for c in coords], axis=-1
    )


def level_multiply(level: SMGLevel, F, ctx, V0, dt, w, axis: str, D: int):
    scatter, gather_st = make_level_ops(level, axis, D)
    return obj_mod.elastic_hessian_apply(
        level.st, F, ctx, V0, dt, level.grid_m, level.active, w,
        scatter=scatter, gather_st=gather_st,
    )


def level_project(level: SMGLevel, r):
    return jnp.where(level.free[:, None], r, 0.0)


def _bapply(B, v):
    return jnp.einsum("nij,nj->ni", B, v)


def make_mul(level: SMGLevel, mat, F, ctx, V0, dt, axis: str, D: int,
             mass_outside: bool = True):
    """A w on OWNED dense level vectors. Assembled levels (mat != None) run
    exchange -> local SpMV on the extended slab -> fold; the local matrix
    is this device's PARTIAL operator A_d (halo rows hold partial sums that
    fold ships to their owners — the same adjoint pair the matrix-free
    scatter/gather uses, so the distributed operator is identical; equality
    is tested). The SpMV is the supertile kernel for half=2 tile-row
    quadrature matrices, the generic gather SpMV for Galerkin RAP outputs
    (7/9-wide flat-row structure).

    mass_outside=True (quadrature partials, dt^2 K_d only): the inertia
    diagonal M is applied from the (halo-folded, complete) owned grid
    masses — a node supported only by the NEIGHBOR device's particles has
    no tile in this device's local grid, so putting mass inside A_d would
    silently drop it. Galerkin mode instead assembles mass INTO the level-0
    partial from the UNFOLDED extended-slab mass (particle additivity makes
    sum_d exact) so coarse RAP operators inherit P^T M P; those callers
    pass mass_outside=False."""
    if mat is None:
        def mul(w):
            return level_multiply(level, F, ctx, V0, dt, w, axis, D)

        return mul

    from hot_mpm.ops import bsr as bsr_mod

    planes, plane_nodes = level.planes, level.plane_nodes
    halo = level.halo
    ext_nodes = (planes + 2 * halo) * plane_nodes
    d = F.shape[-1]

    if mat.half == 2 and level.tgrid is not None and mat.tile_layout:
        from hot_mpm.ops import bsr_tiled

        # reduce='flat': the einsum form's R5 intermediate OOMs the
        # compile of large MG programs (see spmv_tiled docstring).
        # tile_rows guard: a rap_max_half-truncated half-2 RAP mat is in
        # compressed-row order — the supertile kernel would read the
        # wrong rows (see solver.multigrid._rows_mul)
        rows_mul = lambda r: bsr_tiled.spmv_tiled(mat, level.tgrid,
                                                  level.nbr, r,
                                                  reduce="flat")
    else:
        rows_mul = lambda r: bsr_mod.spmv(mat, r)

    def mul(w):
        vp = w.reshape(planes, plane_nodes, d)
        ext = exchange_halo(vp, axis, D, halo).reshape(ext_nodes, d)
        w_rows = bsr_mod.grid_vector_to_rows(mat, ext)
        y_rows = rows_mul(w_rows)
        y_ext = bsr_mod.rows_to_grid_vector(mat, y_rows, ext_nodes)
        y = fold_halo(
            y_ext.reshape(planes + 2 * halo, plane_nodes, d), axis, D, halo
        ).reshape(planes * plane_nodes, d)
        if mass_outside:
            y = y + level.grid_m[:, None] * w
        return jnp.where(level.active[:, None], y, w)

    return mul


def _assemble_level(level: SMGLevel, F, ctx, V0, dt, mass=None):
    """This device's partial BSR operator over the extended slab.

    mass=None: dt^2 K_d only (inertia applied outside — see make_mul).
    mass=array: UNFOLDED extended-slab mass added on the diagonal, making
    the partial sum_d A_d = M + dt^2 K exact (galerkin mode)."""
    from hot_mpm.ops import bsr as bsr_mod

    if mass is None:
        mass = jnp.zeros(
            ((level.planes + 2 * level.halo) * level.plane_nodes,), F.dtype
        )
    if level.bins is not None:
        return bsr_mod.assemble_hessian_modes(
            level.mat_sym, level.bins, level.st, F, ctx, V0, dt, mass
        )
    return bsr_mod.assemble_hessian(
        level.mat_sym, level.st, F, ctx, V0, dt, mass
    )


def _diag_from_mat(level: SMGLevel, mat, dim: int, axis: str, D: int,
                   mass_outside: bool = True):
    """Full (d, d) diagonal blocks on owned nodes: fold the partial center
    blocks (neighbors' halo partials add in) + inertia (unless the partial
    already carries it — galerkin mode)."""
    from hot_mpm.ops import bsr as bsr_mod

    planes, plane_nodes = level.planes, level.plane_nodes
    halo = level.halo
    ext_nodes = (planes + 2 * halo) * plane_nodes
    dd = dim * dim
    center = (mat.K - 1) // 2
    cb = mat.vals[:, center * dd:(center + 1) * dd]     # flat k-major slice
    cb_ext = bsr_mod.rows_to_grid_vector(mat, cb, ext_nodes)
    Dm = fold_halo(
        cb_ext.reshape(planes + 2 * halo, plane_nodes, dim * dim),
        axis, D, halo,
    ).reshape(planes * plane_nodes, dim, dim)
    eye = jnp.eye(dim, dtype=Dm.dtype)
    if mass_outside:
        Dm = Dm + level.grid_m[:, None, None] * eye[None]
    return jnp.where(level.free[:, None, None], Dm, eye[None])


def _rap_level(prev_level: SMGLevel, prev_mat, level: SMGLevel, dev,
               dim: int):
    """Galerkin coarse partial A_c,d = P^T A_d P over the local extended
    slabs, via the structured SpGEMM with global-frame origins (the
    embedding relation holds in GLOBAL coordinates). Rows cover the whole
    coarse extended slab (static; coarse levels are small) — with a 3-plane
    coarse halo every nonzero partial (row, col) pair is representable, so
    sum_d A_c,d == P^T (sum_d A_d) P exactly."""
    from hot_mpm.ops import spgemm

    res_ext_c = (level.planes + 2 * level.halo,) + tuple(level.res[1:])
    n_ext_c = 1
    for r in res_ext_c:
        n_ext_c *= int(r)
    f_org = jnp.zeros((dim,), jnp.int32).at[0].set(
        dev * prev_level.planes - prev_level.halo
    )
    c_org = jnp.zeros((dim,), jnp.int32).at[0].set(
        dev * level.planes - level.halo
    )
    active_all = jnp.ones((n_ext_c,), bool)
    return spgemm.rap(prev_mat, res_ext_c, active_all, n_ext_c,
                      fine_origin=f_org, coarse_origin=c_org)


def build_precond(smg: SMGStatic, F, ctx, V0, dt, cfg: MultigridConfig,
                  dim: int, axis: str, D: int) -> SMGPrecond:
    """Per-Newton smoother data; lambda_max power iterations psum across the
    mesh so every device holds the identical bound. Assembled levels also
    build this device's partial BSR here — once per Newton iteration,
    amortized over every smoother/residual SpMV. cfg.coarsening='galerkin'
    derives coarse partials by local RAP of the level-0 partial (VERDICT r1
    #5: the rediscretized hierarchy can amplify residuals under
    deformation; the Galerkin one is correction-consistent)."""
    diag_inv = []
    lmax = []
    mats = []
    any_assembled = any(lv.mat_sym is not None for lv in smg.levels)
    galerkin = cfg.coarsening == "galerkin" and any_assembled
    mass_outside = not galerkin
    dev = jax.lax.axis_index(axis)
    prev_mat = None
    prev_level = None
    for l, level in enumerate(smg.levels):
        if galerkin and l > 0:
            mat = _rap_level(prev_level, prev_mat, level, dev, dim)
            mats.append(mat)
            Db = _diag_from_mat(level, mat, dim, axis, D,
                                mass_outside=mass_outside)
        elif level.mat_sym is not None:
            mat = _assemble_level(level, F, ctx, V0, dt,
                                  mass=level.ext_mass if galerkin else None)
            mats.append(mat)
            Db = _diag_from_mat(level, mat, dim, axis, D,
                                mass_outside=mass_outside)
        else:
            mat = None
            mats.append(None)
            scatter, _ = make_level_ops(level, axis, D)
            Db = obj_mod.elastic_block_diag(
                level.st, F, ctx, V0, dt, level.grid_m, level.active, dim,
                scatter=scatter,
            )
        Dinv = obj_mod.sym_block_inv(Db)
        diag_inv.append(Dinv)
        need = cfg.smoother == "chebyshev" and (
            l < len(smg.levels) - 1 or cfg.coarse_solver == "smoother"
        )
        if need:
            mul = make_mul(level, mat, F, ctx, V0, dt, axis, D,
                           mass_outside=mass_outside or mat is None)
            lam = _power_lmax(level, mul, Dinv, cfg.power_iters, axis)
        else:
            lam = jnp.ones((), F.dtype)
        lmax.append(lam)
        prev_mat = mat
        prev_level = level
    chol = None
    if cfg.coarse_solver == "direct":
        if galerkin and mats[-1] is not None:
            chol = _coarse_factor_from_mat(smg.levels[-1], mats[-1], dim,
                                           axis, dev,
                                           capacity=cfg.coarse_capacity)
        else:
            chol = _coarse_dense_factor(smg.levels[-1], F, ctx, V0, dt, dim,
                                        axis, D,
                                        capacity=cfg.coarse_capacity)
    return SMGPrecond(diag_inv=tuple(diag_inv), lmax=tuple(lmax), ctx=ctx,
                      coarse_chol=chol,
                      mats=tuple(mats) if any_assembled else ())


def _power_lmax(level, mul, Dinv, iters, axis):
    def dinva(v):
        v = level_project(level, v)
        return level_project(level, _bapply(Dinv, mul(v)))

    def gnorm(v):
        return jnp.sqrt(jax.lax.psum(jnp.sum(v * v), axis))

    d = Dinv.shape[-1]
    dtype = Dinv.dtype
    v = level.free[:, None].astype(dtype) * jnp.ones((1, d), dtype)
    v = v / jnp.maximum(gnorm(v), 1e-30)

    def body(_, carry):
        v, lam = carry
        Av = dinva(v)
        na, nv = gnorm(Av), gnorm(v)
        lam = na / jnp.maximum(nv, 1e-30)
        return (Av / jnp.maximum(na, 1e-30), lam)

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.ones((), dtype)))
    return jnp.maximum(lam, 1e-12)


# ---------------------------------------------------------------------------
# agglomerated coarsest-level direct solve
# ---------------------------------------------------------------------------


def _coarse_dense_factor(level: SMGLevel, F, ctx, V0, dt, dim, axis, D,
                         capacity=None):
    """Dense BC-projected coarsest operator: local quadrature contributions
    with GLOBAL node ids, psum'd across the mesh, factored replicated.

    capacity: static ACTIVE-row cap — the factor costs (capacity*d)^2
    instead of (n_nodes*d)^2 (the full 32^3-coarsest factor is 38 GB;
    the single-device fix of round 1, applied to the agglomerated path).
    None = all nodes (only for tiny coarse grids).

    The coarsest grid must be small (choose `levels` so n_nodes(res_L) is a
    few thousand at most — HOT's own guidance for its LDLT coarse solve)."""
    from hot_mpm.ops import bsr as bsr_mod

    res = level.res
    n_nodes = transfer.n_nodes_of(res)
    gids = level.gids                    # (n, 3^dim) GLOBAL flat node ids

    def per_particle(gwn_p, F_p, ctx_p, V0_p):
        g = gwn_p @ F_p
        eye = jnp.eye(dim, dtype=F_p.dtype)

        def dP_for(gk):
            def col(a):
                from hot_mpm.models import constitutive as cm

                return cm.apply_hessian(ctx_p, dt * jnp.outer(eye[a], gk))

            return jnp.stack([col(a) for a in range(dim)])

        dPs = jax.vmap(dP_for)(g)
        return dt * V0_p * jnp.einsum("iabc,jc->jiba", dPs, g)   # (s_j, s_i, d, d)

    blocks = jax.vmap(per_particle)(level.st.gwn, F, ctx, V0)
    gm = jax.lax.all_gather(
        level.grid_m.reshape(level.planes, level.plane_nodes), axis, tiled=True
    ).reshape(-1)
    free = jax.lax.all_gather(
        level.free.reshape(level.planes, level.plane_nodes), axis, tiled=True
    ).reshape(-1)
    cap = int(capacity) if capacity else n_nodes
    node_of_c, row_of_c = bsr_mod.active_rows(gm > 0, cap)
    r_j = row_of_c[jnp.clip(gids, 0, n_nodes - 1)]               # (n, s)
    ok_g = (gids >= 0) & (gids < n_nodes) & (r_j >= 0)
    rows = jnp.where(ok_g, r_j, cap)[:, :, None]                 # (n, s_j, 1)
    cols = jnp.where(ok_g, r_j, cap)[:, None, :]                 # (n, 1, s_i)
    flat = jnp.minimum(rows * (cap + 1) + cols, cap * (cap + 1) + cap)
    A = jnp.zeros(((cap + 1) * (cap + 1), dim * dim), blocks.dtype)
    A = A.at[flat.reshape(-1)].add(blocks.reshape(-1, dim * dim))
    A = A.reshape(cap + 1, cap + 1, dim, dim)[:cap, :cap]
    A = jax.lax.psum(A, axis)                                    # agglomerate
    # inertia on the diagonal (global masses) + BC/inactive projection
    valid_r = node_of_c < n_nodes
    safe = jnp.minimum(node_of_c, n_nodes - 1)
    gm_rows = jnp.where(valid_r, gm[safe], 0.0)
    free_rows = jnp.where(valid_r, free[safe], False)
    eye = jnp.eye(dim, dtype=A.dtype)
    idx = jnp.arange(cap)
    A = A.at[idx, idx].add(gm_rows[:, None, None] * eye[None])
    ok = free_rows[:, None] & free_rows[None, :]
    A = jnp.where(ok[:, :, None, None], A, 0.0)
    A = A.transpose(0, 2, 1, 3).reshape(cap * dim, cap * dim)
    diag_fix = jnp.repeat(~free_rows, dim).astype(A.dtype)
    A = A + jnp.diag(diag_fix)
    eps = jnp.asarray(1e-8, A.dtype) * jnp.maximum(jnp.max(jnp.diag(A)), 1.0)
    A = A + eps * jnp.eye(A.shape[0], dtype=A.dtype)
    # factor array only (see solver.multigrid._coarse_dense_factor)
    c, _ = jax.scipy.linalg.cho_factor(A)
    return (c, node_of_c)


def _coarse_factor_from_mat(level: SMGLevel, mat, dim: int, axis: str,
                            dev, capacity=None):
    """Galerkin agglomerated coarsest factor: densify this device's partial
    RAP operator at GLOBAL coarse node ids, psum across the mesh, project
    BCs, factor replicated. mat carries inertia inside (galerkin mode), so
    no mass term is added here. capacity: static ACTIVE-row cap — see
    _coarse_dense_factor (the full-grid factor is 38 GB at a 32^3
    coarsest); None = all nodes."""
    from hot_mpm.ops import bsr as bsr_mod

    res = level.res
    n_nodes = transfer.n_nodes_of(res)
    planes, plane_nodes, halo = level.planes, level.plane_nodes, level.halo
    ne = (planes + 2 * halo) * plane_nodes
    res_ext = (planes + 2 * halo,) + tuple(res[1:])
    node_of = mat.node_of
    coords_l = transfer.unravel(jnp.minimum(node_of, ne - 1), res_ext)
    origin = jnp.zeros((dim,), jnp.int32).at[0].set(dev * planes - halo)
    coords_g = coords_l + origin[None, :]
    res_arr = jnp.asarray(res, jnp.int32)
    valid_r = (node_of < ne) & jnp.all(
        (coords_g >= 0) & (coords_g < res_arr[None, :]), axis=-1
    )
    strides_py = []
    acc = 1
    for r in reversed(res):
        strides_py.append(acc)
        acc *= int(r)
    strides = jnp.asarray(strides_py[::-1], jnp.int32)
    g_row = jnp.sum(jnp.clip(coords_g, 0, res_arr - 1) * strides[None, :],
                    axis=-1)
    offs = bsr_mod._offsets(dim, mat.half)
    ncoords = coords_g[:, None, :] + offs[None, :, :]
    ok_c = jnp.all((ncoords >= 0) & (ncoords < res_arr[None, None, :]),
                   axis=-1)
    g_col = jnp.sum(jnp.clip(ncoords, 0, res_arr - 1) * strides[None, None, :],
                    axis=-1)
    ok = valid_r[:, None] & ok_c & (mat.col_row >= 0)
    dd = dim * dim

    gm = jax.lax.all_gather(
        level.grid_m.reshape(level.planes, level.plane_nodes), axis, tiled=True
    ).reshape(-1)
    free = jax.lax.all_gather(
        level.free.reshape(level.planes, level.plane_nodes), axis, tiled=True
    ).reshape(-1)
    cap = int(capacity) if capacity else n_nodes
    node_of_c, row_of_c = bsr_mod.active_rows(gm > 0, cap)
    r_row = row_of_c[jnp.clip(g_row, 0, n_nodes - 1)]
    r_col = row_of_c[jnp.clip(g_col, 0, n_nodes - 1)]
    ok = ok & (r_row >= 0)[:, None] & (r_col >= 0)
    rr = jnp.where(ok, r_row[:, None], cap)
    cc = jnp.where(ok, r_col, cap)
    flat = jnp.minimum(rr * (cap + 1) + cc, cap * (cap + 1) + cap)
    vals = jnp.where(ok[:, :, None], mat.vals.reshape(-1, mat.K, dd), 0.0)
    # (split reshape from the flat storage — the layout-safe direction)
    A = jnp.zeros(((cap + 1) * (cap + 1), dd), vals.dtype)
    A = A.at[flat.reshape(-1)].add(vals.reshape(-1, dd))
    A = A.reshape(cap + 1, cap + 1, dim, dim)[:cap, :cap]
    A = jax.lax.psum(A, axis)                               # agglomerate
    valid_rows = node_of_c < n_nodes
    free_rows = jnp.where(valid_rows,
                          free[jnp.minimum(node_of_c, n_nodes - 1)], False)
    okf = free_rows[:, None] & free_rows[None, :]
    A = jnp.where(okf[:, :, None, None], A, 0.0)
    A = A.transpose(0, 2, 1, 3).reshape(cap * dim, cap * dim)
    diag_fix = jnp.repeat(~free_rows, dim).astype(A.dtype)
    A = A + jnp.diag(diag_fix)
    eps = jnp.asarray(1e-8, A.dtype) * jnp.maximum(jnp.max(jnp.diag(A)), 1.0)
    A = A + eps * jnp.eye(A.shape[0], dtype=A.dtype)
    c, _ = jax.scipy.linalg.cho_factor(A)
    return (c, node_of_c)


def _coarse_dense_solve(level: SMGLevel, chol_rows, b_local, axis: str):
    """all_gather the coarse rhs, replicated ACTIVE-ROW solve, slice the
    owned planes."""
    chol, node_of_c = chol_rows
    res = level.res
    n_nodes = transfer.n_nodes_of(res)
    d = b_local.shape[-1]
    b_nodes = jax.lax.all_gather(
        b_local.reshape(level.planes, level.plane_nodes, d), axis, tiled=True
    ).reshape(n_nodes, d)
    valid = node_of_c < n_nodes
    safe = jnp.minimum(node_of_c, n_nodes - 1)
    b_rows = jnp.where(valid[:, None], b_nodes[safe], 0.0)
    x_rows = jax.scipy.linalg.cho_solve(
        (chol, False), b_rows.reshape(-1)
    ).reshape(-1, d)
    x_nodes = jnp.zeros((n_nodes + 1, d), b_local.dtype)
    x_nodes = x_nodes.at[jnp.where(valid, node_of_c, n_nodes)].set(x_rows)[:n_nodes]
    x = x_nodes.reshape(-1)
    x = x.reshape(-1, level.plane_nodes, d)
    dev = jax.lax.axis_index(axis)
    x_local = jax.lax.dynamic_slice_in_dim(x, dev * level.planes, level.planes, 0)
    return x_local.reshape(level.planes * level.plane_nodes, d)


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------


def _mat_of(pre: SMGPrecond, l: int):
    return pre.mats[l] if pre.mats else None


def _smooth(level, mul, pre: SMGPrecond, l: int,
            cfg: MultigridConfig, b, x, iters: int):
    def proj(r):
        return level_project(level, r)

    if cfg.smoother == "chebyshev":
        return mg_mod.chebyshev_smooth(
            mul, proj, pre.diag_inv[l], pre.lmax[l], b, x,
            max(iters * cfg.chebyshev_order, 1),
            cfg.chebyshev_lo, cfg.chebyshev_hi,
        )
    return mg_mod.jacobi_smooth(mul, proj, pre.diag_inv[l], b, x, iters,
                                cfg.jacobi_omega)


def restrict(smg: SMGStatic, l: int, r_fine, axis: str, D: int):
    embed = smg.embeds[l]
    nxt = smg.levels[l + 1]
    scatter, _ = make_level_ops(nxt, axis, D)
    vals = embed.wn[:, :, None] * r_fine[:, None, :]
    return scatter(embed, vals, 0)


def prolong(smg: SMGStatic, l: int, e_coarse, axis: str, D: int):
    embed = smg.embeds[l]
    nxt = smg.levels[l + 1]
    _, gather_st = make_level_ops(nxt, axis, D)
    ec = gather_st(embed, e_coarse)
    return jnp.sum(embed.wn[:, :, None] * ec, axis=1)


def _mass_outside(pre: SMGPrecond, cfg: MultigridConfig) -> bool:
    return not (bool(pre.mats) and cfg.coarsening == "galerkin")


def v_cycle(smg: SMGStatic, pre: SMGPrecond, F, ctx, V0, dt,
            cfg: MultigridConfig, b, axis: str, D: int, l: int = 0):
    level = smg.levels[l]
    mul = make_mul(level, _mat_of(pre, l), F, ctx, V0, dt, axis, D,
                   mass_outside=_mass_outside(pre, cfg))
    x = jnp.zeros_like(b)
    if l == len(smg.levels) - 1:
        if cfg.coarse_solver == "direct":
            x = _coarse_dense_solve(level, pre.coarse_chol, b, axis)
            return level_project(level, x)
        if cfg.coarse_solver == "cg":
            from hot_mpm.solver.cg import cg_solve

            Dinv = pre.diag_inv[l]
            res = cg_solve(
                lambda w: level_project(level, mul(w)),
                b,
                precondition=lambda r: _bapply(Dinv, r),
                project=lambda r: level_project(level, r),
                tol=1e-2,
                max_iters=cfg.coarse_iters,
                axis_name=axis,
            )
            return res.x
        return _smooth(level, mul, pre, l, cfg, b, x, cfg.coarse_iters)
    x = _smooth(level, mul, pre, l, cfg, b, x, cfg.pre_smooth)
    r = level_project(level, b - mul(x))
    r_c = level_project(smg.levels[l + 1], restrict(smg, l, r, axis, D))
    e_c = v_cycle(smg, pre, F, ctx, V0, dt, cfg, r_c, axis, D, l + 1)
    x = x + level_project(level, prolong(smg, l, e_c, axis, D))
    x = _smooth(level, mul, pre, l, cfg, b, x, cfg.post_smooth)
    return x


def mg_precondition(smg: SMGStatic, pre: SMGPrecond, F, V0, dt,
                    cfg: MultigridConfig, r, axis: str, D: int):
    ctx = pre.ctx
    z = v_cycle(smg, pre, F, ctx, V0, dt, cfg, r, axis, D)
    for _ in range(cfg.cycles - 1):
        mul0 = make_mul(smg.levels[0], _mat_of(pre, 0), F, ctx, V0, dt,
                        axis, D, mass_outside=_mass_outside(pre, cfg))
        res = r - mul0(z)
        z = z + v_cycle(smg, pre, F, ctx, V0, dt, cfg,
                        level_project(smg.levels[0], res), axis, D)
    return z
