"""HOT's node-embedding geometric multigrid.

Reference equivalents: Projects/multigrid/* (components #35/#36,
SURVEY.md §3.4): coarse level L has spacing 2^L dx; fine nodes embed in the
coarse grid's B-spline stencils (prolongation = interpolation weights,
restriction = its transpose); coarse operators are built by particle
quadrature with stencils widened to the level spacing (HOT's primary
construction — equivalent in spirit to Galerkin RAP but reusing the
transfer kernels; SURVEY.md §7 hard part 3). Smoothers: Chebyshev over a
power-iteration lambda_max estimate, or damped block-Jacobi. One V-cycle
per PCG application.

Design notes:
  * Prolongation IS a G2P gather (fine nodes as particles of the coarse
    grid) and restriction IS the matching P2G scatter — the multigrid
    transfer kernels are literally hot_mpm.ops.transfer with different
    inputs. No sparse matrices needed for P/R.
  * Every level's operator is matrix-free through the shared
    elastic_hessian_apply; the per-particle dPdF context is built once per
    Newton iteration and reused by ALL levels.
  * The level list is a static Python tuple — the V-cycle recursion
    unrolls at trace time into one XLA program.

Hierarchy state splits in two:
  MGStatic  — per time step: stencils, masses, activity, BC per level.
  MGPrecond — per Newton iteration: block-diagonals + Chebyshev bounds.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hot_mpm.ops import transfer
from hot_mpm.sim import objective as obj_mod
from hot_mpm.utils.config import MultigridConfig


import dataclasses


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MGLevel:
    stencil: transfer.Stencil   # particle stencil at this level's spacing
    grid_m: jax.Array           # (n_nodes_l,) node mass (particle P2G at dx_l)
    active: jax.Array           # (n_nodes_l,) bool
    free: jax.Array             # (n_nodes_l,) bool — active and unconstrained
    # static metadata: stays Python across jit boundaries (a NamedTuple
    # would trace dx/res into arrays when a level crosses a jit boundary,
    # breaking every static slice downstream)
    dx: float = dataclasses.field(metadata=dict(static=True))
    res: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    bins: object = None         # CellBins for the binned transfer path
                                # (None on sparse tile grids)
    # assembled-operator extras (None unless mg_tile_caps requested them):
    # per-level tile grid + symbolic BSR structure + neighbor-slot table,
    # and the free mask in tile-row order (docs/KERNEL_PLAN.md supertile SpMV)
    tgrid: object = None
    mat_sym: object = None      # ops.bsr.BsrMatrix (tile-row order, zero vals)
    nbr: object = None          # (T_cap, 3^dim) neighbor tile slots
    free_rows: object = None    # (n_rows,) bool
    # COMPACT level: vectors live in tile-compacted node space (n_cnodes
    # incl. trailing dump row) of `tgrid`, and tile-row index == compacted
    # node id (sparse grid backend; component #25 composed with the MG)
    compact: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # composed-Galerkin data (ComposedLevel) on the first assembled level
    # of a matrix-free-finest hierarchy; None elsewhere
    comp: object = None

    def _replace(self, **kw) -> "MGLevel":
        return dataclasses.replace(self, **kw)

    @property
    def scatter(self):
        if self.bins is None:
            return transfer.default_scatter
        if self.compact:
            from hot_mpm.ops import tile_transfer

            return tile_transfer.make_tile_scatter(self.bins, self.tgrid,
                                                   self.nbr)
        return transfer.make_binned_scatter(self.bins, self.res)

    @property
    def gather_st(self):
        if self.bins is None:
            return transfer.default_gather_stencil
        if self.compact:
            from hot_mpm.ops import tile_transfer

            return tile_transfer.make_tile_gather(self.bins, self.tgrid,
                                                  self.nbr)
        return transfer.make_binned_gather(self.bins, self.res)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ComposedLevel:
    """Composed-stencil Galerkin data for the FIRST assembled level of a
    matrix-free-finest hierarchy (ops.composed): the level's operator is
    assembled as exact P^T A_0 P directly from particles + fine node
    masses, with no explicit fine matrix."""

    comp_w: jax.Array        # (n, dim, width) composed per-axis weights
    comp_dw: jax.Array       # (n, dim, width) composed per-axis gradients
    p_bins: object           # particle bins by composed ext cell key
    n_bins: object           # fine-node bins by composed embed ext key
    node_coords: jax.Array   # (nf, dim) int fine node coords
    node_m: jax.Array        # (nf,) fine lumped masses


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TileEmbed:
    """Embed transfer tables for a COMPACT coarse level: sparse bins of the
    fine nodes in the coarse tile grid + that grid's neighbor table."""

    bins: object
    tgrid: object
    nbr: object


class MGStatic(NamedTuple):
    levels: Tuple[MGLevel, ...]
    # embeds[l] = stencil of level-l nodes embedded in level-(l+1) grid
    embeds: Tuple[transfer.Stencil, ...]
    # embed_bins[l] = CellBins of level-l nodes in level-(l+1) cells (dense
    # path; None entries on sparse tile grids)
    embed_bins: Tuple[object, ...]
    # OR of per-level tile-grid overflow flags (assembled mode; None else)
    overflow: object = None


class MGPrecond(NamedTuple):
    diag_inv: Tuple[jax.Array, ...]   # per level: (n_nodes_l, d, d) block inverses
                                      # (tile-ROW order in assembled mode)
    lmax: Tuple[jax.Array, ...]       # per level: scalar spectral bound
    ctx: object                       # per-particle dPdF context (shared by levels)
    coarse_chol: object = None        # Cholesky factor of the projected
                                      # coarsest operator (coarse_solver =
                                      # "direct"; reference: Eigen LDLT, #11)
    # assembled mode: per-level BSR matrices (M + dt^2 K), tile-row order,
    # rebuilt once per Newton iteration and reused by every smoother /
    # residual application in the V-cycle (None entries = matrix-free level)
    mats: Tuple[object, ...] = ()


def coarse_res(res: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple((r + 1) // 2 for r in res)


def build_static(
    x, m, res, dx, n_levels: int, constrained, dtype, tile_capacity: int = 0,
    bin_caps=None, mg_tile_caps=None, mg_bin_caps=None,
    kernel: str = "quadratic", dense_switch=None, assembled_from: int = 0,
    mg_composed_caps=None,
    mg_ncomposed_caps=None,
) -> MGStatic:
    """Per-step hierarchy topology/mass/BC (reference: buildHierarchy's
    level setup; rebuilt when particles move, SURVEY.md §3.4).

    constrained: (n_nodes_0,) bool — fine-level Dirichlet/contact nodes.
    Coarse constraint marking: a coarse node is constrained when more than
    25% of its restriction weight comes from constrained fine nodes
    (sticky-style; coarse slip is treated as free — conservative, only
    affects preconditioner quality, not correctness).

    tile_capacity > 0 builds COMPACT levels on block-sparse tile grids:
    level 0 always (its vectors must match the step's compacted residual
    space), coarser levels while their dense node count exceeds
    `dense_switch` (None = 2 * tile_capacity * 4^dim — switch to dense
    once sparsity stops paying). The dense tail reuses all the dense-level
    machinery (bins, mode assembly, Galerkin RAP, direct coarse factor) —
    HOT's "agglomerate the coarse levels" guidance (SURVEY.md §5.7) in
    storage form.

    mg_bin_caps: EXACT per-level (cells_cap, cap) CellBins capacities
    (host-chosen). Without it, coarse-level caps come from a shift
    heuristic off `bin_caps` that overshoots badly once the cell count
    floors (about 10x slot inflation at an 8^3 coarsest level).

    mg_tile_caps: per-level static tile capacities. For ASSEMBLED levels
    each level gets a tile grid + symbolic tile-row BSR structure so
    build_precond can assemble explicit operators and the V-cycle can
    smooth via the supertile SpMV (ops.bsr_tiled.spmv_tiled) instead of
    per-particle quadrature applies. On compact levels they additionally
    size the level's own tile grid (level 0 always uses tile_capacity).
    """
    sparse_mode = tile_capacity > 0
    assembled = mg_tile_caps is not None
    if sparse_mode or assembled:
        from hot_mpm.grid import sparse as sparse_mod
        from hot_mpm.ops import bsr_tiled
    if sparse_mode:
        from hot_mpm.ops import tile_transfer

        if dense_switch is None:
            dense_switch = 2 * tile_capacity * (4 ** len(res))

    levels = []
    embeds = []
    embed_bins_list = []
    track_overflow = (assembled or sparse_mode or bin_caps is not None
                      or mg_bin_caps is not None)
    overflow = jnp.zeros((), bool) if track_overflow else None
    cur_res = tuple(res)
    cur_dx = dx
    cons = constrained
    carried_tg = None            # coarse tile grid built by the embed step

    def _is_compact(l, r):
        return sparse_mode and (
            l == 0 or transfer.n_nodes_of(r) > dense_switch
        )

    def _level_tile_cap(l):
        if l == 0 or mg_tile_caps is None:
            return tile_capacity
        return int(mg_tile_caps[l])

    for l in range(n_levels):
        bins_l = None
        compact_l = _is_compact(l, cur_res)
        if compact_l:
            tg = carried_tg if carried_tg is not None else (
                sparse_mod.build_tile_grid(x, cur_dx, cur_res,
                                           _level_tile_cap(l))
            )
            st = sparse_mod.sparse_stencil(x, cur_dx, tg)
            n_nodes = tg.n_cnodes
            nbr_l = bsr_tiled.tile_neighbors(tg)
            overflow = jnp.logical_or(overflow, tg.overflow)
            if mg_bin_caps is not None:
                cells_cap, cap = mg_bin_caps[l]
                bins_l = tile_transfer.sparse_bins(x, cur_dx, tg,
                                                   int(cells_cap), int(cap))
            elif bin_caps is not None:
                cells_cap = max(bin_caps[0] >> (len(res) * l), 64)
                cap = min(bin_caps[1] << (len(res) * l), x.shape[0])
                bins_l = tile_transfer.sparse_bins(x, cur_dx, tg,
                                                   cells_cap, cap)
            if bins_l is not None:
                overflow = jnp.logical_or(overflow, bins_l.overflow)
                grid_m = tile_transfer.tile_binned_scatter(
                    bins_l, tg, nbr_l, st.wn * m[:, None]
                )
            else:
                grid_m = transfer.scatter_sum(st.node_ids, st.wn * m[:, None],
                                              n_nodes)
        else:
            tg = None
            nbr_l = None
            # quadrature levels widen the SAME kernel family the objective
            # uses (HOT's construction); the node-embedding P/R below stay
            # quadratic by definition
            st = transfer.particle_stencil(x, cur_dx, cur_res, kernel=kernel)
            n_nodes = transfer.n_nodes_of(cur_res)
            if mg_bin_caps is not None:
                cells_cap, cap = mg_bin_caps[l]
                bins_l = transfer.bin_particles(x, cur_dx, cur_res,
                                                int(cells_cap), int(cap))
            elif bin_caps is not None:
                # coarser levels: ~8x fewer cells, ~8x more particles/cell;
                # cap is bounded by the particle count (the shift heuristic
                # otherwise inflates padded slots ~10x at deep levels)
                cells_cap = max(bin_caps[0] >> (len(res) * l), 64)
                cap = min(bin_caps[1] << (len(res) * l), x.shape[0])
                bins_l = transfer.bin_particles(x, cur_dx, cur_res, cells_cap, cap)
            if bins_l is not None and track_overflow:
                overflow = jnp.logical_or(overflow, bins_l.overflow)
            if bins_l is not None:
                grid_m = transfer.binned_scatter(bins_l, st.wn * m[:, None],
                                                 cur_res)
            else:
                grid_m = transfer.scatter_sum(st.node_ids, st.wn * m[:, None],
                                              n_nodes)
        active = grid_m > 0
        free = jnp.logical_and(active, jnp.logical_not(cons))
        # composed-Galerkin first assembled level: wider structure holding
        # the exact P^T A_0 P operator (ops.composed); only meaningful when
        # the finest level stays matrix-free (assembled_from > 0)
        composed_l = (assembled and mg_composed_caps is not None
                      and assembled_from > 0 and l == assembled_from)
        half_l = (4 if l >= 2 else 3) if composed_l else 2
        tg_l = mat_l = free_rows_l = comp_l = None
        if compact_l:
            tg_l = tg
            if assembled and l >= assembled_from:
                mat_l = bsr_tiled.structure_tiled(tg, half=half_l)
                free_rows_l = free[:-1]             # rows == compacted ids
        elif assembled and l >= assembled_from:
            tg_l = sparse_mod.build_tile_grid(
                x, cur_dx, cur_res, int(mg_tile_caps[l])
            )
            mat_l = bsr_tiled.structure_tiled(tg_l, half=half_l)
            nbr_l = bsr_tiled.tile_neighbors(tg_l)
            valid = mat_l.node_of < n_nodes
            safe = jnp.minimum(mat_l.node_of, n_nodes - 1)
            free_rows_l = jnp.logical_and(free[safe], valid)
            overflow = jnp.logical_or(overflow, tg_l.overflow)
        if composed_l and mat_l is not None:
            from hot_mpm.ops import composed as comp_mod

            cb, cw, cdw = comp_mod.composed_particle_weights(x, dx, l)
            pc_cap, pp_cap = mg_composed_caps
            p_bins = transfer.bin_by_ids(
                comp_mod.ext_key(cb, cur_res), comp_mod.n_ext(cur_res),
                int(pc_cap), int(pp_cap),
            )
            overflow = jnp.logical_or(overflow, p_bins.overflow)
            lvl0 = levels[0]
            if lvl0.compact:
                nf = lvl0.tgrid.dump
                node_coords = bsr_tiled.compact_node_coords(
                    lvl0.tgrid, jnp.arange(nf, dtype=jnp.int32)
                )
                node_m = lvl0.grid_m[:-1]
            else:
                nf = transfer.n_nodes_of(lvl0.res)
                node_coords = transfer.unravel(
                    jnp.arange(nf, dtype=jnp.int32), lvl0.res
                )
                node_m = lvl0.grid_m
            nb = node_coords
            for _ in range(l):
                nb = jnp.floor_divide(nb - 1, 2)
            # cells capacity: ACTIVE composed cells when planned
            # (capacity.composed_node_cells — the full ext coarse grid is
            # ~34x oversized at 128^3);
            # full-grid fallback when driven without a planner
            nc_cells, nc_cap = (mg_ncomposed_caps if mg_ncomposed_caps
                                else (min(nf, comp_mod.n_ext(cur_res)),
                                      2 ** (len(res) * l)))
            n_bins = transfer.bin_by_ids(
                comp_mod.ext_key(nb, cur_res), comp_mod.n_ext(cur_res),
                int(nc_cells), int(nc_cap),
                valid=node_m > 0,
            )
            overflow = jnp.logical_or(overflow, n_bins.overflow)
            comp_l = ComposedLevel(comp_w=cw, comp_dw=cdw, p_bins=p_bins,
                                   n_bins=n_bins, node_coords=node_coords,
                                   node_m=node_m)
        levels.append(
            MGLevel(stencil=st, grid_m=grid_m, active=active, free=free,
                    dx=cur_dx, res=cur_res, bins=bins_l, tgrid=tg_l,
                    mat_sym=mat_l, nbr=nbr_l, free_rows=free_rows_l,
                    compact=compact_l, comp=comp_l)
        )
        if l == n_levels - 1:
            break
        nxt_res = coarse_res(cur_res)
        nxt_dx = cur_dx * 2.0
        e_bins = None
        carried_tg = None
        compact_next = _is_compact(l + 1, nxt_res)
        if compact_l:
            node_pos = sparse_mod.node_positions(tg, cur_dx, dtype)
        else:
            node_pos = transfer.node_positions(cur_res, cur_dx, dtype)
        finite = jnp.all(node_pos < 1e8, axis=-1)
        if compact_next:
            tg_next = sparse_mod.build_tile_grid(x, nxt_dx, nxt_res,
                                                 _level_tile_cap(l + 1))
            carried_tg = tg_next
            embed = sparse_mod.sparse_stencil(node_pos, nxt_dx, tg_next,
                                              weights_impl="flat")
            n_coarse = tg_next.n_cnodes
            # inactive/dump fine nodes sit at a far position: zero their
            # embedding weights so they cannot pollute coarse sums
            embed = embed._replace(wn=jnp.where(active[:, None], embed.wn, 0.0))
            if bins_l is not None or mg_bin_caps is not None:
                nbr_next = bsr_tiled.tile_neighbors(tg_next)
                eb = tile_transfer.sparse_bins(
                    node_pos, nxt_dx, tg_next, tg_next.dump, 2 ** len(res),
                    valid=finite,
                )
                e_bins = TileEmbed(bins=eb, tgrid=tg_next, nbr=nbr_next)
        else:
            embed = transfer.particle_stencil(node_pos, nxt_dx, nxt_res,
                                              weights_impl="flat")
            n_coarse = transfer.n_nodes_of(nxt_res)
            if compact_l:
                # fine compacted pads/dump sit far away: mask their weights
                embed = embed._replace(
                    wn=jnp.where(active[:, None], embed.wn, 0.0)
                )
            if bin_caps is not None or mg_bin_caps is not None:
                # every coarse cell holds at most 2^dim embedded fine nodes
                e_bins = transfer.bin_particles(
                    node_pos, nxt_dx, nxt_res, transfer.n_nodes_of(nxt_res),
                    2 ** len(res),
                    valid=(finite if compact_l else None),
                )
        # LEAN embed: restriction/prolongation consume only wn/node_ids;
        # the stencil's gwn + rel are ~1.4 GB dead weight at a 128^3 fine
        # level (2.1M nodes x 27 x dim x 2 arrays)
        z = jnp.zeros((0,), embed.wn.dtype)
        embeds.append(embed._replace(gwn=z, rel=z))
        embed_bins_list.append(e_bins)
        # propagate constraint mask to the coarse level
        w_total = transfer.scatter_sum(embed.node_ids, embed.wn, n_coarse)
        w_cons = transfer.scatter_sum(
            embed.node_ids,
            embed.wn * cons[:, None].astype(embed.wn.dtype),
            n_coarse,
        )
        cons = w_cons > 0.25 * jnp.maximum(w_total, 1e-30)
        cur_res, cur_dx = nxt_res, nxt_dx
    return MGStatic(levels=tuple(levels), embeds=tuple(embeds),
                    embed_bins=tuple(embed_bins_list), overflow=overflow)


def level_multiply(level: MGLevel, F_n, ctx, V0, dt, w):
    if level.bins is not None and not level.compact:
        # flat mode-form apply: the generic unfused chain's (n, 3, 3)
        # vmap temps (docs/KERNEL_PLAN.md "Tiny trailing dims")
        return obj_mod.elastic_hessian_apply_modes_flat(
            level.stencil, F_n, ctx, V0, dt, level.grid_m, level.active,
            w, level.bins, level.res,
        )
    out = obj_mod.elastic_hessian_apply(
        level.stencil, F_n, ctx, V0, dt, level.grid_m, level.active, w,
        scatter=level.scatter, gather_st=level.gather_st,
    )
    return out


def level_project(level: MGLevel, r):
    return jnp.where(level.free[:, None], r, 0.0)


def _mat_of(pre: "MGPrecond", l: int):
    return pre.mats[l] if pre.mats else None


def _rows_mul(level: MGLevel, mat):
    """Row-vector SpMV for an explicit level operator: the supertile kernel
    when the matrix is in tile-row layout (half=2 AND mat.tile_layout —
    quadrature assembly or tile-compacted RAP), the generic gather SpMV
    otherwise (Galerkin RAP levels on dense row structures:
    compressed-row order, any half — including rap_max_half-truncated
    half-2 mats, which neither half nor n_rows can distinguish from
    tile-layout ones; routing those to the supertile kernel read the
    wrong rows, caught by test_rap_max_half_truncation_guard)."""
    if mat.half == 2 and level.tgrid is not None and mat.tile_layout:
        from hot_mpm.ops import bsr_tiled

        # reduce='flat': the einsum form's R5 intermediate OOMs the
        # compile of large MG programs (see spmv_tiled docstring)
        return lambda w: bsr_tiled.spmv_tiled(mat, level.tgrid, level.nbr, w,
                                              reduce="flat")
    from hot_mpm.ops import bsr as bsr_mod

    return lambda w: bsr_mod.spmv(mat, w)


def _free_rows_of(level: MGLevel, mat):
    """Free mask in the ROW order of `mat` (whatever its structure)."""
    if level.compact:
        # compact levels: row index == compacted node id (dump row dropped)
        return level.free[:-1]
    n_nodes = level.grid_m.shape[0]
    ok = mat.node_of < n_nodes
    return jnp.logical_and(level.free[jnp.minimum(mat.node_of, n_nodes - 1)],
                           ok)


def _to_rows(level: MGLevel, mat, v):
    """Level vector -> mat row layout. Compact levels: drop the dump row."""
    if level.compact:
        return v[:-1]
    from hot_mpm.ops import bsr as bsr_mod

    return bsr_mod.grid_vector_to_rows(mat, v)


def _from_rows(level: MGLevel, mat, y):
    """mat row layout -> level vector. Compact levels: append a zero dump row."""
    if level.compact:
        return jnp.concatenate([y, jnp.zeros((1, y.shape[1]), y.dtype)], axis=0)
    from hot_mpm.ops import bsr as bsr_mod

    return bsr_mod.rows_to_grid_vector(mat, y, level.grid_m.shape[0])


def level_multiply_any(level: MGLevel, mat, F_n, ctx, V0, dt, w):
    """A_l w on dense level vectors; explicit SpMV when mat is available
    (quadrature-assembled tile-row or Galerkin RAP), quadrature apply
    otherwise."""
    if mat is None:
        return level_multiply(level, F_n, ctx, V0, dt, w)
    y_rows = _rows_mul(level, mat)(_to_rows(level, mat, w))
    y = _from_rows(level, mat, y_rows)
    return jnp.where(level.active[:, None], y, w)


def _level_ops_rows(level: MGLevel, mat):
    """(mul, proj) on ROW vectors for an explicit-operator level."""
    mul = _rows_mul(level, mat)
    free_rows = _free_rows_of(level, mat)

    def proj(r):
        return jnp.where(free_rows[:, None], r, 0.0)

    return mul, proj


def _level_ops_dense(level: MGLevel, F_n, ctx, V0, dt):
    """(mul, proj) on dense level vectors for a matrix-free level."""

    def mul(w):
        return level_multiply(level, F_n, ctx, V0, dt, w)

    def proj(r):
        return level_project(level, r)

    return mul, proj


def _level_smoother_data(level: MGLevel, mat, F_n, ctx, V0, dt,
                         cfg: MultigridConfig, need_lmax: bool, dim: int):
    """One level's per-Newton smoother data: block-diagonal inverse +
    (Chebyshev) power-iteration lambda_max. mat = the level's explicit
    operator (tile-row or compressed-row), None for matrix-free levels."""
    if mat is not None:
        from hot_mpm.ops import bsr as bsr_mod

        free_rows = _free_rows_of(level, mat)
        eye = jnp.eye(dim, dtype=mat.vals.dtype)
        D = jnp.where(free_rows[:, None, None],
                      bsr_mod.block_diag(mat), eye[None])
        # jnp.linalg.inv here, NOT sym_block_inv: the analytic
        # inverse inside the assembled-MG program aborted the compiler
        # of the code's first target (ROADMAP D6); these
        # per-level diagonals are small, so LU cost is negligible here
        Dinv = jnp.linalg.inv(D)
        mul, proj = _level_ops_rows(level, mat)
        v0 = free_rows[:, None] * jnp.ones((1, dim), F_n.dtype)
    else:
        # FLAT diag + analytic flat inverse for matrix-free levels (the
        # tiny-trailing-dims rule, docs/KERNEL_PLAN.md). The flat analytic
        # form is a different program than the (n, 3, 3) sym_block_inv
        # that aborted that compiler inside assembled-MG programs.
        D = obj_mod.elastic_block_diag(
            level.stencil, F_n, ctx, V0, dt, level.grid_m, level.active,
            dim, scatter=level.scatter, flat=True,
        )
        # fp32 smoother-stability floor: fringe active nodes (stencil-tail
        # masses ~1e-20) give Dinv rows ~1e14 at 128^3, and Chebyshev
        # iterates THROUGH such rows (z = Dinv r, then A z) compound to
        # fp32 overflow — a 128^3 V-cycle NaN (64^3 per-node masses are
        # 8x larger and never hit it). Floor the diagonal at
        # 1e-10 x the level's max diagonal: caps |Dinv r| at ~1e10/dmax
        # scales (safe under fp32's 3.4e38 through squared dots) while
        # perturbing only negligible-coupling rows. f64 needs no floor
        # and legitimately carries larger dynamic range (a 1e-7 floor
        # cost 87 CG iterations instead of 20 on the f64 CPU suites).
        if D.dtype == jnp.float32:
            dmax = jnp.max(D[:, 0::dim + 1])
            floor = jnp.asarray(1e-10, D.dtype) * dmax
            for i in range(dim):
                col = i * dim + i
                D = D.at[:, col].set(jnp.maximum(D[:, col], floor))
        Dinv = obj_mod.sym_block_inv_flat(D, dim)
        # lmax must bound the SAME operator the smoother applies
        mul = lambda w: level_multiply(level, F_n, ctx, V0, dt, w)
        proj = lambda r: level_project(level, r)
        v0 = level.free[:, None] * jnp.ones((1, dim), F_n.dtype)
    if need_lmax:
        lam = _power_iteration_lmax(mul, proj, Dinv, v0, cfg.power_iters)
    else:
        lam = jnp.ones((), F_n.dtype)
    return Dinv, lam


def build_precond(
    mg: MGStatic, F_n, ctx, V0, dt, cfg: MultigridConfig, dim: int,
    reuse: "MGPrecond" = None, exe=None,
) -> MGPrecond:
    """Per-Newton-iteration smoother data: block diagonals + lambda_max.

    Assembled levels (built with mg_tile_caps) additionally assemble the
    explicit tile-row BSR operator here — once per Newton iteration,
    amortized over every smoother/residual application of every CG
    iteration (reference: HOT's per-level explicit matrices, #35).

    reuse (cfg.rap_refresh == "lagged"): a previously built MGPrecond
    whose Galerkin-RAP chain (every assembled level AFTER the first one)
    and coarse factor are taken as-is instead of rebuilt — the coarse
    CORRECTIONS lag one linearization point while the first assembled
    level (the one built from particles) and every level's smoother
    diagonals/lmax are rebuilt fresh. SPD is preserved (the lagged mats
    were SPD at their build point), so PCG still converges; the cost is
    a few extra CG iterations under large per-Newton rotation.

    exe: optional executor `exe(f, *arrays) -> f(*arrays)` wrapping each
    build PIECE (one level's assembly/RAP, one level's smoother data, the
    coarse factor). Default None runs everything inline (one traced
    program — required inside the jitted step). A memory-bound harness
    passes `lambda f, *a: jax.jit(f)(*a)` from OUTSIDE jit so every piece
    is its own device execution: XLA's scheduler overlaps the independent
    pieces' lifetimes inside one program, and a phased build caps the
    peak at max(piece) + residents (docs/KERNEL_PLAN.md "Memory size")."""
    run = exe if exe is not None else (lambda f, *a: f(*a))
    diag_inv = []
    lmax = []
    mats = []
    any_assembled = any(lv.mat_sym is not None for lv in mg.levels)
    galerkin = cfg.coarsening == "galerkin" and any_assembled
    first_asm = next(
        (l for l, lv in enumerate(mg.levels) if lv.mat_sym is not None), None
    )
    prev_mat = None
    for l, level in enumerate(mg.levels):
        lagged = (reuse is not None and reuse.mats
                  and level.mat_sym is not None and first_asm is not None
                  and l > first_asm)
        if lagged:
            mat = reuse.mats[l]
            mats.append(mat)
            prev_mat = mat
            # smoother data stays fresh-from-the-lagged-mat: the mat IS
            # the level operator the smoother applies, so its diagonal /
            # lmax are the consistent (and already computed) ones
            diag_inv.append(reuse.diag_inv[l])
            lmax.append(reuse.lmax[l])
            continue
        if level.mat_sym is not None:
            from hot_mpm.ops import bsr as bsr_mod

            if galerkin and prev_mat is not None:
                # Galerkin coarse operator A_l = P^T A_{l-1} P (structured
                # SpGEMM) — consistency of the coarse CORRECTION is what
                # makes the V-cycle contract; the rediscretized hierarchy
                # reduced the residual by a factor 114 the wrong way
                # (divergent as an iteration) on the twisting bar where
                # this one reduces it to 0.06.
                from hot_mpm.ops import spgemm

                if level.compact:
                    # tile-compacted coarse rows (sparse backend)
                    mat = run(
                        lambda lv, pm: spgemm.rap(
                            pm, lv.res, None, 0, coarse_tgrid=lv.tgrid,
                            max_half=cfg.rap_max_half),
                        level, prev_mat)
                else:
                    cap = level.mat_sym.n_rows
                    if (l == len(mg.levels) - 1
                            and cfg.coarse_solver == "direct"
                            and cfg.coarse_capacity is not None):
                        # compact the coarsest Galerkin operator to its
                        # active rows: the dense coarse factor is
                        # (cap*d)^2, and the full tile-row capacity
                        # (mg_tile_caps[-1] * 4^dim) silently rebuilt the
                        # ~600 MB factor the active-rows coarse_capacity
                        # fix exists to avoid
                        cap = int(cfg.coarse_capacity)
                    mat = run(
                        lambda lv, pm, cap_=cap: spgemm.rap(
                            pm, lv.res, lv.active, cap_,
                            max_half=cfg.rap_max_half),
                        level, prev_mat)
            elif galerkin and level.comp is not None:
                # composed-stencil Galerkin (ops.composed): exact
                # P^T A_0 P from particles + fine node masses — the first
                # assembled level of a matrix-free-finest hierarchy (no
                # explicit fine matrix exists to RAP from)
                from hot_mpm.ops import composed as comp_mod

                mat = run(
                    lambda lv, F, cx, V0_, l_=l:
                        comp_mod.assemble_composed_galerkin(
                            lv.mat_sym, l_, lv.res, F, cx, V0_, dt,
                            lv.comp.node_coords, lv.comp.node_m,
                            lv.comp.p_bins, lv.comp.n_bins,
                            lv.comp.comp_w, lv.comp.comp_dw,
                            tgrid=(lv.tgrid if lv.compact else None)),
                    level, F_n, ctx, V0)
            elif level.compact:
                from hot_mpm.ops import bsr_tiled

                if level.bins is None:
                    raise NotImplementedError(
                        "assembled MG on the sparse backend needs tile "
                        "bins (transfer_impl='binned' or mg_bin_caps)"
                    )
                mat = run(
                    lambda lv, F, cx, V0_:
                        bsr_tiled.assemble_hessian_modes_tiled(
                            lv.mat_sym, lv.bins, lv.tgrid, lv.stencil,
                            F, cx, V0_, dt, lv.grid_m),
                    level, F_n, ctx, V0)
            elif level.bins is not None:
                # scatter-free rank-1-mode assembly: no colliding block
                # scatter, no 6D dPdF intermediate (docs/KERNEL_PLAN.md)
                mat = run(
                    lambda lv, F, cx, V0_: bsr_mod.assemble_hessian_modes(
                        lv.mat_sym, lv.bins, lv.stencil, F, cx, V0_,
                        dt, lv.grid_m),
                    level, F_n, ctx, V0)
            else:
                mat = run(
                    lambda lv, F, cx, V0_: bsr_mod.assemble_hessian(
                        lv.mat_sym, lv.stencil, F, cx, V0_, dt, lv.grid_m),
                    level, F_n, ctx, V0)
            mats.append(mat)
            prev_mat = mat
        else:
            mats.append(None)
            mat = None
        need_lmax = cfg.smoother == "chebyshev" and (
            l < len(mg.levels) - 1 or cfg.coarse_solver == "smoother"
        )
        Dinv, lam = run(
            lambda lv, m_, F, cx, V0_, nl=need_lmax: _level_smoother_data(
                lv, m_, F, cx, V0_, dt, cfg, nl, dim),
            level, mat, F_n, ctx, V0)
        diag_inv.append(Dinv)
        lmax.append(lam)
    chol = None
    if (cfg.coarse_solver == "direct" and reuse is not None
            and reuse.coarse_chol is not None and first_asm is not None
            and len(mg.levels) - 1 > first_asm and galerkin):
        # coarsest level was lagged above — its factor is too
        chol = reuse.coarse_chol
    elif cfg.coarse_solver == "direct":
        if mg.levels[-1].compact:
            raise NotImplementedError(
                "direct coarse solve needs a dense coarsest level: add MG "
                "levels (or lower dense_switch) so the coarsest grid "
                "leaves the compact tile representation"
            )
        if galerkin and mats[-1] is not None:
            # factor the already-built Galerkin coarsest operator
            chol = (run(
                lambda lv, m_: _dense_factor_from_mat(
                    m_, _free_rows_of(lv, m_), dim),
                mg.levels[-1], mats[-1]), mats[-1])
        else:
            chol = run(
                lambda lv, F, cx, V0_: _coarse_dense_factor(
                    lv, F, cx, V0_, dt, dim, capacity=cfg.coarse_capacity),
                mg.levels[-1], F_n, ctx, V0)
    return MGPrecond(diag_inv=tuple(diag_inv), lmax=tuple(lmax), ctx=ctx,
                     coarse_chol=chol,
                     mats=tuple(mats) if any_assembled else ())


def _coarse_dense_factor(level: MGLevel, F_n, ctx, V0, dt, dim: int,
                         capacity: int = None):
    """Cholesky factor of the BC-projected coarsest operator (reference:
    the Eigen LDLT coarse solve, components #11/#36).

    Assembles the coarsest level's BSR from particle quadrature, expands
    to dense over the ACTIVE coarsest rows (static `capacity`; None = all
    nodes), projects constrained DoFs to identity rows/cols, and factors
    once per Newton iteration. Sizing the factor by active rows instead of
    the full coarse grid is what keeps the memory at (cap*d)^2 — the
    full-grid factor at a 16^3 coarsest is 604 MB.
    """
    from hot_mpm.ops import bsr as bsr_mod

    n_nodes = level.grid_m.shape[0]
    mat = bsr_mod.structure(level.active, level.res,
                            capacity=capacity or n_nodes)
    if level.bins is not None:
        # scatter-free rank-1-mode assembly (docs/KERNEL_PLAN.md): the
        # colliding-scatter path materialises (n*3^2d, d^2) blocks.
        mat = bsr_mod.assemble_hessian_modes(
            mat, level.bins, level.stencil, F_n, ctx, V0, dt, level.grid_m
        )
    else:
        mat = bsr_mod.assemble_hessian(
            mat, level.stencil, F_n, ctx, V0, dt, level.grid_m
        )
    free_rows = level.free[jnp.minimum(mat.node_of, n_nodes - 1)]
    free_rows = jnp.logical_and(free_rows, mat.node_of < n_nodes)
    return (_dense_factor_from_mat(mat, free_rows, dim), mat)


def _dense_factor_from_mat(mat, free_rows, dim: int):
    """Cholesky factor array of a BC-projected explicit BSR operator.

    Dense matrix built COMPONENT-WISE: every intermediate keeps two large
    trailing dims (docs/KERNEL_PLAN.md "Tiny trailing dims")."""
    cols = jnp.maximum(mat.col_row, 0)
    ok = (mat.col_row >= 0) & free_rows[:, None] & free_rows[cols]
    n_rows = mat.n_rows
    K = mat.K
    dd = dim * dim
    r_idx = jnp.arange(n_rows, dtype=jnp.int32)[:, None]
    # invalid entries scatter into per-offset dump columns -> all (row, col)
    # pairs are unique and XLA parallelizes the scatter
    c_idx = jnp.where(ok, cols, n_rows + jnp.arange(K, dtype=jnp.int32)[None, :])
    A = jnp.zeros((n_rows * dim, n_rows * dim), mat.vals.dtype)
    for a in range(dim):
        for b in range(dim):
            # flat vals: strided (n_rows, K) component slab, masked 2D
            comp_ab = jnp.where(ok, mat.vals[:, a * dim + b::dd], 0.0)
            comp = jnp.zeros((n_rows, n_rows + K), mat.vals.dtype)
            comp = comp.at[r_idx, c_idx].add(comp_ab, unique_indices=True)
            A = A.at[a::dim, b::dim].set(comp[:, :n_rows])
    # identity on non-free DoFs keeps the factorization well posed
    diag_fix = jnp.repeat(~free_rows, dim).astype(A.dtype)
    A = A + jnp.diag(diag_fix)
    # tiny Tikhonov guard: quadrature + fp can leave the projected
    # operator semi-definite at machine precision
    eps = jnp.asarray(1e-8, A.dtype) * jnp.maximum(jnp.max(jnp.diag(A)), 1.0)
    A = A + eps * jnp.eye(A.shape[0], dtype=A.dtype)
    # store the factor ARRAY only: cho_factor's `lower` bool would become a
    # traced (unhashable) leaf if the precond pytree crosses a jit boundary
    c, _ = jax.scipy.linalg.cho_factor(A)
    return c


def _coarse_dense_solve(chol_and_mat, b, n_nodes: int):
    (c, mat) = chol_and_mat
    from hot_mpm.ops import bsr as bsr_mod

    b_rows = bsr_mod.grid_vector_to_rows(mat, b)
    d = b.shape[1]
    x = jax.scipy.linalg.cho_solve((c, False), b_rows.reshape(-1))
    return bsr_mod.rows_to_grid_vector(mat, x.reshape(-1, d), n_nodes)


def _bapply(B, v):
    """Block-diagonal application; B either (n, d, d) or FLAT (n, d*d)
    (matrix-free dense levels store flat inverses, docs/KERNEL_PLAN.md
    "Tiny trailing dims")."""
    if B.ndim == 2:
        d = v.shape[-1]
        cols = []
        for a in range(d):
            acc = B[:, a * d] * v[:, 0]
            for b in range(1, d):
                acc = acc + B[:, a * d + b] * v[:, b]
            cols.append(acc)
        return jnp.stack(cols, axis=-1)
    return jnp.einsum("nij,nj->ni", B, v)


def _power_iteration_lmax(mul, proj, Dinv, v, iters: int):
    """lambda_max(D^-1 A) on the free subspace via power iteration
    (reference: estimateEigenvalues, component #36). mul/proj act on
    whatever vector layout the level smooths in; v is the start vector."""

    def dinva(v):
        v = proj(v)
        return proj(_bapply(Dinv, mul(v)))

    v = v / jnp.maximum(jnp.sqrt(jnp.sum(v * v)), 1e-30)

    def body(_, carry):
        v, lam = carry
        Av = dinva(v)
        lam = jnp.sqrt(jnp.sum(Av * Av)) / jnp.maximum(jnp.sqrt(jnp.sum(v * v)), 1e-30)
        v = Av / jnp.maximum(jnp.sqrt(jnp.sum(Av * Av)), 1e-30)
        return (v, lam)

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.ones((), v.dtype)))
    return jnp.maximum(lam, 1e-12)


# ---------------------------------------------------------------------------
# smoothers (layout-agnostic: mul/proj close over the level's operator)
# ---------------------------------------------------------------------------


def jacobi_smooth(mul, proj, Dinv, b, x, iters: int, omega: float):
    def body(_, x):
        r = proj(b - mul(x))
        return x + omega * _bapply(Dinv, r)

    return jax.lax.fori_loop(0, iters, body, x)


def chebyshev_smooth(mul, proj, Dinv, lmax, b, x, order: int,
                     lo: float, hi: float):
    """Chebyshev polynomial smoother on D^-1 A over [lo*lmax, hi*lmax]
    (reference: chebyshevSmooth, component #36 — HOT's recommended smoother)."""
    lmin = lo * lmax
    lmx = hi * lmax
    theta = 0.5 * (lmx + lmin)
    delta = 0.5 * (lmx - lmin)
    sigma1 = theta / delta

    def resid(x):
        return proj(b - mul(x))

    r = resid(x)
    d = proj(_bapply(Dinv, r)) / theta
    x = x + d
    rho_prev = 1.0 / sigma1

    def body(_, carry):
        x, d, rho_prev = carry
        r = resid(x)
        z = proj(_bapply(Dinv, r))
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        d = rho * rho_prev * d + (2.0 * rho / delta) * z
        return (x + d, d, rho)

    x, _, _ = jax.lax.fori_loop(0, order - 1, body, (x, d, rho_prev))
    return x


def colored_gs_smooth(mul, proj, Dinv, color, n_colors: int, b, x,
                      iters: int):
    """Multicolor Gauss-Seidel sweep (reference: the colored-GS smoother
    option of component #36; HOT's OpenMP code colors nodes so threads
    never race — here coloring instead SEQUENCES the update so later
    colors see earlier colors' fresh values).

    Nodes are colored by coordinate parity (2^dim colors). The quadratic
    stencil couples same-color nodes at per-axis distance 2, so those few
    couplings update Jacobi-style within a color — the standard wide-
    stencil compromise (exact GS would need 3^dim colors = 3^dim operator
    applications per sweep). Each iteration is a SYMMETRIC sweep (forward
    then reverse color order, SSOR-style) so the smoother — and hence the
    V-cycle — stays symmetric, which PCG requires of its preconditioner.
    One iteration costs 2*n_colors applications of the level operator.
    """
    order = list(range(n_colors)) + list(range(n_colors - 1, -1, -1))

    def body(_, x):
        for c in order:                    # static unroll
            r = proj(b - mul(x))
            m = (color == c).astype(x.dtype)[:, None]
            x = x + m * _bapply(Dinv, r)
        return x

    return jax.lax.fori_loop(0, iters, body, x)


def _parity_colors(node_of, res: Tuple[int, ...]):
    """(n_rows,) int32 parity color of each vector entry: sum over axes of
    (coord_k & 1) << k. node_of=None means dense layout (entry i = node i).
    Out-of-range rows (assembled-layout padding) get color 0 — they are
    masked by proj anyway."""
    n_nodes = transfer.n_nodes_of(res)
    if node_of is None:
        ids = jnp.arange(n_nodes, dtype=jnp.int32)
    else:
        ids = jnp.clip(node_of, 0, n_nodes - 1)
    coords = transfer.unravel(ids, res)
    dim = len(res)
    color = jnp.zeros(ids.shape, jnp.int32)
    for k in range(dim):
        color = color | ((coords[:, k] & 1) << k)
    return color


def _smooth_ops(mul, proj, pre: MGPrecond, l: int, cfg: MultigridConfig,
                b, x, iters: int, color=None, n_colors: int = 0):
    if cfg.smoother == "chebyshev":
        return chebyshev_smooth(
            mul, proj, pre.diag_inv[l], pre.lmax[l], b, x,
            max(iters * cfg.chebyshev_order, 1), cfg.chebyshev_lo, cfg.chebyshev_hi,
        )
    if cfg.smoother == "colored_gs":
        return colored_gs_smooth(mul, proj, pre.diag_inv[l], color, n_colors,
                                 b, x, iters)
    return jacobi_smooth(mul, proj, pre.diag_inv[l], b, x, iters,
                         cfg.jacobi_omega)


def _smooth(level, F_n, ctx, V0, dt, pre: MGPrecond, l: int, cfg: MultigridConfig,
            b, x, iters: int):
    """Smooth on DENSE level vectors. Assembled levels convert to tile-row
    layout ONCE per smooth call, run the whole polynomial in rows against
    the supertile SpMV, and convert back."""
    mat = _mat_of(pre, l)
    n_colors = 2 ** len(level.res)
    if mat is None:
        color = None
        if cfg.smoother == "colored_gs":
            if level.compact:
                # compacted node coords from tile positions (incl. dump row)
                from hot_mpm.grid import sparse as sparse_mod

                pos = sparse_mod.node_positions(level.tgrid, 1.0, jnp.float32)
                coords = jnp.clip(
                    pos.astype(jnp.int32), 0,
                    jnp.asarray(level.res, jnp.int32) - 1,
                )
                color = jnp.zeros((coords.shape[0],), jnp.int32)
                for k in range(len(level.res)):
                    color = color | ((coords[:, k] & 1) << k)
            else:
                color = _parity_colors(None, level.res)
        mul = lambda w: level_multiply(level, F_n, ctx, V0, dt, w)
        proj = lambda r: level_project(level, r)
        return _smooth_ops(mul, proj, pre, l, cfg, b, x, iters,
                           color=color, n_colors=n_colors)
    mul, proj = _level_ops_rows(level, mat)
    b_r = _to_rows(level, mat, b)
    x_r = _to_rows(level, mat, x)
    color = (_parity_colors(mat.node_of, level.res)
             if cfg.smoother == "colored_gs" else None)
    x_r = _smooth_ops(mul, proj, pre, l, cfg, b_r, x_r, iters,
                      color=color, n_colors=n_colors)
    return _from_rows(level, mat, x_r)


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------


def restrict(embed: transfer.Stencil, r_fine, n_nodes_coarse: int,
             bins=None, res_coarse=None):
    """R = P^T: scatter fine residual into coarse nodes."""
    vals = embed.wn[:, :, None] * r_fine[:, None, :]
    if isinstance(bins, TileEmbed):
        from hot_mpm.ops import tile_transfer

        return tile_transfer.tile_binned_scatter(bins.bins, bins.tgrid,
                                                 bins.nbr, vals)
    if bins is not None:
        return transfer.binned_scatter(bins, vals, res_coarse)
    return transfer.scatter_sum(embed.node_ids, vals, n_nodes_coarse)


def prolong(embed: transfer.Stencil, e_coarse, bins=None, res_coarse=None):
    """P: interpolate coarse correction at fine nodes (node embedding)."""
    if isinstance(bins, TileEmbed):
        from hot_mpm.ops import tile_transfer

        ec = tile_transfer.tile_window_gather(bins.bins, bins.tgrid,
                                              bins.nbr, e_coarse)
    elif bins is not None:
        ec = transfer.window_gather(bins, e_coarse, res_coarse)
    else:
        ec = transfer.gather(e_coarse, embed.node_ids)   # (n_fine, 3^d, d)
    return jnp.sum(embed.wn[:, :, None] * ec, axis=1)


def v_cycle(mg: MGStatic, pre: MGPrecond, F_n, ctx, V0, dt,
            cfg: MultigridConfig, b, l: int = 0):
    """One V(nu1, nu2) cycle on level l; returns approx A_l^-1 b."""
    level = mg.levels[l]
    x = jnp.zeros_like(b)
    if l == len(mg.levels) - 1:
        # coarsest solve (reference: --coarseSolver knob)
        if cfg.coarse_solver == "direct":
            x = _coarse_dense_solve(pre.coarse_chol, b, level.grid_m.shape[0])
            return level_project(level, x)
        if cfg.coarse_solver == "cg":
            from hot_mpm.solver.cg import cg_solve

            Dinv = pre.diag_inv[l]
            cmat = _mat_of(pre, l)
            if cmat is None:
                res = cg_solve(
                    lambda w: level_project(
                        level, level_multiply(level, F_n, ctx, V0, dt, w)
                    ),
                    b,
                    precondition=lambda r: _bapply(Dinv, r),
                    project=lambda r: level_project(level, r),
                    tol=1e-2,
                    max_iters=cfg.coarse_iters,
                )
                return res.x
            mul, proj = _level_ops_rows(level, cmat)
            res = cg_solve(
                lambda w: proj(mul(w)),
                _to_rows(level, cmat, b),
                precondition=lambda r: _bapply(Dinv, r),
                project=proj,
                tol=1e-2,
                max_iters=cfg.coarse_iters,
            )
            return _from_rows(level, cmat, res.x)
        return _smooth(level, F_n, ctx, V0, dt, pre, l, cfg, b, x, cfg.coarse_iters)
    x = _smooth(level, F_n, ctx, V0, dt, pre, l, cfg, b, x, cfg.pre_smooth)
    Ax = level_multiply_any(level, _mat_of(pre, l), F_n, ctx, V0, dt, x)
    r = level_project(level, b - Ax)
    n_coarse = mg.levels[l + 1].grid_m.shape[0]
    r_c = restrict(mg.embeds[l], r, n_coarse, bins=mg.embed_bins[l],
                   res_coarse=mg.levels[l + 1].res)
    r_c = level_project(mg.levels[l + 1], r_c)
    e_c = v_cycle(mg, pre, F_n, ctx, V0, dt, cfg, r_c, l + 1)
    x = x + level_project(level, prolong(mg.embeds[l], e_c,
                                         bins=mg.embed_bins[l],
                                         res_coarse=mg.levels[l + 1].res))
    x = _smooth(level, F_n, ctx, V0, dt, pre, l, cfg, b, x, cfg.post_smooth)
    return x


def mg_precondition(mg: MGStatic, pre: MGPrecond, F_n, V0, dt,
                    cfg: MultigridConfig, r):
    """Preconditioner application: `cycles` V-cycles (usually 1)."""
    ctx = pre.ctx
    z = v_cycle(mg, pre, F_n, ctx, V0, dt, cfg, r)
    for _ in range(cfg.cycles - 1):
        res = r - level_multiply_any(mg.levels[0], _mat_of(pre, 0), F_n, ctx,
                                     V0, dt, z)
        z = z + v_cycle(mg, pre, F_n, ctx, V0, dt, cfg, level_project(mg.levels[0], res))
    return z
