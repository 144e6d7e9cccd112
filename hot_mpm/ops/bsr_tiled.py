"""Tile-structured BSR SpMV — the explicit-operator kernel.

Reference equivalents: HOT's per-level BSR SpMV inside the MG-PCG smoother
loop (components #35/#36, SURVEY.md §3.4); the SPGrid-style paged layout of
component #25 is what makes this formulation natural.

Why this layout: the generic compressed-row SpMV (`ops.bsr.spmv`) gathers
n_rows * K tiny (d,)-rows, and each dynamic-indexed op paid a fixed
latency on the code's first target (docs/KERNEL_PLAN.md "Dynamic
indexing").
The layout mirrors the reference's paged grid: rows are stored per ACTIVE
TILE (4^dim nodes, from grid.sparse.TileGrid), so

  1. the x-values any tile needs live in its 3^dim NEIGHBOR TILES:
     ONE gather of T*3^dim whole tile-blocks (big rows — latency-friendly);
  2. rearranging the (3,4)^dim neighborhood into a 12^dim supercube and
     slicing its center 8^dim makes every one of the K=5^dim stencil
     offsets a STATIC window slice — zero dynamic ops from here on;
  3. y_tile = sum_k vals[:, :, k] @ window_k(X8): regular batched
     (d, d) x (d,) elementwise work, bandwidth-bound on vals.

The matrix reuses ops.bsr.BsrMatrix with rows in tile-compacted order
(inactive in-tile rows padded, zero blocks), so assembly, equality tests,
and the scipy cross-check all come for free.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from hot_mpm.grid import sparse as sparse_mod
from hot_mpm.ops import bsr as bsr_mod
from hot_mpm.ops import transfer


def structure_tiled(tgrid: sparse_mod.TileGrid, half: int = 2) -> bsr_mod.BsrMatrix:
    """Symbolic BSR structure with rows in tile-compacted order.

    Row r = tile_slot * tile_nodes + local_id covers the node at that slot
    (invalid slots / out-of-domain rows are fully masked). col_row holds the
    TILE-COMPACTED row index of each geometric neighbor. half=2 is the
    quadrature operator (supertile SpMV eligible); wider halves hold
    Galerkin RAP coarse operators (generic gather SpMV).
    """
    res = tgrid.res
    dim = tgrid.dim
    n_nodes = transfer.n_nodes_of(res)
    capacity = tgrid.capacity * tgrid.tile_nodes

    # node_of: flat dense node id per compacted row (n_nodes = invalid pad)
    pos = sparse_mod.node_positions(tgrid, 1.0, jnp.float32)[:-1]  # drop dump
    valid = jnp.all(pos < 1e8, axis=-1)
    coords = jnp.clip(
        pos.astype(jnp.int32), 0, jnp.asarray(res, jnp.int32) - 1
    )
    strides = []
    s = 1
    for r in reversed(res):
        strides.append(s)
        s *= int(r)
    strides = jnp.asarray(strides[::-1], jnp.int32)
    node_of = jnp.sum(coords * strides[None, :], axis=-1).astype(jnp.int32)
    node_of = jnp.where(valid, node_of, n_nodes)

    # row_of: dense node -> tile-compacted row
    rows = jnp.arange(capacity, dtype=jnp.int32)
    row_of = jnp.full((n_nodes + 1,), -1, jnp.int32)
    row_of = row_of.at[jnp.where(valid, node_of, n_nodes)].set(
        jnp.where(valid, rows, -1)
    )[:n_nodes]

    # neighbor columns at the (2*half+1)^dim geometric offsets
    offs = bsr_mod._offsets(dim, half)                       # (K, dim)
    res_arr = jnp.asarray(res, jnp.int32)
    ncoords = coords[:, None, :] + offs[None, :, :]
    in_dom = jnp.all((ncoords >= 0) & (ncoords < res_arr[None, None, :]), axis=-1)
    nids = jnp.sum(jnp.clip(ncoords, 0, res_arr - 1) * strides[None, None, :], axis=-1)
    col_row = jnp.where(in_dom & valid[:, None], row_of[nids], -1)
    K = (2 * half + 1) ** dim
    vals = jnp.zeros((capacity, K * dim * dim))     # flat k-major storage
    return bsr_mod.BsrMatrix(
        vals=vals, col_row=col_row, node_of=node_of, row_of=row_of,
        res=tuple(res), half=half, tile_layout=True,
    )


def tile_neighbors(tgrid: sparse_mod.TileGrid) -> jax.Array:
    """(T_cap, 3^dim) int32 neighbor tile SLOT table; T_cap = missing.

    One lookup-gather per structure build — reused by every SpMV.
    """
    dim = tgrid.dim
    tile_res = tgrid.tile_res
    strides = sparse_mod._tile_strides(tile_res)
    slots = jnp.minimum(tgrid.tile_ids, tgrid.n_tiles_logical - 1)
    tcoords = []
    rem = slots
    for k in range(dim):
        c = rem // strides[k]
        rem = rem - c * strides[k]
        tcoords.append(c)
    tcoord = jnp.stack(tcoords, axis=-1)                     # (T_cap, dim)
    offs = bsr_mod._offsets(dim, 1)                          # (3^dim, dim)
    ncoord = tcoord[:, None, :] + offs[None, :, :]
    tr = jnp.asarray(tile_res, jnp.int32)
    in_dom = jnp.all((ncoord >= 0) & (ncoord < tr[None, None, :]), axis=-1)
    st = jnp.asarray(strides, jnp.int32)
    ntid = jnp.sum(jnp.clip(ncoord, 0, tr - 1) * st[None, None, :], axis=-1)
    nslot = tgrid.lookup[jnp.clip(ntid, 0, tgrid.n_tiles_logical - 1)]
    nslot = jnp.where(in_dom, nslot, -1)
    valid_tile = (tgrid.tile_ids < tgrid.n_tiles_logical)[:, None]
    nslot = jnp.where(valid_tile, nslot, -1)
    return jnp.where(nslot >= 0, nslot, tgrid.capacity).astype(jnp.int32)


def _supercube(xn, tile: int, dim: int):
    """(T, 3^dim, tn, c) neighbor blocks -> (T, (3*tile)^dim..., c) supercube.

    Pure reshape/transpose: axis a of the supercube interleaves (neighbor
    offset along a, local coord along a).
    """
    T = xn.shape[0]
    c = xn.shape[-1]
    shape = (T,) + (3,) * dim + (tile,) * dim + (c,)
    x = xn.reshape(shape)
    perm = [0]
    for a in range(dim):
        perm += [1 + a, 1 + dim + a]
    perm += [1 + 2 * dim]
    x = x.transpose(perm)
    return x.reshape((T,) + (3 * tile,) * dim + (c,))


def vals_supertile_arg(mat: bsr_mod.BsrMatrix, dim: int) -> jax.Array:
    """Materialize the canonical FLAT (R, K*d*d) vals as a (R, K, d, d)
    device array to pass as the supertile-SpMV ARGUMENT.

    Argument layouts are chosen by XLA per shape at the executable
    boundary: the 4-D shape gets the reduce-friendly one, while a flat
    argument's in-program split view stays pinned to the flat row-major
    order (shaped on the code's first target; not re-measured on the
    GPU). Cost: one device copy per ASSEMBLY,
    amortized over every CG/smoother apply.
    Run this in its own jit (or jit boundary) so the copy is not fused
    into — and does not re-layout — the assembly program."""
    R, KD = mat.vals.shape
    dd = dim * dim
    return mat.vals.reshape(R, KD // dd, dim, dim)


def spmv_tiled(mat: bsr_mod.BsrMatrix, tgrid: sparse_mod.TileGrid,
               nbr: jax.Array, x, reduce: str = "einsum"):
    """y = A x with rows in tile order; x: (capacity*tile_nodes, d).

    ONE whole-tile-block gather + static supertile windows (see module
    docstring). Equivalent to bsr.spmv(mat, x) — tested in tests/test_bsr.py.

    reduce: "einsum" — the fused (T, tn, K, d, d) multiply-reduce; the
    fast form standalone, but its rank-5 intermediate can be tile-padded
    by layout assignment inside LARGE programs (docs/KERNEL_PLAN.md "Tiny
    trailing dims").
    "flat" — every big intermediate keeps a K*d*d trailing dim and the
    (k, b)->a reduction is a 0/1 matmul; layout-proof, used by the MG
    smoother/V-cycle call sites.
    """
    dim = tgrid.dim
    tile = tgrid.tile
    tn = tgrid.tile_nodes
    T = tgrid.capacity
    d = x.shape[-1]
    half = mat.half
    assert half == 2 and tile >= 3, "supertile windows assume halo 2 < tile"

    xt = x.reshape(T, tn, d)
    xt = jnp.concatenate([xt, jnp.zeros((1, tn, d), x.dtype)], axis=0)
    xn = xt[nbr]                                   # (T, 3^dim, tn, d) block gather
    xn = transfer.barrier(xn)                      # materialize once
    X = _supercube(xn, tile, dim)                  # (T, 12^dim..., d)
    # center 8^dim window: local coords [-2, tile+2) per axis
    lo = tile - half
    hi = 2 * tile + half
    X8 = X[(slice(None),) + (slice(lo, hi),) * dim]  # (T, (tile+4)^dim..., d)
    S = tile + 2 * half

    # all (node, offset) window values with ONE static-index gather
    # instead of a loop of K per-offset einsums (docs/KERNEL_PLAN.md
    # "Dynamic indexing")
    import numpy as _np

    rng5 = _np.arange(5)
    offs = _np.stack(
        _np.meshgrid(*([rng5] * dim), indexing="ij"), -1
    ).reshape(-1, dim)  # 0..4 per axis, row-major — matches col_row's order
    rngt = _np.arange(tile)
    lidx = _np.stack(
        _np.meshgrid(*([rngt] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    strides = _np.array([S ** (dim - 1 - a) for a in range(dim)])
    sup_idx = ((lidx[:, None, :] + offs[None, :, :]) * strides).sum(-1)
    sup_idx = jnp.asarray(sup_idx.reshape(-1), jnp.int32)      # (tn*K,)

    xf = X8.reshape(T, S**dim, d)
    xw = xf[:, sup_idx].reshape(T, tn, mat.K, d)
    K = mat.K
    if reduce == "einsum":
        # split (safe direction) from the flat storage
        vals5 = mat.vals.reshape(T, tn, K, d, d)
        y = jnp.sum(vals5 * xw[:, :, :, None, :], axis=(2, 4))
        return y.reshape(T * tn, d)
    xw9 = jnp.broadcast_to(
        xw[:, :, :, None, :], (T, tn, K, d, d)
    ).reshape(T, tn, K * d * d)
    prod = mat.vals.reshape(T, tn, K * d * d) * xw9
    import numpy as _np2

    cols = _np2.arange(K * d * d)
    M = (((cols % (d * d)) // d)[:, None] ==
         _np2.arange(d)[None, :]).astype(_np2.float32)   # (K*d*d, d)
    y = jnp.einsum("rtc,ca->rta", prod, jnp.asarray(M, x.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    return y.reshape(T * tn, d)


def compact_node_coords(tgrid: sparse_mod.TileGrid, cids):
    """Compacted node ids (...,) -> integer grid coords (..., dim).

    Inverse of sparse.compact_node_id for ids < dump; ids at/over capacity
    are clamped into the last valid slot (callers mask separately).
    """
    dim = tgrid.dim
    tile = tgrid.tile
    tn = tgrid.tile_nodes
    slot = jnp.clip(cids // tn, 0, tgrid.capacity - 1)
    lid = jnp.clip(cids - slot * tn, 0, tn - 1)
    tid = jnp.minimum(tgrid.tile_ids[slot], tgrid.n_tiles_logical - 1)
    strides = sparse_mod._tile_strides(tgrid.tile_res)
    tcs = []
    rem = tid
    for k in range(dim):
        c = rem // strides[k]
        rem = rem - c * strides[k]
        tcs.append(c)
    tcoord = jnp.stack(tcs, axis=-1)
    lcs = []
    rem = lid
    for k in range(dim):
        d_ = tile ** (dim - 1 - k)
        c = rem // d_
        rem = rem - c * d_
        lcs.append(c)
    lcoord = jnp.stack(lcs, axis=-1)
    return tcoord * tile + lcoord


def assemble_hessian_modes_tiled(
    mat: bsr_mod.BsrMatrix, bins, tgrid: sparse_mod.TileGrid,
    stencil, F_n, ctx, V0, dt, grid_m,
) -> bsr_mod.BsrMatrix:
    """Mode assembly into a TILE-COMPACTED structure (structure_tiled):
    identical per-cell block math to bsr.assemble_hessian_modes, but the
    per-j-offset scatter rows come from compact ids (row index == compacted
    node id) instead of the dense row_of table. bins must be
    tile_transfer.sparse_bins of the SAME tgrid (active_cells in compacted
    space); grid_m is the compacted node-mass array (n_cnodes incl. dump).
    Equivalent to assemble_hessian on compacted stencils — tested."""
    dim = mat.dim
    assert mat.half == 2
    K = mat.K
    s = stencil.wn.shape[1]
    n_rows = mat.n_rows
    cells_cap, _cap = bins.p_cell.shape
    assert n_rows == tgrid.dump, "mat must be structure_tiled of tgrid"

    blocks = bsr_mod.cell_mode_blocks(bins, stencil, F_n, ctx, V0, dt, dim)

    offs, off_id = bsr_mod.stencil_offset_table(dim, s)
    valid_cell = bins.active_cells < tgrid.dump
    coords = compact_node_coords(tgrid, bins.active_cells)      # (cells, dim)
    vals = jnp.zeros((n_rows + cells_cap, K, dim * dim), blocks.dtype)
    dump_rows = n_rows + jnp.arange(cells_cap, dtype=jnp.int32)
    for j in range(s):
        cj = coords + jnp.asarray(offs[j], jnp.int32)[None, :]
        r_j = sparse_mod.compact_node_id(tgrid, cj)             # dump if inactive
        r_j = jnp.where(valid_cell & (r_j < tgrid.dump), r_j, dump_rows)
        cols_j = jnp.asarray(off_id[j], jnp.int32)
        vals = vals.at[r_j[:, None], cols_j[None, :]].add(
            blocks[:, j].reshape(cells_cap, s, dim * dim),
            unique_indices=True,
        )
    vals = vals[:n_rows].reshape(n_rows, K * dim * dim)

    # inertia at the center offset + structure mask, in FLAT layout
    dd = dim * dim
    center = (K - 1) // 2
    eye_flat = jnp.eye(dim, dtype=vals.dtype).reshape(1, dd)
    vals = vals.at[:, center * dd:(center + 1) * dd].add(
        grid_m[:-1, None] * eye_flat
    )
    mask = jnp.repeat(mat.col_row >= 0, dd, axis=1)
    return mat._replace(vals=jnp.where(mask, vals, 0.0))
