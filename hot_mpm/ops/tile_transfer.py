"""Tile-local binned transfers for the block-sparse grid backend.

Reference equivalent: the per-block scatter/gather of the SPGrid-backed
transfers in Lib/MPM (components #25/#26): contributions are accumulated
per 4^dim tile with neighbor-block halos instead of through a dense grid.

Why this exists: the dense binned path (transfer.binned_scatter /
window_gather) materializes per-cell stencil sums over the FULL logical
grid ((n_cells, 3^dim * c) intermediates — 5.4 GB at 256^3), which defeats
the sparse backend. Here every step works in tile-compacted space:

  scatter:  slot-scatter + reduce (identical to the dense path) ->
            ONE sorted-unique row scatter into the compacted cell array ->
            2^dim minus-neighbor whole-tile-block gather -> supercube ->
            3^dim STATIC shifted-slice adds (the dense _cells_to_grid
            pattern, applied per-tile) — same op count as the dense path,
            memory O(active tiles) instead of O(n_cells).

  gather:   2^dim plus-neighbor block gather -> supercube -> 3^dim static
            window slices -> ONE per-particle row lookup (window_gather's
            shape, compacted).

Equivalent to transfer.scatter_sum / gather on compacted node ids for
particles one cell inside the domain (tested in tests/test_sparse_grid.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as _np

from hot_mpm.grid import sparse as sparse_mod
from hot_mpm.ops import transfer


def sparse_bins(x, dx, tgrid: sparse_mod.TileGrid, cells_cap: int, cap: int,
                valid=None) -> transfer.CellBins:
    """Bin particles by COMPACTED base-node id (the sparse-grid analog of
    transfer.bin_particles; cell_of/active_cells live in compacted space)."""
    from hot_mpm.ops.bspline import quadratic_bspline_weights

    base, _, _ = quadratic_bspline_weights(x, dx)
    res_arr = jnp.asarray(tgrid.res, jnp.int32)
    base = jnp.clip(base, 0, res_arr[None, :] - 1)
    cell = sparse_mod.compact_node_id(tgrid, base)     # dump for inactive
    return transfer.bin_by_ids(cell, tgrid.dump, cells_cap, cap, valid=valid)


def _nbr_select(dim: int, which: str):
    """Indices into the 27-entry (-1..1)^dim neighbor table for the 2^dim
    offsets in {-1,0} ('minus') or {0,1} ('plus') per axis, in the block
    order _supercube2 expects (row-major over axes, increasing offset)."""
    lo = 0 if which == "minus" else 1
    axes = [_np.arange(lo, lo + 2)] * dim              # per-axis table index
    mesh = _np.stack(_np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    flat = _np.zeros(mesh.shape[0], _np.int64)
    for a in range(dim):
        flat = flat * 3 + mesh[:, a]
    return jnp.asarray(flat, jnp.int32)


def _supercube2(blocks, tile: int, dim: int):
    """(T, 2^dim, tn, c) neighbor blocks -> (T, (2*tile)^dim, c) supercube
    (the 2-block variant of bsr_tiled._supercube)."""
    T = blocks.shape[0]
    c = blocks.shape[-1]
    shape = (T,) + (2,) * dim + (tile,) * dim + (c,)
    xb = blocks.reshape(shape)
    perm = [0]
    for a in range(dim):
        perm += [1 + a, 1 + dim + a]
    perm += [1 + 2 * dim]
    xb = xb.transpose(perm)
    return xb.reshape((T, (2 * tile) ** dim, c))


def _stencil_offs(dim: int):
    offs = _np.stack(
        _np.meshgrid(*([_np.arange(3)] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    return offs


def tile_binned_scatter(bins: transfer.CellBins, tgrid: sparse_mod.TileGrid,
                        nbr, values):
    """Stencil scatter onto the compacted tile grid.

    values: (n, 3^dim[, c]) per-(particle, stencil-offset) contributions in
    transfer.Stencil offset order. Returns (n_cnodes[, c]) — the compacted
    node array including the trailing dump row (zero), matching what
    transfer.scatter_sum(st.node_ids, values, tgrid.n_cnodes) produces.
    """
    dim = tgrid.dim
    tile = tgrid.tile
    tn = tgrid.tile_nodes
    T = tgrid.capacity
    s = 3**dim
    vec = values.ndim == 3
    c = values.shape[2] if vec else 1
    if c > dim:
        # chunk wide channel counts (e.g. the dd = 9-channel block-diag
        # scatter): the slot buffer is (cells_cap*cap, s*c) — 5.1 GB at
        # c=9 / 800k particles (256^3); sequential dim-channel chunks let
        # XLA reuse one 1/3-size temp
        outs = [
            tile_binned_scatter(bins, tgrid, nbr, values[:, :, i:i + dim])
            for i in range(0, c, dim)
        ]
        return jnp.concatenate(outs, axis=-1)
    vals = (values if vec else values[:, :, None]).reshape(-1, s * c)
    cells_cap, cap = bins.p_cell.shape

    # 1-2. per-slot placement + slot reduction (same as the dense path)
    slots = jnp.zeros((cells_cap * cap + 1, s * c), vals.dtype)
    slots = slots.at[bins.slot_of].set(vals, unique_indices=True)[:-1]
    S = jnp.sum(slots.reshape(cells_cap, cap, s * c), axis=1)

    # 3. per-cell sums -> compacted cell array (sorted unique row scatter)
    Sc = jnp.zeros((T * tn + 1, s * c), S.dtype)
    Sc = Sc.at[bins.active_cells].set(
        S, indices_are_sorted=True, unique_indices=True
    )[:-1]

    # 4. minus-neighbor supercube + 3^dim static shifted adds:
    #    out[node n] = sum_k S[cell n - off_k, channel k]
    St = Sc.reshape(T, tn, s * c)
    St = jnp.concatenate([St, jnp.zeros((1, tn, s * c), S.dtype)], axis=0)
    Sn = St[nbr[:, _nbr_select(dim, "minus")]]        # (T, 2^dim, tn, s*c)
    Sn = transfer.barrier(Sn)
    X = _supercube2(Sn, tile, dim)                    # (T, (2t)^dim, s*c)
    W = 2 * tile
    Xg = X.reshape((T,) + (W,) * dim + (s, c))
    # center tile occupies [tile, 2*tile); window of cells [-2, 4) rel. its
    # start -> supercube coords [tile-2, tile+4), width 6
    win = tuple(slice(tile - 2, tile + 4) for _ in range(dim))
    X6 = Xg[(slice(None),) + win]                     # (T, 6^dim..., s, c)
    offs = _stencil_offs(dim)
    out = jnp.zeros((T,) + (tile,) * dim + (c,), S.dtype)
    for k in range(s):
        sl = tuple(slice(2 - int(o), 2 - int(o) + tile) for o in offs[k])
        out = out + X6[(slice(None),) + sl + (k,)]
    out = out.reshape(T * tn, c)
    out = jnp.concatenate([out, jnp.zeros((1, c), S.dtype)], axis=0)
    return out if vec else out[:, 0]


def tile_window_gather(bins: transfer.CellBins, tgrid: sparse_mod.TileGrid,
                       nbr, grid_vals):
    """Stencil gather from the compacted tile grid: (n_cnodes[, c]) ->
    (n, 3^dim[, c]) — grid_vals[st.node_ids] with one dynamic row lookup."""
    dim = tgrid.dim
    tile = tgrid.tile
    tn = tgrid.tile_nodes
    T = tgrid.capacity
    s = 3**dim
    vec = grid_vals.ndim == 2
    c = grid_vals.shape[1] if vec else 1
    g = (grid_vals if vec else grid_vals[:, None])[:-1]   # drop dump row
    gt = g.reshape(T, tn, c)
    gt = jnp.concatenate([gt, jnp.zeros((1, tn, c), g.dtype)], axis=0)
    gn = gt[nbr[:, _nbr_select(dim, "plus")]]             # (T, 2^dim, tn, c)
    gn = transfer.barrier(gn)
    X = _supercube2(gn, tile, dim)                        # (T, (2t)^dim, c)
    W = 2 * tile
    Xg = X.reshape((T,) + (W,) * dim + (c,))
    # cells of the center tile sit at [0, tile); neighbors n + off need
    # coords [0, tile + 2) — a 6-wide window from the supercube origin
    win = tuple(slice(0, tile + 2) for _ in range(dim))
    X6 = Xg[(slice(None),) + win]
    offs = _stencil_offs(dim)
    cols = []
    for k in range(s):
        sl = tuple(slice(int(o), int(o) + tile) for o in offs[k])
        cols.append(X6[(slice(None),) + sl].reshape(T * tn, c))
    Wmat = jnp.stack(cols, axis=1)                        # (T*tn, s, c)
    Wmat = jnp.concatenate(
        [Wmat, jnp.zeros((1, s, c), Wmat.dtype)], axis=0
    )
    out = Wmat[jnp.minimum(bins.cell_of, T * tn)]         # (n, s, c)
    return out if vec else out[..., 0]


def make_tile_scatter(bins: transfer.CellBins, tgrid: sparse_mod.TileGrid,
                      nbr):
    """Drop-in for transfer.default_scatter on compacted node arrays."""

    def scatter(st: transfer.Stencil, values, _n_nodes: int):
        return tile_binned_scatter(bins, tgrid, nbr, values)

    return scatter


def make_tile_gather(bins: transfer.CellBins, tgrid: sparse_mod.TileGrid,
                     nbr):
    """Drop-in for transfer.default_gather_stencil on compacted arrays."""

    def gather_st(st: transfer.Stencil, grid_vals):
        return tile_window_gather(bins, tgrid, nbr, grid_vals)

    return gather_st
