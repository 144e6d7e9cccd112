"""Block-sparse tile grid: active-tile table + compacted node arrays.

Reference equivalents: the SPGrid-style sparse paged grid of Lib/MPM/MpmGrid
(component #25, SURVEY.md §2.2): a uniform background grid stored sparsely
in 4^dim-node tiles, activated each step by particle stencils.

Design (SURVEY.md §2.4 "sparse paged grid" row and §7 hard
part 2 — dynamic sparsity under jit):
  * active-tile table with STATIC capacity T: tile slot -> flat tile id,
    plus a dense logical-tile -> slot lookup (int32; 2M entries at 512^3 —
    8 MB, cheap). Capacity growth is a host-side recompile, amortized.
  * node data lives in flat (T * tile_nodes + 1, ...) arrays — compacted
    node id = slot * tile_nodes + local id; the final row is a dump slot
    for out-of-capacity/inactive accesses, so every existing transfer
    kernel (hot_mpm.ops.transfer) works unchanged on compacted ids.
  * activation = 2^dim candidate tiles per particle -> jnp.unique with
    static size -> overflow flag (checked host-side after the step).

A particle's quadratic stencil spans at most 2 tiles per axis when
tile >= 3 nodes; we use tile = 4 (64-node tiles in 3D, 16-node in 2D).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hot_mpm.ops import transfer
from hot_mpm.ops.bspline import quadratic_bspline_weights, stencil_offsets, tensor_weights


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TileGrid:
    tile_ids: jax.Array     # (T,) int32 flat logical tile index; pad = n_tiles
    lookup: jax.Array       # (n_tiles,) int32 tile -> slot, -1 inactive
    n_active: jax.Array     # () int32 number of active tiles
    overflow: jax.Array     # () bool — capacity exceeded this build
    # static metadata (aux data — stays Python across jit boundaries)
    res: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    tile: int = dataclasses.field(metadata=dict(static=True))

    def _replace(self, **kw) -> "TileGrid":
        return dataclasses.replace(self, **kw)

    @property
    def dim(self) -> int:
        return len(self.res)

    @property
    def tile_res(self) -> Tuple[int, ...]:
        return tuple(-(-r // self.tile) for r in self.res)

    @property
    def n_tiles_logical(self) -> int:
        n = 1
        for r in self.tile_res:
            n *= r
        return n

    @property
    def capacity(self) -> int:
        return self.tile_ids.shape[0]

    @property
    def tile_nodes(self) -> int:
        return self.tile ** self.dim

    @property
    def n_cnodes(self) -> int:
        """Compacted node-array length INCLUDING the trailing dump slot."""
        return self.capacity * self.tile_nodes + 1

    @property
    def dump(self) -> int:
        return self.capacity * self.tile_nodes


def _tile_strides(tile_res) -> list:
    strides = []
    s = 1
    for r in reversed(tile_res):
        strides.append(s)
        s *= int(r)
    return strides[::-1]


def build_tile_grid(x, dx, res: Tuple[int, ...], capacity: int, tile: int = 4) -> TileGrid:
    """Activate tiles touched by particle stencils (jit-safe, static shapes)."""
    dim = x.shape[-1]
    res = tuple(res)
    tile_res = tuple(-(-r // tile) for r in res)
    n_tiles = 1
    for r in tile_res:
        n_tiles *= r
    base, _, _ = quadratic_bspline_weights(x, dx)
    res_arr = jnp.asarray(res, jnp.int32)
    base = jnp.clip(base, 0, res_arr - 1)
    strides = jnp.asarray(_tile_strides(tile_res), jnp.int32)
    # candidate tiles: stencil corners (base and base+2) per axis
    corners = jnp.stack(
        [jnp.clip(base, 0, res_arr - 1), jnp.clip(base + 2, 0, res_arr - 1)], axis=1
    )  # (n, 2, dim)
    combos = stencil_offsets(dim)[: 2**dim] * 0  # placeholder shape (unused)
    # enumerate the 2^dim corner combinations
    cand = []
    for mask in range(2**dim):
        sel = jnp.asarray([(mask >> a) & 1 for a in range(dim)], jnp.int32)
        corner = corners[:, 0, :] * (1 - sel)[None, :] + corners[:, 1, :] * sel[None, :]
        cand.append(jnp.sum((corner // tile) * strides[None, :], axis=-1))
    cand = jnp.stack(cand, axis=1).reshape(-1)  # (n * 2^dim,)

    tile_ids = jnp.unique(cand, size=capacity, fill_value=n_tiles)
    n_active = jnp.sum(tile_ids < n_tiles)
    # overflow detection: count true distinct among candidates
    sorted_c = jnp.sort(cand)
    distinct = 1 + jnp.sum(sorted_c[1:] != sorted_c[:-1])
    overflow = distinct > capacity

    slots = jnp.arange(capacity, dtype=jnp.int32)
    lookup = jnp.full((n_tiles + 1,), -1, jnp.int32)
    lookup = lookup.at[tile_ids].set(jnp.where(tile_ids < n_tiles, slots, -1))[:n_tiles]
    return TileGrid(
        tile_ids=tile_ids.astype(jnp.int32),
        lookup=lookup,
        n_active=n_active.astype(jnp.int32),
        overflow=overflow,
        res=res,
        tile=tile,
    )


def compact_node_id(grid: TileGrid, coords):
    """Integer node coords (..., dim) -> compacted node ids (dump if inactive)."""
    tile = grid.tile
    tile_res = grid.tile_res
    strides = jnp.asarray(_tile_strides(tile_res), jnp.int32)
    tcoord = coords // tile
    tid = jnp.sum(tcoord * strides, axis=-1)
    slot = grid.lookup[jnp.clip(tid, 0, grid.n_tiles_logical - 1)]
    local = coords - tcoord * tile
    lstr = jnp.asarray([tile ** (grid.dim - 1 - a) for a in range(grid.dim)], jnp.int32)
    lid = jnp.sum(local * lstr, axis=-1)
    out = slot * grid.tile_nodes + lid
    return jnp.where(slot >= 0, out, grid.dump)


def sparse_stencil(x, dx, grid: TileGrid,
                   weights_impl: str = "broadcast") -> transfer.Stencil:
    """Particle stencil with COMPACTED node ids (drop-in for transfer ops)."""
    dim = x.shape[-1]
    base, w, dw = quadratic_bspline_weights(x, dx)
    wn, gwn = tensor_weights(w, dw, impl=weights_impl)
    offs = stencil_offsets(dim)
    res_arr = jnp.asarray(grid.res, jnp.int32)
    coords = jnp.clip(base[:, None, :] + offs[None, :, :], 0, res_arr - 1)
    node_ids = compact_node_id(grid, coords)
    rel = coords.astype(x.dtype) * dx - x[:, None, :]
    return transfer.Stencil(node_ids=node_ids, wn=wn, gwn=gwn, rel=rel)


def node_positions(grid: TileGrid, dx, dtype=jnp.float32):
    """(n_cnodes, dim) physical positions of compacted nodes (dump slot gets
    an out-of-domain position so colliders never constrain it)."""
    dim = grid.dim
    tile = grid.tile
    tile_res = grid.tile_res
    strides = _tile_strides(tile_res)
    slots = jnp.minimum(grid.tile_ids, grid.n_tiles_logical - 1)
    tcoords = []
    rem = slots
    for k in range(dim):
        c = rem // strides[k]
        rem = rem - c * strides[k]
        tcoords.append(c)
    tcoord = jnp.stack(tcoords, axis=-1)                       # (T, dim)
    local = stencil_offsets(dim) * 0  # placeholder
    lr = jnp.arange(tile)
    mesh = jnp.meshgrid(*([lr] * dim), indexing="ij")
    local = jnp.stack([m.reshape(-1) for m in mesh], axis=-1)  # (tile_nodes, dim)
    coords = tcoord[:, None, :] * tile + local[None, :, :]     # (T, tn, dim)
    pos = coords.reshape(-1, dim).astype(dtype) * dx
    # invalid tiles + dump slot: push far outside the domain
    valid = (grid.tile_ids < grid.n_tiles_logical)[:, None]
    valid = jnp.broadcast_to(valid, (grid.capacity, grid.tile_nodes)).reshape(-1)
    far = jnp.asarray([1e9] * dim, dtype)
    pos = jnp.where(valid[:, None], pos, far[None, :])
    return jnp.concatenate([pos, far[None, :]], axis=0)        # + dump row


def compact_to_dense(grid: TileGrid, v, fill=0.0):
    """Scatter compacted node values back to the dense logical grid (debug/IO)."""
    n_nodes = transfer.n_nodes_of(grid.res)
    dim = grid.dim
    tile = grid.tile
    # positions of every compacted node -> flat dense ids
    pos = node_positions(grid, 1.0, jnp.float32)[:-1]
    coords = jnp.clip(pos.astype(jnp.int32), 0, jnp.asarray(grid.res, jnp.int32) - 1)
    strides = []
    s = 1
    for r in reversed(grid.res):
        strides.append(s)
        s *= int(r)
    strides = jnp.asarray(strides[::-1], jnp.int32)
    ids = jnp.sum(coords * strides[None, :], axis=-1)
    valid = jnp.all(pos < 1e8, axis=-1)
    ids = jnp.where(valid, ids, n_nodes)
    out = jnp.full((n_nodes + 1,) + v.shape[1:], fill, v.dtype)
    return out.at[ids].set(v[:-1])[:n_nodes]
