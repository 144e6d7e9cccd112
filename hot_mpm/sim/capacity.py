"""One host-side capacity planner for every static device table.

The step program is traced with STATIC capacities (SURVEY.md §7 hard-part
2: dynamic sparsity under jit -> capacity-padded tables, recompile only on
growth). Six device tables need a capacity: particle bins, per-MG-level
tile grids, the explicit-BSR tile rows, the dense coarse factor's active
rows, per-MG-level particle bins, and the composed-Galerkin bins. Round
1-3 grew six parallel `_choose_*` methods on Simulation, each re-deriving
"count the occupancy of the current particle layout at some grid spacing
and pad it" with its own gate and its own regrow bumps (VERDICT r3 weak
#6). This module is the single replacement: one table of cap kinds, one
occupancy probe, one grow/regrow policy.

Every planner output is either None (the table is not used under this
config) or a structure of python ints, consumed as static args by
`advance_one_step` (sim/simulation.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Static capacities for one compiled step program (None = unused)."""
    bin_caps: Optional[Tuple[int, int]] = None        # (cells_cap, per-cell)
    mg_tile_caps: Optional[Tuple[int, ...]] = None    # per-level tile count
    bsr_tile_cap: Optional[int] = None                # explicit-outer tiles
    mg_coarse_cap: Optional[int] = None               # coarse-factor rows
    mg_bin_caps: Optional[Tuple[Tuple[int, int], ...]] = None
    mg_composed_caps: Optional[Tuple[int, int]] = None
    # composed-Galerkin NODE bins (cells with >=1 ACTIVE fine node, nodes
    # per cell): the full extended coarse grid is ~34x the active count at
    # 128^3 (287k vs ~8k cells), so the mass part's (cells, sm, sm) Gram
    # blocks are sized by active cells.
    mg_ncomposed_caps: Optional[Tuple[int, int]] = None


# ---------------------------------------------------------------- probes

def _base_nodes(x: np.ndarray, res: np.ndarray, dx: float) -> np.ndarray:
    """Quadratic-stencil base node of each particle, clipped to the grid."""
    return np.clip(np.floor(x / dx - 0.5).astype(np.int64), 0, res - 1)


def _strides(res: np.ndarray) -> np.ndarray:
    return np.concatenate([np.cumprod(res[::-1])[::-1][1:], [1]])


def cell_occupancy(x: np.ndarray, res: np.ndarray, dx: float
                   ) -> Tuple[int, int]:
    """(#occupied base cells, max particles in one cell) at spacing dx."""
    base = _base_nodes(x, res, dx)
    cells = (base * _strides(res)).sum(axis=1)
    uniq, counts = np.unique(cells, return_counts=True)
    return len(uniq), int(counts.max())


def tile_count(x: np.ndarray, res: np.ndarray, dx: float, dim: int,
               tile: int = 4) -> int:
    """Active-tile count at spacing dx (mirrors grid.sparse.build_tile_grid's
    activation: tiles touched by any clipped stencil corner)."""
    tile_res = -(-res // tile)
    strides = _strides(tile_res)
    base = _base_nodes(x, res, dx)
    tids = []
    for mask in range(2 ** dim):
        sel = np.array([(mask >> a) & 1 for a in range(dim)])
        corner = np.clip(base + 2 * sel[None, :], 0, res - 1)
        tids.append(((corner // tile) * strides).sum(axis=1))
    return len(np.unique(np.concatenate(tids)))


def active_node_count(x: np.ndarray, res: np.ndarray, dx: float,
                      dim: int) -> int:
    """#grid nodes touched by any 3-wide quadratic stencil at spacing dx."""
    base = _base_nodes(x, res, dx)
    strides = _strides(res)
    offs = np.stack(np.meshgrid(*([np.arange(3)] * dim), indexing="ij"),
                    -1).reshape(-1, dim)
    ids = [(np.clip(base + off, 0, res - 1) * strides).sum(axis=1)
           for off in offs]
    return len(np.unique(np.concatenate(ids)))


def _level_geometry(cfg, level: int):
    """(res, dx) of MG level `level` (level 0 = the fine grid)."""
    res = np.asarray(cfg.grid_res[:cfg.dim], np.int64)
    dx = cfg.dx
    for _ in range(level):
        res = (res + 1) // 2
        dx = dx * 2.0
    return res, dx


# ---------------------------------------------------------------- planner

def _binned_transfers(cfg) -> bool:
    """Cell bins are planned when transfer_impl asks for them, and always
    for assembled multigrid on the dense grid: its levels assemble through
    the scatter-free mode form (ops.bsr.assemble_hessian_modes), while the
    scatter form materialises (n, 3^dim, 3^dim, d, d) per-particle blocks
    — about 59 GB at 128^3 with 416k particles."""
    if cfg.transfer_kernel != "quadratic":
        return False
    mgc = cfg.solver.multigrid
    assembled_mg = (cfg.solver.preconditioner == "multigrid"
                    and mgc.assembled and cfg.grid_backend == "dense")
    return cfg.transfer_impl == "binned" or assembled_mg


def _per_cell_cap(per_cell: int, grow: float) -> int:
    """Per-cell bin capacity: 25% headroom over the fullest cell.

    Cells gain particles as a compressed body packs. On the 128^3
    twisting bar from `scenes.stress_state`, the level-2 MG cells outgrow
    an exact fit (+1) on the second step; the regrow recompiles the whole
    assembled-MG step (96 s on an H100 80GB HBM3, 700 W) and grow_plan
    leaves every cap >=25% larger. The headroom costs about 2% of that
    step (0.608 vs 0.598 s for the first step, same card)."""
    return int(math.ceil(grow * (1.25 * per_cell + 1)))


def plan_capacities(cfg, x, grow: float = 1.0) -> CapacityPlan:
    """Size every static table from the CURRENT particle layout.

    Deliberately tight: padded slots multiply per-slot work (the
    docs/KERNEL_PLAN.md "padding tax"), so caps hug measured occupancy
    plus small headroom and the step regrows + recompiles on overflow.
    """
    x = np.asarray(x)
    dim = cfg.dim
    sol = cfg.solver
    mgc = sol.multigrid
    mg_on = sol.preconditioner == "multigrid"
    plan = {}

    if _binned_transfers(cfg):
        res0, dx0 = _level_geometry(cfg, 0)
        n_cells, per_cell = cell_occupancy(x, res0, dx0)
        plan["bin_caps"] = (
            cfg.bin_cells_capacity or int(grow * (1.15 * n_cells + 16)),
            cfg.bin_cap or _per_cell_cap(per_cell, grow),
        )

    if mg_on and mgc.assembled:
        # per-level tile capacities for assembled levels (level 0 itself
        # uses cfg.tile_capacity under the sparse backend)
        caps = []
        for lvl in range(mgc.levels):
            res, dx = _level_geometry(cfg, lvl)
            caps.append(int(math.ceil(
                grow * (1.2 * tile_count(x, res, dx, dim) + 8))))
        plan["mg_tile_caps"] = tuple(caps)

    if mg_on and plan.get("bin_caps") is not None:
        # EXACT per-level bins (the shift heuristic in build_static
        # inflates padded slots ~10x once the coarse cell count floors)
        caps = []
        for lvl in range(mgc.levels):
            res, dx = _level_geometry(cfg, lvl)
            n_cells, per_cell = cell_occupancy(x, res, dx)
            caps.append((int(grow * (1.15 * n_cells + 16)),
                         _per_cell_cap(per_cell, grow)))
        plan["mg_bin_caps"] = tuple(caps)

    if mg_on and mgc.coarse_solver == "direct" and mgc.coarse_capacity is None:
        # the dense coarse factor costs (cap*d)^2 — sizing by ACTIVE
        # coarsest rows (not the whole coarse grid) is what keeps deep
        # hierarchies from OOMing (604 MB at a full 16^3 coarsest)
        res, dx = _level_geometry(cfg, mgc.levels - 1)
        count = active_node_count(x, res, dx, dim)
        plan["mg_coarse_cap"] = int(math.ceil(grow * (1.2 * count + 16)))

    if mg_on and mgc.assembled and mgc.assembled_from_level > 0 \
            and mgc.coarsening == "galerkin":
        from hot_mpm.ops import composed as comp_mod

        L = mgc.assembled_from_level
        res_L, _ = _level_geometry(cfg, L)
        plan["mg_composed_caps"] = comp_mod.composed_bin_caps_host(
            x, cfg.dx, L, tuple(int(r) for r in res_L), dim, grow=grow)
        plan["mg_ncomposed_caps"] = composed_node_cells(
            x, cfg, L, tuple(int(r) for r in res_L), grow=grow)

    if not sol.matrix_free and cfg.grid_backend == "dense":
        res0, dx0 = _level_geometry(cfg, 0)
        plan["bsr_tile_cap"] = int(math.ceil(
            grow * (1.2 * tile_count(x, res0, dx0, dim) + 8)))

    return CapacityPlan(**plan)


def composed_node_cells(x, cfg, L: int, res_L, grow: float = 1.0
                        ) -> Tuple[int, int]:
    """(active composed-node cells, nodes per cell) for the mass half of
    the composed-Galerkin assembly: cells of the level-L EXT grid holding
    >=1 ACTIVE fine node (nodes touched by any particle stencil — a
    superset of the mass>0 nodes binned on device, so the cap is safe).
    Nodes per cell is exactly 2^(dim*L) (each coarse cell owns that many
    fine embedding bases)."""
    x = np.asarray(x)
    dim = cfg.dim
    res0 = np.asarray(cfg.grid_res[:dim], np.int64)
    base = _base_nodes(x, res0, cfg.dx)
    strides = _strides(res0)
    offs = np.stack(np.meshgrid(*([np.arange(3)] * dim), indexing="ij"),
                    -1).reshape(-1, dim)
    ids = np.unique(np.concatenate(
        [(np.clip(base + off, 0, res0 - 1) * strides).sum(axis=1)
         for off in offs]))
    coords = np.stack(
        [ids // strides[a] % res0[a] for a in range(dim)], axis=-1)
    for _ in range(L):
        coords = (coords - 1) >> 1
    key = np.zeros(coords.shape[0], np.int64)
    for a in range(dim):
        key = key * (int(res_L[a]) + 2) + np.clip(coords[:, a] + 1, 0,
                                                  int(res_L[a]) + 1)
    n_cells = len(np.unique(key))
    return (int(grow * (1.15 * n_cells + 16)), 2 ** (dim * L))


# ------------------------------------------------------------------ grow

def _grow_leaf(fresh: int, old: int) -> int:
    """The single regrow rule: take the freshly measured need but never
    shrink — bump the old cap by >=25% (+2) so the retried step cannot
    overflow on the same layout again."""
    return max(int(fresh), int(math.ceil(old * 1.25)) + 2)


def grow_plan(fresh: CapacityPlan, old: CapacityPlan) -> CapacityPlan:
    """Merge a fresh (grow>1) measurement into the overflowed plan,
    leafwise, with one growth rule for every kind."""
    merged = {}
    for f in dataclasses.fields(CapacityPlan):
        fv = getattr(fresh, f.name)
        ov = getattr(old, f.name)
        if ov is None:                 # table unused under this config
            merged[f.name] = None
        elif fv is None:               # config gate flipped? keep old grown
            merged[f.name] = _map_leaves(_grow_leaf, ov, ov)
        else:
            merged[f.name] = _map_leaves(_grow_leaf, fv, ov)
    return CapacityPlan(**merged)


def _map_leaves(fn, a, b):
    if isinstance(a, tuple):
        return tuple(_map_leaves(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)
