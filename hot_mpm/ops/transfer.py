"""Particle <-> grid transfer operators (P2G scatter, G2P gather).

Reference equivalents: the P2G/G2P kernels inside Lib/MPM/MpmSimulationBase
(component #26, SURVEY.md §2.2) — OpenMP scatter with block coloring. Here
there is no coloring: scatters are expressed as XLA scatter-adds over a
dense logical grid, batched across all particles and all 3^dim stencil
nodes at once (sequential on the CPU; atomic, so summed in no fixed order,
on the GPU). The cell-binned forms below (CellBins) and the sparse tile
path (hot_mpm.ops.tile_transfer) are scatter-free alternatives.

All operators take a *flattened* dense grid of shape (n_nodes, ...) plus a
precomputed per-particle `Stencil` (node ids, tensor weights, node-particle
offsets); this keeps one code path for 2D/3D and lets the implicit solver
reuse the same stencil for its force/Hessian scatters (reference:
FBasedMpmForceHelper, component #27).

Out-of-domain stencil nodes are clipped to the boundary; callers must keep
particles at least one cell inside the domain (the sim enforces this via
collision objects, as the reference does).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hot_mpm.ops.bspline import (
    bspline_weights,
    kernel_width,
    quadratic_bspline_weights,
    stencil_offsets,
    tensor_weights,
)


class Stencil(NamedTuple):
    """Per-particle quadratic-B-spline stencil against a dense flat grid."""

    node_ids: jnp.ndarray  # (n, 3^dim) int32 flat node indices (row-major)
    wn: jnp.ndarray        # (n, 3^dim) interpolation weights
    gwn: jnp.ndarray       # (n, 3^dim, dim) weight gradients (1/dx units)
    rel: jnp.ndarray       # (n, 3^dim, dim) node_pos - particle_pos


class CellBins(NamedTuple):
    """Particles binned by base cell — the scatter-free transfer path.

    A scatter-add with COLLIDING indices was serialized by the compiler
    this path was first built for (docs/KERNEL_PLAN.md "Dynamic
    indexing"). This path mirrors the reference's block-binned scatter
    (component #26's coloring) without any colliding write:

      1. once per step, sort particles into per-active-cell bins
         (compacted table, static capacities);
      2. every stencil scatter becomes: gather values by bin -> sum over
         bin slots -> 3^dim scatter-adds with UNIQUE, SORTED indices
         (one per active cell), which XLA parallelizes.

    Collision-free by construction — the analog of the reference's
    scatter coloring (SURVEY.md §5.2).
    """

    active_cells: jnp.ndarray  # (cells_cap,) int32 sorted flat cell ids; pad = n_cells
    p_cell: jnp.ndarray        # (cells_cap, cap) int32 particle idx; pad = n
    slot_of: jnp.ndarray       # (n,) int32 cell_slot * cap + pos; dump if over cap
    cell_of: jnp.ndarray       # (n,) int32 flat base-cell id per particle
    overflow: jnp.ndarray      # () bool — cell count or per-cell cap exceeded


def bin_particles(x, dx, res: Tuple[int, ...], cells_cap: int, cap: int,
                  valid=None) -> CellBins:
    """Bin by base-node cell (jit-safe, static shapes; dense grids only).

    valid: optional (n,) bool — particles with valid == False (e.g. the
    zero-mass padding slots of the sharded step, which all sit at the slab
    center and would otherwise pile into ONE cell) are routed straight to
    the dump slot: they consume no cell entry, no per-cell cap, and never
    trigger the overflow flag.
    """
    base, _, _ = quadratic_bspline_weights(x, dx)
    res_arr = jnp.asarray(res, jnp.int32)
    base = jnp.clip(base, 0, res_arr[None, :] - 1)
    strides = _row_major_strides(res)
    cell = jnp.sum(base * strides[None, :], axis=-1)
    return bin_by_ids(cell, n_nodes_of(res), cells_cap, cap, valid=valid)


def bin_by_ids(cell, n_cells: int, cells_cap: int, cap: int,
               valid=None) -> CellBins:
    """Core binning table from precomputed per-particle cell ids in
    [0, n_cells) (n_cells acts as the invalid/dump sentinel) — shared by
    the dense path above and the sparse tile path (ops.tile_transfer)."""
    n = cell.shape[0]
    if valid is not None:
        # invalid particles get the out-of-range sentinel cell: it sorts
        # LAST, so real cells always win the unique() table slots
        cell = jnp.where(valid, cell, n_cells)

    active_cells = jnp.unique(cell, size=cells_cap, fill_value=n_cells)
    sorted_cell = jnp.sort(cell)
    distinct = 1 + jnp.sum(sorted_cell[1:] != sorted_cell[:-1])
    if valid is not None:
        # the sentinel cell is not a real cell: mask it from the distinct
        # count (in active_cells it equals the fill value, so downstream
        # kernels already treat its slot as padding)
        distinct = distinct - jnp.any(~valid).astype(distinct.dtype)
    overflow_cells = distinct > cells_cap

    order = jnp.argsort(cell)
    cell_sorted = cell[order]
    valid_sorted = (cell_sorted < n_cells) if valid is not None else None
    # slot of each particle's cell in the compacted table
    cslot = jnp.searchsorted(active_cells, cell_sorted)
    cslot = jnp.clip(cslot, 0, cells_cap - 1)
    pos = jnp.arange(n) - jnp.searchsorted(cell_sorted, cell_sorted, side="left")
    over_cap = pos >= cap
    if valid_sorted is not None:
        over_cap = jnp.logical_and(over_cap, valid_sorted)
    overflow = jnp.logical_or(overflow_cells, jnp.any(over_cap))
    slot = cslot * cap + jnp.minimum(pos, cap - 1)
    keep = pos < cap
    if valid_sorted is not None:
        keep = jnp.logical_and(keep, valid_sorted)
    slot = jnp.where(keep, slot, cells_cap * cap)
    p_cell = jnp.full((cells_cap * cap + 1,), n, jnp.int32)
    p_cell = p_cell.at[slot].set(order.astype(jnp.int32))[:-1].reshape(cells_cap, cap)
    # inverse: slot of each particle (in original particle order)
    slot_of = jnp.full((n + 1,), cells_cap * cap, jnp.int32)
    slot_of = slot_of.at[jnp.minimum(order, n - 1)].set(slot.astype(jnp.int32))[:n]
    return CellBins(
        active_cells=active_cells.astype(jnp.int32),
        p_cell=p_cell,
        slot_of=slot_of,
        cell_of=cell.astype(jnp.int32),
        overflow=overflow,
    )


def _static_offsets(res: Tuple[int, ...]):
    """(3^dim, dim) numpy stencil offsets + flat strides as Python ints."""
    import numpy as _np

    dim = len(res)
    strides_py = []
    sacc = 1
    for r in reversed(res):
        strides_py.append(sacc)
        sacc *= int(r)
    strides_py = strides_py[::-1]
    offs = _np.stack(
        _np.meshgrid(*([_np.arange(3)] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    off_flat = (offs * _np.asarray(strides_py)).sum(axis=1)
    return offs, off_flat, strides_py


def binned_scatter(bins: CellBins, values, res: Tuple[int, ...]):
    """Stencil scatter with latency-friendly memory ops:
      1. ONE unique-index row scatter of per-particle contributions into
         padded (cell, slot) order;
      2. slot reduction;
      3. ONE unique sorted-index scatter of per-cell sums to the dense
         cell grid;
      4. 3^dim STATIC shifted-slice adds (fully regular).
    Two dynamic-indexed ops in total instead of 27 small scatters
    (docs/KERNEL_PLAN.md "Dynamic indexing"). Equivalent to scatter_sum(st.node_ids, ...) for
    particles one cell inside the domain (the sim's invariant).
    """
    dim = len(res)
    s = 3**dim
    vec = values.ndim == 3
    c = values.shape[2] if vec else 1
    if c > dim:
        # chunk wide channel counts (see tile_transfer.tile_binned_scatter:
        # the slot buffer scales with s*c — 9-channel block-diag scatters
        # at large n want dim-channel chunks so XLA reuses one small temp)
        outs = [
            binned_scatter(bins, values[:, :, i:i + dim], res)
            for i in range(0, c, dim)
        ]
        return jnp.concatenate(outs, axis=-1)
    vals = (values if vec else values[:, :, None]).reshape(-1, s * c)
    n = vals.shape[0]
    cells_cap, cap = bins.p_cell.shape

    # 1. per-slot placement (unique rows)
    slots = jnp.zeros((cells_cap * cap + 1, s * c), vals.dtype)
    slots = slots.at[bins.slot_of].set(vals, unique_indices=True)[:-1]
    # 2. reduce over slots
    S = jnp.sum(slots.reshape(cells_cap, cap, s * c), axis=1)
    out = _cells_to_grid(bins, S, res, s, c)
    return out if vec else out[:, 0]


def _cells_to_grid(bins: CellBins, S, res: Tuple[int, ...], s: int, c: int):
    """Per-cell stencil sums S (cells_cap, s*c) -> dense grid (n_cells, c):
    ONE sorted-unique row scatter + 3^dim static shifted adds.

    The shifted adds run in COMPONENT-LEADING layout ((c,) + res, lanes =
    res[-1]): the earlier (res..., s, c) form sliced trailing-dim-c
    arrays (docs/KERNEL_PLAN.md "Tiny trailing dims"); the CL form's adds
    are fully regular."""
    n_cells = n_nodes_of(res)
    S_grid = jnp.zeros((n_cells + 1, s * c), S.dtype)
    S_grid = S_grid.at[bins.active_cells].set(
        S, indices_are_sorted=True, unique_indices=True
    )[:n_cells]
    offs, off_flat, _ = _static_offsets(res)
    S_cl = S_grid.T.reshape((s, c) + tuple(res))       # one big transpose
    grid = jnp.zeros((c,) + tuple(res), S.dtype)
    for k in range(s):
        off = tuple(int(o) for o in offs[k])
        src = S_cl[k][(slice(None),) + tuple(
            slice(0, r - o) for r, o in zip(res, off))]
        dst = (slice(None),) + tuple(slice(o, r) for r, o in zip(res, off))
        grid = grid.at[dst].add(src)
    return grid.reshape(c, n_cells).T


def _grid_windows_flat(grid_vals, res: Tuple[int, ...], impl: str = "stack"):
    """(n_nodes[, c]) -> (n_cells, 3^dim * c) stencil windows in k-major
    FLAT layout, all static shifts: col k*c + a = component a of the grid
    value at node (cell + offset_k).

    Two forms: impl="stack" (c-minor shifted planes, the default) and
    impl="cl" (component-leading), which the mode apply's power-iteration
    and smoother loops use. Each was chosen for the compile memory of its
    consumer on the code's first target; neither choice has
    been re-measured on the GPU."""
    vec = grid_vals.ndim == 2
    c = grid_vals.shape[1] if vec else 1
    dim = len(res)
    s = 3**dim
    offs, _, _ = _static_offsets(res)
    if impl == "cl":
        gT = (grid_vals.T if vec
              else grid_vals[None]).reshape((c,) + tuple(res))
        win = []
        for k in range(s):
            off = tuple(int(o) for o in offs[k])
            src = gT[(slice(None),) + tuple(slice(o, None) for o in off)]
            pad = [(0, 0)] + [(0, int(o)) for o in off]
            win.append(jnp.pad(src, pad).reshape(c, -1))  # (c, n_cells)
        Wcl = jnp.concatenate(win, axis=0)                # (s*c, n_cells)
        return Wcl.T                                      # k-major cols
    g = (grid_vals if vec else grid_vals[:, None]).reshape(tuple(res) + (c,))
    win = []
    for k in range(s):
        off = tuple(int(o) for o in offs[k])
        src = g[tuple(slice(o, None) for o in off)]
        pad = [(0, int(o)) for o in off] + [(0, 0)]
        win.append(jnp.pad(src, pad))
    return jnp.stack(win, axis=-2).reshape(-1, s * c)


def _grid_windows(grid_vals, res: Tuple[int, ...]):
    """(n_nodes[, c]) -> (n_cells, 3^dim, c) stencil windows (split view
    of the flat form — SPLIT reshapes are the layout-safe direction)."""
    vec = grid_vals.ndim == 2
    c = grid_vals.shape[1] if vec else 1
    s = 3 ** len(res)
    return _grid_windows_flat(grid_vals, res).reshape(-1, s, c)


def window_gather(bins: CellBins, grid_vals, res: Tuple[int, ...]):
    """Stencil gather via 3^dim STATIC shifts + ONE row gather per particle.

    Returns (n, 3^dim[, c]) — equivalent to grid_vals[st.node_ids] but with
    a single dynamic-indexed op (the per-particle row lookup) instead of a
    1.4M-tiny-row gather at 64^3.
    """
    vec = grid_vals.ndim == 2
    c = grid_vals.shape[1] if vec else 1
    s = 3 ** len(res)
    out = window_gather_flat(bins, grid_vals, res).reshape(-1, s, c)
    return out if vec else out[..., 0]


def window_gather_flat(bins: CellBins, grid_vals, res: Tuple[int, ...],
                       impl: str = "stack", fence: bool = False):
    """Flat-layout stencil gather: (n_nodes[, c]) -> (n, 3^dim * c),
    k-major. The per-particle row gather runs on (n_cells, s*c) FLAT rows
    rather than (n_cells, s, c) rows (docs/KERNEL_PLAN.md "Tiny trailing
    dims").
    """
    vec = grid_vals.ndim == 2
    c = grid_vals.shape[1] if vec else 1
    s = 3 ** len(res)
    W = _grid_windows_flat(grid_vals, res, impl=impl)
    if fence:
        # materialize the windows ONCE per surrounding loop iteration:
        # inside smoother/power-iteration loops XLA may rematerialize the
        # window build per consumer use and keep the clones live at once;
        # the barrier pins one (n_cells, s*c) materialization
        W = barrier(W)
    return W[bins.cell_of]                           # (n, s*c) row gather


def binned_scatter_flat(bins: CellBins, vals_flat, res: Tuple[int, ...],
                        c: int):
    """binned_scatter for K-MAJOR FLAT values (n, 3^dim * c) -> (n_cells, c)
    (or (n_cells,) when c == 1) without reshaping through (n, 3^dim, c)."""
    dim = len(res)
    s = 3**dim
    n = vals_flat.shape[0]
    cells_cap, cap = bins.p_cell.shape
    slots = jnp.zeros((cells_cap * cap + 1, s * c), vals_flat.dtype)
    slots = slots.at[bins.slot_of].set(vals_flat, unique_indices=True)[:-1]
    S = jnp.sum(slots.reshape(cells_cap, cap, s * c), axis=1)
    out = _cells_to_grid(bins, S, res, s, c)
    return out if c > 1 else out[:, 0]


def particle_stencil(x, dx, res: Tuple[int, ...],
                     kernel: str = "quadratic",
                     weights_impl: str = "broadcast") -> Stencil:
    """Build the transfer stencil for particle positions x: (n, dim).

    kernel: "quadratic" (3-wide, HOT's default) or "cubic" (4-wide,
    reference component #13's second kernel family). All downstream
    scatter/gather/objective code is width-generic; the binned/slot-major
    fast paths assume quadratic and are bypassed for cubic.
    weights_impl: pass "flat" when the stencil is MATERIALIZED whole (MG
    node-embedding over every fine grid node) — see bspline.tensor_weights.
    """
    dim = x.shape[-1]
    base, w, dw = bspline_weights(x, dx, kernel)
    wn, gwn = tensor_weights(w, dw, impl=weights_impl)
    offs = stencil_offsets(dim, kernel_width(kernel))  # (S^dim, dim)
    coords = base[:, None, :] + offs[None, :, :]       # (n, 3^dim, dim)
    res_arr = jnp.asarray(res, dtype=jnp.int32)
    coords = jnp.clip(coords, 0, res_arr[None, None, :] - 1)
    strides = _row_major_strides(res)
    node_ids = jnp.sum(coords * strides[None, None, :], axis=-1)
    rel = coords.astype(x.dtype) * dx - x[:, None, :]
    return Stencil(node_ids=node_ids, wn=wn, gwn=gwn, rel=rel)


def _row_major_strides(res) -> jnp.ndarray:
    strides = []
    s = 1
    for r in reversed(res):
        strides.append(s)
        s *= int(r)
    return jnp.asarray(strides[::-1], dtype=jnp.int32)


def n_nodes_of(res) -> int:
    n = 1
    for r in res:
        n *= int(r)
    return n


def unravel(node_ids, res):
    """Flat row-major ids -> integer coords (..., dim)."""
    strides = _row_major_strides(res)
    coords = []
    rem = node_ids
    for k in range(len(res)):
        c = rem // strides[k]
        rem = rem - c * strides[k]
        coords.append(c)
    return jnp.stack(coords, axis=-1)


def node_positions(res, dx, dtype=jnp.float32):
    """(n_nodes, dim) physical positions of all grid nodes (node i at i*dx)."""
    ids = jnp.arange(n_nodes_of(res), dtype=jnp.int32)
    return unravel(ids, res).astype(dtype) * dx


def scatter_sum(node_ids, values, n_nodes: int):
    """Sum per-(particle, stencil-node) values onto flat grid nodes.

    values: (n, 3^dim) or (n, 3^dim, c) -> (n_nodes,) or (n_nodes, c).
    XLA lowers .at[].add to a scatter-add: sequential on the CPU, atomic
    (summed in no fixed order) on the GPU.
    """
    flat_ids = node_ids.reshape(-1)
    flat_vals = values.reshape((flat_ids.shape[0],) + values.shape[node_ids.ndim:])
    zeros = jnp.zeros((n_nodes,) + flat_vals.shape[1:], dtype=values.dtype)
    return zeros.at[flat_ids].add(flat_vals)


def gather(grid_vals, node_ids):
    """Gather per-stencil-node grid values: (n_nodes, ...) -> (n, 3^dim, ...)."""
    return grid_vals[node_ids]


def barrier(x):
    """Materialization fence. XLA may fuse a gather into each of its
    consumers and RE-EXECUTE it per consumer use; a barrier after
    gather-reductions and before bin-gathers restores the
    materialize-once behavior."""
    return jax.lax.optimization_barrier(x)


# ---------------------------------------------------------------------------
# scatter dispatch: plain scatter-add vs binned scatter-free path
# ---------------------------------------------------------------------------


def default_scatter(st: Stencil, values, n_nodes: int):
    return scatter_sum(st.node_ids, values, n_nodes)


def default_gather_stencil(st: Stencil, grid_vals):
    return gather(grid_vals, st.node_ids)


def make_binned_scatter(bins: CellBins, res: Tuple[int, ...]):
    """Stencil-scatter closure using the cell-binned low-latency path.
    Only valid for stencils of the particles `bins` was built from."""

    def scatter(st: Stencil, values, n_nodes: int):
        return binned_scatter(bins, values, res)

    return scatter


def make_binned_gather(bins: CellBins, res: Tuple[int, ...]):
    """Stencil-gather closure using the shifted-window path."""

    def gather_st(st: Stencil, grid_vals):
        return window_gather(bins, grid_vals, res)

    return gather_st


# ---------------------------------------------------------------------------
# slot-major layout: the zero-dynamic-indexing transfer path
# ---------------------------------------------------------------------------
#
# docs/KERNEL_PLAN.md "slot-major" design: per-particle SOLVE-time arrays are
# permuted ONCE per step into (cells_cap * cap, ...) slot order — slot
# s belongs to compacted active cell s // cap. Consequences, per Hessian
# apply / residual (the ops run ~40x per step inside Newton/CG):
#   * stencil gather  = static windows + ONE sorted-unique row gather of
#     cells_cap rows (vs one n-row gather per apply);
#   * stencil scatter = regular reshape-sum over slots + ONE sorted-unique
#     row scatter of cells_cap rows (vs an n-row set + cell set per apply);
# i.e. exactly one latency-bound op per direction, on ~4x fewer rows.
# Padding slots carry zero weights/volume so they contribute nothing.


def slot_order(bins: CellBins, arrays):
    """Permute per-particle arrays into slot-major order with ONE gather.

    arrays: list of (n, ...) same-dtype arrays. Returns (slot_arrays, valid)
    where each slot array is (cells_cap * cap, ...) and valid marks real
    (non-padding) slots. Padding rows are zero.
    """
    n = arrays[0].shape[0]
    parr = bins.p_cell.reshape(-1)                    # (N_slots,) pad = n
    flats = [a.reshape(n, -1) for a in arrays]
    packed = jnp.concatenate(flats, axis=1)
    packed = jnp.concatenate(
        [packed, jnp.zeros((1, packed.shape[1]), packed.dtype)], axis=0
    )
    rows = packed[parr]                               # ONE row gather
    rows = barrier(rows)
    out = []
    ofs = 0
    for a, f in zip(arrays, flats):
        w = f.shape[1]
        out.append(rows[:, ofs:ofs + w].reshape((parr.shape[0],) + a.shape[1:]))
        ofs += w
    return out, parr < n


def particle_order(bins: CellBins, arrays, n: int):
    """Inverse of slot_order for same-dtype arrays (ONE gather): slot-major
    (N_slots, ...) -> per-particle (n, ...) via slot_of."""
    flats = [a.reshape(a.shape[0], -1) for a in arrays]
    packed = jnp.concatenate(flats, axis=1)
    packed = jnp.concatenate(
        [packed, jnp.zeros((1, packed.shape[1]), packed.dtype)], axis=0
    )
    rows = packed[bins.slot_of]                       # (n, Ctot)
    rows = barrier(rows)
    out = []
    ofs = 0
    for a, f in zip(arrays, flats):
        w = f.shape[1]
        out.append(rows[:, ofs:ofs + w].reshape((n,) + a.shape[1:]))
        ofs += w
    return out


def make_slot_scatter(bins: CellBins, res: Tuple[int, ...]):
    """Stencil-scatter closure for SLOT-MAJOR values (N_slots, s[, c])."""
    cells_cap, cap = bins.p_cell.shape

    def scatter(st: Stencil, values, n_nodes: int):
        vec = values.ndim == 3
        s = values.shape[1]
        c = values.shape[2] if vec else 1
        vals = values.reshape(cells_cap, cap, s * c)
        S = jnp.sum(vals, axis=1)                     # regular reduction
        out = _cells_to_grid(bins, S, res, s, c)
        return out if vec else out[:, 0]

    return scatter


def make_slot_gather(bins: CellBins, res: Tuple[int, ...]):
    """Stencil-gather closure returning SLOT-MAJOR (N_slots, s[, c])."""
    cells_cap, cap = bins.p_cell.shape

    def gather_st(st: Stencil, grid_vals):
        vec = grid_vals.ndim == 2
        W = _grid_windows(grid_vals, res)             # (n_cells, s, c)
        rows = W[bins.active_cells]                   # sorted-unique gather
        rows = barrier(rows)
        out = jnp.broadcast_to(
            rows[:, None], (cells_cap, cap) + rows.shape[1:]
        ).reshape((cells_cap * cap,) + rows.shape[1:])
        return out if vec else out[..., 0]

    return gather_st


# ---------------------------------------------------------------------------
# MPM-specific transfers
# ---------------------------------------------------------------------------


def p2g_mass_momentum(st: Stencil, v, C, m, n_nodes: int, scatter=default_scatter):
    """APIC P2G: scatter mass and momentum (with affine term) to the grid.

    momentum_i = sum_p w_ip m_p (v_p + C_p (x_i - x_p))
    Reference: particlesToGrid (components #24/#26).

    FLAT column form: both the einsum and the batched-matmul spellings of
    the affine term leave an (n, d, s, d) broadcast temp (XLA
    strength-reduces small dots back to broadcast-multiply-reduce).
    Strided column slices keep every intermediate (n, s)-shaped.
    """
    mw, mv_vals = apic_momentum_vals(st, v, C, m)
    grid_m = scatter(st, mw, n_nodes)
    grid_mv = scatter(st, mv_vals, n_nodes)
    return grid_m, grid_mv


def apic_momentum_vals(st: Stencil, v, C, m):
    """(mw (n, s), momentum values (n, s, d)) in the flat column form —
    shared by the single-device and sharded P2G so both take identical
    floating-point paths."""
    n, s = st.wn.shape
    d = v.shape[-1]
    rel_flat = st.rel.reshape(n, s * d)
    mw = m[:, None] * st.wn                                  # (n, s)
    cols = []
    for i in range(d):
        acc = v[:, i:i + 1]                                  # (n, 1)
        for j in range(d):
            acc = acc + C[:, i, j:j + 1] * rel_flat[:, j::d]  # (n, s)
        cols.append(mw * acc)
    return mw, jnp.stack(cols, axis=-1)                      # (n, s, d)


def grad_from_vi(st: Stencil, vi):
    """grad[p, i, j] = sum_k vi[p, k, i] gwn[p, k, j] in flat columns."""
    n, s, d = vi.shape
    vi_flat = vi.reshape(n, s * d)
    gwn_flat = st.gwn.reshape(n, s * d)
    rows = [
        jnp.stack(
            [jnp.sum(vi_flat[:, i::d] * gwn_flat[:, j::d], axis=1)
             for j in range(d)],
            axis=-1,
        )
        for i in range(d)
    ]
    return jnp.stack(rows, axis=-2)


def force_contrib(st: Stencil, PFt, V0):
    """contrib[p, k, i] = -V0 sum_j PFt[p, i, j] gwn[p, k, j], flat."""
    n, s = st.wn.shape
    d = PFt.shape[-1]
    gwn_flat = st.gwn.reshape(n, s * d)
    cols = []
    for i in range(d):
        acc = PFt[:, i, 0:1] * gwn_flat[:, 0::d]
        for j in range(1, d):
            acc = acc + PFt[:, i, j:j + 1] * gwn_flat[:, j::d]
        cols.append(acc)                                     # (n, s)
    return -V0[:, None, None] * jnp.stack(cols, axis=-1)


def g2p(st: Stencil, grid_v, dx, gather_st=default_gather_stencil,
        d_inv_factor: float = 4.0):
    """Gather particle velocity, velocity gradient, and APIC C matrix.

    C = (d_inv_factor/dx^2) sum_i w_ip v_i (x_i - x_p)^T — the APIC D^-1;
    4 for the quadratic kernel, 3 for cubic (bspline.apic_d_inv_factor).
    Reference: gridToParticles (component #26).
    """
    vi = barrier(gather_st(st, grid_v))                # (n, 3^dim, dim)
    return g2p_from_vi(st, vi, dx, d_inv_factor)


def g2p_from_vi(st: Stencil, vi, dx, d_inv_factor: float = 4.0):
    """(v_p, grad_v, C) from already-gathered stencil values vi.

    FLAT column form throughout (see p2g_mass_momentum): every (pki,pkj)
    contraction spelled with strided (n, s) column slices so no
    (n, d, s, d) broadcast temp exists at any spelling XLA might pick.
    Shared by the single-device and sharded G2P.
    """
    n, s, d = vi.shape
    vi_flat = vi.reshape(n, s * d)
    gwn_flat = st.gwn.reshape(n, s * d)
    rel_flat = st.rel.reshape(n, s * d)
    wn = st.wn
    c0 = d_inv_factor / (dx * dx)
    v_cols, g_rows, c_rows = [], [], []
    for i in range(d):
        vi_i = vi_flat[:, i::d]                        # (n, s)
        v_cols.append(jnp.sum(wn * vi_i, axis=1))
        g_rows.append(jnp.stack(
            [jnp.sum(vi_i * gwn_flat[:, j::d], axis=1) for j in range(d)],
            axis=-1,
        ))
        c_rows.append(jnp.stack(
            [c0 * jnp.sum(wn * vi_i * rel_flat[:, j::d], axis=1)
             for j in range(d)],
            axis=-1,
        ))
    v_p = jnp.stack(v_cols, axis=-1)
    grad_v = jnp.stack(g_rows, axis=-2)                # (n, d, d)
    C = jnp.stack(c_rows, axis=-2)
    return v_p, grad_v, C


def velocity_gradient(st: Stencil, grid_v, gather_st=default_gather_stencil):
    """grad_v_p = sum_i v_i (grad w_ip)^T — used by force/Hessian evals.
    FLAT column form (see g2p)."""
    vi = gather_st(st, grid_v)
    return barrier(grad_from_vi(st, vi))


def scatter_force(st: Stencil, PFt, V0, n_nodes: int, scatter=default_scatter):
    """f_i = -sum_p V0_p (P F_n^T)_p grad_w_ip — elastic force scatter.

    PFt: (n, dim, dim) = P(F_new) @ F_n^T per particle. FLAT column form
    (see p2g_mass_momentum).
    """
    return scatter(st, force_contrib(st, PFt, V0), n_nodes)
