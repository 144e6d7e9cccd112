"""Composed-stencil Galerkin assembly: exact P^T A P coarse operators
WITHOUT an explicit fine-level matrix.

Reference equivalent: HOT's node-embedding coarse-operator construction
(component #35, SURVEY.md §3.4): "particles contribute to every level with
widened stencils". The coarse basis function of node c is the embedded
interpolation of fine basis functions, so the level-L shape value at a
particle is the COMPOSITION of its quadratic fine weights with L node-
embedding interpolations — per axis (tensor-product kernels compose
axis-wise):

    w^{L}_a = E^{L} ... E^{1} w^{0}_a,        E = the 3-point embedding

giving 4-wide (L=1) then 5-wide (L>=2, fixed point) per-axis supports.
With composed weights/gradients, the particle-quadrature elastic operator
at level L is EXACTLY P^T (dt^2 K_0) P, and the fine lumped mass embeds as
(P^T M P)[i,j] = sum_f m_f w_f,i w_f,j — together the exact Galerkin
coarse operator of the matrix-free fine level, at O(particles) memory.

Why this exists (vs ops.spgemm.rap): rap needs the EXPLICIT fine matrix —
~8.7 GB at 256^3 (the assembled_from_level>0 configuration exists because
it does not fit). The composed construction gives the same matrix from
the particles directly; deeper levels RAP from it (it IS explicit).

Equality with rap(assembled fine) is tested in tests/test_sparse_grid.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as _np

from hot_mpm.ops import bsr as bsr_mod
from hot_mpm.ops import transfer
from hot_mpm.ops.bspline import (
    quadratic_bspline_weights,
    quadratic_kernel_1d,
    stencil_offsets,
    tensor_weights,
)


def _width_out(S: int) -> int:
    """Per-axis support after one embedding composition: ceil((S-1)/2)+3.
    1 -> 3 -> 4 -> 5 -> 5 (fixed point)."""
    return (S - 1 + 1) // 2 + 3


def compose_axis(base, w, dw=None):
    """One node-embedding composition of per-axis weights.

    base: (n, dim) int32 node index at the current level;
    w/dw: (n, dim, S). Returns (base', w'[, dw']) at 2x spacing with
    S' = _width_out(S). dw composes with the same embedding weights
    (the embedding interpolates VALUES; gradients are w.r.t. the particle
    position and pass through linearly), so units stay 1/dx_fine-world.
    """
    S = w.shape[-1]
    S2 = _width_out(S)
    c = base[..., None] + jnp.arange(S, dtype=base.dtype)        # (n, dim, S)
    eb = jnp.floor_divide(c - 1, 2)
    u = 0.5 * c.astype(w.dtype) - eb.astype(w.dtype)             # in [0.5, 1.5)
    ew = quadratic_kernel_1d(u)                                  # (n, dim, S, 3)
    b2 = jnp.floor_divide(base - 1, 2)
    delta = eb - b2[..., None]                                   # in [0, S2-3]
    pos = delta[..., None] + jnp.arange(3, dtype=base.dtype)     # (n, dim, S, 3)
    oh = (pos[..., None] == jnp.arange(S2, dtype=base.dtype)).astype(w.dtype)
    w2 = jnp.einsum("ndk,ndkm,ndkmj->ndj", w, ew, oh)
    if dw is None:
        return b2, w2
    dw2 = jnp.einsum("ndk,ndkm,ndkmj->ndj", dw, ew, oh)
    return b2, w2, dw2


def composed_particle_weights(x, dx, L: int):
    """Level-L composed weights of particles (dx = FINE spacing).

    Returns (base_L (n, dim) int32 in level-L node coords, w, dw) with
    per-axis width 4 (L=1) or 5 (L>=2). dw stays in world units (1/m)."""
    base, w, dw = quadratic_bspline_weights(x, dx)
    for _ in range(L):
        base, w, dw = compose_axis(base, w, dw)
    return base, w, dw


def composed_node_weights(coords, L: int, dtype):
    """Level-L composed EMBEDDING weights of fine nodes (integer coords).

    Width 3 (L=1), 4 (L=2), 5 (L>=3). Returns (base_L, w)."""
    base = coords.astype(jnp.int32)
    n, dim = base.shape
    w = jnp.ones((n, dim, 1), dtype)
    for _ in range(L):
        base, w = compose_axis(base, w)
    return base, w


def _tensor_w(w):
    """Per-axis weights (n, dim, S) -> tensorized (n, S^dim) (no grads).
    Flat impl: composed stencils are WIDE (S = 2^L + 3), so the broadcast
    (n, S, S, S) temp is avoided (see bspline._outer_flat)."""
    wn, _ = tensor_weights(w, jnp.zeros_like(w), impl="flat")
    return wn


def ext_key(base, res_L: Tuple[int, ...]):
    """Injective flat bin key over the EXTENDED index range base+1 in
    [0, res+2) per axis — composed bases can be -1 at the domain edge and
    res-? at the top; clipping would merge distinct cells and break the
    unique-scatter invariant."""
    dim = base.shape[-1]
    key = jnp.zeros(base.shape[:-1], jnp.int32)
    for a in range(dim):
        key = key * (int(res_L[a]) + 2) + jnp.clip(base[..., a] + 1, 0,
                                                   int(res_L[a]) + 1)
    return key


def n_ext(res_L) -> int:
    out = 1
    for r in res_L:
        out *= int(r) + 2
    return out


def _unext(keys, res_L):
    """Inverse of ext_key: (cells,) -> true level coords (cells, dim)."""
    dim = len(res_L)
    coords = []
    rem = keys
    for a in reversed(range(dim)):
        m = int(res_L[a]) + 2
        coords.append(rem % m - 1)
        rem = rem // m
    return jnp.stack(coords[::-1], axis=-1)


def _offset_tables(dim: int, width: int, half: int):
    """Static tables for a width-`width` stencil scattered into a
    (2*half+1)-wide structure: per-node offsets, (j, i) column ids."""
    offs = _np.stack(
        _np.meshgrid(*([_np.arange(width)] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    rel = offs[None, :, :] - offs[:, None, :] + half
    off_id = _np.zeros((rel.shape[0], rel.shape[1]), _np.int64)
    for a in range(dim):
        off_id = off_id * (2 * half + 1) + rel[:, :, a]
    return offs, off_id


def _rows_for_cells(cells_ext, offs_j, res_L, mat, tgrid):
    """Scatter target row per active composed cell for stencil offset j.

    cells_ext: (cells_cap,) ext bin keys (pad = n_ext). Returns
    (r_j (cells_cap,) row ids with invalid -> -1)."""
    coords = _unext(cells_ext, res_L) + jnp.asarray(offs_j, jnp.int32)[None, :]
    res_arr = jnp.asarray(res_L, jnp.int32)
    in_dom = jnp.all((coords >= 0) & (coords < res_arr[None, :]), axis=-1)
    in_dom = jnp.logical_and(in_dom, cells_ext < n_ext(res_L))
    if tgrid is not None:
        from hot_mpm.grid import sparse as sparse_mod

        cid = sparse_mod.compact_node_id(tgrid,
                                         jnp.clip(coords, 0, res_arr - 1))
        return jnp.where(in_dom & (cid < tgrid.dump), cid, -1)
    strides = []
    s = 1
    for r in reversed(res_L):
        strides.append(s)
        s *= int(r)
    strides = jnp.asarray(strides[::-1], jnp.int32)
    nid = jnp.sum(jnp.clip(coords, 0, res_arr - 1) * strides[None, :], axis=-1)
    r = mat.row_of[nid]
    return jnp.where(in_dom & (r >= 0), r, -1)


def _scatter_cell_blocks(vals, blocks, bins, res_L, mat, tgrid,
                         width: int, half: int):
    """Scatter per-cell (cells, s_j, s_i, d, d) blocks into the padded
    vals buffer (n_rows + cells_cap, K, d*d) with per-j unique rows."""
    dim = len(res_L)
    s = width**dim
    cells_cap = bins.p_cell.shape[0]
    n_rows = mat.n_rows
    dd = vals.shape[-1]
    offs, off_id = _offset_tables(dim, width, half)
    dump_rows = n_rows + jnp.arange(cells_cap, dtype=jnp.int32)
    for j in range(s):
        r_j = _rows_for_cells(bins.active_cells, offs[j], res_L, mat, tgrid)
        r_j = jnp.where(r_j >= 0, r_j, dump_rows)
        cols_j = jnp.asarray(off_id[j], jnp.int32)
        vals = vals.at[r_j[:, None], cols_j[None, :]].add(
            blocks[:, j].reshape(cells_cap, s, dd), unique_indices=True
        )
    return vals


def _scatter_cell_scalars(scal, blocks_flat, bins, res_L, mat, tgrid,
                          width: int, half: int):
    """Scatter per-cell SCALAR blocks (cells, s_j*s_i FLAT, not the 3-D
    (cells, sm, sm) form) into a padded (n_rows + cells_cap, K) buffer.
    The caller expands to the block diagonal afterwards — the old
    scalar * eye broadcast per j left ~27 live remat clones of a
    (cells, s, d*d) fusion in the 128^3 compile."""
    dim = len(res_L)
    s = width**dim
    cells_cap = bins.p_cell.shape[0]
    n_rows = mat.n_rows
    offs, off_id = _offset_tables(dim, width, half)
    dump_rows = n_rows + jnp.arange(cells_cap, dtype=jnp.int32)
    for j in range(s):
        r_j = _rows_for_cells(bins.active_cells, offs[j], res_L, mat, tgrid)
        r_j = jnp.where(r_j >= 0, r_j, dump_rows)
        cols_j = jnp.asarray(off_id[j], jnp.int32)
        scal = scal.at[r_j[:, None], cols_j[None, :]].add(
            blocks_flat[:, j * s:(j + 1) * s], unique_indices=True
        )
    return scal


def assemble_composed_galerkin(
    mat: bsr_mod.BsrMatrix, L: int, res_L: Tuple[int, ...],
    F_n, ctx, V0, dt,
    node_coords, node_m,
    p_bins, n_bins,
    comp_w, comp_dw,
    tgrid=None,
) -> bsr_mod.BsrMatrix:
    """Exact Galerkin level-L operator P^T (M + dt^2 K) P from particles +
    fine node masses, into a (2*half+1)-wide structure (half = width-1).

    comp_w/comp_dw: composed_particle_weights(x, dx, L) (built per step in
    multigrid.build_static; passed in to keep this jit-pure).
    p_bins: bins of particles by ext_key(comp_base); n_bins: bins of fine
    nodes by ext_key of their composed embedding base. node_coords/node_m:
    (nf, dim) int coords + lumped masses of the FINE grid rows (invalid
    rows carry m == 0 and are routed out by n_bins' valid mask).
    """
    dim = len(res_L)
    width = comp_w.shape[-1]
    half = mat.half
    assert half == width - 1, (half, width)
    dd = dim * dim
    n_rows = mat.n_rows
    cells_cap = p_bins.p_cell.shape[0]
    ncells_cap = n_bins.p_cell.shape[0]

    # ---- elastic part: rank-1 mode blocks with COMPOSED gradients -------
    # flat: see _tensor_w — no wide-stencil broadcast temps
    wn, gwn = tensor_weights(comp_w, comp_dw, impl="flat")
    st_c = transfer.Stencil(
        node_ids=jnp.zeros(wn.shape, jnp.int32), wn=wn, gwn=gwn,
        rel=jnp.zeros(gwn.shape, wn.dtype),
    )
    # scan-FUSED blocks+scatter: the separate cell_mode_blocks ->
    # _scatter_cell_blocks pipeline materializes the full
    # (cells, s, s, d, d) block tensor on top of two chunk working sets.
    # Pre-resolving the per-(offset, cell) scatter rows lets the scatter
    # run inside the chunk scan: peak = one chunk + the vals carry.
    s_el = width**dim
    offs_el, off_id_el = _offset_tables(dim, width, half)
    dump_rows = n_rows + jnp.arange(cells_cap, dtype=jnp.int32)
    rows_j = []
    for j in range(s_el):
        r_j = _rows_for_cells(p_bins.active_cells, offs_el[j], res_L, mat,
                              tgrid)
        rows_j.append(jnp.where(r_j >= 0, r_j, dump_rows))
    rows_j = jnp.stack(rows_j, axis=0)                  # (s, cells_cap)
    vals = jnp.zeros((n_rows + max(cells_cap, ncells_cap), mat.K, dd),
                     wn.dtype)
    vals = bsr_mod.cell_mode_blocks_scatter(
        p_bins, st_c, F_n, ctx, V0, dt, dim, vals, rows_j, off_id_el)

    # ---- inertia part: P^T diag(m_fine) P ------------------------------
    nb, nw = composed_node_weights(node_coords, L, comp_w.dtype)
    wn_n = _tensor_w(nw)                                   # (nf, sm)
    sm = wn_n.shape[-1]
    m_rt = jnp.sqrt(jnp.maximum(node_m, 0.0))
    rows_w = m_rt[:, None] * wn_n                          # (nf, sm)
    # per-cell sums B = W^T W via the slot trick
    n = rows_w.shape[0]
    packed = jnp.concatenate(
        [rows_w, jnp.zeros((1, sm), rows_w.dtype)], axis=0
    )
    slot_rows = packed[n_bins.p_cell.reshape(-1)]
    slot_rows = transfer.barrier(slot_rows)
    cap_n = n_bins.p_cell.shape[1]
    W = slot_rows.reshape(ncells_cap, cap_n, sm)
    # per-cell sums B = W^T W. ncells_cap is the ACTIVE composed-cell
    # count (plan_capacities mg_ncomposed_caps), not the full extended
    # coarse grid (287k cells at 128^3, ~34x the active count). A flat
    # strided-column rewrite was tried on the code's first target and was
    # worse: each W[:, :, a] minor-axis slice materializes (cells, q, 1).
    Bm = jnp.einsum("xqa,xqb->xab", W, W).reshape(ncells_cap, sm * sm)
    # scatter scalar blocks * I — note the mass stencil is narrower than
    # the particle one (sm_width <= width); its offset ids use `half` too
    m_width = round(sm ** (1.0 / dim))
    m_width = int(m_width)
    scal = jnp.zeros((n_rows + ncells_cap, mat.K), Bm.dtype)
    scal = _scatter_cell_scalars(scal, Bm, n_bins, res_L, mat, tgrid,
                                 m_width, half)[:n_rows]
    scal = jnp.where(mat.col_row >= 0, scal, 0.0)   # structure mask

    vals = vals[:n_rows]
    vals = jnp.where((mat.col_row >= 0)[:, :, None], vals, 0.0)
    # canonical FLAT (n_rows, K*dd) k-major storage (round 4), with the
    # scalar mass sums added on the block diagonal via strided columns
    vals = vals.reshape(n_rows, mat.K * dd)
    for i in range(dim):
        vals = vals.at[:, i * dim + i::dd].add(scal)
    return mat._replace(vals=vals)


def composed_bin_caps_host(x, dx, L: int, res_L, dim: int,
                           grow: float = 1.0):
    """Host-side exact (cells_cap, cap) for the particle composed bins."""
    import numpy as np

    xs = np.asarray(x)
    b = np.floor(xs / dx - 0.5).astype(np.int64)
    for _ in range(L):
        b = (b - 1) >> 1
    key = np.zeros(b.shape[0], np.int64)
    for a in range(dim):
        key = key * (int(res_L[a]) + 2) + np.clip(b[:, a] + 1, 0,
                                                  int(res_L[a]) + 1)
    uniq, counts = np.unique(key, return_counts=True)
    return (int(grow * (1.15 * len(uniq) + 16)),
            int(np.ceil(grow * (counts.max() + 1))))
