"""Structured SpGEMM: Galerkin triple product A_c = P^T A P on BSR
stencil matrices.

Reference equivalent: the Galerkin coarse-operator construction named in
BASELINE.json:5 ("Galerkin coarsening via SpGEMM to construct HOT's
node-embedding multigrid hierarchy"). HOT's primary construction is
particle-quadrature rediscretization (hot_mpm.solver.multigrid); this
module provides the *algebraic* RAP used as its cross-check and as the
general explicit-matrix path (SURVEY.md §7 hard part 3).

Structure exploited instead of general SpGEMM: the prolongation P is the
node-embedding quadratic B-spline interpolation — every fine node embeds
in exactly 3^dim coarse nodes with weights computed from its coordinates.
With a 5-wide fine operator, R A P has a 7-wide coarse stencil (half = 3):
|2 Jc - 2 Ic| < 3 + 2 + 3 => |Jc - Ic| <= 3 coarse cells. Both products are
gather-weighted scatter-adds over fixed-size windows — no dynamic sparsity.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from hot_mpm.ops import bsr as bsr_mod
from hot_mpm.ops import transfer
from hot_mpm.ops.bspline import quadratic_kernel_1d, stencil_offsets


def embedding_weights(coords_f, dtype):
    """Node-embedding interpolation of fine node coords into the coarse grid.

    Fine node at coord c (integer, spacing dx) sits at position c/2 in
    coarse cells. Returns (base (n, dim) int32, w (n, 3^dim)) with
    coarse stencil nodes base + stencil_offsets.
    """
    dim = coords_f.shape[-1]
    xs = coords_f.astype(dtype) * 0.5                 # coarse-cell coordinates
    base = jnp.floor(xs - 0.5).astype(jnp.int32)
    u = xs - base.astype(dtype)
    w_axes = quadratic_kernel_1d(u)                   # (n, dim, 3)
    if dim == 2:
        w = (w_axes[:, 0, :, None] * w_axes[:, 1, None, :]).reshape(-1, 9)
    else:
        w = (
            w_axes[:, 0, :, None, None]
            * w_axes[:, 1, None, :, None]
            * w_axes[:, 2, None, None, :]
        ).reshape(-1, 27)
    return base, w


def rap_half_out(half_in: int) -> int:
    """Output stencil half of P^T A P: ceil(h/2) + 2. Fixed point at 4, so
    recursive Galerkin hierarchies have 5 -> 7 -> 9 -> 9 ... wide levels."""
    return (half_in + 1) // 2 + 2


def rap(A: bsr_mod.BsrMatrix, coarse_res: Tuple[int, ...], coarse_active,
        coarse_capacity: int,
        fine_origin=None, coarse_origin=None,
        coarse_tgrid=None, max_half: int = None) -> bsr_mod.BsrMatrix:
    """A_c = P^T A P with node-embedding prolongation, any stencil half.

    Peak memory is the step-2 scatter buffer, (2^dim * n_out + R + 1)
    x Kc x d^2 values — the parity-static formulation below materializes
    no (R, Kf, 3^dim) product (the old chunked path did, hence its
    removed mem_budget knob).

    fine_origin / coarse_origin: optional (dim,) integer GLOBAL coords of
    the local grids' node (0,...,0) — used by the sharded MG, where A is a
    device's partial operator over its extended slab and the embedding
    relation g_coarse = embed(g_fine) holds in GLOBAL coordinates
    (g = local + origin). None = both grids are global (origins zero).

    coarse_tgrid: when given (a grid.sparse.TileGrid at coarse spacing),
    the output structure is TILE-COMPACTED (ops.bsr_tiled.structure_tiled
    at the widened half): coarse row index == compacted coarse node id,
    coarse_active/coarse_capacity are ignored, and entries landing outside
    active coarse tiles are dropped (subspace Galerkin — the restriction
    drops the same rows, so the V-cycle correction stays consistent).
    The fine A works either way (only node_of/coords are consumed).

    max_half: optional cap on the OUTPUT stencil half (MultigridConfig.
    rap_max_half). The exact Galerkin stencil grows 2 -> 3 -> 4 (fixed
    point): a 9^dim-wide deep operator whose far entries come from
    embedding-kernel tails (quadratic B-spline weights decay fast).
    Truncating drops the |offset| > max_half couplings SYMMETRICALLY
    (offsets come in +/- pairs, so A_c stays symmetric); the operator is
    then near-Galerkin — a preconditioner-quality knob guarded by the
    CG-count test in tests/test_multigrid.py, trading exactness for a
    K 729 -> 343 (max_half=3) cut of every deep-level SpMV, scatter
    buffer, and downstream RAP window.
    """
    dim = A.dim
    h = A.half
    dtype = A.vals.dtype
    Kf = A.K
    dd = dim * dim
    n_nodes_f = transfer.n_nodes_of(A.res)
    res_c = jnp.asarray(coarse_res, jnp.int32)
    f_org = (jnp.zeros((dim,), jnp.int32) if fine_origin is None
             else jnp.asarray(fine_origin, jnp.int32))
    c_org = (jnp.zeros((dim,), jnp.int32) if coarse_origin is None
             else jnp.asarray(coarse_origin, jnp.int32))

    coords = transfer.unravel(jnp.minimum(A.node_of, n_nodes_f - 1), A.res)
    valid_row = A.node_of < n_nodes_f

    emb_offs = stencil_offsets(dim)                   # (3^dim, dim)
    s_emb = emb_offs.shape[0]

    # ---- step 1: W = A P  (fine rows x coarse window) --------------------
    # PARITY-STATIC formulation: for integer global coord g, the embedding
    # base shift floor((g+off-1)/2) - floor((g-1)/2) and the embedding
    # weights (u = 1 -> [1/8, 3/4, 1/8]; u = 1/2 -> [1/2, 1/2, 0]) depend
    # only on the PARITY of g per axis. So A P collapses to 2^dim
    # class-masked (Kf -> KW) contractions (batched matmuls) — the
    # earlier scatter-add formulation COLLIDES within rows
    # (docs/KERNEL_PLAN.md "Dynamic indexing").
    wm = (h + 1) // 2                                 # window margin
    W1d = 2 * wm + 3
    KW = W1d**dim
    # embeds of row node j: embedding runs in GLOBAL coords, results are
    # shifted back to the local coarse frame
    g = coords + f_org[None, :]
    base_j, w_j = embedding_weights(g, dtype)
    base_j = base_j - c_org[None, :]

    import numpy as _np

    def _ax_pattern():
        """(2, 2h+1, W1d) numpy: per (parity, axis offset) the 3 embedding
        weights placed at their window positions."""
        pat = _np.zeros((2, 2 * h + 1, W1d))
        wtab = {0: _np.array([0.125, 0.75, 0.125]),   # g even: u = 1
                1: _np.array([0.5, 0.5, 0.0])}        # g odd:  u = 1/2
        for par in (0, 1):
            eb0 = (par - 1) >> 1
            for oi, off in enumerate(range(-h, h + 1)):
                gi_par = (par + off) & 1
                delta = ((par + off - 1) >> 1) - eb0
                for e in range(3):
                    pat[par, oi, delta + wm + e] += wtab[gi_par][e]
        return pat

    pat_ax = _ax_pattern()
    # tensorize to (2^dim, Kf, KW): class bits are row-major over axes
    PAT = _np.ones((1, 1, 1))
    for a in range(dim):
        n_cls, kf_c, kw_c = PAT.shape
        PAT = _np.einsum("ckw,pov->cpkowv", PAT, pat_ax).reshape(
            n_cls * 2, kf_c * (2 * h + 1), kw_c * W1d
        )
    PAT_j = jnp.asarray(PAT, dtype)                   # (2^dim, Kf, KW)

    cls = jnp.zeros((A.n_rows,), jnp.int32)
    for a in range(dim):
        cls = cls * 2 + (g[:, a] & 1)

    R_rows = A.n_rows
    # A.vals is FLAT (R, Kf*dd); splitting the minor dim into (Kf, dd) is
    # the layout-SAFE reshape direction (the 4D->merge direction forces a
    # row-major materialization, docs/KERNEL_PLAN.md "Tiny trailing dims")
    ok_vals = jnp.where(
        ((A.col_row >= 0) & valid_row[:, None])[:, :, None],
        A.vals.reshape(R_rows, Kf, dd), 0.0,
    )
    W = jnp.zeros((R_rows, KW, dd), dtype)
    for p in range(2 ** dim):
        sel = (cls == p).astype(dtype)[:, None, None]
        W = W + jnp.einsum("rkc,kw->rwc", ok_vals * sel, PAT_j[p],
                           precision=jax.lax.Precision.HIGHEST)
    W = W.reshape(R_rows, KW, dim, dim)

    # ---- step 2: A_c = P^T W (scatter into the coarse stencil) -----------
    h_c = rap_half_out(h)
    if max_half is not None:
        h_c = min(h_c, int(max_half))
    Jc_coord = base_j[:, None, :] + emb_offs[None, :, :]        # (R, 3^d, dim)
    Jc_ok = jnp.all((Jc_coord >= 0) & (Jc_coord < res_c[None, None, :]), axis=-1)
    if coarse_tgrid is not None:
        from hot_mpm.grid import sparse as sparse_mod
        from hot_mpm.ops import bsr_tiled

        A_c = bsr_tiled.structure_tiled(coarse_tgrid, half=h_c)
        cid = sparse_mod.compact_node_id(
            coarse_tgrid, jnp.clip(Jc_coord, 0, res_c - 1)
        )
        Jc_row = jnp.where(Jc_ok & (cid < coarse_tgrid.dump), cid, -1)
    else:
        A_c = bsr_mod.structure(coarse_active, coarse_res, coarse_capacity,
                                half=h_c)
        strides_c = []
        s = 1
        for r in reversed(coarse_res):
            strides_c.append(s)
            s *= int(r)
        strides_c = jnp.asarray(strides_c[::-1], jnp.int32)
        Jc_node = jnp.sum(jnp.clip(Jc_coord, 0, res_c - 1)
                          * strides_c[None, None, :], axis=-1)
        Jc_row = jnp.where(Jc_ok, A_c.row_of[Jc_node], -1)      # (R, 3^d)
    Kc = A_c.K

    # P^T scatter, parity-class extended rows: for a FIXED embedding offset
    # e0, two distinct fine rows collide on a coarse row only when they
    # share the embedding base — impossible within one parity class — so
    # (class, Jc_row) pairs are UNIQUE per e0: 3^dim unique scatters total
    # (no colliding per-(row, window) scatter).
    # The source window column per output offset kc is STATIC per e0:
    # kw = rel(kc) + wm + e0 (out-of-window -> the zero pad column).
    offs_c_np = _np.stack(
        _np.meshgrid(*([_np.arange(-h_c, h_c + 1)] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    e0_np = _np.stack(
        _np.meshgrid(*([_np.arange(3)] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    Wp = jnp.concatenate(
        [W.reshape(R_rows, KW, dd), jnp.zeros((R_rows, 1, dd), dtype)], axis=1
    )
    n_out = A_c.n_rows
    n_cls = 2 ** dim
    buf = jnp.zeros((n_cls * n_out + R_rows + 1, Kc * dd), dtype)
    dump_rows = n_cls * n_out + jnp.arange(R_rows, dtype=jnp.int32)
    for e0 in range(s_emb):
        kwc = offs_c_np + wm + e0_np[e0][None, :]               # (Kc, dim)
        okk = _np.all((kwc >= 0) & (kwc < W1d), axis=-1)
        kw_flat = _np.zeros(len(offs_c_np), _np.int64)
        for a in range(dim):
            kw_flat = kw_flat * W1d + _np.clip(kwc[:, a], 0, W1d - 1)
        kw_flat = _np.where(okk, kw_flat, KW)
        Y = Wp[:, jnp.asarray(kw_flat, jnp.int32)]              # (R, Kc, dd)
        Y = (w_j[:, e0, None, None] * Y).reshape(R_rows, Kc * dd)
        ok_r = valid_row & (Jc_row[:, e0] >= 0)
        rows = jnp.where(ok_r, cls * n_out + Jc_row[:, e0], dump_rows)
        buf = buf.at[rows].add(Y, unique_indices=True)
    out = buf[: n_cls * n_out].reshape(n_cls, n_out, Kc * dd).sum(0)
    mask = jnp.repeat(A_c.col_row >= 0, dd, axis=1)     # (n_out, Kc*dd)
    return A_c._replace(vals=jnp.where(mask, out, 0.0))
