"""Block-sparse (d x d node blocks) Hessian assembly, SpMV/SpMM, and
Galerkin RAP — the explicit-operator path.

Reference equivalents: HOT's per-level explicit BSR-like matrices
(components #35/#38, SURVEY.md §3.4) assembled from particle quadrature,
and the --matfree toggle choosing between assembled and matrix-free finest
level. BASELINE.json:5 names these directly: "BSR-blocked (3x3 node
blocks) assembly", "SpMV/SpMM kernels", "Galerkin coarsening via SpGEMM".

Format: ELL-with-geometric-offsets. A quadratic B-spline
couples nodes at per-axis offsets in [-2, 2], so every row has at most
K = 5^dim neighbor blocks at KNOWN geometric offsets — column structure is
implicit (node coords + offset), stored as a compressed active-row table:

  vals:      (n_rows, K*d*d)    block values, FLAT k-major (i,j)-minor
                                (column k*dd + i*d + j; zero-padded)
  col_row:   (n_rows, K) int32  neighbor's row index, -1 if absent/inactive
  node_of:   (n_rows,) int32    flat node id per row
  row_of:    (n_nodes,) int32   inverse map, -1 for inactive nodes

SpMV = one gather + (i, j)-slab products over strided (n_rows, K) column
slices (no dot_general over tiny dims — see _spmv_slabs); the tiled
variant (ops.bsr_tiled) drops in underneath with the same interface.
n_rows is a static capacity (padded), so assembly/SpMV live inside jit
without dynamic shapes (SURVEY.md §7 hard part 2).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hot_mpm.models import constitutive as cm
from hot_mpm.ops import transfer


import dataclasses


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BsrMatrix:
    vals: jax.Array      # (n_rows, K*d*d) flat k-major, K = (2*half+1)^dim
    # FLAT storage: a (n_rows, K, d, d) leaf forces row-major
    # re-materializations at every reshape-merge consumer (the next RAP
    # level, the dense factor) and einsum operand (docs/KERNEL_PLAN.md
    # "Tiny trailing dims"). Flat vals make the K*dd -> (K, d, d) direction a SPLIT (layout-safe)
    # and every consumer a strided-column slab.
    col_row: jax.Array   # (n_rows, K) int32, -1 = absent
    node_of: jax.Array   # (n_rows,) int32 flat node id (n_nodes = invalid pad)
    row_of: jax.Array    # (n_nodes,) int32, -1 = inactive
    # static metadata (aux data — stays Python across jit boundaries)
    res: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    half: int = dataclasses.field(metadata=dict(static=True))
    # half: 2 for quadratic B-spline quadrature operators, 3 for their
    # Galerkin RAP
    # Row ordering: True = tile-compacted rows (ops.bsr_tiled.
    # structure_tiled — row r = tile_slot * tile_nodes + local_id, the
    # supertile-SpMV eligible layout); False = compressed-row order
    # (bsr.structure — active rows packed by row_of). half alone cannot
    # distinguish them once rap_max_half produces half-2 RAP operators
    # on compressed rows, and n_rows coincides whenever the dense RAP
    # capacity is taken from a tile-laid mat_sym — an explicit flag is
    # the only safe discriminator (see solver.multigrid._rows_mul).
    tile_layout: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    def _replace(self, **kw) -> "BsrMatrix":
        return dataclasses.replace(self, **kw)

    @property
    def dim(self) -> int:
        return len(self.res)

    @property
    def K(self) -> int:
        return (2 * self.half + 1) ** self.dim

    @property
    def n_rows(self) -> int:
        return self.vals.shape[0]

    @property
    def block_nnz(self) -> jax.Array:
        """Number of structurally present blocks (for nnz/s metrics)."""
        return jnp.sum(self.col_row >= 0)


def _offsets(dim: int, half: int = 2):
    """All (2h+1)^dim per-axis offsets in [-h, h]; row-major flat order."""
    rng = jnp.arange(-half, half + 1)
    grids = jnp.meshgrid(*([rng] * dim), indexing="ij")
    return jnp.stack([g.reshape(-1) for g in grids], axis=-1).astype(jnp.int32)


def active_rows(active, capacity: int):
    """Compressed row table from an active-node mask (static capacity).

    Returns (node_of (capacity,), row_of (n_nodes,)). Padding rows get
    node_of == n_nodes (out of range) and are fully masked downstream.
    """
    n_nodes = active.shape[0]
    node_of = jnp.nonzero(active, size=capacity, fill_value=n_nodes)[0].astype(jnp.int32)
    row_ids = jnp.arange(capacity, dtype=jnp.int32)
    valid = node_of < n_nodes
    row_of = jnp.full((n_nodes + 1,), -1, jnp.int32)
    row_of = row_of.at[jnp.where(valid, node_of, n_nodes)].set(
        jnp.where(valid, row_ids, -1)
    )[:n_nodes]
    return node_of, row_of


def structure(active, res: Tuple[int, ...], capacity: int, half: int = 2) -> BsrMatrix:
    """Symbolic structure: rows for active nodes, cols for active neighbors."""
    dim = len(res)
    K = (2 * half + 1) ** dim
    node_of, row_of = active_rows(active, capacity)
    res_arr = jnp.asarray(res, jnp.int32)
    coords = transfer.unravel(jnp.minimum(node_of, transfer.n_nodes_of(res) - 1), res)
    offs = _offsets(dim, half)                             # (K, dim)
    ncoords = coords[:, None, :] + offs[None, :, :]        # (capacity, K, dim)
    in_domain = jnp.all((ncoords >= 0) & (ncoords < res_arr[None, None, :]), axis=-1)
    strides_py = []
    s = 1
    for r in reversed(res):
        strides_py.append(s)
        s *= int(r)
    strides = jnp.asarray(strides_py[::-1], jnp.int32)
    nids = jnp.sum(jnp.clip(ncoords, 0, res_arr - 1) * strides[None, None, :], axis=-1)
    col_row = jnp.where(in_domain, row_of[nids], -1)
    valid_row = node_of < transfer.n_nodes_of(res)
    col_row = jnp.where(valid_row[:, None], col_row, -1)
    dtypeK = jnp.zeros((capacity, K * dim * dim))
    return BsrMatrix(vals=dtypeK, col_row=col_row, node_of=node_of, row_of=row_of,
                     res=tuple(res), half=half)


def assemble_hessian(
    mat: BsrMatrix, stencil: transfer.Stencil, F_n, ctx, V0, dt, grid_m,
) -> BsrMatrix:
    """Fill vals with M + dt^2 K from particle quadrature.

    Per particle: 3^d stencil nodes, d Hessian applies per input node
    (dP_a = dPdF : (dt e_a g_ki^T)), then every (ki -> kj) block is a
    (d, d) matmul dP_a @ g_kj — 3^(2d) blocks scattered by (row, offset).
    Reference: the BSR assembly HOT performs per level (component #35).
    """
    dim = mat.dim
    assert mat.half == 2, "quadrature assembly fills the 5-wide structure"
    K = mat.K
    s = stencil.wn.shape[1]                                # 3^dim
    res_arr = jnp.asarray(mat.res, jnp.int32)
    n_nodes = transfer.n_nodes_of(mat.res)

    def per_particle(gwn_p, ids_p, F_p, ctx_p, V0_p):
        g = gwn_p @ F_p                                    # (s, d): g_k = F^T gw_k
        eye = jnp.eye(dim, dtype=F_p.dtype)

        def dP_for(gk):                                    # input node ki
            def col(a):
                return cm.apply_hessian(ctx_p, dt * jnp.outer(eye[a], gk))

            return jnp.stack([col(a) for a in range(dim)])  # (d[a], d, d)

        dPs = jax.vmap(dP_for)(g)                          # (s, d_a, d, d)
        # blocks[kj, ki][b, a] = dt V0 (dPs[ki, a] @ g_kj)[b]
        blocks = dt * V0_p * jnp.einsum("iabc,jc->jiba", dPs, g)
        return blocks                                      # (s_j, s_i, d, d)

    blocks = jax.vmap(per_particle)(
        stencil.gwn, stencil.node_ids, F_n, ctx, V0
    )                                                      # (n, s, s, d, d)

    # offset id of (ki relative to kj): coords difference in [-2, 2]
    coords = transfer.unravel(stencil.node_ids, mat.res)   # (n, s, dim)
    rel = coords[:, None, :, :] - coords[:, :, None, :]    # (n, s_j, s_i, dim)
    off5 = rel + 2                                         # in [0, 4]
    off_id = jnp.zeros(off5.shape[:-1], jnp.int32)
    for a in range(dim):
        off_id = off_id * 5 + off5[..., a]

    rows = mat.row_of[stencil.node_ids]                    # (n, s_j)
    flat_id = rows[:, :, None] * K + off_id                # (n, s_j, s_i)
    ok = rows[:, :, None] >= 0
    flat_id = jnp.where(ok, flat_id, mat.n_rows * K)       # dump row
    vals = jnp.zeros((mat.n_rows * K + 1, dim * dim), blocks.dtype)
    vals = vals.at[flat_id.reshape(-1)].add(
        blocks.reshape(-1, dim * dim)
    )[: mat.n_rows * K].reshape(mat.n_rows, K * dim * dim)
    return mat._replace(
        vals=_finalize_vals(mat, vals, grid_m, n_nodes, dim, K)
    )


def _finalize_vals(mat: BsrMatrix, vals_flat, grid_m, n_nodes: int,
                   dim: int, K: int):
    """Assembly tail in FLAT (n_rows, K*d*d) layout: add the center-offset
    inertia m_i I and zero absent neighbors. Stays flat — the canonical
    vals layout (see BsrMatrix.vals)."""
    dd = dim * dim
    center = (K - 1) // 2
    m_rows = grid_m[jnp.minimum(mat.node_of, n_nodes - 1)]
    m_rows = jnp.where(mat.node_of < n_nodes, m_rows, 0.0)
    eye_flat = jnp.eye(dim, dtype=vals_flat.dtype).reshape(1, dd)
    vals_flat = vals_flat.at[:, center * dd:(center + 1) * dd].add(
        m_rows[:, None] * eye_flat
    )
    mask = jnp.repeat(mat.col_row >= 0, dd, axis=1)       # (n_rows, K*dd)
    return jnp.where(mask, vals_flat, 0.0)


def dpdf_tensor(ctx, dim: int):
    """Per-particle dPdF as an explicit (n, d, d, a, c) tensor:
    T[:, :, a, c] = dPdF : (e_a e_c^T) — d^2 apply_hessian columns
    (apply_hessian is linear in dF)."""
    eye = jnp.eye(dim)

    def per_particle(ctx_p):
        cols = [
            [cm.apply_hessian(ctx_p, jnp.outer(eye[a], eye[c]))
             for c in range(dim)]
            for a in range(dim)
        ]
        # cols[a][c] is (b, bc'); stack -> (b, c', a, c)
        return jnp.stack(
            [jnp.stack(cols_a, axis=-1) for cols_a in cols], axis=-2
        )

    return jax.vmap(per_particle)(ctx)


def assemble_hessian_binned(
    mat: BsrMatrix, bins, stencil: transfer.Stencil, F_n, ctx, V0, dt, grid_m,
    j_chunk: int = 9,
) -> BsrMatrix:
    """Scatter-free BSR assembly (docs/KERNEL_PLAN.md "Dynamic
    indexing"): no colliding 729-blocks-per-particle scatter as in
    assemble_hessian. This path mirrors the binned transfers (component
    #26's coloring):

      block[j,i][b,a] = dt^2 V0 sum_{c,e} g_j[c] T[b,c,a,e] g_i[e]
                        (T = per-particle dPdF, g_k = F^T grad-w_k)

      1. T (d^2 apply_hessian columns) + g per particle, ONE row gather
         into (cell, slot) order;
      2. per-cell block sums = two batched contractions (batched matmuls,
         no scatters): K1 = T x g_j, then contract (slot, e) against g_i;
      3. per j-offset: ONE unique-index row scatter of (cells, 3^dim)
         i-blocks at STATIC column offsets (cell -> node_j is injective
         for fixed j; relative offsets are particle-independent).

    Requires particles >= one cell inside the domain (the sim invariant,
    enforced by advection clipping) so node ids are base + offset with no
    clipping. Equivalent to assemble_hessian — tested in tests/test_bsr.py.
    """
    import numpy as _np

    dim = mat.dim
    assert mat.half == 2
    K = mat.K
    s = stencil.wn.shape[1]
    n = stencil.wn.shape[0]
    n_nodes = transfer.n_nodes_of(mat.res)
    n_rows = mat.n_rows
    cells_cap, cap = bins.p_cell.shape

    g = jnp.einsum("pkd,pde->pke", stencil.gwn, F_n)            # (n, s, d)
    T = dpdf_tensor(ctx, dim) * (dt * dt * V0)[:, None, None, None, None]

    # one packed row gather into slot order (pad particle -> zero row)
    parr = bins.p_cell.reshape(-1)
    packed = jnp.concatenate(
        [g.reshape(n, -1), T.reshape(n, -1)], axis=1
    )
    packed = jnp.concatenate(
        [packed, jnp.zeros((1, packed.shape[1]), packed.dtype)], axis=0
    )
    rows = packed[parr]
    rows = transfer.barrier(rows)
    g_s = rows[:, : s * dim].reshape(cells_cap, cap, s, dim)
    T_s = rows[:, s * dim:].reshape(cells_cap, cap, dim, dim, dim, dim)

    # per-cell block sums, chunked over the j offset to bound the K1 buffer
    blk_chunks = []
    for j0 in range(0, s, j_chunk):
        g_j = g_s[:, :, j0: j0 + j_chunk]                       # (x, p, jc, d)
        K1 = jnp.einsum("xpbcae,xpjc->xpjbae", T_s, g_j)
        blk_chunks.append(jnp.einsum("xpjbae,xpie->xjiba", K1, g_s))
    blocks = jnp.concatenate(blk_chunks, axis=1)                # (x, s_j, s_i, d, d)

    # static offset-id table: column slot of (i relative to j) in [0, 5)^dim
    rng3 = _np.arange(3)
    offs = _np.stack(
        _np.meshgrid(*([rng3] * dim), indexing="ij"), -1
    ).reshape(-1, dim)                                          # matches stencil order
    rel = offs[None, :, :] - offs[:, None, :] + 2               # (j, i, dim)
    off_id = _np.zeros((s, s), _np.int64)
    for a in range(dim):
        off_id = off_id * 5 + rel[:, :, a]
    node_strides = _np.array(
        [int(_np.prod(mat.res[a + 1:])) for a in range(dim)], _np.int64
    )
    joff_flat = (offs * node_strides[None, :]).sum(axis=1)      # (s,)

    valid_cell = bins.active_cells < n_nodes
    # padded buffer with per-cell distinct dump rows -> every scatter's
    # indices are truly unique (XLA parallelizes unique scatters)
    vals = jnp.zeros((n_rows + cells_cap, K, dim * dim), blocks.dtype)
    dump_rows = n_rows + jnp.arange(cells_cap, dtype=jnp.int32)
    for j in range(s):
        node_j = bins.active_cells + int(joff_flat[j])
        r_j = mat.row_of[jnp.clip(node_j, 0, n_nodes - 1)]
        r_j = jnp.where(valid_cell & (r_j >= 0), r_j, dump_rows)
        cols_j = jnp.asarray(off_id[j], jnp.int32)              # (s_i,) static
        vals = vals.at[r_j[:, None], cols_j[None, :]].add(
            blocks[:, j].reshape(cells_cap, s, dim * dim),
            unique_indices=True,
        )
    vals = vals[:n_rows].reshape(n_rows, K * dim * dim)
    return mat._replace(
        vals=_finalize_vals(mat, vals, grid_m, n_nodes, dim, K)
    )


def _mode_vectors(stencil: transfer.Stencil, F_n, ctx, V0, dt, dim: int):
    """Rank-1 eigen-mode factorization of every particle's quadrature
    contribution (the scatter-free assembly formulation).

    The diagonal-space dP/dF is EXACTLY 9 rank-1 modes in 3D (4 in 2D):
    eigh of the (d, d) normal block A gives d diagonal modes
    M = U diag(q) V^T, and each shear pair (i, j) gives a symmetric mode
    (E_ij + E_ji)/sqrt(2) with eigenvalue b_minus and an antisymmetric one
    with b_plus (see models.constitutive.apply_hessian's 2x2 blocks). So

      block[j, i][b, a] = dt^2 V0 sum_m lam_m z[m, j, b] z[m, i, a],
      z[m, k] = M_m (F^T grad-w_k),

    i.e. cell sums become ONE batched Z^T (lam Z) matmul — no explicit
    (d, d, d, d) tensors anywhere (docs/KERNEL_PLAN.md "Tiny trailing
    dims").

    Returns (Z_flat (n, M*s*d), lam_scaled (n, M)). Z_flat columns are
    (m, e, k)-ordered — mode-major, component e, stencil node k minor —
    so every (m, e) slab is a CONTIGUOUS (n, s) slice. FLAT strided-column
    form throughout (the tiny-trailing-dims rule: the earlier
    vmap-per-particle version materialized (n, M, s, d) temps).
    """
    from hot_mpm.ops.svd import eigh_sym

    n, s = stencil.wn.shape
    d = dim
    gwn_flat = stencil.gwn.reshape(n, s * d)
    # g_cols[a][:, k] = (F^T gw_k)_a
    g_cols = []
    for a in range(d):
        acc = F_n[:, 0, a:a + 1] * gwn_flat[:, 0::d]
        for b in range(1, d):
            acc = acc + F_n[:, b, a:a + 1] * gwn_flat[:, b::d]
        g_cols.append(acc)
    # y_cols[c][:, k] = (V^T g_k)_c
    y_cols = []
    for c in range(d):
        acc = ctx.V[:, 0, c:c + 1] * g_cols[0]
        for a in range(1, d):
            acc = acc + ctx.V[:, a, c:c + 1] * g_cols[a]
        y_cols.append(acc)
    w_eig, Q = jax.vmap(eigh_sym)(ctx.A)             # (n, d), (n, d, d)
    cols = []                                        # M*d slabs of (n, s)
    lams = []
    for m_i in range(d):                             # diagonal modes
        for e in range(d):
            # z_e = sum_c U[e, c] Q[c, m] y_c
            acc = (ctx.U[:, e, 0:1] * Q[:, 0, m_i:m_i + 1]) * y_cols[0]
            for c in range(1, d):
                acc = acc + (ctx.U[:, e, c:c + 1] * Q[:, c, m_i:m_i + 1]) * y_cols[c]
            cols.append(acc)
        lams.append(w_eig[:, m_i])
    inv_sqrt2 = 0.7071067811865476
    for k_p, (i, j) in enumerate(cm._pairs(d)):      # shear-pair modes
        for e in range(d):
            cols.append((ctx.U[:, e, i:i + 1] * y_cols[j]
                         + ctx.U[:, e, j:j + 1] * y_cols[i]) * inv_sqrt2)
        lams.append(ctx.b_minus[:, k_p])
        for e in range(d):
            cols.append((ctx.U[:, e, i:i + 1] * y_cols[j]
                         - ctx.U[:, e, j:j + 1] * y_cols[i]) * inv_sqrt2)
        lams.append(ctx.b_plus[:, k_p])
    Z = jnp.concatenate(cols, axis=1)                # (n, M*d*s)
    assert len(lams) == d + 2 * len(cm._pairs(d))    # M modes emitted
    lam = jnp.stack(lams, axis=-1) * (dt * dt) * V0[:, None]
    return Z, lam


def cell_mode_blocks(bins, stencil: transfer.Stencil, F_n, ctx, V0, dt,
                     dim: int, chunk_budget: int = 1536 * 2 ** 20):
    """Per-active-cell stencil block sums via the rank-1 mode factorization:
    (cells_cap, s_j, s_i, d, d) — the shared compute core of the mode
    assemblies (dense `assemble_hessian_modes` and the tile-compacted
    variant in ops.bsr_tiled). Packed slot-order gathers + batched
    matmuls B = (lam Z)^T Z per cell, CHUNKED over the cell axis: the
    slot-gathered mode rows are the assembly's intrinsic working set
    (about 5 GB gathered + 5 GB of products at 400k particles / 128^3,
    from the shapes); chunking bounds the live slice while the output
    blocks accumulate."""
    s = stencil.wn.shape[1]
    n = stencil.wn.shape[0]
    cells_cap, cap = bins.p_cell.shape
    sd = s * dim

    Z, lam = _mode_vectors(stencil, F_n, ctx, V0, dt, dim)   # (n, M*sd), (n, M)
    Mm = lam.shape[1]

    # packed slot-order gather (pad particle -> zero row), chunked
    packed = jnp.concatenate([Z, lam], axis=1)
    packed = jnp.concatenate(
        [packed, jnp.zeros((1, packed.shape[1]), packed.dtype)], axis=0
    )
    # ~1.5 GB live per chunk for the gathered rows; lax.map SEQUENCES the
    # chunks (a python loop of independent gathers lets the scheduler keep
    # several alive — the remat-clone failure mode)
    row_bytes = cap * Mm * (sd + 1) * 4
    n_chunks = int(max(1, -(-cells_cap * row_bytes // chunk_budget)))
    if n_chunks == 1:
        rows = packed[bins.p_cell.reshape(-1)]
        rows = transfer.barrier(rows)
        Z_s = rows[:, : Mm * sd].reshape(cells_cap, cap * Mm, sd)
        lam_s = rows[:, Mm * sd:].reshape(cells_cap, cap * Mm)
        # per-cell block sums over q = (slot, mode). Z columns are (e, k)
        # within a mode (see _mode_vectors): r = b*s + j, s' = a*s + i
        B = jnp.einsum("xqr,xqs->xrs", Z_s * lam_s[:, :, None], Z_s)
        return B.reshape(cells_cap, dim, s, dim, s).transpose(0, 2, 4, 1, 3)

    # CHUNKED: gather RAW per-particle inputs into slot order per cell
    # chunk and recompute the mode vectors in-chunk. The global Z is
    # (n, M*s*d) — 2.8 GB at 400k particles / composed width 4 — and the
    # packed-gather formulation keeps ~3 copies alive (Z, packed, gathered
    # rows): the raw inputs are ~7.6x smaller per row. Particles belong to
    # exactly ONE cell, so the slot gather is a permutation (no recompute
    # duplication).
    del packed, Z, lam
    raw, _, n_pairs = _mode_raw_pack(stencil, F_n, ctx, V0, dim)
    W = raw.shape[1]
    raw_bytes = cap * (W + Mm * (sd + 1)) * 4
    n_chunks = int(max(1, -(-cells_cap * raw_bytes // chunk_budget)))
    chunk = -(-cells_cap // n_chunks)
    pad_cells = n_chunks * chunk - cells_cap
    p_cell = jnp.concatenate(
        [bins.p_cell,
         jnp.full((pad_cells, cap), n, bins.p_cell.dtype)], axis=0
    ).reshape(n_chunks, chunk, cap)

    def body(pc):
        rows = transfer.barrier(raw[pc.reshape(-1)])          # (chunk*cap, W)
        return _chunk_mode_blocks(rows, chunk, cap, s, dim, n_pairs, dt)

    out = jax.lax.map(body, p_cell)
    return out.reshape(n_chunks * chunk, s, s, dim, dim)[:cells_cap]


def _mode_raw_pack(stencil: transfer.Stencil, F_n, ctx, V0, dim: int):
    """Concatenate the raw per-particle inputs of `_mode_vectors` into ONE
    (n + 1, W) matrix (last row = zero pad for invalid slots) so a cell
    chunk's inputs are a single slot-order gather. ~7.6x smaller per row
    than gathering precomputed mode vectors (cell_mode_blocks note)."""
    s = stencil.wn.shape[1]
    n = stencil.wn.shape[0]
    sd = s * dim
    dd = dim * dim
    n_pairs = len(cm._pairs(dim))
    raw = jnp.concatenate([
        stencil.gwn.reshape(n, sd),
        F_n.reshape(n, dd),
        ctx.U.reshape(n, dd), ctx.V.reshape(n, dd), ctx.A.reshape(n, dd),
        ctx.b_plus, ctx.b_minus, V0[:, None],
    ], axis=1)
    W = raw.shape[1]
    raw = jnp.concatenate([raw, jnp.zeros((1, W), raw.dtype)], axis=0)
    return raw, W, n_pairs


def _chunk_mode_blocks(rows, chunk: int, cap: int, s: int, dim: int,
                       n_pairs: int, dt):
    """(chunk*cap, W) raw slot rows -> (chunk, s_j, s_i, d, d) block sums
    (the per-chunk core of cell_mode_blocks: unpack, recompute mode
    vectors in-chunk, one batched matmul per cell)."""
    m = rows.shape[0]
    sd = s * dim
    dd = dim * dim
    o = 0

    def take(k, shape):
        nonlocal o
        part = rows[:, o:o + k]
        o += k
        return part.reshape((m,) + shape)

    gwn_s = take(sd, (s, dim))
    F_s = take(dd, (dim, dim))
    U_s = take(dd, (dim, dim))
    V_s = take(dd, (dim, dim))
    A_s = take(dd, (dim, dim))
    bp_s = take(n_pairs, (n_pairs,))
    bm_s = take(n_pairs, (n_pairs,))
    V0_s = take(1, ())
    st_s = transfer.Stencil(
        node_ids=jnp.zeros((m, s), jnp.int32),
        wn=jnp.zeros((m, s), rows.dtype), gwn=gwn_s,
        rel=jnp.zeros((0,), rows.dtype),
    )
    ctx_s = cm.HessianContext(U=U_s, V=V_s, A=A_s, b_plus=bp_s,
                              b_minus=bm_s)
    Zc, lamc = _mode_vectors(st_s, F_s, ctx_s, V0_s, dt, dim)
    Mm = lamc.shape[1]
    Z_s = Zc.reshape(chunk, cap * Mm, sd)
    lam_s = lamc.reshape(chunk, cap * Mm)
    B = jnp.einsum("xqr,xqs->xrs", Z_s * lam_s[:, :, None], Z_s)
    return B.reshape(chunk, dim, s, dim, s).transpose(0, 2, 4, 1, 3)


def cell_mode_blocks_scatter(bins, stencil: transfer.Stencil, F_n, ctx, V0,
                             dt, dim: int, vals, rows_j, off_id,
                             chunk_budget: int = 512 * 2 ** 20):
    """Scan-FUSED mode assembly: compute each cell chunk's stencil blocks
    and scatter them into `vals` inside one lax.scan body, so the full
    (cells_cap, s, s, d, d) block tensor NEVER materializes.

    Why (128^3 composed level-1): cell_mode_blocks + a separate scatter
    keeps the whole block output plus double-buffered chunk working sets
    alive at once. Fused, the peak is ONE chunk working set
    (~chunk_budget) + the vals carry.

    vals:   (n_rows_pad, K, d*d) zero-initialized scatter target (carried
            through the scan — callers slice off their dump-row pad).
    rows_j: (s, cells_cap) int32 PRE-RESOLVED target row per (stencil
            offset j, cell); invalid entries must already point at
            caller-provided dump rows inside n_rows_pad.
    off_id: (s, s) static numpy column-id table (offset of stencil node i
            relative to j in the (2*half+1)-wide structure).
    """
    import numpy as _np

    s = stencil.wn.shape[1]
    n = stencil.wn.shape[0]
    cells_cap, cap = bins.p_cell.shape
    dd = dim * dim
    assert rows_j.shape == (s, cells_cap), (rows_j.shape, (s, cells_cap))

    raw, W, n_pairs = _mode_raw_pack(stencil, F_n, ctx, V0, dim)
    Mm = dim + 2 * n_pairs
    sd = s * dim
    per_cell = (cap * (W + Mm * (sd + 1)) + s * s * dd) * 4
    n_chunks = int(max(1, -(-cells_cap * per_cell // chunk_budget)))
    chunk = -(-cells_cap // n_chunks)
    pad_cells = n_chunks * chunk - cells_cap
    p_cell = jnp.concatenate(
        [bins.p_cell, jnp.full((pad_cells, cap), n, bins.p_cell.dtype)],
        axis=0).reshape(n_chunks, chunk, cap)
    # pad cells scatter to the LAST dump row (their blocks are zero: every
    # slot gathers the zero pad row of `raw`)
    rows_pad = jnp.full((s, pad_cells), vals.shape[0] - 1, rows_j.dtype)
    rows_sc = jnp.concatenate([rows_j, rows_pad], axis=1).reshape(
        s, n_chunks, chunk).transpose(1, 0, 2)            # (n_chunks, s, chunk)
    cols = [jnp.asarray(_np.asarray(off_id[j]), jnp.int32) for j in range(s)]

    def body(v, xs):
        pc, rj = xs
        rows = transfer.barrier(raw[pc.reshape(-1)])
        blocks = _chunk_mode_blocks(rows, chunk, cap, s, dim, n_pairs, dt)
        for j in range(s):
            v = v.at[rj[j][:, None], cols[j][None, :]].add(
                blocks[:, j].reshape(chunk, s, dd), unique_indices=True)
        return v, None

    vals, _ = jax.lax.scan(body, vals, (p_cell, rows_sc))
    return vals


def stencil_offset_table(dim: int, s: int):
    """Static (s, s) table of 5-wide offset ids (column slot of stencil
    node i relative to node j) + per-j flat dense-node offsets."""
    import numpy as _np

    rng3 = _np.arange(3)
    offs = _np.stack(
        _np.meshgrid(*([rng3] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    rel = offs[None, :, :] - offs[:, None, :] + 2
    off_id = _np.zeros((s, s), _np.int64)
    for a in range(dim):
        off_id = off_id * 5 + rel[:, :, a]
    return offs, off_id


def assemble_hessian_modes(
    mat: BsrMatrix, bins, stencil: transfer.Stencil, F_n, ctx, V0, dt, grid_m,
) -> BsrMatrix:
    """Scatter-free BSR assembly via the rank-1 mode factorization: per-cell
    block sums are ONE batched matmul B = (lam Z)^T Z over the cell's
    (slot, mode) rows; then the same per-j-offset unique scatters as
    assemble_hessian_binned. Equivalent to assemble_hessian — tested."""
    import numpy as _np

    dim = mat.dim
    assert mat.half == 2
    K = mat.K
    s = stencil.wn.shape[1]
    n_nodes = transfer.n_nodes_of(mat.res)
    n_rows = mat.n_rows
    cells_cap, cap = bins.p_cell.shape

    blocks = cell_mode_blocks(bins, stencil, F_n, ctx, V0, dt, dim)

    # static offset-id table (identical to assemble_hessian_binned)
    rng3 = _np.arange(3)
    offs = _np.stack(
        _np.meshgrid(*([rng3] * dim), indexing="ij"), -1
    ).reshape(-1, dim)
    rel = offs[None, :, :] - offs[:, None, :] + 2
    off_id = _np.zeros((s, s), _np.int64)
    for a in range(dim):
        off_id = off_id * 5 + rel[:, :, a]
    node_strides = _np.array(
        [int(_np.prod(mat.res[a + 1:])) for a in range(dim)], _np.int64
    )
    joff_flat = (offs * node_strides[None, :]).sum(axis=1)

    valid_cell = bins.active_cells < n_nodes
    vals = jnp.zeros((n_rows + cells_cap, K, dim * dim), blocks.dtype)
    dump_rows = n_rows + jnp.arange(cells_cap, dtype=jnp.int32)
    for j in range(s):
        node_j = bins.active_cells + int(joff_flat[j])
        r_j = mat.row_of[jnp.clip(node_j, 0, n_nodes - 1)]
        r_j = jnp.where(valid_cell & (r_j >= 0), r_j, dump_rows)
        cols_j = jnp.asarray(off_id[j], jnp.int32)
        vals = vals.at[r_j[:, None], cols_j[None, :]].add(
            blocks[:, j].reshape(cells_cap, s, dim * dim),
            unique_indices=True,
        )
    vals = vals[:n_rows].reshape(n_rows, K * dim * dim)
    return mat._replace(
        vals=_finalize_vals(mat, vals, grid_m, n_nodes, dim, K)
    )


def _spmv_slabs(vals, xg_cols, ok):
    """y = A x in (i, j)-SLAB form: 2D (n_rows, K) elementwise products
    + row reductions, never a dot_general over the tiny (d, d) dims.

    The einsum spelling ("rkij,rkj->ri") lowers to dot_general contracting
    (k, j), which lays both operands out with the tiny dims minor
    (docs/KERNEL_PLAN.md "Tiny trailing dims"). vals[:, :, i, j] slices
    keep the row dim minor.

    vals: (n_rows, K*d*d) flat k-major; xg_cols[j]: (n_rows, K) gathered
    column j of x (unmasked); ok: (n_rows, K) structure mask.
    """
    d = len(xg_cols)
    dd = d * d
    ys = []
    for i in range(d):
        acc = None
        for j in range(d):
            t = vals[:, i * d + j::dd] * xg_cols[j]     # strided (n_rows, K)
            acc = t if acc is None else acc + t
        ys.append(jnp.sum(jnp.where(ok, acc, 0.0), axis=1))
    return jnp.stack(ys, axis=-1)


def spmv(mat: BsrMatrix, x):
    """y = A x on row vectors x: (n_rows, d).

    ONE gather instead of d column gathers (docs/KERNEL_PLAN.md "Dynamic
    indexing"), then (n_rows, K) slices as slabs."""
    safe_cols = jnp.maximum(mat.col_row, 0)
    ok = mat.col_row >= 0
    xg = x[safe_cols]                                      # (n_rows, K, d)
    return _spmv_slabs(mat.vals, [xg[:, :, j] for j in range(mat.dim)], ok)


def spmv_windowed(mat: BsrMatrix, x_grid):
    """y = A x with x given as the DENSE grid vector (n_nodes, d).

    Latency-friendly gather shape: build the K-offset neighbor
    window with STATIC shifted slices of the dense grid (regular), then
    ONE big-row gather per matrix row — instead of n_rows*K tiny-row
    gathers. Equivalent to spmv(mat, rows(x)) because out-of-structure
    offsets carry zero blocks.

    Materializes the (n_nodes, K, d) window ONCE (an optimization_barrier
    stops XLA from fusing the window build into the einsum and re-executing
    it per use).
    """
    import numpy as _np

    d = mat.dim
    res = mat.res
    K = mat.K
    half = mat.half
    n_nodes = transfer.n_nodes_of(res)
    xg = x_grid.reshape(tuple(res) + (d,))
    rng = _np.arange(-half, half + 1)
    offs = _np.stack(_np.meshgrid(*([rng] * d), indexing="ij"), -1).reshape(-1, d)
    win = []
    for k in range(K):
        off = offs[k]
        # neighbor value at node c is x[c + off]: shift by -off with zero pad
        src = xg[tuple(
            slice(max(0, o), r + min(0, o)) for o, r in zip(off, res)
        )]
        pad = [(max(0, -int(o)), max(0, int(o))) for o in off] + [(0, 0)]
        win.append(jnp.pad(src, pad))
    W = jnp.stack(win, axis=-2).reshape(n_nodes, K, d)     # (n_nodes, K, d)
    W = transfer.barrier(W)                                # materialize once
    rows = jnp.minimum(mat.node_of, n_nodes - 1)
    xw = W[rows]                                           # one big-row gather
    ok = jnp.broadcast_to((mat.node_of < n_nodes)[:, None], xw.shape[:2])
    return _spmv_slabs(mat.vals, [xw[:, :, j] for j in range(d)], ok)


def spmm(mat: BsrMatrix, X):
    """Y = A X for multi-RHS X: (n_rows, d, m) (SpMM, BASELINE.json:2).
    ONE gather, then slab form per RHS column (see _spmv_slabs/spmv)."""
    safe_cols = jnp.maximum(mat.col_row, 0)
    ok = mat.col_row >= 0
    Xg = X[safe_cols]                                      # (n_rows, K, d, m)
    cols = [
        _spmv_slabs(mat.vals,
                    [Xg[:, :, j, r] for j in range(mat.dim)], ok)
        for r in range(X.shape[-1])
    ]
    return jnp.stack(cols, axis=-1)                        # (n_rows, d, m)


def block_diag(mat: BsrMatrix):
    """(n_rows, d, d) diagonal blocks (block-Jacobi)."""
    d = mat.dim
    dd = d * d
    c = (mat.K - 1) // 2
    return mat.vals[:, c * dd:(c + 1) * dd].reshape(mat.n_rows, d, d)


def grid_vector_to_rows(mat: BsrMatrix, v):
    """(n_nodes, d) -> (n_rows, d)."""
    n_nodes = v.shape[0]
    safe = jnp.minimum(mat.node_of, n_nodes - 1)
    out = v[safe]
    return jnp.where((mat.node_of < n_nodes)[:, None], out, 0.0)


def rows_to_grid_vector(mat: BsrMatrix, y, n_nodes: int):
    """(n_rows, d) -> (n_nodes, d)."""
    out = jnp.zeros((n_nodes + 1, y.shape[1]), y.dtype)
    safe = jnp.minimum(mat.node_of, n_nodes)
    return out.at[safe].set(y)[:n_nodes]


def to_scipy(mat: BsrMatrix):
    """Dense scipy check matrix over row DoFs (tests only)."""
    import numpy as np

    d = mat.dim
    n = mat.n_rows
    A = np.zeros((n * d, n * d))
    vals = np.asarray(mat.vals).reshape(n, mat.K, d, d)
    col = np.asarray(mat.col_row)
    for r in range(n):
        for k in range(col.shape[1]):
            c = col[r, k]
            if c >= 0:
                A[r * d:(r + 1) * d, c * d:(c + 1) * d] += vals[r, k]
    return A
