"""Galerkin RAP (structured SpGEMM) tests: A_c == P^T A P against a dense
numpy construction of the node-embedding prolongation (SURVEY.md §4.3).
"""

import jax.numpy as jnp
import numpy as np

from hot_mpm.ops import bsr, spgemm, transfer
from test_bsr import _setup


def _dense_P(res_f, res_c):
    """Dense prolongation: fine node j <- coarse stencil weights (numpy)."""
    nf = int(np.prod(res_f))
    nc = int(np.prod(res_c))
    P = np.zeros((nf, nc))
    dim = len(res_f)
    coords = np.stack(
        np.meshgrid(*[np.arange(r) for r in res_f], indexing="ij"), -1
    ).reshape(-1, dim)
    for j in range(nf):
        xs = coords[j] / 2.0
        base = np.floor(xs - 0.5).astype(int)
        u = xs - base
        w_ax = np.stack(
            [0.5 * (1.5 - u) ** 2, 0.75 - (u - 1.0) ** 2, 0.5 * (u - 0.5) ** 2], -1
        )
        for k in range(3**dim):
            kk = [(k // (3 ** (dim - 1 - a))) % 3 for a in range(dim)]
            J = base + np.asarray(kk)
            if np.all(J >= 0) and np.all(J < np.asarray(res_c)):
                Jflat = 0
                for a in range(dim):
                    Jflat = Jflat * res_c[a] + J[a]
                w = 1.0
                for a in range(dim):
                    w *= w_ax[a, kk[a]]
                P[j, Jflat] = w
    return P


def test_rap_matches_dense():
    mat, obj, hess, state, gm, active, n_nodes = _setup(res=20)
    res_f = mat.res
    res_c = tuple((r + 1) // 2 for r in res_f)

    # coarse activity: any coarse node receiving weight from an active fine node
    coords = transfer.unravel(jnp.arange(n_nodes), res_f)
    base, w = spgemm.embedding_weights(coords, jnp.float64)
    from hot_mpm.ops.bspline import stencil_offsets

    offs = stencil_offsets(2)
    Jc = base[:, None, :] + offs[None]
    ok = jnp.all((Jc >= 0) & (Jc < jnp.asarray(res_c)), axis=-1)
    Jflat = Jc[..., 0] * res_c[1] + Jc[..., 1]
    touched = jnp.zeros(int(np.prod(res_c)), bool).at[
        jnp.where(ok & (w > 0) & active[:, None], Jflat, 0)
    ].set(True)
    coarse_active = touched
    cap_c = int(np.asarray(coarse_active).sum()) + 8

    A_c = spgemm.rap(mat, res_c, coarse_active, cap_c)

    # dense check: P^T A_dense P restricted to coarse rows
    d = 2
    nf = n_nodes
    A_dense_rows = bsr.to_scipy(mat)  # over row dofs
    # expand to full fine-node dof matrix
    node_of = np.asarray(mat.node_of)
    valid = node_of < nf
    A_full = np.zeros((nf * d, nf * d))
    idx = node_of[valid]
    rmap = np.repeat(idx * d, d) + np.tile(np.arange(d), idx.size)
    sub = A_dense_rows[np.ix_(np.repeat(np.where(valid)[0] * d, d) + np.tile(np.arange(d), valid.sum()),
                              np.repeat(np.where(valid)[0] * d, d) + np.tile(np.arange(d), valid.sum()))]
    A_full[np.ix_(rmap, rmap)] = sub

    P1 = _dense_P(res_f, res_c)
    Pd = np.kron(P1, np.eye(d))
    A_c_dense_want = Pd.T @ A_full @ Pd

    A_c_rows = bsr.to_scipy(A_c)
    node_of_c = np.asarray(A_c.node_of)
    nc = int(np.prod(res_c))
    valid_c = node_of_c < nc
    idx_c = node_of_c[valid_c]
    cmap = np.repeat(idx_c * d, d) + np.tile(np.arange(d), idx_c.size)
    rsel = np.repeat(np.where(valid_c)[0] * d, d) + np.tile(np.arange(d), valid_c.sum())
    got = A_c_rows[np.ix_(rsel, rsel)]
    want = A_c_dense_want[np.ix_(cmap, cmap)]
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_rap_symmetric_psd():
    mat, obj, hess, state, gm, active, n_nodes = _setup(res=20)
    res_c = tuple((r + 1) // 2 for r in mat.res)
    coarse_active = jnp.ones(int(np.prod(res_c)), bool)
    A_c = spgemm.rap(mat, res_c, coarse_active, int(np.prod(res_c)))
    A = bsr.to_scipy(A_c)
    np.testing.assert_allclose(A, A.T, atol=1e-8)
    w = np.linalg.eigvalsh(A)
    assert w.min() > -1e-7, w.min()


def test_rap_recursive_matches_dense():
    """Two-level recursion: rap on the 7-wide RAP output must equal the
    dense P2^T (P1^T A P1) P2 (the galerkin MG hierarchy's level-2 op)."""
    mat, obj, hess, state, gm, active, n_nodes = _setup(res=20)
    res_f = mat.res
    res_c = tuple((r + 1) // 2 for r in res_f)
    res_cc = tuple((r + 1) // 2 for r in res_c)

    nc = int(np.prod(res_c))
    ncc = int(np.prod(res_cc))
    A_c = spgemm.rap(mat, res_c, jnp.ones(nc, bool), nc)
    assert A_c.half == spgemm.rap_half_out(2) == 3
    A_cc = spgemm.rap(A_c, res_cc, jnp.ones(ncc, bool), ncc)
    assert A_cc.half == spgemm.rap_half_out(3) == 4

    d = 2
    nf = n_nodes
    node_of = np.asarray(mat.node_of)
    valid = node_of < nf
    A_full = np.zeros((nf * d, nf * d))
    idx = node_of[valid]
    rmap = np.repeat(idx * d, d) + np.tile(np.arange(d), idx.size)
    rows = np.repeat(np.where(valid)[0] * d, d) + np.tile(np.arange(d), valid.sum())
    A_full[np.ix_(rmap, rmap)] = bsr.to_scipy(mat)[np.ix_(rows, rows)]

    P1 = np.kron(_dense_P(res_f, res_c), np.eye(d))
    P2 = np.kron(_dense_P(res_c, res_cc), np.eye(d))
    want_full = P2.T @ (P1.T @ A_full @ P1) @ P2

    got = bsr.to_scipy(A_cc)    # rows == coarse-coarse nodes (capacity=ncc,
                                # all active)
    node_cc = np.asarray(A_cc.node_of)
    sel = np.repeat(node_cc * d, d) + np.tile(np.arange(d), node_cc.size)
    np.testing.assert_allclose(got, want_full[np.ix_(sel, sel)], atol=1e-9)


def test_composed_galerkin_equals_rap(rng):
    """ops.composed.assemble_composed_galerkin == spgemm.rap(assembled A0):
    the composed-stencil construction produces EXACTLY P^T (M + dt^2 K) P
    with no explicit fine matrix (the >=256^3 matrix-free-finest path)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hot_mpm.models import constitutive as cm
    from hot_mpm.ops import bsr, composed as comp_mod, spgemm, transfer

    model = cm.FixedCorotated()
    for dim, res_n, n in ((2, 16, 250), (3, 8, 120)):
        res = (res_n,) * dim
        dx = 1.0 / res_n
        lo, hi = 2.5 * dx, (res_n - 3.5) * dx
        x = jnp.asarray(rng.uniform(lo, hi, size=(n, dim)))
        F = jnp.asarray(
            np.eye(dim)[None] + 0.1 * rng.standard_normal((n, dim, dim))
        )
        V0 = jnp.asarray(rng.uniform(0.5, 1.5, (n,)))
        mu = jnp.full((n,), 30.0)
        lam = jnp.full((n,), 50.0)
        m = jnp.asarray(rng.uniform(0.5, 2.0, (n,)))
        dt = 1e-2
        ctx = jax.vmap(lambda f, m_, l_: cm.hessian_context(model, f, m_, l_))(
            F, mu, lam
        )

        # explicit fine operator + algebraic RAP (the reference path)
        n_nodes = transfer.n_nodes_of(res)
        st = transfer.particle_stencil(x, dx, res)
        grid_m = transfer.scatter_sum(st.node_ids, st.wn * m[:, None], n_nodes)
        A0 = bsr.structure(jnp.ones((n_nodes,), bool), res, n_nodes)
        A0 = bsr.assemble_hessian(A0, st, F, ctx, V0, dt, grid_m)
        cres = tuple(r // 2 for r in res)
        n_c = transfer.n_nodes_of(cres)
        A1_rap = spgemm.rap(A0, cres, jnp.ones((n_c,), bool), n_c)

        # composed construction (no fine matrix)
        cb, cw, cdw = comp_mod.composed_particle_weights(x, dx, 1)
        caps = comp_mod.composed_bin_caps_host(x, dx, 1, cres, dim)
        p_bins = transfer.bin_by_ids(
            comp_mod.ext_key(cb, cres), comp_mod.n_ext(cres), *caps
        )
        assert not bool(p_bins.overflow)
        node_coords = transfer.unravel(
            jnp.arange(n_nodes, dtype=jnp.int32), res
        )
        nb = jnp.floor_divide(node_coords - 1, 2)
        n_bins = transfer.bin_by_ids(
            comp_mod.ext_key(nb, cres), comp_mod.n_ext(cres),
            min(n_nodes, comp_mod.n_ext(cres)), 2**dim,
            valid=grid_m > 0,
        )
        assert not bool(n_bins.overflow)
        A1_c = bsr.structure(jnp.ones((n_c,), bool), res=cres,
                             capacity=n_c, half=3)
        A1_c = comp_mod.assemble_composed_galerkin(
            A1_c, 1, cres, F, ctx, V0, dt, node_coords, grid_m,
            p_bins, n_bins, cw, cdw,
        )
        # both structures index rows by coarse node id (active = all)
        np.testing.assert_allclose(
            np.asarray(A1_c.vals), np.asarray(A1_rap.vals),
            rtol=1e-6, atol=1e-9,
        )
