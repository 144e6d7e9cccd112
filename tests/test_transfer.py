"""Transfer-kernel unit tests (SURVEY.md §4.3): P2G == reference scatter,
polynomial reproduction, conservation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hot_mpm.ops.bspline import (
    quadratic_bspline_weights,
    quadratic_kernel_1d,
    stencil_offsets,
    tensor_weights,
)
from hot_mpm.ops import transfer


def rand_positions(rng, n, dim, res, dx):
    # keep particles well inside so clipping never kicks in
    return jnp.asarray(rng.uniform(3 * dx, (res - 4) * dx, (n, dim)))


def test_partition_of_unity_and_linear_reproduction(rng):
    """Quadratic B-splines: sum_i w = 1, sum_i w x_i = x_p, sum_i gw = 0,
    sum_i x_i gw^T = I."""
    dx = 1.0 / 32
    for dim in (2, 3):
        x = rand_positions(rng, 100, dim, 32, dx)
        base, w, dw = quadratic_bspline_weights(x, dx)
        wn, gwn = tensor_weights(w, dw)
        offs = stencil_offsets(dim)
        node_pos = (base[:, None, :] + offs[None]).astype(x.dtype) * dx
        np.testing.assert_allclose(wn.sum(1), 1.0, atol=1e-12)
        np.testing.assert_allclose(
            jnp.einsum("pk,pki->pi", wn, node_pos), x, atol=1e-12
        )
        np.testing.assert_allclose(gwn.sum(1), 0.0, atol=1e-9)
        eye = jnp.eye(dim)
        np.testing.assert_allclose(
            jnp.einsum("pki,pkj->pij", node_pos, gwn) - eye[None], 0.0, atol=1e-9
        )


def test_kernel_1d_values():
    """Spot values: at u=1 (particle exactly on a node) weights = [1/8, 3/4, 1/8]."""
    w = quadratic_kernel_1d(jnp.asarray(1.0))
    np.testing.assert_allclose(w, [0.125, 0.75, 0.125], atol=1e-12)


def test_scatter_matches_bincount(rng):
    res = (16, 16)
    dx = 1.0 / 16
    x = rand_positions(rng, 50, 2, 16, dx)
    st = transfer.particle_stencil(x, dx, res)
    vals = jnp.asarray(rng.standard_normal(st.wn.shape))
    got = transfer.scatter_sum(st.node_ids, vals, 256)
    want = np.bincount(
        np.asarray(st.node_ids).reshape(-1),
        weights=np.asarray(vals).reshape(-1),
        minlength=256,
    )
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_p2g_conservation(rng, dim):
    res = (24,) * dim
    dx = 1.0 / 24
    n = 200
    x = rand_positions(rng, n, dim, 24, dx)
    v = jnp.asarray(rng.standard_normal((n, dim)))
    C = jnp.asarray(rng.standard_normal((n, dim, dim)))
    m = jnp.asarray(rng.uniform(0.5, 2.0, (n,)))
    st = transfer.particle_stencil(x, dx, res)
    gm, gmv = transfer.p2g_mass_momentum(st, v, C, m, transfer.n_nodes_of(res))
    np.testing.assert_allclose(gm.sum(), m.sum(), rtol=1e-12)
    # affine term is momentum-free: sum_i m w C (x_i - x_p) = m C (x_p - x_p) = 0
    np.testing.assert_allclose(gmv.sum(0), (m[:, None] * v).sum(0), rtol=1e-10)


@pytest.mark.parametrize("dim", [2, 3])
def test_g2p_reproduces_affine_field(rng, dim):
    """grid v_i = a + B x_i  =>  v_p = a + B x_p, grad_v = B, C = B (APIC)."""
    res = (20,) * dim
    dx = 1.0 / 20
    x = rand_positions(rng, 80, dim, 20, dx)
    a = jnp.asarray(rng.standard_normal(dim))
    B = jnp.asarray(rng.standard_normal((dim, dim)))
    node_pos = transfer.node_positions(res, dx, x.dtype)
    grid_v = a[None] + node_pos @ B.T
    st = transfer.particle_stencil(x, dx, res)
    v_p, grad_v, C = transfer.g2p(st, grid_v, dx)
    np.testing.assert_allclose(v_p, a[None] + x @ B.T, atol=1e-10)
    np.testing.assert_allclose(grad_v - B[None], 0.0, atol=1e-8)
    # APIC C with the quadratic-kernel D^-1 recovers B exactly for affine fields
    np.testing.assert_allclose(C - B[None], 0.0, atol=1e-8)


def test_scatter_gather_adjoint(rng):
    """<gather(g), p-values> == <g, scatter(p-values)> — the transpose pair
    the matrix-free Hessian relies on for symmetry."""
    res = (16, 16)
    dx = 1.0 / 16
    x = rand_positions(rng, 40, 2, 16, dx)
    st = transfer.particle_stencil(x, dx, res)
    n_nodes = 256
    g = jnp.asarray(rng.standard_normal((n_nodes,)))
    pv = jnp.asarray(rng.standard_normal(st.wn.shape))
    lhs = jnp.sum(transfer.gather(g, st.node_ids) * pv)
    rhs = jnp.sum(g * transfer.scatter_sum(st.node_ids, pv, n_nodes))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def _bins_setup(rng, dim=2, res=(16, 16), n=300):
    dx = 1.0 / 16
    lo, hi = 2.5 * dx, (res[0] - 3.5) * dx
    x = jnp.asarray(rng.uniform(lo, hi, size=(n, dim)))
    st = transfer.particle_stencil(x, dx, res)
    bins = transfer.bin_particles(x, dx, res, cells_cap=512, cap=32)
    assert not bool(bins.overflow)
    return x, st, bins, dx


def test_binned_scatter_matches_scatter_sum(rng):
    x, st, bins, dx = _bins_setup(rng)
    n, s = st.wn.shape
    n_nodes = transfer.n_nodes_of((16, 16))
    vals = jnp.asarray(rng.standard_normal((n, s, 3)))
    want = transfer.scatter_sum(st.node_ids, vals, n_nodes)
    got = transfer.binned_scatter(bins, vals, (16, 16))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)


def test_slot_scatter_gather_match(rng):
    """Slot-major scatter/gather == particle-order scatter/gather (the
    zero-dynamic-indexing layout of docs/KERNEL_PLAN.md)."""
    x, st, bins, dx = _bins_setup(rng)
    n, s = st.wn.shape
    res = (16, 16)
    n_nodes = transfer.n_nodes_of(res)
    vals = jnp.asarray(rng.standard_normal((n, s, 3)))

    # slot_order / particle_order round trip
    (vals_s, wn_s), valid = transfer.slot_order(bins, [vals, st.wn])
    (vals_back,) = transfer.particle_order(bins, [vals_s], n)
    np.testing.assert_allclose(np.asarray(vals_back), np.asarray(vals), atol=0)
    assert int(valid.sum()) == n

    # scatter equality
    want = transfer.scatter_sum(st.node_ids, vals, n_nodes)
    got = transfer.make_slot_scatter(bins, res)(st, vals_s, n_nodes)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)

    # gather equality (slot rows of real particles == particle gather)
    g = jnp.asarray(rng.standard_normal((n_nodes, 2)))
    got_rows = transfer.make_slot_gather(bins, res)(st, g)
    (got_p,) = transfer.particle_order(bins, [got_rows], n)
    want_g = transfer.gather(g, st.node_ids)
    np.testing.assert_allclose(np.asarray(got_p), np.asarray(want_g), atol=0)


def test_bin_particles_valid_mask_excludes_pads(rng):
    """Pad particles (all piled at one point, the sharded-step layout) must
    not consume cells/caps or trigger overflow when masked invalid — and
    the binned scatter of real particles is unchanged (ADVICE r1 #1)."""
    dim, res, n_real, n_pad = 2, (16, 16), 200, 100
    dx = 1.0 / 16
    lo, hi = 2.5 * dx, (res[0] - 3.5) * dx
    x_real = jnp.asarray(rng.uniform(lo, hi, size=(n_real, dim)))
    # every pad at the domain center -> one cell holds n_pad of them
    x_pad = jnp.full((n_pad, dim), 0.5 * res[0] * dx)
    x = jnp.concatenate([x_real, x_pad], axis=0)
    valid = jnp.concatenate(
        [jnp.ones((n_real,), bool), jnp.zeros((n_pad,), bool)]
    )

    # cap=8 < n_pad: unmasked binning overflows on the pad pile-up
    bins_bad = transfer.bin_particles(x, dx, res, cells_cap=512, cap=8)
    assert bool(bins_bad.overflow)
    bins = transfer.bin_particles(x, dx, res, cells_cap=512, cap=8,
                                  valid=valid)
    assert not bool(bins.overflow)

    # scatter with zero pad values == scatter of the real particles alone
    st = transfer.particle_stencil(x, dx, res)
    n_nodes = transfer.n_nodes_of(res)
    vals = jnp.asarray(rng.standard_normal((n_real + n_pad, st.wn.shape[1], 3)))
    vals = jnp.where(valid[:, None, None], vals, 0.0)
    want = transfer.scatter_sum(st.node_ids, vals, n_nodes)
    got = transfer.binned_scatter(bins, vals, res)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)

    # a genuine overflow among REAL particles must still be flagged
    x_dense = jnp.concatenate(
        [jnp.full((20, dim), 0.3), x_pad], axis=0
    )
    valid2 = jnp.concatenate([jnp.ones((20,), bool), jnp.zeros((n_pad,), bool)])
    bins2 = transfer.bin_particles(x_dense, dx, res, cells_cap=512, cap=8,
                                   valid=valid2)
    assert bool(bins2.overflow)


def test_cubic_partition_of_unity_and_linear_reproduction(rng):
    """Cubic B-splines (4-wide): sum w = 1, sum w x_i = x_p, sum gw = 0,
    sum x_i gw^T = I — same identities the quadratic kernel satisfies."""
    from hot_mpm.ops.bspline import cubic_bspline_weights

    dx = 1.0 / 32
    for dim in (2, 3):
        x = rand_positions(rng, 100, dim, 32, dx)
        base, w, dw = cubic_bspline_weights(x, dx)
        wn, gwn = tensor_weights(w, dw)
        offs = stencil_offsets(dim, 4)
        node_pos = (base[:, None, :] + offs[None]).astype(x.dtype) * dx
        np.testing.assert_allclose(wn.sum(1), 1.0, atol=1e-12)
        np.testing.assert_allclose(
            jnp.einsum("pk,pki->pi", wn, node_pos), x, atol=1e-12
        )
        np.testing.assert_allclose(gwn.sum(1), 0.0, atol=1e-9)
        eye = jnp.eye(dim)
        np.testing.assert_allclose(
            jnp.einsum("pki,pkj->pij", node_pos, gwn) - eye[None], 0.0,
            atol=1e-9,
        )


def test_cubic_kernel_1d_values():
    """At u=1 (particle on a node): cubic weights [1/6, 2/3, 1/6, 0]."""
    from hot_mpm.ops.bspline import cubic_kernel_1d

    w = cubic_kernel_1d(jnp.asarray(1.0))
    np.testing.assert_allclose(
        w, [1.0 / 6.0, 2.0 / 3.0, 1.0 / 6.0, 0.0], atol=1e-12
    )


def test_cubic_g2p_reproduces_affine_field(rng):
    """Cubic G2P with D^-1 = 3/dx^2 recovers an affine grid velocity field
    exactly (APIC consistency for the 4-wide kernel)."""
    dim = 2
    res = (32, 32)
    dx = 1.0 / 32
    x = rand_positions(rng, 80, dim, 32, dx)
    st = transfer.particle_stencil(x, dx, res, kernel="cubic")
    A = jnp.asarray(rng.standard_normal((dim, dim)))
    b = jnp.asarray(rng.standard_normal((dim,)))
    node_pos = transfer.node_positions(res, dx, x.dtype)
    grid_v = node_pos @ A.T + b[None]
    v_p, grad_v, C = transfer.g2p(st, grid_v, dx, d_inv_factor=3.0)
    np.testing.assert_allclose(np.asarray(v_p), np.asarray(x @ A.T + b), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(grad_v), np.broadcast_to(np.asarray(A), grad_v.shape), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(C), np.broadcast_to(np.asarray(A), C.shape), atol=1e-9
    )
