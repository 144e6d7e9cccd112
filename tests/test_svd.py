"""SVD/eigen unit tests: reconstruction, conventions, degenerate cases,
and the analytic JVP versus numerical differences.

Mirrors the reference's reliance on ImplicitQRSVD correctness (component #9)
— here tested explicitly rather than implicitly through DiffTest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hot_mpm.ops.svd import svd, svd2, svd3, polar, eigh_sym


def random_mats(rng, n, d, scale=1.0):
    return jnp.asarray(rng.standard_normal((n, d, d)) * scale)


@pytest.mark.parametrize("d", [2, 3])
def test_svd_reconstruction_random(rng, d):
    A = random_mats(rng, 200, d)
    U, s, V = jax.vmap(svd)(A)
    rec = jnp.einsum("nij,nj,nkj->nik", U, s, V)
    np.testing.assert_allclose(rec, A, atol=1e-10)


@pytest.mark.parametrize("d", [2, 3])
def test_svd_conventions(rng, d):
    A = random_mats(rng, 200, d)
    U, s, V = jax.vmap(svd)(A)
    # Proper rotations
    np.testing.assert_allclose(jnp.linalg.det(U), 1.0, atol=1e-10)
    np.testing.assert_allclose(jnp.linalg.det(V), 1.0, atol=1e-10)
    # Orthogonality
    eye = jnp.eye(d)
    np.testing.assert_allclose(U @ jnp.swapaxes(U, 1, 2) - eye[None], 0.0, atol=1e-10)
    np.testing.assert_allclose(V @ jnp.swapaxes(V, 1, 2) - eye[None], 0.0, atol=1e-10)
    # Descending magnitudes, only the last may be negative
    assert bool(jnp.all(s[:, 0] >= s[:, 1] - 1e-12))
    if d == 3:
        assert bool(jnp.all(s[:, 1] >= jnp.abs(s[:, 2]) - 1e-12))
    assert bool(jnp.all(s[:, :-1] >= -1e-12))
    # sigma[-1] sign tracks det(A)
    det = jnp.linalg.det(A)
    np.testing.assert_allclose(jnp.sign(s[:, -1]) * (jnp.abs(det) > 1e-12), jnp.sign(det), atol=0)


@pytest.mark.parametrize(
    "mat",
    [
        np.eye(3),
        np.zeros((3, 3)),
        np.diag([1.0, 1.0, 1.0]),
        np.diag([2.0, 2.0, 0.5]),
        np.diag([1.0, 1.0, -1.0]),  # reflection
        np.diag([3.0, 0.0, 0.0]),   # rank 1
        np.diag([1e-8, 1e-8, 1e-8]),
        np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]),  # rotation
    ],
)
def test_svd_degenerate_3x3(mat):
    A = jnp.asarray(mat)
    U, s, V = svd(A)
    rec = (U * s[None, :]) @ V.T
    np.testing.assert_allclose(rec, A, atol=1e-9)
    np.testing.assert_allclose(jnp.linalg.det(U), 1.0, atol=1e-9)
    np.testing.assert_allclose(jnp.linalg.det(V), 1.0, atol=1e-9)


def test_svd_matches_numpy_singular_values(rng):
    A = random_mats(rng, 100, 3)
    _, s, _ = jax.vmap(svd)(A)
    s_np = np.linalg.svd(np.asarray(A), compute_uv=False)
    np.testing.assert_allclose(np.abs(np.asarray(s)), s_np, atol=1e-9)


def test_svd_jvp_matches_fd(rng):
    """Analytic JVP vs central differences at generic states."""
    A = jnp.asarray(rng.standard_normal((3, 3)))
    dA = jnp.asarray(rng.standard_normal((3, 3)))
    eps = 1e-6

    (U, s, V), (dU, ds, dV) = jax.jvp(svd, (A,), (dA,))
    Up, sp, Vp = svd(A + eps * dA)
    Um, sm, Vm = svd(A - eps * dA)
    np.testing.assert_allclose(ds, (sp - sm) / (2 * eps), atol=1e-5)
    np.testing.assert_allclose(dU, (Up - Um) / (2 * eps), atol=1e-5)
    np.testing.assert_allclose(dV, (Vp - Vm) / (2 * eps), atol=1e-5)


def test_svd_grad_no_nan_at_identity():
    """Gradients must be finite at degenerate inputs (repeated sigmas)."""

    def f(A):
        U, s, V = svd(A)
        return jnp.sum(s**2) + jnp.sum(U) + jnp.sum(V)

    for A in [jnp.eye(3), jnp.zeros((3, 3)), jnp.diag(jnp.array([2.0, 2.0, 2.0]))]:
        g = jax.grad(f)(A)
        assert bool(jnp.all(jnp.isfinite(g)))


def test_polar(rng):
    A = random_mats(rng, 50, 3)
    R, S = polar(A)
    np.testing.assert_allclose(R @ S, A, atol=1e-9)
    np.testing.assert_allclose(jnp.linalg.det(R), 1.0, atol=1e-9)
    np.testing.assert_allclose(S, jnp.swapaxes(S, 1, 2), atol=1e-9)


@pytest.mark.parametrize("d", [2, 3])
def test_eigh_sym(rng, d):
    A = random_mats(rng, 100, d)
    S = A + jnp.swapaxes(A, 1, 2)
    w, Q = jax.vmap(eigh_sym)(S)
    rec = jnp.einsum("nij,nj,nkj->nik", Q, w, Q)
    np.testing.assert_allclose(rec, S, atol=1e-9)
    # descending eigenvalues
    assert bool(jnp.all(w[:, :-1] >= w[:, 1:] - 1e-10))
    w_np = np.linalg.eigvalsh(np.asarray(S))[:, ::-1]
    np.testing.assert_allclose(np.asarray(w), w_np, atol=1e-8)


def test_batched_wrappers(rng):
    A3 = jnp.asarray(rng.standard_normal((4, 5, 3, 3)))
    U, s, V = svd3(A3)
    assert U.shape == (4, 5, 3, 3) and s.shape == (4, 5, 3)
    rec = jnp.einsum("...ij,...j,...kj->...ik", U, s, V)
    np.testing.assert_allclose(rec, A3, atol=1e-9)

    A2 = jnp.asarray(rng.standard_normal((7, 2, 2)))
    U, s, V = svd2(A2)
    rec = jnp.einsum("...ij,...j,...kj->...ik", U, s, V)
    np.testing.assert_allclose(rec, A2, atol=1e-10)


def test_svd_float32_accuracy(rng):
    """fp32 path (the device path) stays within fp32-appropriate tolerance."""
    A = jnp.asarray(rng.standard_normal((100, 3, 3)), dtype=jnp.float32)
    U, s, V = jax.vmap(svd)(A)
    assert U.dtype == jnp.float32
    rec = jnp.einsum("nij,nj,nkj->nik", U, s, V)
    np.testing.assert_allclose(rec, A, atol=5e-5)
