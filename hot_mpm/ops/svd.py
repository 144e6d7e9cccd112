"""Branch-free, vmappable 2x2/3x3 SVD, polar decomposition, symmetric eigen.

Vectorized replacement for the reference's implicit-QR SVD
(reference: Lib/Ziran/Math/Linear/ImplicitQRSVD.h — the Gast/Jiang
branch-free 3x3 SVD used on every particle every Newton iteration).
Design differences from the reference, chosen for batched execution:

  * No data-dependent branching: cyclic Jacobi with `jnp.where`-guarded
    Givens rotations, a fixed number of sweeps, fully `vmap`-batchable. The reference's scalar branchy code would defeat XLA
    vectorization.
  * Derivatives come from a `jax.custom_jvp` implementing the analytic SVD
    differential (with safe-guarded small denominators) instead of
    differentiating through the iteration — cheaper, and well-defined at
    (near-)degenerate singular values.

Conventions (matching the reference's ImplicitQRSVD so downstream
constitutive-model formulas transfer):
  * A = U @ diag(sigma) @ V.T
  * det(U) = det(V) = +1 (proper rotations).
  * sigma sorted descending; sigma[-1] may be negative iff det(A) < 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Symmetric eigendecomposition via cyclic Jacobi (2x2 exact, 3x3 sweeps)
# ---------------------------------------------------------------------------


def _jacobi_rotation(app, aqq, apq):
    """Givens angle (c, s) diagonalizing the 2x2 symmetric [[app,apq],[apq,aqq]].

    Branch-free: returns identity rotation when apq ~ 0. The double-where
    guard keeps reverse-mode gradients NaN-free when apq == 0 exactly.
    """
    dtype = jnp.result_type(app, aqq, apq)
    tiny = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-20, dtype)
    small = jnp.abs(apq) < tiny
    apq_safe = jnp.where(small, jnp.ones((), dtype), apq)
    diff_safe = jnp.where(small, jnp.ones((), dtype), app - aqq)
    theta = jnp.where(small, jnp.zeros((), dtype), 0.5 * jnp.arctan2(2.0 * apq_safe, diff_safe))
    return jnp.cos(theta), jnp.sin(theta)


def _apply_jacobi(S, V, p, q):
    """One (p, q) Jacobi rotation on symmetric S, accumulated into V."""
    c, s = _jacobi_rotation(S[p, p], S[q, q], S[p, q])
    d = S.shape[0]
    G = jnp.eye(d, dtype=S.dtype)
    G = G.at[p, p].set(c).at[q, q].set(c).at[p, q].set(-s).at[q, p].set(s)
    return G.T @ S @ G, V @ G


def eigh_sym(S, sweeps: int = 6):
    """Eigendecomposition of a symmetric (2,2) or (3,3) matrix.

    Returns (w, Q) with S = Q @ diag(w) @ Q.T, eigenvalues descending,
    det(Q) = +1. Fixed `sweeps` cyclic-Jacobi sweeps; 6 sweeps reaches
    fp64 machine precision for 3x3. vmap over leading batch via jax.vmap.
    """
    d = S.shape[-1]
    V = jnp.eye(d, dtype=S.dtype)
    if d == 2:
        S, V = _apply_jacobi(S, V, 0, 1)  # one rotation is exact for 2x2
    elif d == 3:
        for _ in range(sweeps):
            for (p, q) in ((0, 1), (0, 2), (1, 2)):
                S, V = _apply_jacobi(S, V, p, q)
    else:
        raise ValueError(f"eigh_sym supports d in (2, 3); got {d}")
    w = jnp.diagonal(S)
    # Sort eigenvalues descending; realize the permutation with column
    # gathers, then restore det(Q) = +1 with a sign flip on the last column.
    perm = jnp.argsort(-w)
    w = w[perm]
    Q = V[:, perm]
    parity = _perm_parity(perm, d, S.dtype)
    Q = Q.at[:, d - 1].multiply(parity)
    return w, Q


def _perm_parity(perm, d, dtype):
    """+1 / -1 parity of a permutation given as an index array of length d."""
    if d == 2:
        return jnp.where(perm[0] == 0, 1.0, -1.0).astype(dtype)
    # d == 3: Levi-Civita sign of a 3-permutation of {0, 1, 2}.
    i, j, k = perm[0], perm[1], perm[2]
    s = jnp.sign((j - i) * (k - i) * (k - j))
    return s.astype(dtype)


# ---------------------------------------------------------------------------
# Givens QR of a small matrix (used for the U factor)
# ---------------------------------------------------------------------------


def _givens_cs(a, b):
    """(c, s) with [c -s; s c]^T @ [a; b] = [r; 0]; identity when both tiny."""
    dtype = jnp.result_type(a, b)
    r2 = a * a + b * b
    tiny = jnp.asarray(1e-38 if dtype == jnp.float64 else 1e-30, dtype)
    small = r2 < tiny
    inv = jnp.where(small, jnp.zeros((), dtype), jax.lax.rsqrt(jnp.where(small, jnp.ones((), dtype), r2)))
    c = jnp.where(small, jnp.ones((), dtype), a * inv)
    s = jnp.where(small, jnp.zeros((), dtype), b * inv)
    return c, s


def _givens_qr(B):
    """QR of (d,d) B via Givens rotations: B = Q @ R, det(Q) = +1."""
    d = B.shape[-1]
    Q = jnp.eye(d, dtype=B.dtype)
    pairs = [(1, 0)] if d == 2 else [(1, 0), (2, 0), (2, 1)]
    R = B
    for (i, j) in pairs:  # zero R[i, j] by rotating rows (j, i)
        c, s = _givens_cs(R[j, j], R[i, j])
        G = jnp.eye(d, dtype=B.dtype)
        # Row-rotation [c s; -s c] on rows (j, i): new R[i,j] = -s*Rjj + c*Rij = 0.
        G = G.at[j, j].set(c).at[j, i].set(s).at[i, j].set(-s).at[i, i].set(c)
        R = G @ R
        Q = Q @ G.T
    return Q, R


# ---------------------------------------------------------------------------
# SVD: primal via (A^T A eigendecomp -> V), Givens QR(AV) -> U, R
# ---------------------------------------------------------------------------


def _svd_primal(A):
    d = A.shape[-1]
    _, V = eigh_sym(A.T @ A)
    B = A @ V
    U, R = _givens_qr(B)
    sigma = jnp.diagonal(R)
    # R's diagonal can be negative. Push signs into U columns, keeping the
    # convention det(U) = +1 by accumulating any overall flip into the last
    # column/singular value (sigma[-1] < 0 iff det(A) < 0).
    signs = jnp.where(sigma >= 0, 1.0, -1.0).astype(A.dtype)
    total = jnp.prod(signs)
    # Scaling the last entry by prod(signs) makes prod(col_signs) == +1, so
    # det(U) stays +1 after the column flips below.
    col_signs = signs.at[d - 1].set(signs[d - 1] * total)
    U = U * col_signs[None, :]
    sigma = sigma * col_signs
    return U, sigma, V


@jax.custom_jvp
def svd(A):
    """SVD of a single (2,2) or (3,3) matrix. Returns (U, sigma, V).

    A = U @ diag(sigma) @ V.T, det(U) = det(V) = +1, sigma descending with
    sigma[-1] < 0 iff det(A) < 0. Batch with jax.vmap.
    """
    return _svd_primal(A)


@svd.defjvp
def _svd_jvp(primals, tangents):
    """Analytic SVD differential with guarded denominators.

    dU = U @ Om_u, dV = V @ Om_v, ds = diag(W), W = U^T dA V, where for i<j
      (Om_u + Om_v)_ij = (W_ij + W_ji) / (s_j - s_i)
      (Om_u - Om_v)_ij = (W_ij - W_ji) / (s_j + s_i)
    Denominators clamped in magnitude (sign-preserving) — near-degenerate
    singular values get a finite, bounded rotation rate instead of NaN/Inf.
    """
    (A,) = primals
    (dA,) = tangents
    U, s, V = _svd_primal(A)
    d = A.shape[-1]
    dtype = A.dtype
    eps = jnp.asarray(1e-10 if dtype == jnp.float64 else 1e-6, dtype)

    W = U.T @ dA @ V
    ds = jnp.diagonal(W)

    def safe_div(num, den):
        mag = jnp.maximum(jnp.abs(den), eps)
        return num * jnp.where(den >= 0, 1.0, -1.0).astype(dtype) / mag

    Om_u = jnp.zeros((d, d), dtype)
    Om_v = jnp.zeros((d, d), dtype)
    idx = [(0, 1)] if d == 2 else [(0, 1), (0, 2), (1, 2)]
    for (i, j) in idx:
        plus = safe_div(W[i, j] + W[j, i], s[j] - s[i])   # (Om_u + Om_v)_ij
        minus = safe_div(W[i, j] - W[j, i], s[j] + s[i])  # (Om_u - Om_v)_ij
        ou = 0.5 * (plus + minus)
        ov = 0.5 * (plus - minus)
        Om_u = Om_u.at[i, j].set(ou).at[j, i].set(-ou)
        Om_v = Om_v.at[i, j].set(ov).at[j, i].set(-ov)

    dU = U @ Om_u
    dV = V @ Om_v
    return (U, s, V), (dU, ds, dV)


def svd3(A):
    """SVD of (..., 3, 3): vmapped over leading batch dims."""
    return _batched(svd, A)


def svd2(A):
    """SVD of (..., 2, 2): vmapped over leading batch dims."""
    return _batched(svd, A)


def _batched(fn, A):
    batch = A.shape[:-2]
    if not batch:
        return fn(A)
    flat = A.reshape((-1,) + A.shape[-2:])
    U, s, V = jax.vmap(fn)(flat)
    return (
        U.reshape(batch + U.shape[-2:]),
        s.reshape(batch + s.shape[-1:]),
        V.reshape(batch + V.shape[-2:]),
    )


def polar(A):
    """Polar decomposition A = R @ S (R proper rotation, S symmetric).

    Note: with the signed-sigma convention, R = U V^T is always a proper
    rotation; S = V diag(sigma) V^T is symmetric but indefinite for
    inverted elements — matching the reference's polarDecomposition
    (Lib/Ziran/Math/Linear/ImplicitQRSVD.h) semantics.
    """
    U, s, V = _batched(svd, A)
    R = U @ _transpose(V)
    S = V @ (s[..., :, None] * _transpose(V))
    return R, S


def _transpose(M):
    return jnp.swapaxes(M, -1, -2)
