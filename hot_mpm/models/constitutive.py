"""Isotropic hyperelastic constitutive models in diagonal (singular-value) space.

Reference equivalents: Lib/Ziran/Physics/ConstitutiveModel/{CorotatedElasticity,
NeoHookeanBorden, StvkWithHenckyIsotropic, ...}.h and the SPD projection
mechanism of SvdBasedIsotropicHelper (reference component #20, SURVEY.md §2.1).

Design
------
Every model is defined by ONE scalar function `psi_hat(sigma, mu, lam)` of the
singular values. Everything else is derived uniformly:

  * Psi(F)        = psi_hat(sigma(F))                      (energy density)
  * P(F)          = U diag(dpsi_hat/dsigma) V^T            (first Piola)
  * dP/dF action  — diagonal-space Hessian: the (d x d) normal block
    A = d2psi_hat/dsigma2 plus, per off-diagonal pair (i, j), the 2x2 block
       [[b11, b12], [b12, b11]],
       b11 + b12 = (g_i - g_j) / (sigma_i - sigma_j)   (shear-stretch mode)
       b11 - b12 = (g_i + g_j) / (sigma_i + sigma_j)   (rotation mode, g = dpsi_hat/dsigma)
    with sign-preserving clamped denominators. SPD projection = clamping
    eigenvalues of A and of each pair block (b11 +- b12) to >= 0 — exactly
    the Gauss-Newton-style projection the reference applies per particle.

The per-sigma derivatives come from `jax.grad`/`jax.jacfwd` of `psi_hat`
(d <= 3, so this is a handful of flops — no autodiff-through-SVD in the
hot path). The SVD itself is hot_mpm.ops.svd (analytic-JVP custom rule).

All functions are single-particle; batch with `jax.vmap`. `mu`/`lam` are
per-particle Lame parameters so multi-material scenes are one fused vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from hot_mpm.ops.svd import svd, eigh_sym


def lame_parameters(E, nu):
    """(mu, lambda) from Young's modulus and Poisson ratio."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def _hybrid_bm(sigma, g, closed):
    """Select the pair quotient (g_i - g_j)/(s_i - s_j) per pair:

    * singular values well separated -> direct quotient (no cancellation;
      also the only branch that is correct where the energy's sigma clamp
      is active, i.e. near/through inversion);
    * nearly repeated -> the model's analytically-cancelled closed form
      (`closed`), which is where the direct quotient is 0/0;
    * nearly repeated AND both below the clamp (deep inversion): the energy
      is locally constant in both sigmas -> quotient is 0.
    """
    d = sigma.shape[-1]
    out = []
    for k, (i, j) in enumerate(_pairs(d)):
        delta = sigma[i] - sigma[j]
        scale = jnp.abs(sigma[i]) + jnp.abs(sigma[j]) + 1.0
        well_sep = jnp.abs(delta) > 1e-3 * scale
        delta_safe = jnp.where(well_sep, delta, 1.0)
        direct = (g[i] - g[j]) / delta_safe
        smooth = jnp.minimum(sigma[i], sigma[j]) > 2e-6
        out.append(
            jnp.where(well_sep, direct, jnp.where(smooth, closed[k], 0.0))
        )
    return jnp.stack(out)


# ---------------------------------------------------------------------------
# Model definitions: psi_hat(sigma) per model
# ---------------------------------------------------------------------------


class FixedCorotated:
    """Fixed corotated: Psi = mu * sum((s_i - 1)^2) + lam/2 * (J - 1)^2.

    Reference: CorotatedElasticity.h / FixedCorotated (Stomakhin et al. 2012).
    The material class of HOT's twisting-bar and boxes scenes.
    """

    name = "fixed_corotated"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        J = jnp.prod(sigma)
        return mu * jnp.sum((sigma - 1.0) ** 2) + 0.5 * lam * (J - 1.0) ** 2

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        """Exact (g_i - g_j)/(s_i - s_j) per pair — the difference quotient
        cancels algebraically, so there is NO division by (s_i - s_j):
          3D pair (i, j): 2 mu - lam (J - 1) s_k   (k the third axis)
          2D:             2 mu - lam (J - 1)
        Exact for ALL sigma (the energy has no clamp), including the
        s_i == s_j limit that dominates near-rest states, where the naive
        quotient is 0/0."""
        J = jnp.prod(sigma)
        if sigma.shape[-1] == 2:
            return jnp.stack([2.0 * mu - lam * (J - 1.0)])
        return jnp.stack([
            2.0 * mu - lam * (J - 1.0) * sigma[2],
            2.0 * mu - lam * (J - 1.0) * sigma[1],
            2.0 * mu - lam * (J - 1.0) * sigma[0],
        ])


class NeoHookean:
    """Neo-Hookean (log-J form): Psi = mu/2 (tr(F^T F) - d) - mu log J + lam/2 log^2 J.

    Reference: NeoHookeanBorden.h-class model. Singular values are clamped
    to a small positive floor so log J stays finite for inverted elements.
    """

    name = "neo_hookean"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        s = jnp.maximum(sigma, 1e-6)
        logJ = jnp.sum(jnp.log(s))
        return 0.5 * mu * (jnp.sum(s * s) - s.shape[-1]) - mu * logJ + 0.5 * lam * logJ**2

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        """Difference quotient (g_i - g_j)/(s_i - s_j), stable everywhere:
        in the smooth (unclamped) branch it cancels algebraically to
        mu + (mu - lam logJ)/(s_i s_j); near/through inversion (sigma at the
        1e-6 energy clamp, where that premise fails) the singular values are
        well separated from their positive partners, so the direct quotient
        is used — see _hybrid_bm."""
        s = jnp.maximum(sigma, 1e-6)
        logJ = jnp.sum(jnp.log(s))
        closed = jnp.stack(
            [mu + (mu - lam * logJ) / (s[i] * s[j]) for (i, j) in _pairs(s.shape[-1])]
        )
        return _hybrid_bm(sigma, g, closed)


class StvkHencky:
    """St. Venant-Kirchhoff with Hencky strain: Psi = mu ||log S||^2 + lam/2 tr(log S)^2.

    Reference: StvkWithHenckyIsotropic.h. The model paired with von Mises
    plasticity in the reference's elastoplastic scenes.
    """

    name = "stvk_hencky"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        eps = jnp.log(jnp.maximum(sigma, 1e-6))
        return mu * jnp.sum(eps * eps) + 0.5 * lam * jnp.sum(eps) ** 2

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        """Difference quotient via the log difference quotient
        L = (log s_i - log s_j)/(s_i - s_j) = 2 atanh(z)/(s_i + s_j),
        z = (s_i - s_j)/(s_i + s_j); atanh(z)/z evaluated by series for
        small z (no 0/0 anywhere):
          (g_i - g_j)/(s_i - s_j) = (2 mu (s_j L - log s_j) - lam tr)/(s_i s_j).
        Valid in the smooth branch; the clamped branch (near inversion) is
        routed to the direct quotient by _hybrid_bm."""
        s = jnp.maximum(sigma, 1e-6)
        tr = jnp.sum(jnp.log(s))
        out = []
        for (i, j) in _pairs(s.shape[-1]):
            si, sj = s[i], s[j]
            z = (si - sj) / (si + sj)
            small = jnp.abs(z) < 1e-4
            z_safe = jnp.where(small, 1.0, z)
            # atanh(z)/z: log form for the general case, series near 0
            atz = jnp.where(
                small,
                1.0 + z * z / 3.0,
                jnp.log((1.0 + z_safe) / (1.0 - z_safe)) / (2.0 * z_safe),
            )
            L = 2.0 / (si + sj) * atz
            out.append((2.0 * mu * (sj * L - jnp.log(sj)) - lam * tr) / (si * sj))
        return _hybrid_bm(sigma, g, jnp.stack(out))


class LinearCorotated:
    """Linear elasticity in diagonal space (small-strain; for tests/debugging).

    Reference: LinearElasticity.h. Psi = mu ||S - I||^2 + lam/2 tr(S - I)^2.
    """

    name = "linear_corotated"

    @staticmethod
    def psi_hat(sigma, mu, lam):
        e = sigma - 1.0
        return mu * jnp.sum(e * e) + 0.5 * lam * jnp.sum(e) ** 2

    @staticmethod
    def bm_hat(sigma, g, mu, lam):
        n_pairs = 1 if sigma.shape[-1] == 2 else 3
        return jnp.broadcast_to(2.0 * mu, (n_pairs,)).astype(sigma.dtype)


MODEL_REGISTRY = {
    m.name: m for m in (FixedCorotated, NeoHookean, StvkHencky, LinearCorotated)
}


# ---------------------------------------------------------------------------
# Uniform derived quantities
# ---------------------------------------------------------------------------


def psi_from_F(model, F, mu, lam):
    """Energy density Psi(F) for one particle."""
    _, sigma, _ = svd(F)
    return model.psi_hat(sigma, mu, lam)


def first_piola(model, F, mu, lam):
    """P(F) = dPsi/dF = U diag(g) V^T with g = dpsi_hat/dsigma."""
    U, sigma, V = svd(F)
    g = jax.grad(model.psi_hat)(sigma, mu, lam)
    return (U * g[None, :]) @ V.T


class HessianContext(NamedTuple):
    """Cached per-particle diagonal-space Hessian (possibly SPD-projected).

    Built once per Newton iteration; `apply_hessian` contracts it with a
    direction dF every CG iteration (reference: the updateState /
    addScaledStressDifferentials split of FBasedMpmForceHelper, component #27).
    """

    U: jax.Array          # (d, d)
    V: jax.Array          # (d, d)
    A: jax.Array          # (d, d)   normal-block Hessian (projected)
    b_plus: jax.Array     # (n_pairs,)  eigenvalue (b11 + b12) per pair
    b_minus: jax.Array    # (n_pairs,)  eigenvalue (b11 - b12) per pair


def _pairs(d: int):
    return [(0, 1)] if d == 2 else [(0, 1), (0, 2), (1, 2)]


def _pair_eigenvalues(model, sigma, g, mu, lam, dtype):
    """(b_plus, b_minus) per off-diagonal pair.

    b_minus = (g_i - g_j)/(s_i - s_j) is 0/0 at repeated singular values —
    i.e. at EVERY near-rest particle — so models provide the analytically
    cancelled closed form `bm_hat` (exact; no division by s_i - s_j).
    b_plus's denominator s_i + s_j only degenerates under total collapse;
    a sign-preserving clamped division suffices there.
    """
    d = sigma.shape[-1]
    eps = jnp.asarray(1e-10 if dtype == jnp.float64 else 1e-6, dtype)

    def safe_div(num, den):
        mag = jnp.maximum(jnp.abs(den), eps)
        return num * jnp.where(den >= 0, 1.0, -1.0).astype(dtype) / mag

    b_plus = jnp.stack(
        [safe_div(g[i] + g[j], sigma[i] + sigma[j]) for (i, j) in _pairs(d)]
    )
    if hasattr(model, "bm_hat"):
        b_minus = model.bm_hat(sigma, g, mu, lam).astype(dtype)
    else:
        b_minus = jnp.stack(
            [safe_div(g[i] - g[j], sigma[i] - sigma[j]) for (i, j) in _pairs(d)]
        )
    return b_plus, b_minus


def hessian_context(model, F, mu, lam, project: bool = True):
    """Build the diagonal-space Hessian context for one particle.

    With project=True the normal block A is eigen-clamped to PSD and each
    shear-pair eigenvalue is clamped to >= 0, yielding the SPD-projected
    dP/dF the reference uses for Newton (SvdBasedIsotropicHelper).
    """
    U, sigma, V = svd(F)
    g = jax.grad(model.psi_hat)(sigma, mu, lam)
    A = jax.jacfwd(jax.grad(model.psi_hat))(sigma, mu, lam)
    A = 0.5 * (A + A.T)
    b_plus, b_minus = _pair_eigenvalues(model, sigma, g, mu, lam, F.dtype)

    if project:
        w, Q = eigh_sym(A)
        A = (Q * jnp.maximum(w, 0.0)[None, :]) @ Q.T
        b_plus = jnp.maximum(b_plus, 0.0)
        b_minus = jnp.maximum(b_minus, 0.0)

    return HessianContext(U=U, V=V, A=A, b_plus=b_plus, b_minus=b_minus)


def stress_and_hessian(model, F, mu, lam, project: bool = True):
    """(P(F), HessianContext) sharing ONE SVD — the per-Newton-iteration
    linearization (reference: FBasedMpmForceHelper::updateState computing
    stress and dPdF together, component #27)."""
    U, sigma, V = svd(F)
    g = jax.grad(model.psi_hat)(sigma, mu, lam)
    P = (U * g[None, :]) @ V.T
    A = jax.jacfwd(jax.grad(model.psi_hat))(sigma, mu, lam)
    A = 0.5 * (A + A.T)
    b_plus, b_minus = _pair_eigenvalues(model, sigma, g, mu, lam, F.dtype)

    if project:
        w, Q = eigh_sym(A)
        A = (Q * jnp.maximum(w, 0.0)[None, :]) @ Q.T
        b_plus = jnp.maximum(b_plus, 0.0)
        b_minus = jnp.maximum(b_minus, 0.0)

    return P, HessianContext(U=U, V=V, A=A, b_plus=b_plus, b_minus=b_minus)


def apply_hessian(ctx: HessianContext, dF):
    """delta_P = (dP/dF) : dF using the cached diagonal-space context."""
    d = dF.shape[-1]
    W = ctx.U.T @ dF @ ctx.V  # direction rotated into diagonal space
    dP_hat = jnp.diag(ctx.A @ jnp.diagonal(W))
    for k, (i, j) in enumerate(_pairs(d)):
        # Eigen-pairing: the symmetric combination (W_ij + W_ji, shear
        # stretch) carries (g_i - g_j)/(s_i - s_j) = b_minus; the
        # antisymmetric one (rotation) carries (g_i + g_j)/(s_i + s_j).
        b11 = 0.5 * (ctx.b_plus[k] + ctx.b_minus[k])
        b12 = 0.5 * (ctx.b_minus[k] - ctx.b_plus[k])
        dij = b11 * W[i, j] + b12 * W[j, i]
        dji = b12 * W[i, j] + b11 * W[j, i]
        dP_hat = dP_hat.at[i, j].set(dij).at[j, i].set(dji)
    return ctx.U @ dP_hat @ ctx.V.T
