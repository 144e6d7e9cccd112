"""Plasticity return mappings applied to the trial deformation gradient.

Reference equivalents: Lib/Ziran/Physics/ConstitutiveModel/PlasticityApplier.h
(component #21, SURVEY.md §2.1): VonMisesStvkHencky, SnowPlasticity,
DruckerPragerStvkHencky. Applied after G2P per particle per step.

Design: each return map is a branch-free pure function
F_trial -> F_projected on one particle (all conditionals via jnp.where),
batched with `jax.vmap`. Extra per-particle state (e.g. sand volume
correction) is threaded explicitly.
"""

from __future__ import annotations

import jax.numpy as jnp

from hot_mpm.ops.svd import svd


class VonMisesHencky:
    """Von Mises yield on Hencky strain (pairs with StvkHencky elasticity).

    yield: f = ||dev(eps)|| - yield_stress / (2 mu) <= 0 in Hencky space.
    Reference: VonMisesStvkHencky in PlasticityApplier.h — used by HOT's
    elastoplastic benchmark scenes.
    """

    name = "von_mises_hencky"

    @staticmethod
    def project(F, mu, lam, yield_stress):
        d = F.shape[-1]
        U, sigma, V = svd(F)
        s = jnp.maximum(jnp.abs(sigma), 1e-6)
        eps = jnp.log(s)
        tr = jnp.sum(eps)
        dev = eps - tr / d
        dev_norm = jnp.sqrt(jnp.sum(dev * dev))
        # Plastic flow magnitude (delta gamma); <= 0 means elastic (no change).
        dg = dev_norm - yield_stress / (2.0 * mu)
        safe_norm = jnp.maximum(dev_norm, 1e-12)
        eps_proj = eps - jnp.maximum(dg, 0.0) * dev / safe_norm
        sigma_new = jnp.exp(eps_proj)
        return (U * sigma_new[None, :]) @ V.T


class SnowPlasticity:
    """Stomakhin et al. 2013 snow: clamp singular values to [1-tc, 1+ts].

    Reference: SnowPlasticity in PlasticityApplier.h. Returns the projected
    elastic F; hardening (Jp tracking) is handled by the caller via the
    returned plastic volume ratio.
    """

    name = "snow"

    @staticmethod
    def project(F, theta_c=2.5e-2, theta_s=7.5e-3):
        U, sigma, V = svd(F)
        clamped = jnp.clip(sigma, 1.0 - theta_c, 1.0 + theta_s)
        F_new = (U * clamped[None, :]) @ V.T
        # |det|: with the signed-sigma convention an inverted trial F has
        # prod(sigma) < 0; the plastic volume ratio tracks magnitudes.
        jp_ratio = jnp.abs(jnp.prod(sigma)) / jnp.maximum(jnp.prod(clamped), 1e-12)
        return F_new, jp_ratio


class DruckerPrager:
    """Drucker-Prager sand (Klar et al. 2016) on Hencky strain.

    Reference: DruckerPragerStvkHencky in PlasticityApplier.h.
    friction_alpha = sqrt(2/3) * 2 sin(phi) / (3 - sin(phi)).
    """

    name = "drucker_prager"

    @staticmethod
    def alpha_from_friction_angle(phi_degrees):
        s = jnp.sin(jnp.deg2rad(phi_degrees))
        return jnp.sqrt(2.0 / 3.0) * 2.0 * s / (3.0 - s)

    @staticmethod
    def project(F, mu, lam, alpha):
        d = F.shape[-1]
        U, sigma, V = svd(F)
        s = jnp.maximum(jnp.abs(sigma), 1e-6)
        eps = jnp.log(s)
        tr = jnp.sum(eps)
        dev = eps - tr / d
        dev_norm = jnp.sqrt(jnp.sum(dev * dev))
        safe_norm = jnp.maximum(dev_norm, 1e-12)
        # Case 1 (expansion, tr > 0): project to cone tip (eps = 0).
        # Case 2: yield amount dg = ||dev|| + alpha * tr * (d lam + 2 mu) / (2 mu)
        #         dg <= 0 elastic; else shift dev toward the cone.
        dg = dev_norm + alpha * tr * (d * lam + 2.0 * mu) / (2.0 * mu)
        eps_cone = eps - jnp.maximum(dg, 0.0) * dev / safe_norm
        eps_proj = jnp.where(tr > 0.0, jnp.zeros_like(eps), eps_cone)
        sigma_new = jnp.exp(eps_proj)
        return (U * sigma_new[None, :]) @ V.T


PLASTICITY_REGISTRY = {
    p.name: p for p in (VonMisesHencky, SnowPlasticity, DruckerPrager)
}
