"""Constitutive-model tests: the autodiff analog of the reference's DiffTest.

Reference: Lib/Ziran/Sim/DiffTest.h (component #23) validates
energy->force->Hessian consistency by finite-difference refinement. Here we
do the stronger/cheaper version (SURVEY.md §4.1): analytic P and
diagonal-space Hessian action vs jax.grad / jax.jvp of Psi(F), per model,
to fp tolerance — plus SPD-projection and plasticity invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hot_mpm.models.constitutive import (
    MODEL_REGISTRY,
    apply_hessian,
    first_piola,
    hessian_context,
    lame_parameters,
    psi_from_F,
)
from hot_mpm.models.plasticity import DruckerPrager, SnowPlasticity, VonMisesHencky
from hot_mpm.ops.svd import svd

MU, LAM = lame_parameters(1e4, 0.3)


def random_F(rng, n, d, spread=0.3):
    """Random deformation gradients near identity (generic, non-degenerate)."""
    return jnp.eye(d)[None] + spread * jnp.asarray(rng.standard_normal((n, d, d)))


@pytest.mark.parametrize("name", list(MODEL_REGISTRY))
@pytest.mark.parametrize("d", [2, 3])
def test_bm_hat_matches_quotient_and_its_degenerate_limit(name, d):
    """b_minus = (g_i - g_j)/(s_i - s_j) via the model's closed form:
    (a) equals the direct quotient at well-separated sigmas, and
    (b) equals the analytic limit at repeated sigmas — the case every
    near-rest particle hits, where the naive quotient is 0/0 (this noise
    stalls Newton/CG in fp32)."""
    model = MODEL_REGISTRY[name]

    def bm0(sig):
        g = jax.grad(model.psi_hat)(sig, MU, LAM)
        return model.bm_hat(sig, g, MU, LAM)[0]

    # (a) separated: compare against the direct quotient
    sig = jnp.asarray([1.4, 0.9, 0.7][:d])
    g = jax.grad(model.psi_hat)(sig, MU, LAM)
    direct = (g[0] - g[1]) / (sig[0] - sig[1])
    np.testing.assert_allclose(bm0(sig), direct, rtol=1e-6)

    # (b) repeated pair: compare against a symmetric-perturbation limit
    base = jnp.asarray([1.3, 1.3, 0.7][:d])
    e01 = jnp.asarray([0.5, -0.5, 0.0][:d])
    t = 1e-7
    gp = jax.grad(model.psi_hat)(base + t * e01, MU, LAM)
    limit = (gp[0] - gp[1]) / t
    np.testing.assert_allclose(bm0(base), limit, rtol=1e-5)


@pytest.mark.parametrize("name", list(MODEL_REGISTRY))
@pytest.mark.parametrize("d", [2, 3])
def test_first_piola_is_grad_of_psi(rng, name, d):
    model = MODEL_REGISTRY[name]
    F = random_F(rng, 50, d)

    P_analytic = jax.vmap(lambda f: first_piola(model, f, MU, LAM))(F)
    P_autodiff = jax.vmap(jax.grad(lambda f: psi_from_F(model, f, MU, LAM)))(F)
    np.testing.assert_allclose(P_analytic, P_autodiff, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", list(MODEL_REGISTRY))
@pytest.mark.parametrize("d", [2, 3])
def test_hessian_action_matches_autodiff(rng, name, d):
    """Unprojected diagonal-space Hessian action == jvp of grad(Psi)."""
    model = MODEL_REGISTRY[name]
    F = random_F(rng, 30, d)
    dF = jnp.asarray(rng.standard_normal(F.shape))

    def dP_auto(f, df):
        g = lambda x: jax.grad(lambda y: psi_from_F(model, y, MU, LAM))(x)
        return jax.jvp(g, (f,), (df,))[1]

    def dP_ours(f, df):
        ctx = hessian_context(model, f, MU, LAM, project=False)
        return apply_hessian(ctx, df)

    got = jax.vmap(dP_ours)(F, dF)
    want = jax.vmap(dP_auto)(F, dF)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(MODEL_REGISTRY))
def test_projected_hessian_is_psd(rng, name):
    """SPD-projected action must give non-negative dF : dP for any dF,
    including at strongly compressed/inverted states."""
    model = MODEL_REGISTRY[name]
    d = 3
    F = random_F(rng, 40, d, spread=0.8)  # includes near/through inversion

    def quad_form(f, df):
        ctx = hessian_context(model, f, MU, LAM, project=True)
        return jnp.sum(df * apply_hessian(ctx, df))

    dF = jnp.asarray(rng.standard_normal(F.shape))
    q = jax.vmap(quad_form)(F, dF)
    assert bool(jnp.all(q >= -1e-8))


@pytest.mark.parametrize("name", list(MODEL_REGISTRY))
def test_rest_state_zero_stress(name):
    model = MODEL_REGISTRY[name]
    for d in (2, 3):
        P = first_piola(model, jnp.eye(d), MU, LAM)
        np.testing.assert_allclose(P, 0.0, atol=1e-9)
        assert float(psi_from_F(model, jnp.eye(d), MU, LAM)) == pytest.approx(0.0, abs=1e-12)


def test_rotation_invariance(rng):
    """Psi(R F) == Psi(F) for rotations R (isotropy + frame indifference)."""
    model = MODEL_REGISTRY["fixed_corotated"]
    F = random_F(rng, 20, 3)
    theta = 0.7
    R = jnp.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    psi0 = jax.vmap(lambda f: psi_from_F(model, f, MU, LAM))(F)
    psi1 = jax.vmap(lambda f: psi_from_F(model, R @ f, MU, LAM))(F)
    np.testing.assert_allclose(psi0, psi1, rtol=1e-9)


# ---------------------------------------------------------------------------
# Plasticity
# ---------------------------------------------------------------------------


def test_von_mises_elastic_region_identity(rng):
    """States inside the yield surface are unchanged."""
    F = random_F(rng, 20, 3, spread=1e-4)
    out = jax.vmap(lambda f: VonMisesHencky.project(f, MU, LAM, yield_stress=1e9))(F)
    np.testing.assert_allclose(out, F, atol=1e-9)


def test_von_mises_projects_to_yield_surface(rng):
    F = random_F(rng, 20, 3, spread=0.4)
    tau_y = 100.0
    out = jax.vmap(lambda f: VonMisesHencky.project(f, MU, LAM, tau_y))(F)
    _, s, _ = jax.vmap(svd)(out)
    eps = jnp.log(jnp.abs(s))
    dev = eps - jnp.mean(eps, axis=1, keepdims=True)
    dev_norm = jnp.linalg.norm(dev, axis=1)
    assert bool(jnp.all(dev_norm <= tau_y / (2 * MU) + 1e-8))


def test_snow_clamps_singular_values(rng):
    F = random_F(rng, 20, 3, spread=0.5)
    out, jp = jax.vmap(lambda f: SnowPlasticity.project(f))(F)
    _, s, _ = jax.vmap(svd)(out)
    assert bool(jnp.all(jnp.abs(s) <= 1.0 + 7.5e-3 + 1e-9))
    assert bool(jnp.all(jnp.abs(s) >= 1.0 - 2.5e-2 - 1e-9))
    assert bool(jnp.all(jp > 0))


def test_drucker_prager_cone(rng):
    alpha = DruckerPrager.alpha_from_friction_angle(30.0)
    F = random_F(rng, 30, 3, spread=0.4)
    out = jax.vmap(lambda f: DruckerPrager.project(f, MU, LAM, alpha))(F)
    _, s, _ = jax.vmap(svd)(out)
    eps = jnp.log(jnp.maximum(jnp.abs(s), 1e-9))
    tr = jnp.sum(eps, axis=1)
    dev = eps - tr[:, None] / 3
    dev_norm = jnp.linalg.norm(dev, axis=1)
    f_yield = dev_norm + alpha * tr * (3 * LAM + 2 * MU) / (2 * MU)
    # After projection every state satisfies the yield constraint (or tip).
    assert bool(jnp.all((f_yield <= 1e-6) | (dev_norm <= 1e-8)))
