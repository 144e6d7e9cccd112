"""The plain Newton linearization (objective.linearize) — the one
per-Newton-iteration evaluation of residual and Hessian context — checked
against autodiff of the incremental potential, in 2D and 3D, for the two
models the scenes use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hot_mpm.models.constitutive import MODEL_REGISTRY
from hot_mpm.ops import transfer
from hot_mpm.scenes import build_scene
from hot_mpm.sim import objective as obj_mod


def _objective(dim, model, rng):
    if dim == 2:
        scene = build_scene("block_drop_2d", res=16, E=1e5, dtype=jnp.float64)
    else:
        scene = build_scene("twisting_bar_3d", res=8, ppc=2, dtype=jnp.float64)
    cfg, state = scene["cfg"], scene["state"]
    res = cfg.grid_res[:dim]
    n_nodes = transfer.n_nodes_of(res)
    st = transfer.particle_stencil(state.x, cfg.dx, res)
    gm, _ = transfer.p2g_mass_momentum(st, state.v, state.C, state.m, n_nodes)
    F = state.F + 0.05 * jnp.asarray(rng.standard_normal(state.F.shape))
    v_star = jnp.asarray(rng.standard_normal((n_nodes, dim)))
    proj = jnp.broadcast_to(jnp.eye(dim), (n_nodes, dim, dim))
    obj = obj_mod.make_objective(model, st, F, state.V0, state.mu, state.lam,
                                 gm, v_star, proj, 2e-3, cfg.dx)
    v = v_star + 0.5 * jnp.asarray(rng.standard_normal((n_nodes, dim)))
    return obj, v, (state.x, cfg.dx, res)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("model_name", ["fixed_corotated", "stvk_hencky"])
def test_linearize_matches_autodiff(rng, model_name, dim):
    """linearize's residual is the projected gradient of the incremental
    potential; its Hessian context is the one build_hessian (the
    stress_and_hessian-free path) computes, and — unprojected — its
    matrix-free apply is the autodiff Hessian-vector product."""
    model = MODEL_REGISTRY[model_name]
    obj, v, _ = _objective(dim, model, rng)

    r, hess = obj_mod.linearize(model, obj, v)
    grad = jax.grad(lambda u: obj_mod.energy(model, obj, u))(v)
    want_r = obj_mod.project(obj, grad)
    scale = float(jnp.max(jnp.abs(want_r)))
    np.testing.assert_allclose(np.asarray(r), np.asarray(want_r),
                               rtol=1e-9, atol=1e-9 * scale)

    ref = obj_mod.build_hessian(model, obj, v)
    for got, want in zip(hess.ctx, ref.ctx):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-9)

    _, hess_u = obj_mod.linearize(model, obj, v, project_spd=False)
    w = jnp.asarray(rng.standard_normal(v.shape))
    got = obj_mod.multiply(obj, hess_u, w)
    _, hvp = jax.jvp(
        jax.grad(lambda u: obj_mod.energy(model, obj, u)), (v,), (w,))
    want = jnp.where(obj.active[:, None], hvp, w)
    scale = float(jnp.max(jnp.abs(want)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_binned_transfers_match_scatter(rng, dim):
    """The matrix-free CG apply through the cell-binned gather/scatter
    (transfer_impl="binned") equals the apply through the plain
    scatter-add (the default)."""
    model = MODEL_REGISTRY["fixed_corotated"]
    obj, v, (x, dx, res) = _objective(dim, model, rng)
    hess = obj_mod.build_hessian(model, obj, v)
    bins = transfer.bin_particles(x, dx, res, x.shape[0], 32)
    assert not bool(bins.overflow)
    w = jnp.asarray(rng.standard_normal(v.shape))
    want = obj_mod.multiply(obj, hess, w)
    got = obj_mod.multiply(obj, hess, w,
                           scatter=transfer.make_binned_scatter(bins, res),
                           gather_st=transfer.make_binned_gather(bins, res))
    scale = float(jnp.max(jnp.abs(want)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-9, atol=1e-12 * scale)
