"""Data-parallel parameter sweeps via vmap (SURVEY.md §2.5's DP row):
one jit, a batch of scenes with different material stiffness — the
batched replacement for running the reference binary N times.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.models.constitutive import lame_parameters
from hot_mpm.scenes import build_scene
from hot_mpm.sim.simulation import advance_one_step


def test_vmap_stiffness_sweep():
    scene = build_scene("block_drop_2d", res=24, dtype=jnp.float64)
    cfg = scene["cfg"]
    base = scene["state"]
    n_batch = 4
    Es = jnp.asarray([1e4, 1e5, 1e6, 1e7])

    def with_E(E):
        mu, lam = lame_parameters(E, 0.3)
        return base.replace(
            mu=jnp.full((base.n,), mu, base.mu.dtype),
            lam=jnp.full((base.n,), lam, base.lam.dtype),
        )

    batch = jax.vmap(with_E)(Es)

    step = functools.partial(
        advance_one_step, cfg=cfg, model=scene["model"],
        colliders=scene["colliders"], plasticity=None,
    )
    vstep = jax.jit(jax.vmap(step, in_axes=(0, None, None)))

    state = batch
    t = 0.0
    for _ in range(75):  # through impact (~t=0.25) and settling
        state, stats = vstep(state, jnp.float64(4e-3), jnp.float64(t))
        t += 4e-3
    x = np.asarray(state.x)
    assert np.isfinite(x).all()
    assert bool(jnp.all(stats.converged))
    # the soft block squashes on impact (small vertical extent); the stiff
    # one keeps its shape
    spread = x[:, :, 1].max(axis=1) - x[:, :, 1].min(axis=1)
    assert spread[0] < 0.7 * spread[-1], spread
    # trajectories genuinely differ across the batch
    assert np.abs(x[0] - x[-1]).max() > 1e-3
