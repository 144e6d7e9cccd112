"""Simulation data analysis: energy and momentum queries.

Reference equivalent: Lib/MPM/MpmSimulationDataAnalysis.h (component #31):
evalTotalEnergy / evalMomentum used for per-frame conservation logging.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hot_mpm.models import constitutive as cm
from hot_mpm.sim.state import ParticleState


def total_momentum(state: ParticleState):
    """(dim,) total linear momentum of the particle set."""
    return jnp.sum(state.m[:, None] * state.v, axis=0)


def total_mass(state: ParticleState):
    return jnp.sum(state.m)


def kinetic_energy(state: ParticleState):
    return 0.5 * jnp.sum(state.m * jnp.sum(state.v * state.v, axis=-1))


def potential_energy(state: ParticleState, model):
    psi = jax.vmap(lambda f, m_, l_: cm.psi_from_F(model, f, m_, l_))(
        state.F, state.mu, state.lam
    )
    return jnp.sum(state.V0 * psi)


def gravitational_energy(state: ParticleState, gravity):
    g = jnp.asarray(gravity, state.x.dtype)
    return -jnp.sum(state.m[:, None] * state.x * g[None, :])


def center_of_mass(state: ParticleState):
    return jnp.sum(state.m[:, None] * state.x, axis=0) / jnp.maximum(
        jnp.sum(state.m), 1e-30
    )
