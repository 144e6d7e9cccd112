"""Particle state pytree — the SoA attribute store of the rebuild.

Reference equivalents: Lib/Ziran/CS/DataStructure/DataManager.h +
Math/Geometry/Particles.h (components #7/#15): named per-particle attribute
arrays. In JAX the natural form is a registered-dataclass pytree of arrays;
"adding an attribute" is adding a field (or an entry in `extra`). Subsets
(the reference's DisjointRanges per material) become per-particle parameter
arrays (mu/lam/yield) so multi-material scenes stay one fused vmap.

FLAT MATRIX STORAGE: the per-particle matrices C and F are STORED as
(n, d*d) row-major flat leaves (`Cf`, `Ff`). A (n, d, d) program buffer
had its (d, d) minor dims tile-padded on the code's first target (docs/KERNEL_PLAN.md "Tiny trailing dims"); flat buffers are dense
everywhere.
Consumers keep the matrix view through the `C`/`F` properties (a reshape,
which inside jit is layout-free until a consumer forces it), and
`replace()` accepts either the flat or the matrix shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    """All per-particle arrays. Shapes: n particles, d spatial dims."""

    x: jax.Array            # (n, d) positions
    v: jax.Array            # (n, d) velocities
    Cf: jax.Array           # (n, d*d) APIC affine velocity field, row-major
    Ff: jax.Array           # (n, d*d) elastic deformation gradient, row-major
    m: jax.Array            # (n,) mass
    V0: jax.Array           # (n,) initial volume
    mu: jax.Array           # (n,) Lame mu
    lam: jax.Array          # (n,) Lame lambda
    # Plasticity parameters (semantics depend on the scene's plasticity
    # setting; inf/unused entries are fine — the return map is branch-free).
    yield_stress: jax.Array  # (n,)
    Jp: jax.Array            # (n,) plastic volume ratio (snow hardening)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    @property
    def C(self) -> jax.Array:
        """(..., d, d) matrix view of the flat-stored APIC affine field.
        Shape-generic so the sharded block layout (D, n_max, d*d) views as
        (D, n_max, d, d)."""
        d = self.dim
        return self.Cf.reshape(self.Cf.shape[:-1] + (d, d))

    @property
    def F(self) -> jax.Array:
        """(..., d, d) matrix view of the flat-stored deformation gradient."""
        d = self.dim
        return self.Ff.reshape(self.Ff.shape[:-1] + (d, d))

    def replace(self, **kw) -> "ParticleState":
        """dataclasses.replace that also accepts the matrix views: passing
        C=(..., d, d) or F=(..., d, d) stores them flat."""
        for mat, flat in (("C", "Cf"), ("F", "Ff")):
            if mat in kw:
                M = kw.pop(mat)
                kw[flat] = M.reshape(M.shape[:-2] + (-1,))
        return dataclasses.replace(self, **kw)


def make_particle_state(
    x,
    *,
    velocity=None,
    density: float = 1000.0,
    particle_volume: Optional[float] = None,
    mu=None,
    lam=None,
    E: float = 1e5,
    nu: float = 0.3,
    yield_stress: float = jnp.inf,
    dtype=jnp.float32,
) -> ParticleState:
    """Build a rest-state particle set from positions.

    Reference: MpmParticleHandleBase::sampleInAnalyticLevelSet +
    addFBasedMpmForce (component #29) — there, sampling assigns
    mass/volume from density and per-cell particle count; here the caller
    provides positions (see hot_mpm.sim.seeding) and a shared volume.
    """
    x = jnp.asarray(x, dtype)
    n, d = x.shape
    if particle_volume is None:
        raise ValueError("particle_volume is required (V0 per particle)")
    if mu is None or lam is None:
        from hot_mpm.models.constitutive import lame_parameters

        mu_s, lam_s = lame_parameters(E, nu)
        mu = jnp.full((n,), mu_s, dtype)
        lam = jnp.full((n,), lam_s, dtype)
    else:
        mu = jnp.broadcast_to(jnp.asarray(mu, dtype), (n,))
        lam = jnp.broadcast_to(jnp.asarray(lam, dtype), (n,))
    v = jnp.zeros((n, d), dtype) if velocity is None else jnp.broadcast_to(
        jnp.asarray(velocity, dtype), (n, d)
    )
    return ParticleState(
        x=x,
        v=v,
        Cf=jnp.zeros((n, d * d), dtype),
        Ff=jnp.broadcast_to(jnp.eye(d, dtype=dtype).reshape(-1), (n, d * d)),
        m=jnp.full((n,), density * particle_volume, dtype),
        V0=jnp.full((n,), particle_volume, dtype),
        mu=mu,
        lam=lam,
        yield_stress=jnp.full((n,), yield_stress, dtype),
        Jp=jnp.ones((n,), dtype),
    )


def concatenate_states(states) -> ParticleState:
    """Concatenate particle sets (multi-object scenes)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs, axis=0), *states)


def pad_particles(state: ParticleState, multiple: int, pad_pos=None) -> ParticleState:
    """Pad the particle axis up to a multiple (sharding divisibility). Padding particles have zero mass and zero volume, so
    they contribute nothing to any transfer, force, or energy; positions
    default to the first particle's (guaranteed in-domain)."""
    n = state.n
    target = ((n + multiple - 1) // multiple) * multiple
    extra = target - n
    if extra == 0:
        return state
    if pad_pos is None:
        pad_pos = state.x[0]

    def pad(a, fill):
        pad_block = jnp.broadcast_to(
            jnp.asarray(fill, a.dtype), (extra,) + a.shape[1:]
        )
        return jnp.concatenate([a, pad_block], axis=0)

    d = state.dim
    return ParticleState(
        x=pad(state.x, pad_pos),
        v=pad(state.v, jnp.zeros((d,), state.v.dtype)),
        Cf=pad(state.Cf, jnp.zeros((d * d,), state.Cf.dtype)),
        Ff=pad(state.Ff, jnp.eye(d, dtype=state.Ff.dtype).reshape(-1)),
        m=pad(state.m, 0.0),
        V0=pad(state.V0, 0.0),
        mu=pad(state.mu, 0.0),
        lam=pad(state.lam, 0.0),
        yield_stress=pad(state.yield_stress, jnp.inf),
        Jp=pad(state.Jp, 1.0),
    )
