"""Particle seeding in level-set regions.

Reference equivalent: MpmParticleHandleBase::sampleInAnalyticLevelSet
(component #29): Poisson-disk-ish sampling at ~2^dim particles/cell. Here:
a jittered lattice at `particles_per_cell` density — deterministic given a
PRNG key, which is what the determinism tests require (SURVEY.md §4.5).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def sample_box(key, lo, hi, dx, particles_per_cell: int, dtype=jnp.float32):
    """Jittered-lattice samples filling the axis-aligned box [lo, hi].

    Returns (n, dim) positions and the per-particle volume
    dx^dim / particles_per_cell.
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    dim = lo.shape[0]
    # subdivide each dx-cell into per-axis sub-cells with one jittered
    # sample each. Per-axis counts factor particles_per_cell greedily so
    # intermediate densities are honored (the old isotropic
    # ceil(ppc^(1/dim)) quantized 3D ppc=2..8 all to 8/cell, which made
    # particle counts impossible to scale down at high grid res).
    k_axes = []
    rem = max(int(particles_per_cell), 1)
    for i in range(dim):
        k = int(np.ceil(rem ** (1.0 / (dim - i))))
        k_axes.append(k)
        rem = max(1, rem // k)
    k_axes = np.asarray(k_axes)
    sub_dx = dx / k_axes
    counts = np.maximum(((hi - lo) / sub_dx).round().astype(int), 1)
    axes = [np.arange(c) * sub_dx[i] + lo[i] + 0.5 * sub_dx[i]
            for i, c in enumerate(counts)]
    mesh = np.meshgrid(*axes, indexing="ij")
    centers = np.stack([m.reshape(-1) for m in mesh], axis=-1)
    jitter = jax.random.uniform(
        key, centers.shape, minval=-0.45, maxval=0.45
    ) * jnp.asarray(sub_dx, jnp.float32)[None, :]
    x = jnp.asarray(centers, dtype) + jitter.astype(dtype)
    volume = float(np.prod(sub_dx))
    return x, volume


def sample_level_set(key, phi: Callable, lo, hi, dx, particles_per_cell: int,
                     dtype=jnp.float32):
    """Samples of the box [lo,hi] kept where phi(x) < 0 (inside).

    Note: filtering is host-side (static shapes for the sim afterwards).
    """
    x, volume = sample_box(key, lo, hi, dx, particles_per_cell, dtype)
    inside = np.asarray(phi(x) < 0.0)
    return x[jnp.asarray(inside)], volume


def sample_sphere(key, center, radius, dx, particles_per_cell: int, dtype=jnp.float32):
    center = np.asarray(center, np.float64)
    lo = center - radius
    hi = center + radius
    phi = lambda x: jnp.linalg.norm(x - jnp.asarray(center, x.dtype)[None, :], axis=-1) - radius
    return sample_level_set(key, phi, lo, hi, dx, particles_per_cell, dtype)


def sample_cylinder(key, center, axis, radius, half_height, dx,
                    particles_per_cell: int, dtype=jnp.float32):
    """Samples inside a finite capped cylinder (matches collision.Cylinder)."""
    from hot_mpm.sim.collision import Cylinder

    cyl = Cylinder(center=tuple(center), axis=tuple(axis), radius=radius,
                   half_height=half_height)
    center = np.asarray(center, np.float64)
    reach = float(np.sqrt(radius**2 + half_height**2))
    lo = center - reach
    hi = center + reach
    return sample_level_set(key, lambda x: cyl.phi(x, 0.0), lo, hi, dx,
                            particles_per_cell, dtype)
