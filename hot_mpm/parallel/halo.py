"""Slab-decomposition halo exchange over a named mesh axis.

The device-mesh replacement for the reference's shared-memory scatter
(SURVEY.md §2.5/§5.8): the grid is partitioned into contiguous slabs of
x-planes, one slab per device along mesh axis `axis_name`. A quadratic
B-spline stencil reaches 2 nodes, so each device keeps a 2-plane ghost
margin on each side:

  exchange_halo: fill ghosts from neighbors (two ppermute shifts; edge
    devices receive zeros — the domain boundary).
  fold_halo: after a local scatter that accumulated into ghost planes,
    ship those partial sums back to their owners and add (the transpose
    of exchange_halo — together they make scatter/gather adjoint across
    the mesh, which keeps the distributed operator symmetric for CG).

Collectives are jax.lax.ppermute — XLA lowers them to ICI neighbor sends
on a real slice; on the CPU-simulated mesh they exercise the identical
program (SURVEY.md §4.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift(x, axis_name: str, direction: int, n_devices: int):
    """ppermute x to the neighbor at +direction; missing sources -> zeros."""
    perm = [
        (i, i + direction)
        for i in range(n_devices)
        if 0 <= i + direction < n_devices
    ]
    return lax.ppermute(x, axis_name, perm)


def exchange_halo(v_local, axis_name: str, n_devices: int, width: int = 2):
    """(P, ...) local planes -> (P + 2*width, ...) with neighbor ghosts.

    Ghost planes [0:width] come from the left neighbor's top planes,
    [-width:] from the right neighbor's bottom planes.
    """
    top = v_local[-width:]       # planes flowing right
    bottom = v_local[:width]     # planes flowing left
    ghost_lo = _shift(top, axis_name, +1, n_devices)
    ghost_hi = _shift(bottom, axis_name, -1, n_devices)
    return jnp.concatenate([ghost_lo, v_local, ghost_hi], axis=0)


def fold_halo(acc_ext, axis_name: str, n_devices: int, width: int = 2):
    """(P + 2*width, ...) accumulated (incl. ghosts) -> (P, ...) owned sums.

    Ghost accumulations are ppermuted back to their owning device and added
    onto its boundary planes. Adjoint of exchange_halo.
    """
    ghost_lo = acc_ext[:width]           # belongs to left neighbor's top
    ghost_hi = acc_ext[-width:]          # belongs to right neighbor's bottom
    interior = acc_ext[width:-width]
    from_right = _shift(ghost_lo, axis_name, -1, n_devices)  # right nbr's lo -> my top
    from_left = _shift(ghost_hi, axis_name, +1, n_devices)   # left nbr's hi -> my bottom
    interior = interior.at[-width:].add(from_right)
    interior = interior.at[:width].add(from_left)
    return interior
