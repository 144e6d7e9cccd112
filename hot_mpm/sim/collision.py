"""Analytic level sets and grid-node collision boundary conditions.

Reference equivalents: Lib/Ziran/Math/Geometry/AnalyticLevelSet.h +
CollisionObject.h (components #16/#18): signed-distance objects with
sticky / slip / separate contact, including scripted rigid motion (the
rotating clamps of the twisting-bar scene).

Design: colliders are static Python dataclasses captured in the
jitted step's closure; per grid node they produce a (d, d) projection
matrix P_i and target velocity v_bc_i, evaluated vectorized over all nodes.
The implicit solver applies P_i inside its `project` callback every CG
iteration (reference mechanism: component #30) — so Dirichlet/contact
constraints cost one small matvec per node, fused by XLA.

Velocity convention at constrained nodes:
    v_i = v_bc_i + P_i (v_i - v_bc_i)
  * sticky:   P = 0          v = v_obj
  * slip:     P = I - n n^T  normal component pinned to the object's
  * separate: slip only while approaching (evaluated at pre-solve v)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import jax.numpy as jnp

STICKY = "sticky"
SLIP = "slip"
SEPARATE = "separate"


@dataclasses.dataclass(frozen=True)
class Collider:
    """Base: subclasses implement phi/normal; motion is an optional script.

    `velocity(x, t)` returns the object's material velocity at point x —
    for rigid scripts v = v_lin(t) + omega(t) x (x - center(t)).
    """

    kind: str = STICKY
    # Scripted rigid motion: returns (linear_velocity, angular_velocity,
    # center) at time t. None = static object.
    motion: Optional[Callable] = None
    # Coulomb friction coefficient for slip/separate contacts (reference:
    # AnalyticCollisionObject's friction; 0 = frictionless slip).
    friction: float = 0.0

    def phi(self, x, t):  # (n, d) -> (n,)
        raise NotImplementedError

    def normal(self, x, t):  # (n, d) -> (n, d), outward (phi increasing)
        raise NotImplementedError

    def velocity(self, x, t):
        if self.motion is None:
            return jnp.zeros_like(x)
        v_lin, omega, center = self.motion(t)
        v_lin = jnp.asarray(v_lin, x.dtype)
        rel = x - jnp.asarray(center, x.dtype)[None, :]
        if x.shape[-1] == 2:
            # omega is a scalar in 2D: v = omega x r = omega * perp(r)
            w = jnp.asarray(omega, x.dtype)
            rot = w * jnp.stack([-rel[:, 1], rel[:, 0]], axis=-1)
        else:
            w = jnp.asarray(omega, x.dtype)
            rot = jnp.cross(jnp.broadcast_to(w, rel.shape), rel)
        return v_lin[None, :] + rot


@dataclasses.dataclass(frozen=True)
class HalfSpace(Collider):
    """phi(x) = n . (x - origin); inside (contact) where phi < 0."""

    origin: Tuple[float, ...] = (0.0, 0.0, 0.0)
    n: Tuple[float, ...] = (0.0, 1.0, 0.0)

    def phi(self, x, t):
        n = _unit(jnp.asarray(self.n, x.dtype))
        o = jnp.asarray(self.origin, x.dtype)
        return (x - o[None, :]) @ n

    def normal(self, x, t):
        n = _unit(jnp.asarray(self.n, x.dtype))
        return jnp.broadcast_to(n, x.shape)


@dataclasses.dataclass(frozen=True)
class Sphere(Collider):
    center: Tuple[float, ...] = (0.0, 0.0, 0.0)
    radius: float = 1.0
    inverted: bool = False  # True: keep things INSIDE the sphere

    def phi(self, x, t):
        c = jnp.asarray(self.center, x.dtype)
        d = jnp.linalg.norm(x - c[None, :], axis=-1) - self.radius
        return -d if self.inverted else d

    def normal(self, x, t):
        c = jnp.asarray(self.center, x.dtype)
        rel = x - c[None, :]
        n = rel / jnp.maximum(jnp.linalg.norm(rel, axis=-1, keepdims=True), 1e-12)
        return -n if self.inverted else n


@dataclasses.dataclass(frozen=True)
class AxisBox(Collider):
    """Axis-aligned box; contact inside the box (use for clamps/pads).

    phi < 0 inside. Normal = gradient of box distance (axis of deepest
    penetration inside).
    """

    lo: Tuple[float, ...] = (0.0, 0.0, 0.0)
    hi: Tuple[float, ...] = (1.0, 1.0, 1.0)

    def phi(self, x, t):
        lo = jnp.asarray(self.lo, x.dtype)
        hi = jnp.asarray(self.hi, x.dtype)
        q = jnp.maximum(lo[None, :] - x, x - hi[None, :])  # per-axis outside dist
        outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
        inside = jnp.max(q, axis=-1)
        return jnp.where(inside < 0, inside, outside)

    def normal(self, x, t):
        lo = jnp.asarray(self.lo, x.dtype)
        hi = jnp.asarray(self.hi, x.dtype)
        q = jnp.maximum(lo[None, :] - x, x - hi[None, :])
        # axis of max q; sign: +1 if nearer hi face, -1 if nearer lo face
        axis = jnp.argmax(q, axis=-1)
        sign = jnp.where(
            (x - lo[None, :])[jnp.arange(x.shape[0]), axis]
            > (hi - lo)[axis] * 0.5,
            1.0,
            -1.0,
        ).astype(x.dtype)
        n = jnp.zeros_like(x).at[jnp.arange(x.shape[0]), axis].set(sign)
        return n


@dataclasses.dataclass(frozen=True)
class Cylinder(Collider):
    """Finite capped cylinder (reference AnalyticLevelSet cylinders, #16):
    axis through `center` along unit(`axis`), radius R, half-height h.
    phi < 0 inside. Exact SDF outside; inside, distance to nearest face."""

    center: Tuple[float, ...] = (0.0, 0.0, 0.0)
    axis: Tuple[float, ...] = (0.0, 1.0, 0.0)
    radius: float = 1.0
    half_height: float = 1.0

    def _frame(self, x, t):
        a = _unit(jnp.asarray(self.axis, x.dtype))
        rel = x - jnp.asarray(self.center, x.dtype)[None, :]
        y = rel @ a                                     # axial coordinate
        rad_vec = rel - y[:, None] * a[None, :]
        r = jnp.linalg.norm(rad_vec, axis=-1)
        return a, y, rad_vec, r

    def phi(self, x, t):
        _, y, _, r = self._frame(x, t)
        d_r = r - self.radius
        d_y = jnp.abs(y) - self.half_height
        outside = jnp.linalg.norm(
            jnp.stack([jnp.maximum(d_r, 0.0), jnp.maximum(d_y, 0.0)], -1),
            axis=-1,
        )
        inside = jnp.maximum(d_r, d_y)
        return jnp.where(inside < 0, inside, outside)

    def normal(self, x, t):
        a, y, rad_vec, r = self._frame(x, t)
        d_r = r - self.radius
        d_y = jnp.abs(y) - self.half_height
        # degenerate points (on the axis / mid-plane) get a well-defined
        # fallback: any unit radial, and the +axis cap
        perp = jnp.eye(len(self.axis), dtype=x.dtype)[
            int(jnp.argmin(jnp.abs(jnp.asarray(self.axis))))
        ]
        perp = _unit(perp - jnp.dot(perp, a) * a)
        rad_dir = jnp.where(
            (r > 1e-12)[:, None],
            rad_vec / jnp.maximum(r, 1e-12)[:, None],
            perp[None, :],
        )
        cap_dir = jnp.where(y >= 0, 1.0, -1.0)[:, None] * a[None, :]
        # outside: gradient of the 2D (d_r, d_y) distance; inside: face of
        # least depth (max of the two negatives)
        wr = jnp.maximum(d_r, 0.0)
        wy = jnp.maximum(d_y, 0.0)
        g_out = wr[:, None] * rad_dir + wy[:, None] * cap_dir
        g_norm = jnp.linalg.norm(g_out, axis=-1, keepdims=True)
        g_out = g_out / jnp.maximum(g_norm, 1e-12)
        g_in = jnp.where((d_r > d_y)[:, None], rad_dir, cap_dir)
        # exactly-on-surface points have wr == wy == 0 -> g_out is the zero
        # vector; use the inside-branch face direction so the normal stays
        # unit-length everywhere
        g_out = jnp.where(g_norm > 1e-12, g_out, g_in)
        return jnp.where((jnp.maximum(d_r, d_y) < 0)[:, None], g_in, g_out)


def _unit(v):
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-12)


def grid_boundary_conditions(
    node_pos,
    t,
    colliders: Sequence[Collider],
    grid_v=None,
    boundary_margin: int = 0,
    res=None,
    dx=None,
):
    """Evaluate all colliders at grid nodes -> (proj, v_bc, constrained).

    Args:
      node_pos: (n_nodes, d) node positions.
      t: current time (traced scalar ok).
      colliders: static tuple of Collider objects.
      grid_v: optional (n_nodes, d) pre-solve velocities, needed for
        `separate` contacts (project only while approaching).
      boundary_margin: if > 0, also stick the outermost `margin` node
        layers of the domain (the reference's domain-wall guard).

    Returns:
      proj: (n_nodes, d, d) projection matrices P_i.
      v_bc: (n_nodes, d) target velocities.
      constrained: (n_nodes,) bool mask of any constraint.
    """
    n, d = node_pos.shape
    dtype = node_pos.dtype
    eye = jnp.broadcast_to(jnp.eye(d, dtype=dtype), (n, d, d))
    proj = eye
    v_bc = jnp.zeros((n, d), dtype)
    constrained = jnp.zeros((n,), bool)

    for c in colliders:
        inside = c.phi(node_pos, t) < 0.0
        v_obj = c.velocity(node_pos, t)
        if c.kind == STICKY:
            P_c = jnp.zeros((n, d, d), dtype)
        else:
            nrm = c.normal(node_pos, t)
            P_c = eye - nrm[:, :, None] * nrm[:, None, :]
            if c.kind == SEPARATE:
                if grid_v is None:
                    raise ValueError("separate contact needs grid_v")
                approaching = jnp.sum((grid_v - v_obj) * nrm, axis=-1) < 0.0
                inside = jnp.logical_and(inside, approaching)
        active = inside
        # Sequential composition (reference applies objects in order).
        # Columnwise flat form: the batched (n, d, d) @ (n, d, d)
        # dot_general's buffer tile-pads 56.9x (1.25 GB at 656k nodes)
        cols = []
        for a in range(d):
            for b in range(d):
                acc = P_c[:, a, 0] * proj[:, 0, b]
                for cc in range(1, d):
                    acc = acc + P_c[:, a, cc] * proj[:, cc, b]
                cols.append(jnp.where(active, acc, proj[:, a, b]))
        proj = jnp.stack(cols, axis=-1).reshape(n, d, d)
        v_bc_new = v_obj + _apply(P_c, v_bc - v_obj)
        if c.kind != STICKY and c.friction > 0.0 and grid_v is not None:
            # Coulomb friction on the pre-solve velocity: scale the
            # tangential relative velocity by max(0, 1 - mu |vn| / |vt|)
            # (reference: CollisionObject friction response). Applied as a
            # velocity target correction; the implicit solve keeps the
            # node's tangential DoFs free but biased by v_bc.
            nrm_f = c.normal(node_pos, t)
            rel_v = grid_v - v_obj
            vn = jnp.sum(rel_v * nrm_f, axis=-1)
            vt = rel_v - vn[:, None] * nrm_f
            vt_norm = jnp.linalg.norm(vt, axis=-1)
            scale = jnp.maximum(
                0.0, 1.0 - c.friction * jnp.maximum(-vn, 0.0)
                / jnp.maximum(vt_norm, 1e-12)
            )
            v_bc_fric = v_obj + vt * scale[:, None]
            # fully stuck (scale == 0): the node becomes sticky
            stuck = active & (scale <= 0.0)
            proj = jnp.where(stuck[:, None, None],
                             jnp.zeros((n, d, d), dtype), proj)
            v_bc_new = v_bc_fric
        v_bc = jnp.where(active[:, None], v_bc_new, v_bc)
        constrained = jnp.logical_or(constrained, active)

    if boundary_margin > 0:
        assert res is not None and dx is not None
        lo = boundary_margin * dx
        hi = (jnp.asarray(res, dtype) - 1 - boundary_margin) * dx
        wall = jnp.any((node_pos < lo) | (node_pos > hi[None, :]), axis=-1)
        proj = jnp.where(wall[:, None, None], jnp.zeros((n, d, d), dtype), proj)
        v_bc = jnp.where(wall[:, None], jnp.zeros((n, d), dtype), v_bc)
        constrained = jnp.logical_or(constrained, wall)

    return proj, v_bc, constrained


def _apply(P, v):
    """Batched (n,d,d) @ (n,d)."""
    return jnp.einsum("nij,nj->ni", P, v)


def apply_bc_to_velocity(grid_v, proj, v_bc):
    """v <- v_bc + P (v - v_bc)."""
    return v_bc + _apply(proj, grid_v - v_bc)
