"""B-spline interpolation kernels for particle<->grid transfers.

Reference equivalent: Lib/Ziran/Math/Splines/BSplines.h (BSplineWeights) —
quadratic (3-wide) kernels, the stencil HOT uses for all its scenes.
Design notes: weights are *recomputed* inside transfer kernels rather
than stored per particle (recompute beats the memory round-trip), and
everything is shaped for `vmap` over particles.

Conventions:
  * Grid nodes sit at integer multiples of dx (node i at position i*dx).
  * For the quadratic kernel a particle at position x has base node
    b = floor(x/dx - 0.5); its stencil is nodes b, b+1, b+2 per axis.
  * `quadratic_bspline_weights` returns per-axis weights w[(dim, 3)] and
    derivative weights dw[(dim, 3)] (d/dx of the 1D kernel, in 1/dx units
    applied — i.e. already divided by dx).
"""

from __future__ import annotations

import jax.numpy as jnp


def quadratic_kernel_1d(u):
    """Quadratic B-spline N(u) evaluated at the 3 stencil offsets.

    `u` is the fractional position x/dx - base (in [0.5, 1.5)); returns
    weights for nodes at offsets 0, 1, 2 from the base node.
      N(t) = 3/4 - t^2           for |t| < 1/2
           = (3/2 - |t|)^2 / 2   for 1/2 <= |t| < 3/2
    The three stencil arguments are t0 = u, t1 = u - 1, t2 = u - 2 with
    t0 in [0.5, 1.5), t1 in [-0.5, 0.5), t2 in [-1.5, -0.5).
    """
    t0 = u          # in [0.5, 1.5): outer branch
    t1 = u - 1.0    # in [-0.5, 0.5): inner branch
    t2 = u - 2.0    # in [-1.5, -0.5): outer branch
    w0 = 0.5 * (1.5 - t0) ** 2
    w1 = 0.75 - t1 * t1
    w2 = 0.5 * (1.5 + t2) ** 2
    return jnp.stack([w0, w1, w2], axis=-1)


def quadratic_kernel_grad_1d(u):
    """d/dt of the quadratic kernel at the 3 stencil offsets (see above)."""
    t0 = u
    t1 = u - 1.0
    t2 = u - 2.0
    g0 = t0 - 1.5
    g1 = -2.0 * t1
    g2 = t2 + 1.5
    return jnp.stack([g0, g1, g2], axis=-1)


def cubic_kernel_1d(u):
    """Cubic B-spline N(u) at the 4 stencil offsets (reference: BSplines.h
    cubic branch; 4-wide stencil, base = floor(x/dx) - 1, u = x/dx - base).

      N(t) = 1/2|t|^3 - t^2 + 2/3          for |t| < 1
           = -1/6|t|^3 + t^2 - 2|t| + 4/3  for 1 <= |t| < 2
    Offsets 0..3 have t = u, u-1, u-2, u-3 with u in [1, 2).
    """
    def outer(t):
        a = jnp.abs(t)
        return -a**3 / 6.0 + a * a - 2.0 * a + 4.0 / 3.0

    def inner(t):
        a = jnp.abs(t)
        return 0.5 * a**3 - t * t + 2.0 / 3.0

    return jnp.stack(
        [outer(u), inner(u - 1.0), inner(u - 2.0), outer(u - 3.0)], axis=-1
    )


def cubic_kernel_grad_1d(u):
    """d/dt of the cubic kernel at the 4 stencil offsets."""
    def outer(t):
        a = jnp.abs(t)
        return jnp.sign(t) * (-0.5 * a * a + 2.0 * a - 2.0)

    def inner(t):
        a = jnp.abs(t)
        return jnp.sign(t) * (1.5 * a * a) - 2.0 * t

    return jnp.stack(
        [outer(u), inner(u - 1.0), inner(u - 2.0), outer(u - 3.0)], axis=-1
    )


def quadratic_bspline_weights(x, dx):
    """Base node + per-axis weights for particle position(s) x.

    Args:
      x: (..., dim) particle positions.
      dx: grid spacing (scalar).

    Returns:
      base: (..., dim) int32 base node index per axis.
      w:    (..., dim, 3) interpolation weights per axis per offset.
      dw:   (..., dim, 3) d/dx weights per axis per offset (units 1/dx).
    """
    xs = x / dx
    base = jnp.floor(xs - 0.5)
    u = xs - base  # in [0.5, 1.5)
    w = quadratic_kernel_1d(u)
    dw = quadratic_kernel_grad_1d(u) / dx
    return base.astype(jnp.int32), w, dw


def cubic_bspline_weights(x, dx):
    """Base node + per-axis CUBIC weights (4-wide stencil; reference:
    BSplines.h cubic branch, component #13's second half).

    Base node b = floor(x/dx) - 1; stencil nodes b..b+3 per axis;
    u = x/dx - b is in [1, 2).
    """
    xs = x / dx
    base = jnp.floor(xs) - 1.0
    u = xs - base  # in [1, 2)
    w = cubic_kernel_1d(u)
    dw = cubic_kernel_grad_1d(u) / dx
    return base.astype(jnp.int32), w, dw


def bspline_weights(x, dx, kernel: str = "quadratic"):
    """Dispatch on the kernel family (HOT exposes both; SURVEY.md #13)."""
    if kernel == "cubic":
        return cubic_bspline_weights(x, dx)
    return quadratic_bspline_weights(x, dx)


def kernel_width(kernel: str = "quadratic") -> int:
    return 4 if kernel == "cubic" else 3


def apic_d_inv_factor(kernel: str = "quadratic") -> float:
    """APIC inertia-tensor inverse: D = dx^2/4 I (quadratic), dx^2/3 I
    (cubic); the returned factor multiplies 1/dx^2."""
    return 3.0 if kernel == "cubic" else 4.0


def stencil_offsets(dim: int, width: int = 3):
    """All width^dim integer offsets of the stencil, shape (width^dim, dim)."""
    grids = jnp.meshgrid(*([jnp.arange(width)] * dim), indexing="ij")
    return jnp.stack([g.reshape(-1) for g in grids], axis=-1).astype(jnp.int32)


def _outer_flat(a, b):
    """Flat outer product along the last axis: (..., p) x (..., q) ->
    (..., p*q) with columns (i*q + j) = a_i * b_j — built as p slabs of
    (..., q), never through a (..., p, q) tensor: the broadcast
    (..., p, q, ...) intermediate + bitcast reshape of the tensor
    formulation forces a row-major materialization (docs/KERNEL_PLAN.md
    "Tiny trailing dims"), which for the 128^3 node-embedding stencil
    (2.1M fine nodes) was the largest temp of the MG build."""
    p = a.shape[-1]
    return jnp.concatenate([a[..., i:i + 1] * b for i in range(p)], axis=-1)


def tensor_weights(w, dw, impl: str = "broadcast"):
    """Combine per-axis weights into per-stencil-node weight and gradient.

    Args:
      w:  (..., dim, S) per-axis weights (S = 3 quadratic, 4 cubic).
      dw: (..., dim, S) per-axis derivative weights.
      impl: "broadcast" — (..., S, S, S) broadcast products + reshape.
            In the per-PARTICLE stencil path XLA fuses the temp into the
            consumers, so this is the fast form there.
            "flat" — hierarchical _outer_flat slabs, no >2-trailing-dim
            intermediate at any point. REQUIRED where the stencil is
            materialized whole (the MG node-embedding stencils, which
            cross while-loop carries): the broadcast temp then lays out
            row-major (see _outer_flat).

    Returns:
      wn:  (..., S^dim) scalar weight per stencil node.
      gwn: (..., S^dim, dim) weight gradient per stencil node.

    Both impls use the identical multiply association ((wx*wy)*wz), so
    results are bitwise equal.
    """
    dim = w.shape[-2]
    s = w.shape[-1]
    if impl == "flat":
        if dim == 2:
            wx, wy = w[..., 0, :], w[..., 1, :]
            wn = _outer_flat(wx, wy)
            gx = _outer_flat(dw[..., 0, :], wy)
            gy = _outer_flat(wx, dw[..., 1, :])
            gwn = jnp.stack([gx, gy], axis=-1)
        elif dim == 3:
            wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
            wxy = _outer_flat(wx, wy)                  # (..., S^2)
            wn = _outer_flat(wxy, wz)
            gx = _outer_flat(_outer_flat(dw[..., 0, :], wy), wz)
            gy = _outer_flat(_outer_flat(wx, dw[..., 1, :]), wz)
            gz = _outer_flat(wxy, dw[..., 2, :])
            gwn = jnp.stack([gx, gy, gz], axis=-1)
        else:
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        return wn, gwn
    if dim == 2:
        wi = w[..., 0, :, None]      # (..., S, 1)
        wj = w[..., 1, None, :]      # (..., 1, S)
        wn = (wi * wj).reshape(w.shape[:-2] + (s * s,))
        gx = (dw[..., 0, :, None] * wj).reshape(w.shape[:-2] + (s * s,))
        gy = (wi * dw[..., 1, None, :]).reshape(w.shape[:-2] + (s * s,))
        gwn = jnp.stack([gx, gy], axis=-1)
    elif dim == 3:
        wi = w[..., 0, :, None, None]
        wj = w[..., 1, None, :, None]
        wk = w[..., 2, None, None, :]
        shape = w.shape[:-2] + (s * s * s,)
        wn = (wi * wj * wk).reshape(shape)
        gx = (dw[..., 0, :, None, None] * wj * wk).reshape(shape)
        gy = (wi * dw[..., 1, None, :, None] * wk).reshape(shape)
        gz = (wi * wj * dw[..., 2, None, None, :]).reshape(shape)
        gwn = jnp.stack([gx, gy, gz], axis=-1)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    return wn, gwn
