"""Slab-partitioned distributed implicit solve: shard_map CG with explicit
halo exchange.

This is the capability the reference lacks (SURVEY.md §2.5: "the
capability gap the rebuild adds"): the Newton linear systems — where the
solver spends its time (SURVEY.md §3.5 hot-loop ranking #1) — solved
across a device mesh with:

  * grid x-planes slab-partitioned over mesh axis 'x' (P planes each)
  * particles co-located with the slab owning their stencil base plane
  * per-CG-iteration neighbor halo exchange (2 ghost planes, ppermute)
    for the gather, and its adjoint fold for the scatter — keeping the
    distributed operator exactly symmetric
  * psum inner products

The partitioner produces per-device padded particle blocks (static n_max);
padding entries carry zero weights so they are exact no-ops. Tested
against the single-device solver for iteration-count and solution equality
on a CPU-simulated 8-device mesh (SURVEY.md §4.4).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hot_mpm.models import constitutive as cm
from hot_mpm.ops import transfer
from hot_mpm.parallel.halo import exchange_halo, fold_halo
from hot_mpm.solver.cg import cg_solve

HALO = 2  # quadratic B-spline reach in planes


class ShardedSystem(NamedTuple):
    """Per-device blocks (leading axis = devices) of one Newton system.
    Array-only pytree (shard_map-friendly); static plane geometry travels
    separately."""

    # particles (D, n_max, ...) — node_ids are LOCAL to the extended slab
    node_ids: jax.Array
    wn: jax.Array
    gwn: jax.Array
    F_n: jax.Array
    ctx: cm.HessianContext
    V0: jax.Array
    # grid slabs (D, P * plane_nodes, ...)
    grid_m: jax.Array
    active: jax.Array
    proj: jax.Array
    dt: jax.Array             # scalar, replicated


def partition_system(
    stencil: transfer.Stencil, F_n, ctx, V0, grid_m, active, proj, dt,
    res: Tuple[int, ...], n_devices: int, pad_factor: float = None,
) -> ShardedSystem:
    """Host-side partitioner: global system -> per-device padded blocks.

    pad_factor=None sizes blocks to the actual maximum per-device count
    (host-side exact; pass a factor only when jitting with a fixed bound).
    """
    r0 = res[0]
    assert r0 % n_devices == 0, f"res[0]={r0} not divisible by {n_devices}"
    planes = r0 // n_devices
    plane_nodes = 1
    for r in res[1:]:
        plane_nodes *= int(r)

    n = stencil.wn.shape[0]
    base_plane = stencil.node_ids[:, 0] // plane_nodes  # plane of first stencil node
    dev = jnp.clip(base_plane // planes, 0, n_devices - 1)

    if pad_factor is None:
        counts = jnp.bincount(dev, length=n_devices)
        n_max = max(int(jnp.max(counts)), 1)
    else:
        n_max = int(-(-n * pad_factor // n_devices))
    order = jnp.argsort(dev, stable=True)
    dev_sorted = dev[order]
    # position of each particle within its device block
    pos_in_dev = jnp.arange(n) - jnp.searchsorted(dev_sorted, dev_sorted, side="left")
    slot = dev_sorted * n_max + pos_in_dev
    overflow = jnp.any(pos_in_dev >= n_max)

    def fill(a, fill_value=0.0):
        out = jnp.full((n_devices * n_max + 1,) + a.shape[1:], fill_value, a.dtype)
        out = out.at[jnp.where(pos_in_dev < n_max, slot, n_devices * n_max)].set(
            a[order]
        )
        return out[:-1].reshape((n_devices, n_max) + a.shape[1:])

    # localize node ids: global -> extended-slab local
    g_plane = stencil.node_ids // plane_nodes
    g_rest = stencil.node_ids % plane_nodes
    local_plane = g_plane - (dev * planes)[:, None] + HALO
    local_ids = local_plane * plane_nodes + g_rest

    sys = ShardedSystem(
        node_ids=fill(local_ids, 0),
        wn=fill(stencil.wn),             # zero weights on padding => no-op
        gwn=fill(stencil.gwn),
        F_n=fill(F_n),
        ctx=jax.tree_util.tree_map(fill, ctx),
        V0=fill(V0),
        grid_m=grid_m.reshape(n_devices, planes * plane_nodes),
        active=active.reshape(n_devices, planes * plane_nodes),
        proj=proj.reshape((n_devices, planes * plane_nodes) + proj.shape[1:]),
        dt=jnp.asarray(dt, stencil.wn.dtype),
    )
    return sys, (planes, plane_nodes), bool(overflow)


def _local_apply(sys_local, w_local, planes, plane_nodes, axis_name: str,
                 n_devices: int, dim: int):
    """(M + dt^2 K) w on one slab, halos exchanged (one shard_map body)."""
    w_planes = w_local.reshape(planes, plane_nodes, dim)
    w_ext = exchange_halo(w_planes, axis_name, n_devices, HALO)
    w_flat = w_ext.reshape((planes + 2 * HALO) * plane_nodes, dim)

    st = transfer.Stencil(
        node_ids=sys_local.node_ids, wn=sys_local.wn, gwn=sys_local.gwn, rel=None
    )
    grad_w = transfer.velocity_gradient(st, w_flat)
    dF = sys_local.dt * (grad_w @ sys_local.F_n)
    dP = jax.vmap(cm.apply_hessian)(sys_local.ctx, dF)
    dPFt = dP @ jnp.swapaxes(sys_local.F_n, -1, -2)
    df_ext = transfer.scatter_force(
        st, dPFt, sys_local.V0, (planes + 2 * HALO) * plane_nodes
    )
    df_planes = df_ext.reshape(planes + 2 * HALO, plane_nodes, dim)
    df = fold_halo(df_planes, axis_name, n_devices, HALO)
    df = df.reshape(planes * plane_nodes, dim)
    out = sys_local.grid_m[:, None] * w_local - sys_local.dt * df
    return jnp.where(sys_local.active[:, None], out, w_local)


def _strip_device_axis(tree):
    return jax.tree_util.tree_map(
        lambda a: a[0] if getattr(a, "ndim", 0) > 0 else a, tree
    )


def _local_project(sys_local, r):
    r = jnp.einsum("nij,nj->ni", sys_local.proj, r)
    return jnp.where(sys_local.active[:, None], r, 0.0)


def sharded_cg_solve(
    mesh: Mesh, sys: ShardedSystem, geometry: Tuple[int, int], b, *,
    tol=1e-8, max_iters=1000, axis: str = "x",
):
    """Distributed PCG over the mesh. b: global (n_nodes, dim). Returns the
    global solution and iteration stats (identical math to cg_solve on one
    device — verified by tests)."""
    planes, plane_nodes = geometry
    n_devices = mesh.shape[axis]
    dim = b.shape[-1]
    b_blocks = b.reshape(n_devices, planes * plane_nodes, dim)

    sys_specs = jax.tree_util.tree_map(lambda _: P(axis), sys)
    sys_specs = sys_specs._replace(dt=P())

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(sys_specs, P(axis)),
        out_specs=(P(axis), P(), P()),
    )
    def run(sys_blocks, b_block):
        sys_local = _strip_device_axis(sys_blocks)._replace(dt=sys_blocks.dt)
        b_local = b_block[0]
        inv_m = jnp.where(
            sys_local.active, 1.0 / jnp.maximum(sys_local.grid_m, 1e-30), 1.0
        )
        res = cg_solve(
            lambda w: _local_apply(
                sys_local, w, planes, plane_nodes, axis, n_devices, dim
            ),
            b_local,
            precondition=lambda r: r * inv_m[:, None],
            project=lambda r: _local_project(sys_local, r),
            tol=tol,
            max_iters=max_iters,
            axis_name=axis,
        )
        return res.x[None], res.iters, res.residual

    x_blocks, iters, residual = run(sys, b_blocks)
    return x_blocks.reshape(-1, dim), iters, residual
