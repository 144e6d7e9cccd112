"""The backward-Euler incremental-potential objective on grid velocities.

Reference equivalents: the implicit objective assembled across
Lib/MPM/MpmSimulationBase + Lib/MPM/Force/FBasedMpmForceHelper
(components #27/#28, SURVEY.md §2.2): E(v) = 1/2 |v - v*|_M^2 + Phi(x + dt v),
exposing computeResidual / multiply / project / precondition to the Krylov
layer, with the per-particle SPD-projected dP/dF cached per Newton iteration.

Design: everything is a pure function of (grid velocity field v,
cached per-particle state); the Hessian application is the G2P -> per-
particle contraction -> P2G composition of the same transfer stencils —
matrix-free, exactly one gather + one scatter per CG iteration, which is
the HBM-bandwidth roofline shape for this operator (SURVEY.md §6).

Unknown layout: v is (n_nodes, dim) over the flattened dense logical grid;
inactive nodes (zero mass) are masked to the identity operator so they sit
inert in CG.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from hot_mpm.models import constitutive as cm
from hot_mpm.ops import transfer


class ObjectiveContext(NamedTuple):
    """Everything fixed during one implicit solve (one time step)."""

    stencil: transfer.Stencil
    F_n: jax.Array           # (n, d, d) deformation gradients at step start
    V0: jax.Array            # (n,)
    mu: jax.Array            # (n,)
    lam: jax.Array           # (n,)
    grid_m: jax.Array        # (n_nodes,)
    v_star: jax.Array        # (n_nodes, d) — predictor velocity (incl. gravity)
    active: jax.Array        # (n_nodes,) bool — nodes with mass
    proj: jax.Array          # (n_nodes, d, d) BC projection matrices
    dt: jax.Array            # scalar
    cn_scale: jax.Array      # (n_nodes,) characteristic force*dt per node


class HessianState(NamedTuple):
    """Per-particle linearization cache, rebuilt each Newton iteration."""

    ctx: cm.HessianContext   # batched over particles
    F_new: jax.Array         # (n, d, d) at the linearization point


def make_objective(model, stencil, F_n, V0, mu, lam, grid_m, v_star, proj, dt,
                   dx, project_hessian: bool = True,
                   scatter=transfer.default_scatter):
    """Build the ObjectiveContext (reference: backwardEulerStep setup)."""
    active = grid_m > 0
    n_nodes = grid_m.shape[0]
    # Characteristic-norm scale (SURVEY.md component #37). HOT
    # nondimensionalizes the Newton residual by a per-node characteristic
    # impulse so one epsilon works across materials/resolutions/dt
    # (paper Sec. "characteristic norm"; re-derived here, not copied):
    #   force scale  f_i = sum_p w_ip V0_p (2 mu_p + lam_p) / dx
    #   impulse scale s_i = max(dt * f_i, m_i * dx / dt)
    # the second term keeps free-fall nodes (no stiffness) sensibly scaled.
    stiff = V0 * (2.0 * mu + lam) / dx
    f_char = scatter(stencil, stencil.wn * stiff[:, None], n_nodes)
    cn_scale = jnp.maximum(dt * f_char, grid_m * dx / dt)
    cn_scale = jnp.where(active, cn_scale, 1.0)
    return ObjectiveContext(
        stencil=stencil, F_n=F_n, V0=V0, mu=mu, lam=lam, grid_m=grid_m,
        v_star=v_star, active=active, proj=proj, dt=dt, cn_scale=cn_scale,
    )


def updated_F(obj: ObjectiveContext, v, gather_st=transfer.default_gather_stencil):
    """F_p(v) = (I + dt grad_v_p) F_n_p."""
    grad_v = transfer.velocity_gradient(obj.stencil, v, gather_st=gather_st)
    d = grad_v.shape[-1]
    eye = jnp.eye(d, dtype=v.dtype)
    return (eye[None] + obj.dt * grad_v) @ obj.F_n


def residual(model, obj: ObjectiveContext, v, scatter=transfer.default_scatter,
             gather_st=transfer.default_gather_stencil):
    """r(v) = M (v - v*) - dt f(v); zero at inactive nodes, BC-projected.

    Units: momentum. This is the gradient of the incremental potential.
    """
    F_new = updated_F(obj, v, gather_st=gather_st)
    P = jax.vmap(lambda f, m_, l_: cm.first_piola(model, f, m_, l_))(
        F_new, obj.mu, obj.lam
    )
    PFt = P @ jnp.swapaxes(obj.F_n, -1, -2)
    f = transfer.scatter_force(obj.stencil, PFt, obj.V0, obj.grid_m.shape[0],
                               scatter=scatter)
    r = obj.grid_m[:, None] * (v - obj.v_star) - obj.dt * f
    return project(obj, r)


def energy(model, obj: ObjectiveContext, v,
           gather_st=transfer.default_gather_stencil):
    """E(v) — used by optional line search and tests."""
    F_new = updated_F(obj, v, gather_st=gather_st)
    psi = jax.vmap(lambda f, m_, l_: cm.psi_from_F(model, f, m_, l_))(
        F_new, obj.mu, obj.lam
    )
    dv = v - obj.v_star
    inertia = 0.5 * jnp.sum(obj.grid_m[:, None] * dv * dv)
    return inertia + jnp.sum(obj.V0 * psi)


def build_hessian(model, obj: ObjectiveContext, v, project_spd: bool = True,
                  gather_st=transfer.default_gather_stencil) -> HessianState:
    """Linearize at v: per-particle SPD-projected diagonal-space Hessians."""
    F_new = updated_F(obj, v, gather_st=gather_st)
    ctx = jax.vmap(
        lambda f, m_, l_: cm.hessian_context(model, f, m_, l_, project=project_spd)
    )(F_new, obj.mu, obj.lam)
    return HessianState(ctx=ctx, F_new=F_new)


def linearize(model, obj: ObjectiveContext, v, project_spd: bool = True,
              scatter=transfer.default_scatter,
              gather_st=transfer.default_gather_stencil):
    """(residual, HessianState) at v with ONE SVD per particle — the
    per-Newton-iteration evaluation (saves a full per-particle SVD chain
    versus calling residual + build_hessian separately)."""
    F_new = updated_F(obj, v, gather_st=gather_st)
    P, ctx = jax.vmap(
        lambda f, m_, l_: cm.stress_and_hessian(model, f, m_, l_, project=project_spd)
    )(F_new, obj.mu, obj.lam)
    PFt = P @ jnp.swapaxes(obj.F_n, -1, -2)
    f = transfer.scatter_force(obj.stencil, PFt, obj.V0, obj.grid_m.shape[0],
                               scatter=scatter)
    r = obj.grid_m[:, None] * (v - obj.v_star) - obj.dt * f
    return project(obj, r), HessianState(ctx=ctx, F_new=F_new)


def elastic_hessian_apply(stencil, F_n, ctx, V0, dt, grid_m, active, w,
                          scatter=transfer.default_scatter,
                          gather_st=transfer.default_gather_stencil):
    """Generic matrix-free (M + dt^2 K) w through an arbitrary stencil.

    Shared by the finest-level objective and every multigrid level (the
    node-embedding coarse operators use the same per-particle dPdF context
    with stencils at coarser spacing — HOT's quadrature coarsening,
    component #35). Identity on inactive nodes so CG/smoothers ignore them.
    """
    grad_w = transfer.velocity_gradient(stencil, w, gather_st=gather_st)
    dF = dt * (grad_w @ F_n)
    dP = jax.vmap(cm.apply_hessian)(ctx, dF)
    dPFt = dP @ jnp.swapaxes(F_n, -1, -2)
    df = transfer.scatter_force(stencil, dPFt, V0, grid_m.shape[0],
                                scatter=scatter)
    out = grid_m[:, None] * w - dt * df                           # -dt * (-dt ...) = +dt^2
    return jnp.where(active[:, None], out, w)


def elastic_hessian_apply_modes_flat(stencil, F_n, ctx, V0, dt, grid_m,
                                     active, w, bins, res):
    """Matrix-free (M + dt^2 K) w via the rank-1 MODE factorization in
    fully FLAT 2D form: H_elastic = Z diag(lam) Z^T with the (n, M*s*d)
    mode matrix of ops.bsr._mode_vectors (lam already carries dt^2 V0),
    window values gathered/scattered as flat k-major rows.

    Why this exists: the generic unfused chain (velocity_gradient ->
    vmap(apply_hessian) -> scatter_force) materializes (n, 3, 3)-class
    temps, which the code's first target tile-padded inside large
    programs (docs/KERNEL_PLAN.md "Tiny trailing dims"). Here every
    device array is (n, s), (n, M) or (n, M*s*d), at ~3x the FLOPs
    (2 M s d MACs/particle). Exactly equal to
    the assembled operator (same modes — tested via the assembly-equality
    suites) and to the unfused apply on active windows.

    Requires dense-grid CellBins (window_gather_flat); callers fall back
    to elastic_hessian_apply without them.
    """
    from hot_mpm.ops import bsr as bsr_mod

    n, s = stencil.wn.shape
    d = w.shape[-1]
    sd = s * d
    Z, lam = bsr_mod._mode_vectors(stencil, F_n, ctx, V0, dt, d)
    Mm = lam.shape[1]
    # fence=True: without it the window build can be rematerialized per
    # consumer inside this apply's smoother/power-iteration loops (see
    # window_gather_flat)
    rows = transfer.window_gather_flat(bins, w, res, fence=True)  # (n, s*d)
    # q_m = z_m . window  (Z columns are b*s + j — component-major)
    qs = []
    for m_ in range(Mm):
        acc = None
        for b in range(d):
            t = (Z[:, m_ * sd + b * s:m_ * sd + (b + 1) * s]
                 * rows[:, b::d])
            acc = t if acc is None else acc + t
        qs.append(jnp.sum(acc, axis=1, keepdims=True))        # (n, 1)
    # contrib = sum_m lam_m q_m z_m, written back in k-major order
    contrib = jnp.zeros((n, sd), w.dtype)
    for b in range(d):
        cb = None
        for m_ in range(Mm):
            t = (lam[:, m_:m_ + 1] * qs[m_]) * \
                Z[:, m_ * sd + b * s:m_ * sd + (b + 1) * s]
            cb = t if cb is None else cb + t
        contrib = contrib.at[:, b::d].set(cb)
    dKw = transfer.binned_scatter_flat(bins, contrib, res, d)  # dt^2 K w
    out = grid_m[:, None] * w + dKw
    return jnp.where(active[:, None], out, w)


def multiply(obj: ObjectiveContext, hess: HessianState, w,
             scatter=transfer.default_scatter,
             gather_st=transfer.default_gather_stencil):
    """H w at the finest level (reference: component #27's
    addScaledStressDifferentials path)."""
    return elastic_hessian_apply(
        obj.stencil, obj.F_n, hess.ctx, obj.V0, obj.dt, obj.grid_m, obj.active, w,
        scatter=scatter, gather_st=gather_st,
    )


def elastic_block_diag(stencil, F_n, ctx, V0, dt, grid_m, active, dim: int,
                       scatter=transfer.default_scatter, flat: bool = False):
    """Per-node (d, d) diagonal blocks of M + dt^2 K — the block-Jacobi
    preconditioner/smoother basis (reference: HOT's --Ainv block-diagonal
    option, component #38).

    Node i's block gets, from each particle p with stencil node k -> i:
      B[a, b] = dt^2 V0 (dPdF : (e_a o g_k)) : (e_b o g_k),  g_k = F^T gw_k.

    FLAT rank-1-mode form: the SPD-projected diagonal-space dPdF is
    exactly M = d + 2*n_pairs rank-1 modes (see ops.bsr._mode_vectors), so
    B_k = dt^2 V0 sum_m lam_m z_m(k) z_m(k)^T with z_m(k) = M_m (F^T gw_k)
    — computed here with strided (n, s) column slices only. The earlier
    vmap(vmap(apply_hessian-column)) form left (n, s, d, d)-class
    broadcast temps (docs/KERNEL_PLAN.md "Tiny trailing dims") and cost
    81 apply_hessian columns per particle.
    """
    from hot_mpm.ops.svd import eigh_sym

    n, s = stencil.wn.shape
    d = dim
    gwn_flat = stencil.gwn.reshape(n, s * d)
    # g_flat[:, k*d+a] = (F^T gw_k)_a = sum_b gwn[k, b] F[b, a]
    g_cols = []
    for a in range(d):
        acc = F_n[:, 0, a:a + 1] * gwn_flat[:, 0::d]
        for b in range(1, d):
            acc = acc + F_n[:, b, a:a + 1] * gwn_flat[:, b::d]
        g_cols.append(acc)                               # (n, s)
    # y = g V (diagonal-space rows): y_c = sum_a g_a V[a, c]
    y_cols = []
    for c in range(d):
        acc = ctx.V[:, 0, c:c + 1] * g_cols[0]
        for a in range(1, d):
            acc = acc + ctx.V[:, a, c:c + 1] * g_cols[a]
        y_cols.append(acc)
    w_eig, Q = jax.vmap(eigh_sym)(ctx.A)                 # (n, d), (n, d, d)
    lam_scale = (dt * dt) * V0                           # (n,)

    # accumulate D[k][a][b] = sum_m lam_m z_m_a z_m_b, flat (n, s) per (a, b)
    acc_ab = [[None] * d for _ in range(d)]

    def add_mode(z_cols, lam_m):
        lam = (lam_scale * lam_m)[:, None]               # (n, 1)
        for a in range(d):
            za_l = lam * z_cols[a]
            for b in range(a, d):
                t = za_l * z_cols[b]
                acc_ab[a][b] = t if acc_ab[a][b] is None else acc_ab[a][b] + t

    for m_i in range(d):                                 # diagonal modes
        z_cols = []
        for e in range(d):
            acc = (ctx.U[:, e, 0:1] * Q[:, 0, m_i:m_i + 1]) * y_cols[0]
            for c in range(1, d):
                acc = acc + (ctx.U[:, e, c:c + 1] * Q[:, c, m_i:m_i + 1]) * y_cols[c]
            z_cols.append(acc)
        add_mode(z_cols, w_eig[:, m_i])
    inv_sqrt2 = 0.7071067811865476
    for k_p, (i, j) in enumerate(cm._pairs(d)):          # shear-pair modes
        zs = [
            (ctx.U[:, e, i:i + 1] * y_cols[j] + ctx.U[:, e, j:j + 1] * y_cols[i])
            * inv_sqrt2
            for e in range(d)
        ]
        add_mode(zs, ctx.b_minus[:, k_p])
        za = [
            (ctx.U[:, e, i:i + 1] * y_cols[j] - ctx.U[:, e, j:j + 1] * y_cols[i])
            * inv_sqrt2
            for e in range(d)
        ]
        add_mode(za, ctx.b_plus[:, k_p])

    # pack flat (n, s*d*d) in k-major (k*dd + a*d + b) order and scatter
    cols = [None] * (d * d)
    for a in range(d):
        for b in range(d):
            cols[a * d + b] = acc_ab[a][b] if a <= b else acc_ab[b][a]
    blocks_flat = jnp.stack(cols, axis=-1)               # (n, s, dd)
    K_flat = scatter(stencil, blocks_flat, grid_m.shape[0])  # (n_nodes, dd)
    if flat:
        # FLAT (n_nodes, d*d) output for the tiny-trailing-dims rule
        # (docs/KERNEL_PLAN.md); its consumers (sym_block_inv_flat,
        # multigrid._bapply) are strided-column elementwise
        eye_flat = jnp.eye(dim, dtype=K_flat.dtype).reshape(1, dim * dim)
        D = grid_m[:, None] * eye_flat + K_flat
        return jnp.where(active[:, None], D, eye_flat)
    K_diag = K_flat.reshape(-1, dim, dim)
    eye = jnp.eye(dim, dtype=K_diag.dtype)
    D = grid_m[:, None, None] * eye[None] + K_diag
    return jnp.where(active[:, None, None], D, eye[None])


def sym_block_inv(D):
    """Batched analytic inverse of symmetric (n, d, d) blocks, d in {2, 3}
    (adjugate / determinant, pure elementwise arithmetic).

    Every block-diagonal in this solver is symmetric (SPD-projected
    elastic blocks + identity BC rows), so the adjugate form replaces a
    batched LU (jnp.linalg.inv) with a few fused elementwise ops.

    Scale-normalized for fp32: a tiny-mass boundary block m*I has
    det = m^d which UNDERFLOWS to 0 in fp32 for m ~ 1e-30 (adjugate/0 =
    inf -> the whole solve goes non-finite, every step retried at
    halved dt until nonfinite_give_up). Dividing by the
    max diagonal first keeps det O(1) for any well-conditioned block at
    any scale.
    """
    d = D.shape[-1]
    diag = jnp.stack([D[..., i, i] for i in range(d)], -1)
    s = jnp.maximum(jnp.max(jnp.abs(diag), axis=-1), 1e-30)
    D = D / s[..., None, None]
    if d == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c = D[..., 1, 1]
        det = a * c - b * b
        inv_det = 1.0 / (det * s)
        return jnp.stack(
            [jnp.stack([c, -b], -1), jnp.stack([-b, a], -1)], -2
        ) * inv_det[..., None, None]
    assert d == 3, d
    a, b, c = D[..., 0, 0], D[..., 0, 1], D[..., 0, 2]
    e, f = D[..., 1, 1], D[..., 1, 2]
    g = D[..., 2, 2]
    A00 = e * g - f * f
    A01 = c * f - b * g
    A02 = b * f - c * e
    A11 = a * g - c * c
    A12 = b * c - a * f
    A22 = a * e - b * b
    det = a * A00 + b * A01 + c * A02
    inv_det = 1.0 / (det * s)
    row0 = jnp.stack([A00, A01, A02], -1)
    row1 = jnp.stack([A01, A11, A12], -1)
    row2 = jnp.stack([A02, A12, A22], -1)
    return jnp.stack([row0, row1, row2], -2) * inv_det[..., None, None]


def sym_block_inv_flat(Df, dim: int):
    """sym_block_inv on FLAT (n, d*d) symmetric blocks -> flat (n, d*d)
    inverses: identical adjugate/determinant arithmetic read and written
    through strided columns, so no (n, d, d) array ever exists in the
    program (see elastic_block_diag flat=True). Same fp32 max-diagonal scale normalization."""
    d = dim
    dd = d * d

    def comp(a, b):
        return Df[:, a * d + b]

    diag = [comp(i, i) for i in range(d)]
    s = jnp.maximum(jnp.abs(diag[0]), 1e-30)
    for i in range(1, d):
        s = jnp.maximum(s, jnp.abs(diag[i]))
    if d == 2:
        a, b, c = comp(0, 0) / s, comp(0, 1) / s, comp(1, 1) / s
        det = a * c - b * b
        inv_det = 1.0 / (det * s)
        cols = [c, -b, -b, a]
        return jnp.stack([col * inv_det for col in cols], axis=-1)
    assert d == 3, d
    a, b, c = comp(0, 0) / s, comp(0, 1) / s, comp(0, 2) / s
    e, f = comp(1, 1) / s, comp(1, 2) / s
    g = comp(2, 2) / s
    A00 = e * g - f * f
    A01 = c * f - b * g
    A02 = b * f - c * e
    A11 = a * g - c * c
    A12 = b * c - a * f
    A22 = a * e - b * b
    det = a * A00 + b * A01 + c * A02
    inv_det = 1.0 / (det * s)
    cols = [A00, A01, A02, A01, A11, A12, A02, A12, A22]
    return jnp.stack([col * inv_det for col in cols], axis=-1)


def project(obj: ObjectiveContext, r):
    """BC projection + inactive-node mask (reference: component #30)."""
    r = jnp.einsum("nij,nj->ni", obj.proj, r)
    return jnp.where(obj.active[:, None], r, 0.0)


def mass_precondition(obj: ObjectiveContext, r):
    """Inverse-mass (Jacobi on the inertia term) preconditioner."""
    inv_m = jnp.where(obj.active, 1.0 / jnp.maximum(obj.grid_m, 1e-30), 1.0)
    return r * inv_m[:, None]


def cn_norm(obj: ObjectiveContext, r):
    """Characteristic norm: RMS of the nondimensionalized residual."""
    scaled = r / obj.cn_scale[:, None]
    n_active = jnp.maximum(jnp.sum(obj.active), 1)
    return jnp.sqrt(jnp.sum(scaled * scaled) / n_active.astype(r.dtype))
