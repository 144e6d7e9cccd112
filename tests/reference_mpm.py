"""Independent dense numpy reference implementation of one implicit MPM step.

This is the CPU-runnable correctness reference of BASELINE.json:7 (config
1): same algorithm as hot_mpm (backward-Euler incremental potential,
SPD-projected Newton, mass-Jacobi PCG, characteristic-norm termination),
implemented separately with numpy loops + np.linalg (svd/eigh) and an
EXPLICIT dense Hessian — no code shared with the JAX implementation
except constants. Used by test_golden.py to check Newton/CG iteration
counts and end-of-step positions match (the BASELINE.json:5 acceptance
criterion, applied against this stand-in since /root/reference is empty —
see SURVEY.md §7 hard part 7).

Conventions intentionally mirrored (they are part of the algorithm spec):
  * quadratic B-splines, base = floor(x/dx - 0.5)
  * APIC transfers with D^-1 = 4/dx^2
  * fixed corotated energy
  * CN scale s_i = max(dt * f_char_i, m_i dx / dt),
    f_char_i = sum_p w_ip V0_p (2 mu + lam) / dx
  * forcing eta = clip(sqrt(cn/cn0), cg_tol, 0.5)
  * CG stops at |r| <= eta |r0|; Newton at cn <= cn_eps
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# splines
# ---------------------------------------------------------------------------


def bspline(x, dx, kernel="quadratic"):
    """Per-particle base index, per-axis weights (S,), grads (S,);
    S = 3 (quadratic) or 4 (cubic)."""
    xs = x / dx
    if kernel == "cubic":
        base = (np.floor(xs) - 1.0).astype(np.int64)
        u = xs - base  # in [1, 2)

        def outer_w(t):
            a = np.abs(t)
            return -(a ** 3) / 6.0 + a * a - 2.0 * a + 4.0 / 3.0

        def inner_w(t):
            a = np.abs(t)
            return 0.5 * a ** 3 - t * t + 2.0 / 3.0

        def outer_g(t):
            a = np.abs(t)
            return np.sign(t) * (-0.5 * a * a + 2.0 * a - 2.0)

        def inner_g(t):
            a = np.abs(t)
            return np.sign(t) * (1.5 * a * a) - 2.0 * t

        w = np.stack(
            [outer_w(u), inner_w(u - 1.0), inner_w(u - 2.0), outer_w(u - 3.0)],
            axis=-1,
        )
        g = np.stack(
            [outer_g(u), inner_g(u - 1.0), inner_g(u - 2.0), outer_g(u - 3.0)],
            axis=-1,
        ) / dx
        return base, w, g
    base = np.floor(xs - 0.5).astype(np.int64)
    u = xs - base
    w = np.stack(
        [0.5 * (1.5 - u) ** 2, 0.75 - (u - 1.0) ** 2, 0.5 * (u - 0.5) ** 2], axis=-1
    )
    g = np.stack([u - 1.5, -2.0 * (u - 1.0), u - 0.5], axis=-1) / dx
    return base, w, g


# ---------------------------------------------------------------------------
# fixed corotated model (2D), diagonal-space Hessian with SPD projection
# ---------------------------------------------------------------------------


def svd2_signed(F):
    """np SVD massaged to det(U)=det(V)=+1, sigma[-1] signed."""
    U, s, Vt = np.linalg.svd(F)
    V = Vt.T
    if np.linalg.det(U) < 0:
        U[:, -1] *= -1
        s[-1] *= -1
    if np.linalg.det(V) < 0:
        V[:, -1] *= -1
        s[-1] *= -1
    return U, s, V


def psi_hat_grad(s, mu, lam):
    J = np.prod(s)
    dJ = np.array([s[1], s[0]])
    return 2.0 * mu * (s - 1.0) + lam * (J - 1.0) * dJ


def psi_hat_hess(s, mu, lam):
    J = np.prod(s)
    dJ = np.array([s[1], s[0]])
    A = 2.0 * mu * np.eye(2) + lam * np.outer(dJ, dJ)
    A += lam * (J - 1.0) * np.array([[0.0, 1.0], [1.0, 0.0]])
    return A


def first_piola(F, mu, lam):
    U, s, V = svd2_signed(F)
    g = psi_hat_grad(s, mu, lam)
    return U @ np.diag(g) @ V.T


def dpdf_matrix(F, mu, lam, project=True, eps=1e-10):
    """Full 4x4 dP/dF (row-major vec of 2x2), SPD-projected."""
    U, s, V = svd2_signed(F)
    g = psi_hat_grad(s, mu, lam)
    A = psi_hat_hess(s, mu, lam)
    if project:
        w, Q = np.linalg.eigh(A)
        A = Q @ np.diag(np.maximum(w, 0.0)) @ Q.T

    def safe(num, den):
        mag = max(abs(den), eps)
        return num * (1.0 if den >= 0 else -1.0) / mag

    # shear-stretch eigenvalue: the difference quotient (g0 - g1)/(s0 - s1)
    # cancels algebraically for fixed corotated -> 2 mu - lam (J - 1);
    # exact at s0 == s1 (every rest-state particle), where the naive
    # quotient is 0/0 (matches constitutive.FixedCorotated.bm_hat)
    b_minus = 2.0 * mu - lam * (np.prod(s) - 1.0)
    b_plus = safe(g[0] + g[1], s[0] + s[1])    # rotation eigenvalue
    if project:
        b_minus = max(b_minus, 0.0)
        b_plus = max(b_plus, 0.0)
    b11 = 0.5 * (b_plus + b_minus)
    b12 = 0.5 * (b_minus - b_plus)

    # M_hat maps vec(W) -> vec(dP_hat), ordering (00, 01, 10, 11)
    M_hat = np.zeros((4, 4))
    M_hat[0, 0], M_hat[0, 3] = A[0, 0], A[0, 1]
    M_hat[3, 0], M_hat[3, 3] = A[1, 0], A[1, 1]
    M_hat[1, 1], M_hat[1, 2] = b11, b12
    M_hat[2, 1], M_hat[2, 2] = b12, b11
    # dP = U M_hat(U^T dF V) V^T  =>  K = (U kron V) M_hat (U kron V)^T in
    # row-major vec: vec(U W V^T) = (kron(U, V)) vec(W)
    T = np.kron(U, V)
    return T @ M_hat @ T.T


# ---------------------------------------------------------------------------
# one implicit step on a dense 2D grid
# ---------------------------------------------------------------------------


class RefResult:
    pass


def advance_one_step_ref(
    x, v, C, F, m, V0, mu, lam, *, dx, res, dt, gravity, floor_y,
    cn_eps=1e-2, cg_tol=1e-3, max_newton=10, max_cg=200, boundary_margin=2,
    kernel="quadratic",
):
    """Mirrors hot_mpm.sim.simulation.advance_one_step for 2D fixed
    corotated + sticky floor halfspace. Returns RefResult with positions,
    velocities, per-Newton CG iteration counts."""
    n = x.shape[0]
    nx, ny = res
    n_nodes = nx * ny

    def nid(i, j):
        return i * ny + j

    # ---- P2G
    base, w, gw = bspline(x, dx, kernel)
    S = 4 if kernel == "cubic" else 3
    SS = S * S
    d_inv = (3.0 if kernel == "cubic" else 4.0) / (dx * dx)
    grid_m = np.zeros(n_nodes)
    grid_mv = np.zeros((n_nodes, 2))
    stencils = []  # (ids(SS,), wn(SS,), gwn(SS,2), rel(SS,2)) per particle
    for p in range(n):
        ids = np.empty(SS, np.int64)
        wn = np.empty(SS)
        gwn = np.empty((SS, 2))
        rel = np.empty((SS, 2))
        k = 0
        for a in range(S):
            for b in range(S):
                i = min(max(base[p, 0] + a, 0), nx - 1)
                j = min(max(base[p, 1] + b, 0), ny - 1)
                ids[k] = nid(i, j)
                wn[k] = w[p, 0, a] * w[p, 1, b]
                gwn[k] = [gw[p, 0, a] * w[p, 1, b], w[p, 0, a] * gw[p, 1, b]]
                rel[k] = [i * dx - x[p, 0], j * dx - x[p, 1]]
                k += 1
        stencils.append((ids, wn, gwn, rel))
        mv = m[p] * (v[p][None, :] + (C[p] @ rel.T).T)
        np.add.at(grid_m, ids, m[p] * wn)
        np.add.at(grid_mv, ids, wn[:, None] * mv)

    active = grid_m > 0
    v_grid = np.zeros((n_nodes, 2))
    v_grid[active] = grid_mv[active] / grid_m[active, None]
    v_star = v_grid + dt * np.asarray(gravity)[None, :]

    # ---- BC: sticky floor + sticky domain margin
    node_pos = np.stack(
        np.meshgrid(np.arange(nx) * dx, np.arange(ny) * dx, indexing="ij"), axis=-1
    ).reshape(-1, 2)
    sticky = node_pos[:, 1] < floor_y
    lo = boundary_margin * dx
    hi_x = (nx - 1 - boundary_margin) * dx
    hi_y = (ny - 1 - boundary_margin) * dx
    wall = (
        (node_pos[:, 0] < lo) | (node_pos[:, 0] > hi_x)
        | (node_pos[:, 1] < lo) | (node_pos[:, 1] > hi_y)
    )
    constrained = sticky | wall
    free = active & ~constrained

    def project(r):
        out = r.copy()
        out[~free] = 0.0
        return out

    v0 = v_star.copy()
    v0[constrained] = 0.0

    # ---- CN scale
    f_char = np.zeros(n_nodes)
    for p in range(n):
        ids, wn, _, _ = stencils[p]
        np.add.at(f_char, ids, wn * V0[p] * (2 * mu[p] + lam[p]) / dx)
    cn_scale = np.maximum(dt * f_char, grid_m * dx / dt)
    cn_scale[~active] = 1.0

    def cn_norm(r):
        scaled = r / cn_scale[:, None]
        return np.sqrt((scaled**2).sum() / max(active.sum(), 1))

    def updated_F(vg):
        Fn = np.empty_like(F)
        for p in range(n):
            ids, _, gwn, _ = stencils[p]
            grad_v = vg[ids].T @ gwn  # (2,2) = sum_i v_i gw_i^T
            Fn[p] = (np.eye(2) + dt * grad_v) @ F[p]
        return Fn

    def residual(vg):
        Fn = updated_F(vg)
        f = np.zeros((n_nodes, 2))
        for p in range(n):
            ids, _, gwn, _ = stencils[p]
            P = first_piola(Fn[p], mu[p], lam[p])
            contrib = -V0[p] * (P @ F[p].T @ gwn.T).T  # (SS,2)
            np.add.at(f, ids, contrib)
        r = grid_m[:, None] * (vg - v_star) - dt * f
        return project(r)

    def assemble_hessian(vg):
        """Explicit dense H (2*n_nodes x 2*n_nodes), free DoFs only used."""
        Fn = updated_F(vg)
        H = np.zeros((2 * n_nodes, 2 * n_nodes))
        for i in range(n_nodes):
            H[2 * i, 2 * i] = grid_m[i]
            H[2 * i + 1, 2 * i + 1] = grid_m[i]
        for p in range(n):
            ids, _, gwn, _ = stencils[p]
            K = dpdf_matrix(Fn[p], mu[p], lam[p], project=True)
            # G maps grid dofs (9*2) to vec(dF): dF = dt * (sum_i w_i gw_i^T) F
            # vec(dF)_ab = dt * sum_i w_i[a] (F^T gw_i)[b]
            FtG = F[p].T @ gwn.T  # (2, SS)
            G = np.zeros((4, 2 * SS))
            for k in range(SS):
                for a_ in range(2):
                    for b_ in range(2):
                        G[2 * a_ + b_, 2 * k + a_] = dt * FtG[b_, k]
            Kl = V0[p] * G.T @ K @ G  # (2SS, 2SS) local stiffness
            for ki in range(SS):
                for kj in range(SS):
                    bi, bj = ids[ki], ids[kj]
                    H[2 * bi : 2 * bi + 2, 2 * bj : 2 * bj + 2] += Kl[
                        2 * ki : 2 * ki + 2, 2 * kj : 2 * kj + 2
                    ]
        return H

    def cg(H, b_vec, eta):
        """Jacobi(mass)-preconditioned CG, same termination as hot_mpm."""
        inv_m = np.zeros(n_nodes)
        inv_m[active] = 1.0 / grid_m[active]

        def mult(z):
            out = (H @ z.reshape(-1)).reshape(n_nodes, 2)
            out[~active] = z[~active]
            return out

        def prec(z):
            out = z * inv_m[:, None]
            out[~active] = z[~active]
            return out

        xk = np.zeros_like(b_vec)
        r = project(b_vec - mult(xk))
        z = project(prec(r))
        rz = (r * z).sum()
        rnorm0 = np.sqrt((r * r).sum())
        thr = eta * rnorm0
        p_ = z.copy()
        it = 0
        rnorm = rnorm0
        while it < max_cg and rnorm > thr:
            Ap = project(mult(p_))
            pAp = (p_ * Ap).sum()
            alpha = rz / pAp if pAp > 0 else 0.0
            xk += alpha * p_
            r -= alpha * Ap
            z = project(prec(r))
            rz_new = (r * z).sum()
            beta = rz_new / rz if rz != 0 else 0.0
            p_ = z + beta * p_
            rz = rz_new
            rnorm = np.sqrt((r * r).sum())
            it += 1
        return xk, it

    # ---- Newton
    vg = v0
    r = residual(vg)
    cn0 = cn_norm(r)
    cn = cn0
    cg_iters = []
    newton_iters = 0
    while newton_iters < max_newton and cn > cn_eps:
        H = assemble_hessian(vg)
        eta = np.clip(np.sqrt(cn / max(cn0, 1e-30)), cg_tol, 0.5)
        dv, it = cg(H, -r, eta)
        vg = vg + dv
        r = residual(vg)
        cn = cn_norm(r)
        cg_iters.append(it)
        newton_iters += 1
    v_new = vg.copy()
    v_new[constrained] = 0.0

    # ---- G2P + update
    x_out = np.empty_like(x)
    v_out = np.empty_like(v)
    C_out = np.empty_like(C)
    F_out = np.empty_like(F)
    for p in range(n):
        ids, wn, gwn, rel = stencils[p]
        vi = v_new[ids]
        v_pic = (wn[:, None] * vi).sum(0)
        grad_v = vi.T @ gwn
        C_out[p] = d_inv * (wn[:, None] * vi).T @ rel
        F_out[p] = (np.eye(2) + dt * grad_v) @ F[p]
        v_out[p] = v_pic
        x_out[p] = x[p] + dt * v_pic
    lo_c = 2.0 * dx
    hi_c = (np.asarray(res) - 3.0) * dx
    x_out = np.clip(x_out, lo_c, hi_c[None, :])

    out = RefResult()
    out.x, out.v, out.C, out.F = x_out, v_out, C_out, F_out
    out.newton_iters = newton_iters
    out.cg_iters = cg_iters
    out.cn_residual = cn
    out.cn_residual0 = cn0
    return out
