"""Inexact projected Newton with characteristic-norm termination.

Reference equivalents: Lib/Ziran/Math/Nonlinear/NewtonsMethod.h driven by
the HOT project's characteristic-norm control (components #12/#37,
SURVEY.md §3.3): iterate
    r_k = grad E(v_k);  stop when |r_k|_CN < eps
    solve H_k dv = -r_k by preconditioned CG to forcing tolerance eta_k
    v_{k+1} = v_k + dv
The forcing sequence ties CG accuracy to Newton progress
(Eisenstat-Walker-style, like HOT's inexact inner solves):
    eta_k = clip(sqrt(cn_k / cn_0), cg_tol_floor, 0.5)   if adaptive

The whole loop is one `lax.while_loop` (on-device); the linearization
closures are rebuilt inside the loop body — under jit this is one traced
program, not per-iteration recompilation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from hot_mpm.solver.cg import cg_solve, minres_solve


class NewtonResult(NamedTuple):
    v: jax.Array
    iters: jax.Array            # Newton iterations executed
    cg_iters: jax.Array         # total CG iterations across the solve
    cn_residual: jax.Array      # final characteristic-norm residual
    cn_residual0: jax.Array
    converged: jax.Array
    cn_history: jax.Array       # (max_newton + 1,) CN residual trace (padded
                                # with the final value after convergence)


def newton_solve(
    *,
    residual: Callable = None,   # v -> r (projected); optional with linearize
    build_hessian: Callable = None,  # v -> hessian state; optional with linearize
    multiply: Callable,          # (hess, w) -> H w
    project: Callable,           # r -> projected r
    precondition: Callable,      # (precond_state, r) -> z
    cn_norm: Callable,           # r -> scalar characteristic norm
    build_preconditioner: Callable = lambda hess: None,  # hess -> state,
                                 # built ONCE per Newton iteration (e.g. MG
                                 # block diagonals + Chebyshev bounds)
    v0,
    max_newton: int = 10,
    cn_eps: float = 1e-2,
    abs_tol: float = 0.0,
    cg_tol: float = 1e-3,
    max_cg: int = 200,
    adaptive_forcing: bool = True,
    linear_solver: str = "cg",
    energy: Callable = None,
    line_search: bool = False,
    ls_max_backtracks: int = 8,
    linearize: Callable = None,   # v -> (r, hess); overrides residual +
                                  # build_hessian with a fused evaluation
                                  # (one SVD chain per Newton iteration)
    axis_name: str = None,        # set under shard_map: residual norms and
                                  # CG dots psum across the mesh so every
                                  # device takes identical trip counts
    precond_refresh: str = "newton",  # "newton": rebuild the preconditioner
                                  # at every Newton iterate (HOT's
                                  # semantics — hierarchy follows the
                                  # linearization point); "step": build it
                                  # ONCE at v0 and reuse (lagged/frozen
                                  # preconditioner — still SPD, CG still
                                  # converges to the same iterates'
                                  # tolerance; trades per-Newton build
                                  # cost for a few extra CG iterations)
    refresh_preconditioner: Callable = None,
                                  # optional (hess, base_pstate) -> pstate:
                                  # partial per-Newton refresh against a
                                  # base built ONCE at v0 (e.g. lagged
                                  # Galerkin-RAP chain with fresh finest
                                  # assembly + smoother diagonals —
                                  # MultigridConfig.rap_refresh="lagged").
                                  # Only used when precond_refresh=="newton".
) -> NewtonResult:
    """Run the inexact Newton loop. All arguments with shapes are traced.

    line_search=True enables Armijo backtracking on the incremental
    potential (`energy` closure required) — HOT's optional robustness
    guard for hard steps (reference component #12; off by default at
    CFL-rate dt, matching the paper)."""
    solve = cg_solve if linear_solver == "cg" else minres_solve

    if linearize is None:
        assert residual is not None and build_hessian is not None
        linearize = lambda v: (residual(v), build_hessian(v))

    def sq_norm(r):
        s = jnp.sum(r * r)
        if axis_name is not None:
            s = jax.lax.psum(s, axis_name)
        return s

    r0, hess0 = linearize(v0)
    cn0 = cn_norm(r0)
    partial_refresh = (refresh_preconditioner is not None
                       and precond_refresh == "newton")
    frozen_pstate = (build_preconditioner(hess0)
                     if precond_refresh == "step" or partial_refresh
                     else None)

    def cond(carry):
        v, r, hess, cn, k, cg_total, hist = carry
        not_conv = jnp.logical_and(cn > cn_eps, jnp.sqrt(sq_norm(r)) > abs_tol)
        return jnp.logical_and(k < max_newton, not_conv)

    def body(carry):
        v, r, hess, cn, k, cg_total, hist = carry
        if precond_refresh == "step":
            pstate = frozen_pstate
        elif partial_refresh:
            pstate = refresh_preconditioner(hess, frozen_pstate)
        else:
            pstate = build_preconditioner(hess)
        if adaptive_forcing:
            ratio = cn / jnp.maximum(cn0, 1e-30)
            eta = jnp.clip(jnp.sqrt(ratio), cg_tol, 0.5)
        else:
            eta = jnp.asarray(cg_tol, r.dtype)
        res = solve(
            lambda w: multiply(hess, w),
            -r,
            precondition=lambda z: precondition(pstate, z),
            project=project,
            tol=eta,
            max_iters=max_cg,
            axis_name=axis_name,
        )
        if line_search and energy is not None:
            E0 = energy(v)
            slope = jnp.sum(r * res.x)  # directional derivative (r = grad E)
            if axis_name is not None:
                slope = jax.lax.psum(slope, axis_name)

            def ls_cond(carry):
                alpha, j = carry
                armijo = energy(v + alpha * res.x) <= E0 + 1e-4 * alpha * slope
                return jnp.logical_and(jnp.logical_not(armijo), j < ls_max_backtracks)

            alpha, _ = jax.lax.while_loop(
                ls_cond,
                lambda c: (0.5 * c[0], c[1] + 1),
                (jnp.ones((), r.dtype), jnp.zeros((), jnp.int32)),
            )
            v_new = v + alpha * res.x
        else:
            v_new = v + res.x
        r_new, hess_new = linearize(v_new)
        cn_new = cn_norm(r_new)
        hist = hist.at[k + 1].set(cn_new)
        return (v_new, r_new, hess_new, cn_new, k + 1, cg_total + res.iters, hist)

    hist0 = jnp.full((max_newton + 1,), cn0, dtype=r0.dtype)
    v, r, _, cn, k, cg_total, hist = jax.lax.while_loop(
        cond,
        body,
        (v0, r0, hess0, cn0, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32), hist0),
    )
    # pad the unreached history slots with the final CN value
    idx = jnp.arange(hist.shape[0])
    hist = jnp.where(idx <= k, hist, cn)
    return NewtonResult(
        v=v,
        iters=k,
        cg_iters=cg_total,
        cn_residual=cn,
        cn_residual0=cn0,
        converged=cn <= cn_eps,
        cn_history=hist,
    )
