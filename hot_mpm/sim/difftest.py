"""DiffTest: finite-difference validation of the implicit objective.

Reference equivalent: Lib/Ziran/Sim/DiffTest.h (component #23) — the
reference's main correctness instrument: refinement sweeps asserting
energy -> gradient -> Hessian consistency at a random state, printing the
observed convergence order. The test suite already does the stronger
autodiff cross-checks (SURVEY.md §4.1); this module reproduces the
reference's user-facing FD mode for parity and for validating NEW models.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.sim import objective as obj_mod


def run_difftest(model, obj, v0, key=None, n_refinements: int = 8,
                 project_spd: bool = False, verbose: bool = True):
    """FD refinement sweep at state v0.

    Checks, for halving step sizes h:
      e_grad(h) = |E(v+h dv) - E(v) - h <r(v), dv>|            ~ O(h^2)
      e_hess(h) = |r(v+h dv) - r(v) - h H(v) dv|_2             ~ O(h^2)
    Returns dict with errors and observed orders; the reference prints the
    same table from its -runDiffTest mode.
    """
    key = key if key is not None else jax.random.PRNGKey(0)
    dv = jax.random.normal(key, v0.shape, v0.dtype)
    dv = obj_mod.project(obj, dv)
    dv = dv / jnp.linalg.norm(dv)

    E0 = obj_mod.energy(model, obj, v0)
    r0 = obj_mod.residual(model, obj, v0)
    hess = obj_mod.build_hessian(model, obj, v0, project_spd=project_spd)
    Hdv = obj_mod.multiply(obj, hess, dv)
    # exclude inactive-node identity action from the check
    Hdv = jnp.where(obj.active[:, None], Hdv, 0.0)
    rdv = jnp.sum(r0 * dv)

    hs, e_grad, e_hess = [], [], []
    for k in range(n_refinements):
        h = 1e-2 * (0.5**k)
        vh = v0 + h * dv
        Eh = obj_mod.energy(model, obj, vh)
        rh = obj_mod.residual(model, obj, vh)
        e_g = abs(float(Eh - E0 - h * rdv))
        diff = jnp.where(obj.active[:, None], rh - r0 - h * Hdv, 0.0)
        e_h = float(jnp.linalg.norm(diff))
        hs.append(h)
        e_grad.append(e_g)
        e_hess.append(e_h)

    def orders(errs):
        out = []
        for a, b in zip(errs[:-1], errs[1:]):
            out.append(np.log2(a / b) if b > 0 and a > 0 else float("nan"))
        return out

    result = dict(
        h=hs, e_grad=e_grad, e_hess=e_hess,
        order_grad=orders(e_grad), order_hess=orders(e_hess),
    )
    if verbose:
        print("      h        e_grad   order    e_hess   order")
        for i, h in enumerate(hs):
            og = result["order_grad"][i - 1] if i else float("nan")
            oh = result["order_hess"][i - 1] if i else float("nan")
            print(f"{h:10.3e} {e_grad[i]:9.2e} {og:6.2f} {e_hess[i]:9.2e} {oh:6.2f}")
    return result
