"""hot_mpm — an implicit-MPM solver and sparse linear-algebra framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
penn-graphics-research/HOT ("Hierarchical Optimization Time integration",
Wang et al., ACM TOG 39(3) 2020): implicit Material Point Method with
CFL-rate time steps, solved by characteristic-norm inexact Newton over an
incremental potential, with MG-preconditioned CG whose hierarchy is HOT's
node-embedding geometric multigrid.

Layering (see SURVEY.md §1 for the reference layer map this mirrors):

  hot_mpm.ops       — numerics substrate: 3x3/2x2 SVD, symmetric eigen,
                      B-spline weights, P2G/G2P transfer kernels, BSR SpMV.
                      (reference L1 Lib/Ziran/Math + L2 transfer kernels)
  hot_mpm.models    — constitutive models (energy/stress/SPD-projected
                      Hessian in diagonal space) + plasticity return maps.
                      (reference L1 Lib/Ziran/Physics/ConstitutiveModel)
  hot_mpm.solver    — CG/MINRES, inexact Newton + characteristic norm,
                      node-embedding multigrid, smoothers.
                      (reference L1 Math/Linear + L3 Projects/multigrid)
  hot_mpm.sim       — particle/grid state, the MPM step pipeline, collision
                      objects, seeding, frame loop, checkpointing.
                      (reference L2 Lib/MPM + L1 Sim/)
  hot_mpm.parallel  — device-mesh partitioning, halo exchange, sharded step.
                      (no reference equivalent: HOT is shared-memory only)
  hot_mpm.scenes    — benchmark scene registry (twisting bar, boxes, ...).
                      (reference L4 Projects/multigrid/MultigridInit*)
  hot_mpm.utils     — config tree, timers, structured metrics logging.
                      (reference L1 Lib/Ziran/CS/Util)
"""

__version__ = "0.1.0"

from hot_mpm.utils.config import (  # noqa: F401
    SimConfig,
    SolverConfig,
    MultigridConfig,
    MeshConfig,
)
