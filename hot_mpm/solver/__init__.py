"""Krylov solvers, inexact Newton with characteristic norm, multigrid."""

from hot_mpm.solver.cg import cg_solve, minres_solve, CGResult  # noqa: F401
from hot_mpm.solver.newton import newton_solve, NewtonResult  # noqa: F401
