"""Frozen configuration tree for scenes, solver, multigrid, and device mesh.

Reference equivalent: the command-line flag groups of the HOT project binary
(components #5/#32, SURVEY.md §5.6): dimension/precision, dt & CFL, Newton
CN epsilon, linear-solver choice, preconditioner, MG knobs, matrix-free
toggle. Every reference knob exists here; the CLI (hot_mpm.cli) overrides
fields and dumps the whole tree into the run directory.

These are hashable frozen dataclasses so they can be passed as static
arguments to jit-compiled step functions.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MultigridConfig:
    """Node-embedding multigrid knobs (reference flags -mg_level, --mg_times,
    --smoother, --coarseSolver; components #35/#36)."""

    levels: int = 3                 # number of levels incl. finest
    cycles: int = 1                 # V-cycles per preconditioner application
    pre_smooth: int = 2             # nu_1
    post_smooth: int = 2            # nu_2
    # chebyshev | jacobi | colored_gs (parity-colored Gauss-Seidel, the
    # reference's colored-GS option — see solver.multigrid.colored_gs_smooth)
    smoother: str = "chebyshev"
    chebyshev_order: int = 2        # polynomial degree per smooth call
    jacobi_omega: float = 2.0 / 3.0
    # smoother | cg | direct (dense Cholesky of the agglomerated coarsest
    # operator — reference's Eigen LDLT, #11; pick `levels` so the coarsest
    # is a few-thousand DoF)
    coarse_solver: str = "smoother"
    coarse_iters: int = 20
    # Fraction of the spectrum the Chebyshev smoother targets: [lmax*lo, lmax*hi]
    chebyshev_lo: float = 0.1
    chebyshev_hi: float = 1.05
    power_iters: int = 8            # power-iteration steps for lambda_max
    # Assemble every level's explicit BSR operator once per Newton iteration
    # and smooth via the supertile SpMV (ops.bsr_tiled) instead of
    # per-particle quadrature applies — HOT's explicit per-level matrices
    # (#35) in the tile-row layout of ops.bsr_tiled. Dense grid backend only.
    assembled: bool = False
    # Coarse-operator construction (assembled mode):
    #   galerkin   — A_{l+1} = P^T A_l P via structured SpGEMM (ops.spgemm).
    #                Guarantees correction consistency: measured vred 0.06
    #                and 5 CG iters on the twisting-bar state where the
    #                rediscretized hierarchy DIVERGES (vred 114, 121 CG).
    #   quadrature — re-integrate particles at 2^l spacing (cheaper build,
    #                inconsistent corrections under large deformation/BCs;
    #                kept for A/B and as the matrix-free levels' semantics).
    coarsening: str = "galerkin"
    # First level that gets an explicit assembled operator (assembled
    # mode). Levels below it run matrix-free quadrature smoothing. At
    # >=256^3 the finest-level explicit BSR is ~8.7 GB (1.9M rows x 125
    # offsets x 9 x fp32); set 1 so only the coarser levels assemble. With coarsening='galerkin' the FIRST
    # assembled level is built by the composed-stencil EXACT Galerkin path
    # (ops.composed, auto-enabled via sim.capacity.plan_capacities);
    # deeper levels RAP from it.
    assembled_from_level: int = 0
    # Static row capacity of the dense coarse factor (coarse_solver =
    # "direct"): the factor is built over ACTIVE coarsest rows only, so it
    # costs (capacity*d)^2 instead of (n_nodes*d)^2 (the full-grid factor
    # at a 16^3 coarsest is 604 MB, carried through every Newton
    # iteration). None = Simulation auto-chooses from the particle layout
    # (full n_nodes when driven without a Simulation).
    coarse_capacity: Optional[int] = None
    # Cap on the Galerkin coarse-operator stencil half (ops.spgemm.rap
    # max_half): the exact RAP stencil grows 5 -> 7 -> 9-wide; 3 keeps
    # every level <= 7^dim wide (near-Galerkin truncation — see
    # spgemm.rap). None = exact.
    rap_max_half: Optional[int] = None
    # Galerkin-RAP refresh cadence: "newton" (exact HOT semantics — the
    # whole chain rebuilt at every Newton iterate) or "lagged" (the RAP
    # chain + coarse factor are built once per solve at v0 and reused
    # across Newton iterates, while the FIRST assembled level + every
    # smoother diagonal/lmax stay fresh — coarse corrections lag one
    # linearization point, the profitable trade when the RAP chain is
    # ~1/3 of a per-Newton build; see solver.multigrid.build_precond).
    rap_refresh: str = "newton"
    # Sparse grid backend: MG levels stay tile-COMPACT while their dense
    # node count exceeds this; coarser levels switch to dense logical
    # grids (HOT's coarse-level agglomeration, SURVEY.md §5.7, in storage
    # form — the dense tail reuses the direct coarse factor and dense
    # Galerkin RAP). None = 2 * tile_capacity * 4^dim.
    sparse_dense_switch: Optional[int] = None


@dataclass(frozen=True)
class SolverConfig:
    """Newton + Krylov knobs (reference flags --usecn --cneps --lsolver
    --Ainv --matfree; components #37/#38/#10)."""

    # Time integrator: "implicit" (backward Euler, HOT) or "explicit"
    # (symplectic Euler — the reference's explicit MPM path in
    # MpmSimulationBase; needs sound-CFL dt)
    integrator: str = "implicit"
    # Nonlinear solver for the implicit step: "newton" (HOT) or "lbfgs"
    # (the paper's LBFGS-H baseline)
    nonlinear: str = "newton"
    lbfgs_history: int = 8
    max_newton: int = 10
    use_cn: bool = True             # characteristic-norm termination
    cn_eps: float = 1e-2            # --cneps
    abs_tol: float = 1e-9           # fallback absolute residual tolerance
    linear_solver: str = "cg"       # cg | minres
    # none | jacobi (mass) | block_jacobi (HOT's --Ainv) | multigrid.
    # block_jacobi default: about 4x fewer CG iterations than mass-Jacobi
    # on the twisting bar once the Hessian carries the exact shear-stretch
    # pair terms (bm_hat).
    preconditioner: str = "block_jacobi"
    max_cg: int = 200
    cg_tol: float = 1e-3            # relative tolerance (inexact Newton floor)
    # Eisenstat-Walker-style forcing: eta_k = min(cg_tol, sqrt(|r_k|/|r_0|))
    adaptive_forcing: bool = True
    matrix_free: bool = True        # finest-level Hessian: matrix-free vs BSR
    # Slot-major solve layout (docs/KERNEL_PLAN.md): permute per-particle
    # solve arrays to (cell, slot) order once per step so every solve
    # transfer is one sorted-unique row op. OPT-IN (True): padded slots
    # multiply per-row work (the "padding tax").
    slot_major: Optional[bool] = None
    # static row capacity for the explicit BSR matrix (matrix_free=False);
    # 0 = one row per grid node (fine for 2D / small 3D grids)
    bsr_capacity: int = 0
    line_search: bool = False       # optional backtracking (off, like HOT at CFL dt)
    # Preconditioner rebuild cadence: "newton" (HOT — rebuilt at every
    # Newton iterate) or "step" (lagged: built once at v0 and reused; still
    # SPD, trades the per-Newton hierarchy/assembly cost for a few extra
    # CG iterations — the profitable trade when the MG build dominates the
    # step, see solver.newton.newton_solve precond_refresh)
    precond_refresh: str = "newton"
    # Failure handling (SURVEY.md §5.3): on non-convergence or non-finite
    # state, retry the step with halved dt up to this many times.
    dt_retries: int = 3
    project_hessian: bool = True    # SPD projection of per-particle dP/dF
    multigrid: MultigridConfig = field(default_factory=MultigridConfig)
    # Distributed CG: overlap the halo exchange with interior compute in the
    # matrix-free Hessian apply (SURVEY.md §5.8 "double-buffer halos"). The
    # apply is linear in the grid vector, so it splits into a local-data
    # chain (no communication dependency — XLA's latency-hiding scheduler
    # runs the ppermute underneath it) + a ghost-only chain whose per-
    # particle work is nonzero only near slab boundaries. Costs a second
    # (mostly-zero) particle sweep; wins when ICI/DCN latency dominates.
    # Exactly equal to the unoverlapped apply (tested).
    overlap_halo: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh partitioning of the grid (no reference equivalent —
    HOT is shared-memory; SURVEY.md §2.5/§5.8)."""

    axes: Tuple[str, ...] = ("x",)
    shape: Tuple[int, ...] = (1,)   # devices per mesh axis
    # Which spatial grid dimensions are partitioned (by axis order).
    partition_dims: Tuple[int, ...] = (0,)


@dataclass(frozen=True)
class SimConfig:
    """Scene-independent simulation parameters (reference: MpmSimulationBase
    settings + SimulationBase frame loop, components #22/#24)."""

    dim: int = 3
    dx: float = 1.0 / 64.0
    gravity: Tuple[float, ...] = (0.0, -9.81, 0.0)
    cfl: float = 0.6                # max particle travel in cells per step
    frame_dt: float = 1.0 / 24.0
    max_dt: float = 1e-2
    min_dt: float = 1e-7
    dtype: str = "float32"          # float32 | float64 (CPU validation)
    flip_ratio: float = 0.95        # FLIP/APIC blend (1.0 = pure FLIP); APIC uses C
    transfer: str = "apic"          # apic | flip
    solver: SolverConfig = field(default_factory=SolverConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Grid extent in nodes per dimension (dense logical domain; sparse tiles
    # activate within it).
    grid_res: Tuple[int, ...] = (64, 64, 64)
    # Background-grid storage: "dense" materializes the full logical grid
    # (fine <= ~128^3); "sparse" uses the active-tile table (SPGrid-style,
    # required for >= 256^3 scenes). tile_capacity = max active 4^dim tiles.
    grid_backend: str = "dense"
    tile_capacity: int = 4096
    # Per-step energy diagnostics (StepStats kinetic/potential — component
    # #31). The potential needs one more SVD sweep over all particles;
    # large-scale configs turn it off.
    compute_energy: bool = True
    # Transfer scatter implementation: "scatter" (plain XLA scatter-add)
    # or "binned" (cell-binned scatter-free path, ops.transfer.CellBins).
    # Assembled multigrid on the dense grid plans bins either way
    # (sim.capacity._binned_transfers).
    transfer_impl: str = "scatter"
    bin_cells_capacity: int = 0   # 0 = auto (sized from the initial state)
    bin_cap: int = 0              # max particles per cell; 0 = auto
    # B-spline kernel family (reference component #13 exposes both):
    # "quadratic" (3-wide, HOT's default for all scenes) or "cubic"
    # (4-wide). Cubic runs the width-generic scatter path: the binned/
    # slot-major fast paths and the sharded step assume quadratic stencils.
    transfer_kernel: str = "quadratic"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def config_from_overrides(base: SimConfig, overrides: dict) -> SimConfig:
    """Apply dotted-path overrides, e.g. {"solver.cn_eps": 1e-4}."""
    cfg = base
    for key, value in overrides.items():
        parts = key.split(".")
        cfg = _replace_path(cfg, parts, value)
    return cfg


def _replace_path(obj, parts, value):
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(child, parts[1:], value)})
