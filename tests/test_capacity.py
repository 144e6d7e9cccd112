"""Unit tests for the one capacity planner (hot_mpm.sim.capacity).

VERDICT r3 item 8: the six `_choose_*_caps` host choosers are collapsed
into `plan_capacities` + `grow_plan`; these tests pin (a) the gates — a
table is planned iff the config uses it, (b) sufficiency — every planned
cap covers the actual occupancy of the layout it was measured on, and
(c) the single regrow rule — strict leafwise growth.
"""

import dataclasses

import numpy as np
import pytest

from hot_mpm.scenes import build_scene
from hot_mpm.sim import capacity
from hot_mpm.utils.config import MultigridConfig


def _scene(res=24, **cfg_over):
    scene = build_scene("block_drop_2d", res=res)
    cfg = scene["cfg"]
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    return cfg, scene["state"]


def _binned(cfg):
    return dataclasses.replace(cfg, transfer_impl="binned")


def _mg(cfg, assembled=True, coarse="direct", levels=3,
        assembled_from_level=0, coarsening="galerkin"):
    mgc = MultigridConfig(levels=levels, assembled=assembled,
                          coarse_solver=coarse,
                          assembled_from_level=assembled_from_level,
                          coarsening=coarsening)
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver,
                                        preconditioner="multigrid",
                                        multigrid=mgc))


def test_gates():
    cfg, state = _scene()
    # scatter transfers, no MG, matrix-free: nothing needs a capacity
    cfg0 = dataclasses.replace(cfg, transfer_impl="scatter")
    assert capacity.plan_capacities(cfg0, state.x) == capacity.CapacityPlan()

    plan = capacity.plan_capacities(_binned(cfg), state.x)
    assert plan.bin_caps is not None
    assert plan.mg_tile_caps is None and plan.mg_coarse_cap is None

    plan = capacity.plan_capacities(_mg(_binned(cfg)), state.x)
    assert plan.mg_tile_caps is not None and len(plan.mg_tile_caps) == 3
    assert plan.mg_bin_caps is not None and len(plan.mg_bin_caps) == 3
    assert plan.mg_coarse_cap is not None
    assert plan.mg_composed_caps is None      # assembled_from_level == 0

    # chebyshev-smoothed coarse (no direct factor) drops the coarse cap
    plan = capacity.plan_capacities(_mg(_binned(cfg), coarse="smoother"),
                                    state.x)
    assert plan.mg_coarse_cap is None

    # explicit outer BSR operator needs the tile-row capacity
    cfg_exp = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, matrix_free=False))
    assert capacity.plan_capacities(cfg_exp, state.x).bsr_tile_cap is not None


def test_caps_cover_occupancy():
    cfg, state = _scene()
    cfg = _mg(_binned(cfg))
    x = np.asarray(state.x)
    plan = capacity.plan_capacities(cfg, x)

    res = np.asarray(cfg.grid_res[: cfg.dim], np.int64)
    dx = cfg.dx
    for lvl in range(3):
        n_cells, per_cell = capacity.cell_occupancy(x, res, dx)
        if lvl == 0:
            assert plan.bin_caps[0] >= n_cells and plan.bin_caps[1] > per_cell
        cc, pc = plan.mg_bin_caps[lvl]
        assert cc >= n_cells and pc > per_cell
        assert plan.mg_tile_caps[lvl] >= capacity.tile_count(
            x, res, dx, cfg.dim)
        res = (res + 1) // 2
        dx *= 2.0
    assert plan.mg_coarse_cap >= capacity.active_node_count(
        x, res, dx, cfg.dim)  # res/dx now at the coarsest level


def test_config_overrides_win():
    cfg, state = _scene()
    cfg = dataclasses.replace(_binned(cfg), bin_cells_capacity=4096, bin_cap=9)
    assert capacity.plan_capacities(cfg, state.x).bin_caps == (4096, 9)


def test_grow_plan_strictly_grows():
    cfg, state = _scene()
    cfg = _mg(_binned(cfg))
    old = capacity.plan_capacities(cfg, state.x)
    fresh = capacity.plan_capacities(cfg, state.x, grow=1.3)
    grown = capacity.grow_plan(fresh, old)

    def leaves(v):
        if v is None:
            return []
        if isinstance(v, tuple):
            return [x for e in v for x in leaves(e)]
        return [v]

    for f in dataclasses.fields(capacity.CapacityPlan):
        ov, gv = getattr(old, f.name), getattr(grown, f.name)
        assert (ov is None) == (gv is None)
        for o, g in zip(leaves(ov), leaves(gv)):
            assert g > o     # strict growth on every leaf

    # a fresh measurement that gate-flipped to None still grows the old cap
    none_fresh = capacity.CapacityPlan()
    grown2 = capacity.grow_plan(none_fresh, old)
    for o, g in zip(leaves(old.bin_caps), leaves(grown2.bin_caps)):
        assert g > o


def test_grow_rule_uses_larger_fresh_measurement():
    assert capacity._grow_leaf(1000, 10) == 1000        # fresh need dominates
    assert capacity._grow_leaf(5, 100) == 127           # never shrink: 100*1.25+2


def test_assembled_mg_plans_bins_under_scatter_transfers():
    """Assembled MG on the dense grid needs cell bins for its scatter-free
    assembly whatever transfer_impl says; the transfers themselves stay
    on the scatter path (Simulation only bins them for "binned")."""
    cfg, state = _scene()
    cfg = dataclasses.replace(cfg, transfer_impl="scatter")
    plan = capacity.plan_capacities(_mg(cfg), state.x)
    assert plan.bin_caps is not None and plan.mg_bin_caps is not None
    # matrix-free MG under scatter transfers needs no bins
    plan = capacity.plan_capacities(_mg(cfg, assembled=False), state.x)
    assert plan.bin_caps is None and plan.mg_bin_caps is None
