"""Sand-column collapse: physical behavior evidence (VERDICT r3 item 9).

The breadth scenes previously ran 3-6 smoke steps with only a NaN check —
nothing distinguished a working Drucker-Prager return map from a no-op.
This test runs the 2D sand column (scenes.sand_column_2d: StVK-Hencky +
Drucker-Prager, slip floor with friction) through a real collapse and
asserts granular-physics facts that fail if plasticity or contact breaks:

  * the column SPREADS (plastic flow) — and spreads far more than the
    same column with plasticity disabled (the elastic control mostly
    rings/bounces and keeps its footprint);
  * the pile's repose angle lands in a physical band — sand neither
    flows flat like water (angle ~ 0, e.g. yield surface collapsed to a
    point) nor stands as a column (angle ~ 90, e.g. return map inert);
  * no particle penetrates the floor by more than a fraction of a cell;
  * the system settles (kinetic energy decays).

CPU fp64, ~1k particles, 200 steps of dt=3e-3 (0.6 s of collapse).
"""

import numpy as np

from hot_mpm.scenes import build_scene
from hot_mpm.sim import Simulation

FLOOR = 0.15
DT = 3e-3
STEPS = 200


def _run(plasticity):
    import jax.numpy as jnp

    scene = build_scene("sand_column_2d", res=64, dtype=jnp.float64)
    sim = Simulation(
        scene["cfg"], scene["state"], scene["model"], scene["colliders"],
        plasticity=plasticity,
    )
    for _ in range(STEPS):
        sim.step(DT)
    return sim


def _footprint_width(x, q=0.98):
    """Robust deposit half-width about the column center (quantile keeps
    a stray particle from defining the footprint)."""
    return float(np.quantile(np.abs(x[:, 0] - 0.5), q))


def test_sand_column_collapse_physics():
    sim = _run("drucker_prager")
    x = np.asarray(sim.state.x)
    assert np.isfinite(x).all()

    h = x[:, 1] - FLOOR
    dx_cell = sim.cfg.dx

    # contact: no particle sunk below the floor by more than ~a cell
    assert h.min() > -1.5 * dx_cell, f"floor penetration {h.min():.4f}"

    # plastic flow: initial half-width 0.08 -> the deposit spreads
    w = _footprint_width(x)
    assert w > 1.5 * 0.08, f"column did not spread (half-width {w:.3f})"

    # the column drops from its initial 0.40 height
    h_peak = float(np.quantile(h, 0.99))
    assert h_peak < 0.75 * 0.40, f"column did not collapse (peak {h_peak:.3f})"

    # repose angle of the settled pile: physical band for a frictional
    # material (Drucker-Prager ~30 deg class): not fluid-flat, not a
    # standing column
    angle = np.degrees(np.arctan2(h_peak, w))
    assert 8.0 < angle < 55.0, f"repose angle {angle:.1f} deg out of band"

    # settling: kinetic energy decayed well below its collapse-time peak
    # (granular piles keep creeping — 0.25 is the decay band at 0.6 s,
    # measured 0.20 at 0.45 s; a non-dissipating bounce stays near 1)
    ke = [r["kinetic_energy"] for r in sim.metrics.records]
    assert ke[-1] < 0.25 * max(ke), "pile did not settle"


def test_sand_spreads_more_than_elastic_control():
    """The discriminator: disabling the return map (elastic column) must
    produce a clearly smaller footprint — fails if plasticity silently
    became a no-op."""
    sand = _run("drucker_prager")
    elastic = _run(None)
    w_sand = _footprint_width(np.asarray(sand.state.x))
    w_el = _footprint_width(np.asarray(elastic.state.x))
    assert w_sand > 1.3 * w_el, (
        f"sand ({w_sand:.3f}) did not out-spread elastic ({w_el:.3f})"
    )
