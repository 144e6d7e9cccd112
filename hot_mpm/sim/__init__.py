"""Particle/grid state, collision objects, the MPM step pipeline, frame loop."""

from hot_mpm.sim.state import ParticleState, make_particle_state  # noqa: F401
from hot_mpm.sim.collision import (  # noqa: F401
    HalfSpace,
    Sphere,
    AxisBox,
    grid_boundary_conditions,
)
from hot_mpm.sim.simulation import Simulation, advance_one_step  # noqa: F401
