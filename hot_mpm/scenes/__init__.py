"""Benchmark scene registry.

Reference equivalent: Projects/multigrid/MultigridInit*.h (component #33):
numbered test scenes. Here each scene is a builder returning
(SimConfig, ParticleState, model, colliders, plasticity) — selected by
name or number via hot_mpm.cli.
"""

from hot_mpm.scenes.registry import SCENES, build_scene, stress_state  # noqa: F401
