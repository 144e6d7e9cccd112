"""Mesh-sampled scene tests (components #17/#33): the procedural faceless
OBJ is watertight, the OBJ -> ray-parity -> sampling pipeline fills it,
and the registered scene steps.
"""

import numpy as np
import jax.numpy as jnp

from hot_mpm.scenes import build_scene
from hot_mpm.scenes.assets import faceless_mesh, write_faceless_obj


def test_faceless_mesh_watertight():
    """Every directed edge appears exactly once with its reverse present
    exactly once — a closed orientable 2-manifold (the ray-parity inside
    test's contract)."""
    verts, faces = faceless_mesh()
    edges = {}
    for a, b, c in faces:
        for u, v in ((a, b), (b, c), (c, a)):
            assert (u, v) not in edges, "duplicated directed edge"
            edges[(u, v)] = True
    for (u, v) in edges:
        assert (v, u) in edges, f"boundary edge {(u, v)} — mesh not closed"
    # no degenerate triangles
    tri = verts[np.asarray(faces)]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )
    assert np.all(areas > 1e-10)


def test_faceless_mesh_inside_sampling(tmp_path):
    from hot_mpm.io.mesh import load_obj, points_inside_mesh

    path = write_faceless_obj(str(tmp_path / "faceless.obj"))
    verts, faces = load_obj(path)
    v0, f0 = faceless_mesh()
    np.testing.assert_allclose(verts, v0, atol=1e-8)
    assert faces.shape == f0.shape
    # torso center inside; points outside the silhouette / slab outside
    probes = np.asarray([
        [0.50, 0.46, 0.50],   # torso           -> inside
        [0.50, 0.78, 0.50],   # head            -> inside
        [0.435, 0.10, 0.50],  # left leg        -> inside
        [0.50, 0.10, 0.50],   # between legs    -> outside
        [0.50, 0.46, 0.70],   # beyond slab     -> outside
        [0.10, 0.10, 0.50],   # far corner      -> outside
    ])
    inside = points_inside_mesh(probes, verts, faces)
    assert inside.tolist() == [True, True, True, False, False, False]


def test_faceless_mesh_scene_steps():
    """The registered mesh-sampled scene builds and survives implicit
    steps (small res; the full config-5 scale runs on hardware)."""
    from hot_mpm.sim import Simulation

    scene = build_scene("faceless_mesh_3d", res=32, ppc=2,
                        dtype=jnp.float64)
    state = scene["state"]
    assert state.n > 200
    x = np.asarray(state.x)
    # all particles inside the translated mesh bounding box
    assert x[:, 0].min() > 0.15 and x[:, 0].max() < 0.85
    assert x[:, 1].min() > 0.10 and x[:, 1].max() < 0.96
    assert x[:, 2].min() > 0.40 and x[:, 2].max() < 0.60
    sim = Simulation(scene["cfg"], state, scene["model"],
                     scene["colliders"])
    for _ in range(3):
        stats = sim.step(2e-3)
    assert bool(stats.converged)
    assert np.all(np.isfinite(np.asarray(sim.state.x)))
