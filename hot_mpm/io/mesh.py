"""Triangle-mesh loading and inside-sampling for complex scene geometry.

Reference equivalents: Lib/Ziran/Math/Geometry/{ObjIO, VdbLevelSet}
(component #17): load OBJ meshes, sample particles inside (the faceless-
character scene). This is host-side setup code (numpy) — the
sampled particles feed the device pipeline; no VDB dependency, inside
tests use ray-parity counting (watertight meshes).
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Minimal OBJ reader: vertices + triangulated faces (numpy arrays)."""
    verts = []
    faces = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def points_inside_mesh(points, verts, faces):
    """Ray-parity inside test (+x ray), vectorized over points.

    Watertight-mesh assumption, matching the reference's level-set-from-
    mesh sampling contract. O(n_points * n_faces) — fine for scene setup.
    """
    p = np.asarray(points, np.float64)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    counts = np.zeros(len(p), np.int64)
    # Möller–Trumbore, batched over faces. Irrational ray direction avoids
    # edge/diagonal double-count degeneracies on axis-aligned meshes.
    d = np.array([0.577350269, 0.211324865, 0.788675134])
    d = d / np.linalg.norm(d)
    e1 = v1 - v0                                  # (F, 3)
    e2 = v2 - v0
    h = np.cross(np.broadcast_to(d, e2.shape), e2)  # (F, 3)
    a = np.einsum("fj,fj->f", e1, h)              # (F,)
    ok = np.abs(a) > 1e-12
    inv_a = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
    for i in range(len(p)):
        s = p[i][None, :] - v0                     # (F, 3)
        u = inv_a * np.einsum("fj,fj->f", s, h)
        q = np.cross(s, e1)
        vv = inv_a * (q @ d)
        t = inv_a * np.einsum("fj,fj->f", e2, q)
        hit = ok & (u >= 0) & (u <= 1) & (vv >= 0) & (u + vv <= 1) & (t > 1e-12)
        counts[i] = hit.sum()
    return counts % 2 == 1


def sample_mesh(key, obj_path: str, dx: float, particles_per_cell: int,
                scale: float = 1.0, translate=(0.0, 0.0, 0.0), dtype=None):
    """Jittered-lattice samples inside an OBJ mesh (reference: the faceless
    scene's mesh sampling). Returns (positions (n,3) jnp, volume)."""
    import jax.numpy as jnp

    from hot_mpm.sim.seeding import sample_box

    verts, faces = load_obj(obj_path)
    verts = verts * scale + np.asarray(translate)[None, :]
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    dtype = dtype or jnp.float32
    x, vol = sample_box(key, lo, hi, dx, particles_per_cell, dtype)
    from hot_mpm import native

    # native OpenMP ray-parity when the toolchain is present (the 10M-
    # particle path); identical-rule numpy fallback otherwise
    inside = native.inside_mesh(verts, faces, np.asarray(x))
    return x[jnp.asarray(inside)], vol
