"""Checkpoint / restart: particle SoA + sim clock; grid state is derived.

Reference equivalents: writeState/readState binary attribute dumps
(components #4/#22; SURVEY.md §5.4) — exact-bit restart from any frame,
grid rebuilt from particles on resume. Here: one .npz per checkpoint with
every ParticleState field + scalars; `save_frame` writes the per-frame
particle positions for rendering (the reference writes partio .bgeo; .npz
is our portable equivalent).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import jax
import numpy as np

from hot_mpm.sim.state import ParticleState


def save_checkpoint(path: str, state: ParticleState, t: float, step_count: int):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }
    np.savez_compressed(path, __t=t, __step_count=step_count, **arrays)


def load_checkpoint(path: str) -> Tuple[ParticleState, float, int]:
    data = np.load(path)
    fields = {
        f.name: jax.numpy.asarray(data[f.name])
        for f in dataclasses.fields(ParticleState)
    }
    return ParticleState(**fields), float(data["__t"]), int(data["__step_count"])


def save_frame(path: str, state: ParticleState, fmt: str = None):
    """Render-output frame dump (reference: writePartio .bgeo, #19).

    Format from the extension (or `fmt`): .bgeo (classic Houdini, what the
    reference's partio emits — native C++ writer), .ply (binary
    little-endian), .vtk (legacy binary POLYDATA), .npz (portable arrays).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ext = (fmt or os.path.splitext(path)[1].lstrip(".")).lower()
    x = np.asarray(state.x)
    v = np.asarray(state.v)
    if ext == "bgeo":
        from hot_mpm import native

        native.write_bgeo(path, x, v)
    elif ext == "ply":
        from hot_mpm import native

        native.write_ply(path, x, v)
    elif ext == "vtk":
        from hot_mpm import native

        native.write_vtk(path, x, v)
    else:
        np.savez_compressed(path, x=x, v=v)
