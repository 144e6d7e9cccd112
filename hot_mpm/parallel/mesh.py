"""Device-mesh construction helpers (SURVEY.md §5.8).

No reference equivalent — HOT is shared-memory-only. This is the
jax.distributed / mesh layer the rebuild adds: named axes over the slice,
with spatial grid-slab ownership as the primary ("SP/CP-analog") strategy
(SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Sequence[str] = ("x",)) -> Mesh:
    """Mesh over the available devices; defaults to 1-D over all devices."""
    devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    n = 1
    for s in shape:
        n *= s
    assert n <= len(devices), f"mesh {shape} needs {n} devices, have {len(devices)}"
    import numpy as np

    return Mesh(np.asarray(devices[:n]).reshape(shape), axis_names=tuple(axes))


def loop_mesh_width(requested: int = 4) -> int:
    """Device count to use for LONG collective-in-loop programs on the
    CPU backend (test meshes, protocol runs).

    XLA:CPU's in-process collective rendezvous is keyed by (RunId, op_id)
    with no iteration sequence number (jax 0.9.0, rendezvous.h). When
    virtual device threads outnumber physical cores, a device that gets a
    full loop iteration ahead re-arrives at the SAME rendezvous object
    before a preempted straggler releases it, and the runtime aborts the
    process: `Check failed: id < num_threads` — reproduced deterministically
    on a 2-core host with a 4-device mesh the moment a sharded CG loop
    runs multiple iterations (impact step), and never with 2 devices.
    Meshes of real accelerator devices are unaffected; only cap on the
    cpu backend.
    """
    import os

    if jax.default_backend() != "cpu":
        return requested
    return max(2, min(requested, os.cpu_count() or requested))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_leading(mesh: Mesh, axis: str = "x") -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(axis))
