"""Multi-host runtime entry: jax.distributed wiring + MeshConfig-driven
mesh construction (SURVEY.md §5.8; VERDICT r1 #4 "multi-host runtime").

No reference equivalent — HOT is shared-memory-only. This module is the
process-level scaffolding the rebuild adds:

  * `initialize(...)` — one call per process when a run spans several
    hosts. One host with several cards is ONE process that sees every
    card and needs no call. Across hosts, pass the coordinator address,
    process count and id explicitly (or set JAX_COORDINATOR_ADDRESS /
    COORDINATOR_ADDRESS for jax.distributed to read).
  * `mesh_from_config(cfg.mesh)` — the named device mesh the sharded
    step/MG run on, built from MeshConfig (which the config tree has
    carried since round 1 but nothing consumed — this is the consumer).
  * `checkpoint_spec(...)` — per-host shard layout for orbax-style
    multi-host checkpointing (each host saves its slab's particles).

Single-process usage is unchanged: `mesh_from_config` on one host simply
spans the local devices (including the CPU-simulated
--xla_force_host_platform_device_count mesh the tests use).

Measurement protocol for the >=70% scaling target (BASELINE.json:5),
runnable the day >=2 hosts exist:
  1. per chip-count N in {1, 2, 4, ...}: run `scripts/bench_scaling.py
     --devices N` (same scene, grid res scaled so nnz/chip is constant —
     weak scaling), recording SpMV nnz/s and steps/s;
  2. efficiency(N) = nnz_per_s(N) / (N * nnz_per_s(1));
  3. the halo-overlap A/B (scripts/bench_overlap.py) must be run at each
     N — overlap hides the interconnect latency that otherwise caps
     efficiency.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
from jax.sharding import Mesh

from hot_mpm.utils.config import MeshConfig


_INITIALIZED = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> None:
    """Initialize jax.distributed exactly once per process.

    A no-op for single-process runs (no arguments and no coordinator in
    the environment) — including one host driving all of its cards.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    explicit = coordinator_address is not None
    auto = any(v in os.environ
               for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"))
    if not explicit and not auto:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True


def mesh_from_config(mcfg: MeshConfig) -> Mesh:
    """Named device mesh from MeshConfig over the GLOBAL device list.

    shape entries of -1 are filled from the available device count (so
    `MeshConfig(axes=("x",), shape=(-1,))` spans whatever slice the job
    landed on). Asserts the product matches the global device count when
    fully specified.
    """
    import numpy as np

    devices = jax.devices()
    shape = list(mcfg.shape)
    n_dev = len(devices)
    if any(s == -1 for s in shape):
        fixed = 1
        for s in shape:
            if s != -1:
                fixed *= s
        assert n_dev % fixed == 0, (n_dev, mcfg.shape)
        fill = n_dev // fixed
        shape = [fill if s == -1 else s for s in shape]
    n = 1
    for s in shape:
        n *= s
    assert n <= n_dev, f"mesh {tuple(shape)} needs {n} devices, have {n_dev}"
    return Mesh(np.asarray(devices[:n]).reshape(shape),
                axis_names=tuple(mcfg.axes))


def checkpoint_spec(mesh: Mesh, axis: str = "x"):
    """Per-host shard layout for multi-host checkpointing (§5.4).

    Returns (local_rows, n_rows): the mesh-`axis` block-row indices owned
    by THIS process (in mesh order) and the total row count D. The
    migrating sharded step keeps particles in a persistent (D, n_max)
    block layout, so "each host saves its shard" (SURVEY.md §5.4) means:
    each process dumps exactly the block rows of its local devices; restore
    re-places every row on its device. See
    hot_mpm.parallel.sharded_step.save_sharded_checkpoint /
    load_sharded_checkpoint for the IO half, and
    ShardedSimulation.save_checkpoint / restore for the driver API.
    """
    devs = list(mesh.devices.reshape(-1))
    rows = tuple(
        i for i, d in enumerate(devs)
        if d.process_index == jax.process_index()
    )
    return rows, len(devs)
