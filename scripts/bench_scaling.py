"""Weak-scaling efficiency protocol (BASELINE.json:5 ">=70% nnz/s scaling
1 chip -> >=2 hosts"), on the devices JAX finds or on a CPU-simulated mesh.

Weak scaling: the grid extends along x with device count (res_x = base *
D), so nnz/chip and particles/chip stay constant; efficiency(D) =
steps_per_sec(D) / steps_per_sec(1) (ideal = 1.0 — each device does the
same work, communication is the only loss).

Usage:
  python scripts/bench_scaling.py --devices 1 2 4 8 --cpu  # CPU-simulated
  python scripts/bench_scaling.py --devices 1 4            # real devices
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(devices: int, base_res: int, steps: int, dt: float, cpu: bool):
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    import jax.numpy as jnp

    from hot_mpm.parallel.distributed import initialize, mesh_from_config
    from hot_mpm.parallel.sharded_step import ShardedSimulation
    from hot_mpm.scenes import build_scene, stress_state
    from hot_mpm.utils.config import MeshConfig

    initialize()
    mesh = mesh_from_config(MeshConfig(axes=("x",), shape=(devices,)))

    # weak scaling: stretch the domain along x by replicating the bar scene
    # resolution (res_x = base * D) — constant work per device
    scene = build_scene("twisting_bar_3d", res=base_res, ppc=4)
    cfg = scene["cfg"]
    res = (base_res * devices,) + tuple(cfg.grid_res[1:3])
    cfg = dataclasses.replace(cfg, grid_res=res)
    # tile the particles D times along x
    import numpy as np

    st0 = scene["state"]
    xs, vs = [], []
    for d in range(devices):
        off = np.zeros((3,), np.float32)
        off[0] = d * base_res * cfg.dx
        xs.append(np.asarray(st0.x) + off[None, :])
    x = jnp.asarray(np.concatenate(xs, axis=0))
    rep = lambda a: jnp.concatenate([a] * devices, axis=0)
    state = type(st0)(
        x=x, v=rep(st0.v), Cf=rep(st0.Cf), Ff=rep(st0.Ff), m=rep(st0.m),
        V0=rep(st0.V0), mu=rep(st0.mu), lam=rep(st0.lam),
        yield_stress=rep(st0.yield_stress), Jp=rep(st0.Jp),
    )
    # stressed initial state: the rest-state record measured newton=0
    # cg=0 per step — protocol smoke, not scaling evidence (VERDICT r3
    # weak #3). The impact field gives every step a real Newton solve.
    state = stress_state(state, cfg)

    sim = ShardedSimulation(mesh, cfg, state, scene["model"],
                            scene["colliders"])
    stats = sim.step(dt)
    t0 = time.perf_counter()
    for _ in range(steps):
        stats = sim.step(dt)
    jax.block_until_ready(sim.blocks.x)
    sec = (time.perf_counter() - t0) / steps
    return dict(
        devices=devices, res_x=res[0], n_particles=int(state.n),
        steps_per_sec=round(1.0 / sec, 4), step_ms=round(sec * 1e3, 2),
        newton=int(stats.newton_iters), cg=int(stats.cg_iters),
        backend=jax.default_backend(),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--res", type=int, default=16,
                    help="per-device x-resolution (weak scaling)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU-simulated mesh instead of the real devices")
    ap.add_argument("--out", default=None,
                    help="write one JSON row per device count (jsonl)")
    args = ap.parse_args()

    if args.cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={max(args.devices)}"
        ).strip()

    if os.environ.get("HOT_SCALING_CHILD"):
        d = int(os.environ["HOT_SCALING_CHILD"])
        print(json.dumps(run(d, args.res, args.steps, args.dt, args.cpu)),
              flush=True)
        return

    # one SUBPROCESS per device count, with retries: XLA:CPU's in-process
    # collective rendezvous can abort the whole process when device
    # threads outnumber cores (see parallel.mesh.loop_mesh_width) — a
    # crash of the 8-device leg must not destroy the 1/2/4 records, and
    # the abort is probabilistic per collective, so retries are sound.
    import subprocess

    rows = []
    for d in args.devices:
        row = None
        for attempt in range(3):
            env = dict(os.environ, HOT_SCALING_CHILD=str(d))
            pr = subprocess.run([sys.executable, os.path.abspath(__file__)]
                                + sys.argv[1:], env=env, capture_output=True,
                                text=True)
            lines = [l for l in pr.stdout.splitlines() if l.startswith("{")]
            if pr.returncode == 0 and lines:
                row = json.loads(lines[-1])
                break
            print(f"[scaling] d={d} attempt {attempt} rc={pr.returncode}",
                  file=sys.stderr, flush=True)
        if row is None:
            row = dict(devices=d, error="crashed 3x (cpu collective "
                                        "rendezvous abort)")
        rows.append(row)
        if rows[0].get("devices") == 1 and "steps_per_sec" in row \
                and "steps_per_sec" in rows[0]:
            # weak-scaling efficiency vs the 1-device leg (ideal 1.0)
            row["efficiency"] = round(
                row["steps_per_sec"] / rows[0]["steps_per_sec"], 3)
        print(json.dumps(row), flush=True)
    print(json.dumps(rows, indent=2), file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
