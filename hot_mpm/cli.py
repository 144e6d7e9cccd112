"""Command-line driver: scene selection, solver knobs, frame loop, output.

Reference equivalent: Projects/multigrid/multigrid.cpp (component #32) —
`./multigrid -test N --3d --usecn --cneps ... -o out/`. Here:

    python -m hot_mpm --scene twisting_bar_3d --frames 24 -o runs/twist \
        --set solver.preconditioner=multigrid --set solver.cn_eps=1e-3 \
        --scene-arg res=64 --scene-arg ppc=8

Every reference knob group exists as a --set path (SURVEY.md §5.6); the
resolved config is dumped verbatim into the run directory. Frames are
.npz particle dumps (reference writes partio .bgeo); checkpoints enable
exact restart (--resume).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hot_mpm",
        description="Implicit MPM (HOT-class solver) in JAX",
    )
    p.add_argument("--scene", required=True, help="scene name (see --list-scenes)")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("-o", "--output", default=None, help="run directory")
    p.add_argument(
        "--set", action="append", default=[], metavar="PATH=VALUE",
        help="config override, e.g. solver.cn_eps=1e-3 (repeatable)",
    )
    p.add_argument(
        "--scene-arg", action="append", default=[], metavar="KEY=VALUE",
        help="scene builder argument, e.g. res=64 (repeatable)",
    )
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    p.add_argument(
        "--frame-format", default="bgeo", choices=["bgeo", "ply", "npz"],
        help="render frame format (bgeo = reference's partio output)",
    )
    p.add_argument("--checkpoint-every", type=int, default=1, metavar="FRAMES")
    p.add_argument("--max-steps", type=int, default=0, help="stop after N steps (0=off)")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--f64", action="store_true", help="enable float64")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    from hot_mpm.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from hot_mpm.io import load_checkpoint, save_checkpoint, save_frame
    from hot_mpm.scenes import SCENES, build_scene
    from hot_mpm.sim import Simulation
    from hot_mpm.utils.config import config_from_overrides
    from hot_mpm.utils.metrics import MetricsLogger

    if args.list_scenes:
        for name in sorted(SCENES):
            print(name)
        return 0

    scene_kwargs = {}
    for item in args.scene_arg:
        k, _, v = item.partition("=")
        scene_kwargs[k] = _parse_value(v)
    scene = build_scene(args.scene, **scene_kwargs)

    overrides = {}
    for item in args.set:
        k, _, v = item.partition("=")
        overrides[k] = _parse_value(v)
    cfg = config_from_overrides(scene["cfg"], overrides)

    out_dir = args.output or os.path.join("runs", f"{args.scene}-{int(time.time())}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())

    metrics = MetricsLogger(os.path.join(out_dir, "metrics.jsonl"), echo=not args.quiet)

    # Multi-device launch (SURVEY.md §5.8): any mesh.shape other than the
    # single-device default routes through jax.distributed + the fully
    # sharded migrating step, e.g.
    #   python -m hot_mpm --scene twisting_bar_3d --set mesh.shape="(-1,)"
    # On a multi-host slice each process runs this same command;
    # distributed.initialize() auto-detects the coordinator.
    use_mesh = tuple(cfg.mesh.shape) != (1,)
    if use_mesh:
        from hot_mpm.parallel import distributed
        from hot_mpm.parallel.sharded_step import ShardedSimulation

        distributed.initialize()
        mesh = distributed.mesh_from_config(cfg.mesh)
        sim = ShardedSimulation(
            mesh, cfg, scene["state"], scene["model"], scene["colliders"],
            plasticity=scene["plasticity"],
        )
        if jax.process_index() == 0 and not args.quiet:
            print(f"mesh {dict(zip(cfg.mesh.axes, mesh.devices.shape))} "
                  f"over {mesh.devices.size} devices")
    else:
        sim = Simulation(
            cfg, scene["state"], scene["model"], scene["colliders"],
            plasticity=scene["plasticity"], metrics=metrics,
        )

    start_frame = 0
    if args.resume:
        if use_mesh:
            sim.restore(args.resume)     # sharded checkpoint directory
        else:
            sim.state, sim.t, sim.step_count = load_checkpoint(args.resume)
        start_frame = int(sim.t / cfg.frame_dt + 0.5)
        print(f"resumed from {args.resume} at t={sim.t:.4f} (frame {start_frame})")

    print(
        f"scene={args.scene} particles={sim.state.n} grid={cfg.grid_res} "
        f"backend={jax.default_backend()} precond={cfg.solver.preconditioner}",
        flush=True,
    )

    for frame in range(start_frame, args.frames):
        t0 = time.perf_counter()
        sim.advance_frame()
        io_proc = not use_mesh or jax.process_index() == 0
        if io_proc:
            save_frame(
                os.path.join(out_dir, f"frame_{frame:05d}.{args.frame_format}"),
                sim.state,
            )
        if (frame + 1) % args.checkpoint_every == 0:
            if use_mesh:
                # every process writes its own shard (checkpoint_spec)
                sim.save_checkpoint(os.path.join(out_dir, f"ckpt_{frame:05d}"))
            else:
                save_checkpoint(
                    os.path.join(out_dir, f"ckpt_{frame:05d}.npz"),
                    sim.state, sim.t, sim.step_count,
                )
        if not args.quiet:
            print(
                f"frame {frame}: t={sim.t:.4f} steps={sim.step_count} "
                f"({time.perf_counter() - t0:.2f}s)",
                flush=True,
            )
        if args.max_steps and sim.step_count >= args.max_steps:
            break

    if not use_mesh:
        with open(os.path.join(out_dir, "timers.txt"), "w") as fh:
            fh.write(sim.timer.report())
    metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
