"""Benchmark entry point — prints ONE JSON line.

The primary metric is the BSR(3x3) supertile SpMV nnz/s on the config-2
Hessian (3D twisting bar at 128^3, BASELINE.json:8), with vs_baseline its
share of the device's memory-bandwidth roofline (PEAK_HBM_BYTES_PER_S,
keyed by device_kind). Extra fields carry the 64^3 production-step
throughput, the matrix-free CG apply time, the assembled-MG step at 64^3
and the MG-vs-block-Jacobi step at 128^3.

Every phase runs in its own subprocess, one after another, so each
measurement gets a clean device and only one JAX process holds the card
at a time; the parent never imports jax. Timings are warm medians of calls
that end in block_until_ready. The cumulative JSON line is re-printed
after every phase, so a timeout in a later phase still leaves a complete
record of the earlier ones.

    python bench.py                       # all phases
    BENCH_PHASES=spmv,apply python bench.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
VERBOSE = os.environ.get("BENCH_VERBOSE") == "1"

# Peak device-memory bandwidth, bytes/s, by jax device_kind.
#   NVIDIA H100 SXM5 80 GB: 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet)
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _mark(msg):
    if VERBOSE:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def peak_hbm(kind: str) -> float:
    """Peak memory bandwidth of device_kind `kind`; unknown kinds raise."""
    try:
        return PEAK_HBM_BYTES_PER_S[kind]
    except KeyError:
        raise KeyError(
            f"no peak bandwidth for device kind {kind!r}: add it to "
            "bench.PEAK_HBM_BYTES_PER_S with its source") from None


def median_time(fn, x, reps=10):
    """Warm median seconds of fn(x), each call ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _build_system(res_n: int, ppc: int):
    """Scene + stencil + bins + grid state + objective + hessian ctx."""
    import jax
    import jax.numpy as jnp

    from hot_mpm.ops import transfer
    from hot_mpm.scenes import build_scene
    from hot_mpm.sim import capacity
    from hot_mpm.sim import objective as obj_mod

    scene = build_scene("twisting_bar_3d", res=res_n, ppc=ppc)
    cfg, model = scene["cfg"], scene["model"]
    state = scene["state"]
    dim = cfg.dim
    res = cfg.grid_res[:dim]
    n = state.n
    n_nodes = transfer.n_nodes_of(res)
    dtype = state.x.dtype
    dt = jnp.asarray(2e-3, dtype)

    caps = capacity.plan_capacities(cfg, state.x).bin_caps \
        or (max(1024, n // 4), 16)

    st = jax.jit(lambda x: transfer.particle_stencil(x, cfg.dx, res))(state.x)
    bins = jax.jit(
        lambda x: transfer.bin_particles(x, cfg.dx, res, caps[0], caps[1])
    )(state.x)
    gm, gmv = jax.jit(
        lambda st, v, C, m: transfer.p2g_mass_momentum(st, v, C, m, n_nodes)
    )(st, state.v, state.C, state.m)
    active = gm > 0
    vg = gmv * jnp.where(active, 1.0 / jnp.maximum(gm, 1e-30), 0.0)[:, None]
    proj = jnp.broadcast_to(jnp.eye(dim, dtype=dtype), (n_nodes, dim, dim))
    obj = jax.jit(
        lambda st, F, V0, mu, lam, gm, vg, proj: obj_mod.make_objective(
            model, st, F, V0, mu, lam, gm, vg, proj, dt, cfg.dx
        )
    )(st, state.F, state.V0, state.mu, state.lam, gm, vg, proj)
    hess = jax.jit(
        lambda o, v, b: obj_mod.build_hessian(
            model, o, v, gather_st=transfer.make_binned_gather(b, res)
        )
    )(obj, vg, bins)
    jax.block_until_ready(hess.F_new)
    return dict(scene=scene, cfg=cfg, model=model, state=state, st=st,
                bins=bins, gm=gm, active=active, vg=vg, obj=obj, hess=hess,
                res=res, n_nodes=n_nodes, dt=dt, dtype=dtype, caps=caps)


def _phase_spmv_at(res_n: int):
    """Config-2 SpMV: supertile BSR(3x3) SpMV on the res^3 bar Hessian."""
    import jax
    import jax.numpy as jnp

    from hot_mpm.grid import sparse as sparse_mod
    from hot_mpm.ops import bsr as bsr_mod
    from hot_mpm.ops import bsr_tiled

    sysd = _build_system(res_n, ppc=8)
    state, cfg = sysd["state"], sysd["cfg"]
    res, dt = sysd["res"], sysd["dt"]
    dim = cfg.dim
    dtype = sysd["dtype"]
    active = sysd["active"]

    n_active = int(jnp.sum(active))
    cap_rows = ((n_active + 1023) // 1024 + 1) * 1024
    mat_c = bsr_mod.structure(active, res, cap_rows)
    block_nnz = int(jax.jit(lambda m_: m_.block_nnz)(mat_c))

    probe = sparse_mod.build_tile_grid(state.x, cfg.dx, res, capacity=16384)
    t_cap = int(((int(probe.n_active) + 255) // 256 + 1) * 256)
    tgrid = sparse_mod.build_tile_grid(state.x, cfg.dx, res, capacity=t_cap)
    tmat = bsr_tiled.structure_tiled(tgrid)
    # scatter-free rank-1-mode assembly (the production assembly): the
    # colliding-scatter assemble_hessian materializes (n, 27, 27, d, d)
    # per-particle blocks — 59 GB at 128^3 / 416k particles
    tmat = jax.jit(
        lambda m_, b_, st_, F_, cx_, V0_, gm_: bsr_mod.assemble_hessian_modes(
            m_, b_, st_, F_, cx_, V0_, dt, gm_
        )
    )(tmat, sysd["bins"], sysd["st"], state.F, sysd["hess"].ctx, state.V0,
      sysd["gm"])
    nbr = bsr_tiled.tile_neighbors(tgrid)
    jax.block_until_ready(tmat.vals)
    _mark(f"{res_n}^3: rows={n_active} block_nnz={block_nnz} "
          f"tiles={int(tgrid.n_active)}")

    # supertile-arg form: one (R, K*dd) -> (R, K, d, d) copy per assembly
    # (amortized over the CG applies this SpMV models) — see
    # bsr_tiled.vals_supertile_arg
    vals5 = jax.jit(lambda m_: bsr_tiled.vals_supertile_arg(m_, dim))(tmat)
    jax.block_until_ready(vals5)
    spmv_fn = jax.jit(lambda v_, x_: bsr_tiled.spmv_tiled(
        tmat._replace(vals=v_), tgrid, nbr, x_))
    x_rows = bsr_mod.grid_vector_to_rows(tmat, sysd["vg"])
    t_spmv = median_time(lambda y: spmv_fn(vals5, y), x_rows)
    _mark(f"{res_n}^3 spmv best {t_spmv * 1e3:.3f} ms")

    nnz = block_nnz * dim * dim
    bpe = jnp.dtype(dtype).itemsize
    spmv_bytes = nnz * bpe + block_nnz * (4 + dim * bpe) + n_active * 2 * dim * bpe
    peak = peak_hbm(jax.devices()[0].device_kind)
    return dict(
        value=round(nnz / t_spmv, 0),
        vs_baseline=round((spmv_bytes / t_spmv) / peak, 4),
        spmv_res=res_n,
        spmv_ms=round(t_spmv * 1e3, 4),
        spmv_gbps=round(spmv_bytes / t_spmv / 1e9, 2),
        bsr_rows=n_active,
        block_nnz=block_nnz,
        particles=int(state.n),
    )


def phase_spmv():
    import jax

    kind = jax.devices()[0].device_kind
    out = dict(device=kind, platform=jax.devices()[0].platform,
               peak_hbm_gbps=peak_hbm(kind) / 1e9)
    out.update(_phase_spmv_at(int(os.environ.get("BENCH_SPMV_RES", "128"))))
    return out


def phase_apply():
    """Matrix-free CG apply (the production CG hot op, with the library's
    default transfers) at 64^3."""
    import jax

    from hot_mpm.sim import objective as obj_mod

    sysd = _build_system(64, ppc=8)
    obj, hess = sysd["obj"], sysd["hess"]
    apply_fn = jax.jit(lambda w: obj_mod.multiply(obj, hess, w))
    t = median_time(apply_fn, sysd["vg"] + 1e-3)
    return dict(matfree_apply_ms=round(t * 1e3, 3))


def _steps_at(res_n: int, variant: str, steps: int = 5):
    """Implicit-step throughput at the protocol dt from stress_state."""
    import dataclasses

    from hot_mpm.scenes import build_scene, stress_state
    from hot_mpm.sim.simulation import Simulation
    from hot_mpm.utils.config import MultigridConfig

    scene = build_scene("twisting_bar_3d", res=res_n, ppc=8)
    cfg = scene["cfg"]
    sol = cfg.solver
    if variant == "jacobi":
        sol = dataclasses.replace(sol, preconditioner="block_jacobi")
    else:
        mg = MultigridConfig(levels=4, smoother="chebyshev",
                             coarse_solver="direct", assembled=True)
        sol = dataclasses.replace(sol, preconditioner="multigrid",
                                  multigrid=mg)
    cfg = dataclasses.replace(cfg, solver=sol)
    sim = Simulation(cfg, stress_state(scene["state"], cfg),
                     scene["model"], scene["colliders"])
    dt = 2e-3
    stats = sim.step(dt)                  # compile
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        stats = sim.step(dt)
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    return dict(
        steps_per_sec=round(1.0 / step_s, 3),
        step_ms=round(step_s * 1e3, 1),
        newton=int(stats.newton_iters),
        cg=int(stats.cg_iters),
        retries=sim.retry_count,
    )


def phase_steps():
    r = _steps_at(64, "jacobi")
    return dict(steps_per_sec=r["steps_per_sec"], last_newton=r["newton"],
                last_cg=r["cg"], step_retries=r["retries"])


def phase_mg():
    r = _steps_at(64, "mg_asm")
    return dict(mg_steps_per_sec=r["steps_per_sec"],
                mg_step_ms=r["step_ms"],
                mg_newton=r["newton"], mg_cg=r["cg"],
                mgpcg_ms_per_newton=round(
                    r["step_ms"] / max(r["newton"], 1), 1))


def phase_mg128():
    """MG-PCG vs block-Jacobi-PCG per-Newton wall time at 128^3
    (BASELINE.json:2/9)."""
    out = {}
    for side, variant in (("mg", "mg_asm"), ("jacobi", "jacobi")):
        r = _steps_at(128, variant, steps=3)
        out[f"mg128_{side}_cg"] = r["cg"]
        out[f"mg128_{side}_newton_ms"] = round(
            r["step_ms"] / max(r["newton"], 1), 1)
    return out


PHASES = {
    "spmv": (phase_spmv, 1200),
    "apply": (phase_apply, 900),
    "steps": (phase_steps, 900),
    "mg": (phase_mg, 1200),
    "mg128": (phase_mg128, 1800),
}


def main():
    """Jax-free orchestrator: one subprocess per phase (clean device)."""
    out = {
        "metric": "bsr_spmv_nnz_per_s",
        "value": 0.0,
        "unit": "scalar nnz/s (BSR 3x3 supertile SpMV, twisting bar 128^3 "
                "Hessian)",
        "vs_baseline": 0.0,
        "extra": {},
    }
    phases = os.environ.get(
        "BENCH_PHASES", "spmv,apply,steps,mg,mg128").split(",")
    for name in phases:
        fn, tmo = PHASES[name]
        _mark(f"phase {name} (subprocess)")
        cmd = [sys.executable, os.path.abspath(__file__), "--phase", name]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=tmo, cwd=REPO)
            lines = [l for l in p.stdout.strip().splitlines()
                     if l.startswith("{")]
            if p.returncode != 0 or not lines:
                tail = p.stderr.strip().splitlines()[-4:]
                out["extra"][f"{name}_error"] = f"rc={p.returncode} {tail}"
            else:
                r = json.loads(lines[-1])
                out["value"] = r.pop("value", out["value"])
                out["vs_baseline"] = r.pop("vs_baseline", out["vs_baseline"])
                out["extra"].update(r)
        except subprocess.TimeoutExpired:
            out["extra"][f"{name}_error"] = f"timeout {tmo}s"
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--phase":
        from hot_mpm.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        import jax

        # the step runs every contraction at full fp32 (no TF32); so do
        # the layer timings
        jax.config.update("jax_default_matmul_precision", "highest")
        print(json.dumps(PHASES[sys.argv[2]][0]()), flush=True)
    else:
        main()
