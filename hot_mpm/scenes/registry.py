"""Benchmark scenes (reference: Projects/multigrid/MultigridInit*.h).

Each builder returns a dict:
  cfg: SimConfig, state: ParticleState, model: constitutive class,
  colliders: tuple, plasticity: str|None.

The three acceptance scenes of BASELINE.json:5 are here — twisting bar,
stacked boxes (stiffness contrast), faceless-character drop (approximated
by an analytic-level-set body: the reference loads a mesh asset we do not
ship; geometry differs, solver behavior class is the same) — plus the
CPU-runnable config-1 block drop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hot_mpm.models.constitutive import MODEL_REGISTRY, lame_parameters
from hot_mpm.sim.collision import SEPARATE, SLIP, STICKY, AxisBox, HalfSpace, Sphere
from hot_mpm.sim.seeding import sample_box, sample_level_set, sample_sphere
from hot_mpm.sim.state import concatenate_states, make_particle_state
from hot_mpm.utils.config import SimConfig


def stress_state(state, cfg, mag: float = 8.0):
    """Impact-velocity field (radial compression + twist about z in 3D)
    for protocol runs on scenes whose canonical initial state is at rest:
    a rest state at tiny dt converges in 0 Newton iterations, so gate /
    scaling / overlap records made with it measure only plumbing (VERDICT
    r3 weak #1-3). The magnitude keeps per-step motion well under a cell
    at the protocol dt so no dt-halving retries trigger."""
    dim = cfg.dim
    c = jnp.mean(state.x, axis=0)
    r = state.x - c
    v = -mag * r                       # radial compression toward center
    if dim == 3:
        v = v + mag * jnp.stack(
            [-r[:, 1], r[:, 0], jnp.zeros_like(r[:, 2])], axis=-1)
    return state.replace(v=v.astype(state.v.dtype))


def block_drop_2d(res: int = 64, E: float = 1e5, dtype=jnp.float32):
    """Config 1 (BASELINE.json:7): 2D elastic block drop, 64^2, ~10k particles."""
    dx = 1.0 / res
    cfg = SimConfig(
        dim=2,
        dx=dx,
        grid_res=(res, res),
        gravity=(0.0, -9.81),
        dtype=str(jnp.dtype(dtype)),
    )
    key = jax.random.PRNGKey(0)
    x, vol = sample_box(key, (0.3, 0.45), (0.7, 0.65), dx, particles_per_cell=4, dtype=dtype)
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(
        x, particle_volume=vol, density=1000.0, mu=mu, lam=lam, dtype=dtype
    )
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.15), n=(0.0, 1.0)),)
    return dict(
        cfg=cfg,
        state=state,
        model=MODEL_REGISTRY["fixed_corotated"],
        colliders=colliders,
        plasticity=None,
    )


def twisting_bar_3d(res: int = 64, E: float = 1e6, omega: float = 4.0 * np.pi,
                    ppc: int = 8, dtype=jnp.float32):
    """Configs 2/3 (BASELINE.json:8-9): 3D bar twisted by rotating end clamps.

    Reference scene: HOT's "twist" — a fixed-corotated bar; both end clamps
    counter-rotate about the bar (x) axis at angular speed omega (scripted
    sticky collision objects, component #18).
    """
    dx = 1.0 / res
    cfg = SimConfig(
        dim=3,
        dx=dx,
        grid_res=(res, res, res),
        gravity=(0.0, 0.0, 0.0),
        dtype=str(jnp.dtype(dtype)),
    )
    key = jax.random.PRNGKey(1)
    x, vol = sample_box(
        key, (0.2, 0.4, 0.4), (0.8, 0.6, 0.6), dx, particles_per_cell=ppc, dtype=dtype
    )
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(
        x, particle_volume=vol, density=1000.0, mu=mu, lam=lam, dtype=dtype
    )
    center = (0.5, 0.5, 0.5)

    def spin(sign):
        def motion(t):
            w = jnp.asarray([sign * omega, 0.0, 0.0])
            return jnp.zeros(3), w, jnp.asarray(center)

        return motion

    colliders = (
        AxisBox(kind=STICKY, lo=(0.0, 0.3, 0.3), hi=(0.25, 0.7, 0.7), motion=spin(+1.0)),
        AxisBox(kind=STICKY, lo=(0.75, 0.3, 0.3), hi=(1.0, 0.7, 0.7), motion=spin(-1.0)),
    )
    return dict(
        cfg=cfg,
        state=state,
        model=MODEL_REGISTRY["fixed_corotated"],
        colliders=colliders,
        plasticity=None,
    )


def stacked_boxes_3d(res: int = 64, ppc: int = 8, dtype=jnp.float32):
    """Config 4 (BASELINE.json:10): stacked boxes with stiffness contrast.

    Three boxes, E spanning 1e4..1e8 (multi-material via per-particle Lame
    arrays), dropping onto a sticky floor — the conditioning stress test.
    """
    dx = 1.0 / res
    cfg = SimConfig(
        dim=3,
        dx=dx,
        grid_res=(res, res, res),
        gravity=(0.0, -9.81, 0.0),
        dtype=str(jnp.dtype(dtype)),
    )
    stiffness = [1e4, 1e6, 1e8]
    states = []
    for i, E in enumerate(stiffness):
        key = jax.random.PRNGKey(10 + i)
        y0 = 0.2 + i * 0.18
        x, vol = sample_box(
            key,
            (0.35, y0, 0.35),
            (0.65, y0 + 0.14, 0.65),
            dx,
            particles_per_cell=ppc,
            dtype=dtype,
        )
        mu, lam = lame_parameters(E, 0.3)
        states.append(
            make_particle_state(
                x, particle_volume=vol, density=1000.0, mu=mu, lam=lam, dtype=dtype
            )
        )
    state = concatenate_states(states)
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.12, 0.0), n=(0.0, 1.0, 0.0)),)
    return dict(
        cfg=cfg,
        state=state,
        model=MODEL_REGISTRY["fixed_corotated"],
        colliders=colliders,
        plasticity=None,
    )


def faceless_3d(res: int = 128, ppc: int = 8, E: float = 5e5, dtype=jnp.float32):
    """Config 5 (BASELINE.json:11)-class scene: soft character drop.

    The reference's "faceless" scene samples a character mesh (OBJ/VDB,
    component #17). This variant uses an analytic union (head sphere +
    torso box + limb boxes) — same solver character: large soft body,
    self-collision through the grid, floor contact. See faceless_mesh_3d
    for the mesh-sampled variant (procedural OBJ through the real
    io.mesh pipeline).
    """
    dx = 1.0 / res
    cfg = SimConfig(
        dim=3,
        dx=dx,
        grid_res=(res, res, res),
        gravity=(0.0, -9.81, 0.0),
        dtype=str(jnp.dtype(dtype)),
    )

    def phi(x):
        head = jnp.linalg.norm(x - jnp.asarray([0.5, 0.62, 0.5], x.dtype), axis=-1) - 0.08
        torso = _box_phi(x, (0.42, 0.38, 0.44), (0.58, 0.58, 0.56))
        leg1 = _box_phi(x, (0.43, 0.22, 0.45), (0.49, 0.40, 0.55))
        leg2 = _box_phi(x, (0.51, 0.22, 0.45), (0.57, 0.40, 0.55))
        arm1 = _box_phi(x, (0.34, 0.46, 0.46), (0.44, 0.54, 0.54))
        arm2 = _box_phi(x, (0.56, 0.46, 0.46), (0.66, 0.54, 0.54))
        return jnp.minimum(
            jnp.minimum(jnp.minimum(head, torso), jnp.minimum(leg1, leg2)),
            jnp.minimum(arm1, arm2),
        )

    key = jax.random.PRNGKey(7)
    x, vol = sample_level_set(
        key, phi, (0.3, 0.2, 0.4), (0.7, 0.72, 0.6), dx, particles_per_cell=ppc, dtype=dtype
    )
    mu, lam = lame_parameters(E, 0.35)
    state = make_particle_state(
        x, particle_volume=vol, density=1000.0, mu=mu, lam=lam, dtype=dtype
    )
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.08, 0.0), n=(0.0, 1.0, 0.0)),)
    return dict(
        cfg=cfg,
        state=state,
        model=MODEL_REGISTRY["fixed_corotated"],
        colliders=colliders,
        plasticity=None,
    )


def faceless_mesh_3d(res: int = 128, ppc: int = 8, E: float = 5e5,
                     obj_path: str = None, dtype=jnp.float32):
    """The faceless scene's REAL variant (components #17/#33): particles
    sampled INSIDE a character triangle mesh via the OBJ -> ray-parity ->
    jittered-lattice pipeline (hot_mpm.io.mesh.sample_mesh). No mesh asset
    ships, so the default mesh is the procedurally generated watertight
    character of hot_mpm.scenes.assets (pass obj_path to use your own —
    the reference loads the paper's faceless OBJ the same way)."""
    dx = 1.0 / res
    cfg = SimConfig(
        dim=3,
        dx=dx,
        grid_res=(res, res, res),
        gravity=(0.0, -9.81, 0.0),
        dtype=str(jnp.dtype(dtype)),
    )
    if obj_path is None:
        from hot_mpm.scenes.assets import faceless_obj_path

        obj_path = faceless_obj_path()
    from hot_mpm.io.mesh import sample_mesh

    key = jax.random.PRNGKey(7)
    # drop from above the floor: mesh occupies y in [0.02, 0.84]; lift it
    x, vol = sample_mesh(key, obj_path, dx, particles_per_cell=ppc,
                         translate=(0.0, 0.1, 0.0), dtype=dtype)
    mu, lam = lame_parameters(E, 0.35)
    state = make_particle_state(
        x, particle_volume=vol, density=1000.0, mu=mu, lam=lam, dtype=dtype
    )
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.08, 0.0), n=(0.0, 1.0, 0.0)),)
    return dict(
        cfg=cfg,
        state=state,
        model=MODEL_REGISTRY["fixed_corotated"],
        colliders=colliders,
        plasticity=None,
    )


def boards_3d(res: int = 64, ppc: int = 8, dtype=jnp.float32):
    """Paper-suite "boards" scene (SURVEY.md #33 breadth, beyond the three
    acceptance scenes): thin stiff elastoplastic boards dropped flat onto
    a frictional floor — the bending-dominated stress case that separates
    preconditioners (thin elements condition the Hessian badly)."""
    dx = 1.0 / res
    cfg = SimConfig(
        dim=3,
        dx=dx,
        grid_res=(res, res, res),
        gravity=(0.0, -9.81, 0.0),
        dtype=str(jnp.dtype(dtype)),
    )
    states = []
    thick = max(3.0 * dx, 0.04)
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        y0 = 0.3 + i * (thick + 0.08)
        x, vol = sample_box(
            key,
            (0.25 + 0.04 * i, y0, 0.35),
            (0.75 - 0.04 * i, y0 + thick, 0.65),
            dx, particles_per_cell=ppc, dtype=dtype,
        )
        mu, lam = lame_parameters(2e7, 0.35)
        states.append(make_particle_state(
            x, particle_volume=vol, density=800.0, mu=mu, lam=lam,
            dtype=dtype,
        ))
    state = concatenate_states(states)
    state = state.replace(
        yield_stress=jnp.full((state.n,), 5e4, state.x.dtype)
    )
    colliders = (
        HalfSpace(kind=SLIP, friction=0.3, origin=(0.0, 0.2, 0.0),
                  n=(0.0, 1.0, 0.0)),
    )
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["stvk_hencky"],
                colliders=colliders, plasticity="von_mises")


def chain_2d(res: int = 96, E: float = 5e6, dtype=jnp.float32):
    """Paper-suite "chain" scene (2D section): stiff elastic rings falling
    onto each other and a sticky floor — large rotations + ring-on-ring
    contact through the grid, the stress case for SPD projection
    (component #20) and CN termination across stacked stiff bodies.
    (True interlocked links are 3D; the 2D section keeps the contact +
    bending character at CPU-testable cost.)"""
    dx = 1.0 / res
    cfg = SimConfig(
        dim=2, dx=dx, grid_res=(res, res), gravity=(0.0, -9.81),
        dtype=str(jnp.dtype(dtype)),
    )
    r_out, r_in = 0.085, 0.055
    # slightly separated vertically (no initial interpenetration:
    # band overlap needs center distance < 2*r_out)
    centers = [(0.5, 0.75), (0.46, 0.55), (0.54, 0.35)]

    states = []
    for i, c in enumerate(centers):
        cj = jnp.asarray(c)

        def phi(p, cj=cj):
            d = jnp.linalg.norm(p - cj[None, :], axis=-1)
            return jnp.maximum(d - r_out, r_in - d)      # annulus

        key = jax.random.PRNGKey(30 + i)
        lo = (c[0] - r_out - 2 * dx, c[1] - r_out - 2 * dx)
        hi = (c[0] + r_out + 2 * dx, c[1] + r_out + 2 * dx)
        x, vol = sample_level_set(key, phi, lo, hi, dx,
                                  particles_per_cell=4, dtype=dtype)
        mu, lam = lame_parameters(E, 0.3)
        states.append(make_particle_state(
            x, particle_volume=vol, density=1200.0, mu=mu, lam=lam,
            dtype=dtype,
        ))
    state = concatenate_states(states)
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.1), n=(0.0, 1.0)),)
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["fixed_corotated"],
                colliders=colliders, plasticity=None)


def _box_phi(x, lo, hi):
    lo = jnp.asarray(lo, x.dtype)
    hi = jnp.asarray(hi, x.dtype)
    q = jnp.maximum(lo[None, :] - x, x - hi[None, :])
    outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


def sand_column_2d(res: int = 64, E: float = 3.5e5, dtype=jnp.float32):
    """Drucker-Prager sand column collapse (reference: the sand scenes of
    PlasticityApplier; StVK-Hencky elasticity + friction-cone return map)."""
    dx = 1.0 / res
    cfg = SimConfig(
        dim=2, dx=dx, grid_res=(res, res), gravity=(0.0, -9.81),
        dtype=str(jnp.dtype(dtype)),
    )
    key = jax.random.PRNGKey(3)
    x, vol = sample_box(key, (0.42, 0.16), (0.58, 0.56), dx,
                        particles_per_cell=4, dtype=dtype)
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(x, particle_volume=vol, density=1600.0,
                                mu=mu, lam=lam, dtype=dtype)
    colliders = (
        HalfSpace(kind=SLIP, friction=0.4, origin=(0.0, 0.15), n=(0.0, 1.0)),
    )
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["stvk_hencky"],
                colliders=colliders, plasticity="drucker_prager")


def snowball_drop_2d(res: int = 64, E: float = 1.4e5, dtype=jnp.float32):
    """Snow ball drop (reference: SnowPlasticity scenes — Stomakhin snow
    with singular-value clamping and Jp tracking)."""
    dx = 1.0 / res
    cfg = SimConfig(
        dim=2, dx=dx, grid_res=(res, res), gravity=(0.0, -9.81),
        dtype=str(jnp.dtype(dtype)),
    )
    key = jax.random.PRNGKey(4)
    x, vol = sample_level_set(
        key,
        lambda p: jnp.linalg.norm(p - jnp.asarray([0.5, 0.6], p.dtype)[None, :], axis=-1) - 0.1,
        (0.38, 0.48), (0.62, 0.72), dx, particles_per_cell=4, dtype=dtype,
    )
    mu, lam = lame_parameters(E, 0.2)
    state = make_particle_state(x, particle_volume=vol, density=400.0,
                                mu=mu, lam=lam, velocity=jnp.asarray([0.0, -2.0]),
                                dtype=dtype)
    colliders = (HalfSpace(kind=STICKY, origin=(0.0, 0.15), n=(0.0, 1.0)),)
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["fixed_corotated"],
                colliders=colliders, plasticity="snow")


def twisting_bar_vonmises_3d(res: int = 64, E: float = 1e6, ppc: int = 8,
                             yield_stress: float = 2e4, dtype=jnp.float32):
    """Elastoplastic twisting bar: StVK-Hencky + von Mises yield — the
    reference's elastoplastic twist variant."""
    out = twisting_bar_3d(res=res, E=E, ppc=ppc, dtype=dtype)
    state = out["state"]
    out["state"] = state.replace(
        yield_stress=jnp.full((state.n,), yield_stress, state.x.dtype)
    )
    out["model"] = MODEL_REGISTRY["stvk_hencky"]
    out["plasticity"] = "von_mises"
    return out


def wheel_3d(res: int = 64, E: float = 1e6, ppc: int = 8,
             yield_stress: float = 1.5e4, omega: float = 8.0 * np.pi,
             dtype=jnp.float32):
    """Spinning elastoplastic wheel dropped on a frictional floor — the
    paper's "wheel" scene family (reference: MultigridInit test cases
    beyond the three acceptance scenes): a cylinder-sampled StVK-Hencky
    disc with von Mises yield, initialized with rigid spin about its axis.
    """
    from hot_mpm.sim.seeding import sample_cylinder

    dx = 1.0 / res
    cfg = SimConfig(
        dim=3,
        dx=dx,
        grid_res=(res, res, res),
        gravity=(0.0, -9.81, 0.0),
        dtype=str(jnp.dtype(dtype)),
    )
    center = np.asarray([0.5, 0.42, 0.5])
    axis = np.asarray([0.0, 0.0, 1.0])
    key = jax.random.PRNGKey(12)
    x, vol = sample_cylinder(key, center, axis, radius=0.16, half_height=0.05,
                             dx=dx, particles_per_cell=ppc, dtype=dtype)
    mu, lam = lame_parameters(E, 0.3)
    state = make_particle_state(
        x, particle_volume=vol, density=1200.0, mu=mu, lam=lam, dtype=dtype
    )
    # rigid initial spin about the wheel axis: v = omega x r
    rel = state.x - jnp.asarray(center, state.x.dtype)[None, :]
    w_vec = jnp.asarray(axis * omega, state.x.dtype)
    v0 = jnp.cross(jnp.broadcast_to(w_vec, rel.shape), rel)
    state = state.replace(
        v=v0.astype(state.v.dtype),
        yield_stress=jnp.full((state.n,), yield_stress, state.x.dtype),
    )
    colliders = (
        HalfSpace(kind=SLIP, friction=0.5, origin=(0.0, 0.2, 0.0),
                  n=(0.0, 1.0, 0.0)),
    )
    return dict(cfg=cfg, state=state, model=MODEL_REGISTRY["stvk_hencky"],
                colliders=colliders, plasticity="von_mises")


SCENES = {
    "block_drop_2d": block_drop_2d,
    "wheel_3d": wheel_3d,
    "twisting_bar_3d": twisting_bar_3d,
    "twisting_bar_vonmises_3d": twisting_bar_vonmises_3d,
    "stacked_boxes_3d": stacked_boxes_3d,
    "boards_3d": boards_3d,
    "chain_2d": chain_2d,
    "faceless_3d": faceless_3d,
    "faceless_mesh_3d": faceless_mesh_3d,
    "sand_column_2d": sand_column_2d,
    "snowball_drop_2d": snowball_drop_2d,
}


def build_scene(name: str, **kwargs):
    if name not in SCENES:
        raise KeyError(f"unknown scene '{name}'; have {sorted(SCENES)}")
    return SCENES[name](**kwargs)
