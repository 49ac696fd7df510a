"""Synthetic RGB-D sequence generator (analytic SDF scene + sphere tracing).

The reference validates end-to-end on TUM RGB-D `.klg` logs (SURVEY.md §5);
this box has no datasets and no network, so golden end-to-end tests run on
synthetic sequences rendered from an analytic scene: exact depth (sphere
tracing the analytic SDF), exact trajectory ground truth, and per-object
instance ids for the instance-fusion tests.

The scene: the interior of a room box containing a sphere, a box and a
cylinder (distinct instance ids 1..3; walls id 0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.geometry.camera import Intrinsics, ray_directions
from instancefusion_tpu.geometry.se3 import se3_exp

# The ground-truth renderer runs its matmuls in full f32 (no TF32).
_PREC = jax.lax.Precision.HIGHEST


class Frame(NamedTuple):
    depth: jnp.ndarray  # f32[H,W] meters, 0 = invalid
    color: jnp.ndarray  # f32[H,W,3] in [0,1]
    instance: jnp.ndarray  # i32[H,W] ground-truth object id (-1 = none)
    T_wc: jnp.ndarray  # f32[4,4] ground-truth camera-to-world pose


def _sd_sphere(p, center, r):
    return jnp.linalg.norm(p - center, axis=-1) - r


def _sd_box(p, center, half):
    q = jnp.abs(p - center) - half
    return jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1) + jnp.minimum(
        jnp.max(q, axis=-1), 0.0
    )


def _sd_cylinder(p, center, r, h):
    d = p - center
    dxy = jnp.linalg.norm(d[..., :2], axis=-1) - r
    dz = jnp.abs(d[..., 2]) - h
    outside = jnp.linalg.norm(
        jnp.maximum(jnp.stack([dxy, dz], -1), 0.0), axis=-1
    )
    inside = jnp.minimum(jnp.maximum(dxy, dz), 0.0)
    return outside + inside


# Object palette for the synthetic color render.
_COLORS = jnp.array(
    [
        [0.7, 0.7, 0.7],  # walls
        [0.9, 0.3, 0.2],  # sphere
        [0.2, 0.7, 0.3],  # box
        [0.2, 0.4, 0.9],  # cylinder
    ]
)


def scene_sdf(p: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Analytic scene SDF. p: (..., 3) world -> (sdf, object_id).

    Room interior: 2.4 x 2.4 x 2.4 m box centered at (0, 0, 1.2) —
    the SDF of the interior is (distance to walls) negated.
    """
    room_half = jnp.array([1.2, 1.2, 1.2])
    room_center = jnp.array([0.0, 0.0, 1.2])
    walls = -_sd_box(p, room_center, room_half)  # positive inside the room
    sphere = _sd_sphere(p, jnp.array([0.45, 0.10, 1.05]), 0.30)
    box = _sd_box(p, jnp.array([-0.50, 0.35, 1.55]), jnp.array([0.25, 0.22, 0.25]))
    cyl = _sd_cylinder(p, jnp.array([-0.15, -0.55, 0.85]), 0.18, 0.35)
    ds = jnp.stack([walls, sphere, box, cyl], axis=-1)
    obj = jnp.argmin(ds, axis=-1).astype(jnp.int32)
    return jnp.min(ds, axis=-1), obj


@functools.partial(jax.jit, static_argnums=(1, 3))
def _render_frame_impl(
    T_wc: jnp.ndarray, intr: Intrinsics, palette: jnp.ndarray,
    texture: bool = False,
) -> Frame:
    """Sphere-trace the analytic SDF to exact depth + flat-shaded color."""
    rays_c = ray_directions(intr)
    ray_norm = jnp.linalg.norm(rays_c, axis=-1)
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    dirs = jnp.matmul(rays_c.reshape(-1, 3), R.T, precision=_PREC).reshape(
        rays_c.shape
    )
    dirs = dirs / ray_norm[..., None]

    def body(_, t):
        p = o + t[..., None] * dirs
        s, _ = scene_sdf(p)
        return t + jnp.clip(s, -0.05, 0.5) * 0.9

    t = jax.lax.fori_loop(0, 96, body, jnp.full(rays_c.shape[:2], 0.05))
    p = o + t[..., None] * dirs
    s, obj = scene_sdf(p)
    hit = (jnp.abs(s) < 5e-3) & (t > 0.05) & (t < 8.0)
    depth = jnp.where(hit, t / ray_norm, 0.0)

    # Normal from analytic gradient for shading.
    eps = 1e-3
    grads = []
    for ax in range(3):
        e = jnp.zeros(3).at[ax].set(eps)
        sp, _ = scene_sdf(p + e)
        sm, _ = scene_sdf(p - e)
        grads.append(sp - sm)
    n = jnp.stack(grads, -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    light = jnp.array([0.4, -0.3, -0.85])
    light = light / jnp.linalg.norm(light)
    shade = 0.55 + 0.45 * jnp.clip(-jnp.sum(n * light, axis=-1), 0.0, 1.0)
    base = jnp.matmul(
        jax.nn.one_hot(obj, palette.shape[0], dtype=jnp.float32), palette,
        precision=_PREC,
    )
    if texture:
        # World-anchored procedural texture (multi-sine): gives flat
        # surfaces photometric gradients so the rgb odometry term has
        # something to lock onto (the flat-shaded render is featureless
        # on walls).
        tex = (
            0.80
            + 0.12 * jnp.sin(17.0 * p[..., 0] + 5.0 * p[..., 2])
            + 0.08 * jnp.sin(23.0 * p[..., 1] - 7.0 * p[..., 0])
        )
        base = base * tex[..., None]
    color = jnp.where(hit[..., None], base * shade[..., None], 0.0)
    instance = jnp.where(hit, obj, -1).astype(jnp.int32)
    return Frame(depth=depth, color=color, instance=instance, T_wc=T_wc)


def render_frame(
    T_wc: jnp.ndarray, intr: Intrinsics, texture: bool = False
) -> Frame:
    return _render_frame_impl(T_wc, intr, _COLORS, texture)


# ---------------------------------------------------------------------------
# Randomized parametric scenes (seg-head generalization rig, SURVEY §8
# Phase 3 exit: train on varied scenes, gate on a held-out seed)
# ---------------------------------------------------------------------------

MAX_SCENE_OBJECTS = 6

# Base color per object KIND (1 sphere, 2 box, 3 cylinder) — matches the
# fixed scene's palette so the legacy scene sits inside the randomized
# distribution; random_scene jitters around these.
_KIND_COLORS = jnp.array(
    [
        [0.0, 0.0, 0.0],  # kind 0 = empty slot, never rendered
        [0.9, 0.3, 0.2],
        [0.2, 0.7, 0.3],
        [0.2, 0.4, 0.9],
    ]
)


class Scene(NamedTuple):
    """A parametric room scene: up to MAX_SCENE_OBJECTS primitives.

    Static shapes (always MAX_SCENE_OBJECTS slots; kind 0 = empty) so a
    single compiled renderer serves every seed.  sizes packs per-kind
    parameters: sphere (r, -, -), box (half extents), cylinder (r, h, -).
    """

    centers: jnp.ndarray  # f32[K, 3]
    sizes: jnp.ndarray  # f32[K, 3]
    kinds: jnp.ndarray  # i32[K] — 1 sphere, 2 box, 3 cylinder, 0 empty
    colors: jnp.ndarray  # f32[K, 3]


def random_scene(seed: int, n_min: int = 3, n_max: int = MAX_SCENE_OBJECTS):
    """Sample a randomized room scene: object count, kind, pose, size and
    color all vary by seed (rejection-placed to avoid heavy overlap)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = MAX_SCENE_OBJECTS
    n = int(rng.integers(n_min, n_max + 1))
    kinds = np.zeros(k, np.int32)
    kinds[:n] = rng.integers(1, 4, n)
    centers = np.zeros((k, 3), np.float32)
    placed: list = []
    for i in range(n):
        c = None
        for _ in range(64):
            c = np.array([
                rng.uniform(-0.7, 0.7),
                rng.uniform(-0.55, 0.7),  # keep clear of the orbit eyes
                rng.uniform(0.7, 1.7),
            ])
            if all(np.linalg.norm(c - q) > 0.55 for q in placed):
                break
        placed.append(c)
        centers[i] = c
    sizes = np.zeros((k, 3), np.float32)
    for i in range(n):
        if kinds[i] == 1:
            sizes[i, 0] = rng.uniform(0.16, 0.32)
        elif kinds[i] == 2:
            sizes[i] = rng.uniform(0.14, 0.27, 3)
        else:
            sizes[i, 0] = rng.uniform(0.12, 0.22)
            sizes[i, 1] = rng.uniform(0.22, 0.38)
    base = np.asarray(_KIND_COLORS)
    colors = np.zeros((k, 3), np.float32)
    for i in range(n):
        colors[i] = np.clip(
            base[kinds[i]] + rng.uniform(-0.18, 0.18, 3), 0.05, 1.0
        )
    return Scene(
        centers=jnp.asarray(centers), sizes=jnp.asarray(sizes),
        kinds=jnp.asarray(kinds), colors=jnp.asarray(colors),
    )


def scene_sdf_with(p: jnp.ndarray, scene: Scene):
    """Parametric-scene SDF. p: (..., 3) world -> (sdf, object_id) where
    id 0 = walls and i+1 = object slot i (mirrors `scene_sdf`)."""
    room_half = jnp.array([1.2, 1.2, 1.2])
    room_center = jnp.array([0.0, 0.0, 1.2])
    walls = -_sd_box(p, room_center, room_half)

    d = p[..., None, :] - scene.centers  # (..., K, 3)
    dist = jnp.linalg.norm(d, axis=-1)
    sph = dist - scene.sizes[:, 0]
    q = jnp.abs(d) - scene.sizes
    box = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1) + jnp.minimum(
        jnp.max(q, axis=-1), 0.0
    )
    dxy = jnp.linalg.norm(d[..., :2], axis=-1) - scene.sizes[:, 0]
    dz = jnp.abs(d[..., 2]) - scene.sizes[:, 1]
    cyl = jnp.linalg.norm(
        jnp.maximum(jnp.stack([dxy, dz], -1), 0.0), axis=-1
    ) + jnp.minimum(jnp.maximum(dxy, dz), 0.0)

    ds = jnp.where(
        scene.kinds == 1, sph, jnp.where(scene.kinds == 2, box, cyl)
    )
    ds = jnp.where(scene.kinds > 0, ds, 1e9)  # empty slots never win
    all_ds = jnp.concatenate([walls[..., None], ds], axis=-1)
    obj = jnp.argmin(all_ds, axis=-1).astype(jnp.int32)
    return jnp.min(all_ds, axis=-1), obj


@functools.partial(jax.jit, static_argnums=(1, 3))
def _render_scene_impl(
    T_wc: jnp.ndarray, intr: Intrinsics, scene: Scene, texture: bool = False
) -> Frame:
    """Sphere-trace a parametric Scene (random_scene) — same conventions
    as `_render_frame_impl`; all scene parameters are traced arguments so
    one compilation serves every seed."""
    rays_c = ray_directions(intr)
    ray_norm = jnp.linalg.norm(rays_c, axis=-1)
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    dirs = jnp.matmul(rays_c.reshape(-1, 3), R.T, precision=_PREC).reshape(
        rays_c.shape
    )
    dirs = dirs / ray_norm[..., None]

    def body(_, t):
        p = o + t[..., None] * dirs
        s, _ = scene_sdf_with(p, scene)
        return t + jnp.clip(s, -0.05, 0.5) * 0.9

    t = jax.lax.fori_loop(0, 96, body, jnp.full(rays_c.shape[:2], 0.05))
    p = o + t[..., None] * dirs
    s, obj = scene_sdf_with(p, scene)
    hit = (jnp.abs(s) < 5e-3) & (t > 0.05) & (t < 8.0)
    depth = jnp.where(hit, t / ray_norm, 0.0)

    eps = 1e-3
    grads = []
    for ax in range(3):
        e = jnp.zeros(3).at[ax].set(eps)
        sp, _ = scene_sdf_with(p + e, scene)
        sm, _ = scene_sdf_with(p - e, scene)
        grads.append(sp - sm)
    n = jnp.stack(grads, -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    light = jnp.array([0.4, -0.3, -0.85])
    light = light / jnp.linalg.norm(light)
    shade = 0.55 + 0.45 * jnp.clip(-jnp.sum(n * light, axis=-1), 0.0, 1.0)
    palette = jnp.concatenate(
        [jnp.array([[0.7, 0.7, 0.7]]), scene.colors], axis=0
    )
    base = jnp.matmul(
        jax.nn.one_hot(obj, palette.shape[0], dtype=jnp.float32), palette,
        precision=_PREC,
    )
    if texture:
        tex = (
            0.80
            + 0.12 * jnp.sin(17.0 * p[..., 0] + 5.0 * p[..., 2])
            + 0.08 * jnp.sin(23.0 * p[..., 1] - 7.0 * p[..., 0])
        )
        base = base * tex[..., None]
    color = jnp.where(hit[..., None], base * shade[..., None], 0.0)
    instance = jnp.where(hit, obj, -1).astype(jnp.int32)
    return Frame(depth=depth, color=color, instance=instance, T_wc=T_wc)


def render_frame_scene(
    T_wc: jnp.ndarray, intr: Intrinsics, scene: Scene, texture: bool = False
) -> Frame:
    return _render_scene_impl(T_wc, intr, scene, texture)


def orbit_trajectory(
    num_frames: int,
    radius: float = 0.45,
    center: jnp.ndarray | None = None,
    sweep: float = 1.2,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Smooth camera trajectory inside the room, looking at the scene.

    Returns (num_frames, 4, 4) camera-to-world poses. The camera starts
    near the -y wall looking at the room center and arcs sideways —
    adjacent poses differ by a few mm / fractions of a degree, mimicking a
    handheld 30 Hz sweep.
    """
    look_at = jnp.array([0.0, 0.0, 1.2]) if center is None else center
    ts = jnp.linspace(0.0, 1.0, num_frames)
    ang = (ts - 0.5) * sweep
    # Camera positions on an arc.
    cx = radius * jnp.sin(ang)
    cy = -0.95 + 0.06 * jnp.sin(ts * 5.0)
    cz = 1.1 + 0.08 * jnp.cos(ts * 3.0)
    eyes = jnp.stack([cx, cy, cz], axis=-1).astype(dtype)

    def pose(eye):
        fwd = look_at - eye
        fwd = fwd / jnp.linalg.norm(fwd)
        up_hint = jnp.array([0.0, 0.0, -1.0], dtype)
        right = jnp.cross(fwd, up_hint)
        right = right / jnp.maximum(jnp.linalg.norm(right), 1e-9)
        down = jnp.cross(fwd, right)  # camera +y points "down" in world
        R = jnp.stack([right, down, fwd], axis=-1)  # columns = cam axes
        T = jnp.eye(4, dtype=dtype)
        T = T.at[:3, :3].set(R).at[:3, 3].set(eye)
        return T

    return jax.vmap(pose)(eyes)


def make_sequence(num_frames: int, intr: Intrinsics):
    """Generator of Frames along the orbit trajectory."""
    poses = orbit_trajectory(num_frames)
    for i in range(num_frames):
        yield render_frame(poses[i], intr)


# ---------------------------------------------------------------------------
# Sensor noise + aggressive motion (the fr1-class stress rig)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def add_sensor_noise(
    frame: Frame,
    key: jnp.ndarray,
    sigma_base: float = 0.0012,
    sigma_z2: float = 0.0019,
    edge_dropout: float = 0.6,
    speckle_dropout: float = 0.002,
) -> Frame:
    """Kinect-class depth corruption for the analytic renders.

    The golden ATE evidence was noise-free (r3 VERDICT Weak #1); this
    applies the standard structured-light error model so accuracy gates
    run on data that actually stresses ICP basins and TSDF fusion:

    - axial Gaussian noise with variance growing as z^2 (Khoshelham &
      Elberink's sigma_z ~ 0.0012 + 0.0019 (z - 0.4)^2 m Kinect fit);
    - quantization to the TUM 16-bit depth scale (1/5000 m steps);
    - edge speckle: pixels whose 3x3 depth neighborhood jumps more than
      4 cm (occlusion boundaries) drop out with prob `edge_dropout` —
      structured light cannot match across disparity discontinuities;
    - uniform salt dropout with prob `speckle_dropout`.
    """
    d = frame.depth
    k1, k2, k3 = jax.random.split(key, 3)
    valid = d > 0.0
    z = jnp.maximum(d - 0.4, 0.0)
    sigma = sigma_base + sigma_z2 * z * z
    noisy = d + sigma * jax.random.normal(k1, d.shape, d.dtype)
    # TUM depth factor 5000: quantize to 0.2 mm steps.
    noisy = jnp.round(noisy * 5000.0) / 5000.0

    # Occlusion-edge mask from the max 3x3 neighborhood jump.
    pad = jnp.pad(d, 1, mode="edge")
    jump = jnp.zeros_like(d)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = pad[1 + dy : 1 + dy + d.shape[0], 1 + dx : 1 + dx + d.shape[1]]
            jump = jnp.maximum(jump, jnp.abs(nb - d))
    edge = jump > 0.04
    drop_e = edge & (jax.random.uniform(k2, d.shape) < edge_dropout)
    drop_s = jax.random.uniform(k3, d.shape) < speckle_dropout
    keep = valid & jnp.logical_not(drop_e) & jnp.logical_not(drop_s)
    return frame._replace(depth=jnp.where(keep, jnp.maximum(noisy, 0.0), 0.0))


def handheld_trajectory(
    num_frames: int,
    radius: float = 0.45,
    sweep: float = 1.6,
    shake_rot: float = 0.02,
    shake_trans: float = 0.012,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """fr1-class aggressive handheld motion: fast arc + rotational shake.

    The gentle `orbit_trajectory` moves millimeters per frame; fr1_desk's
    handheld camera turns over a degree per frame with jerky translation.
    This sweeps the same arc faster (sweep/num_frames rad per frame) and
    superimposes smooth high-frequency SE(3) shake (multi-sine, so it is
    deterministic and velocity stays continuous): peak ~shake_rot rad and
    ~shake_trans m frame-to-frame deltas.
    """
    base = orbit_trajectory(num_frames, radius=radius, sweep=sweep, dtype=dtype)
    ts = jnp.linspace(0.0, 1.0, num_frames).astype(dtype)

    def shake(i):
        t = ts[i]
        xi = jnp.stack([
            shake_trans * jnp.sin(t * 37.0),
            shake_trans * jnp.sin(t * 29.0 + 1.3),
            shake_trans * 0.6 * jnp.sin(t * 43.0 + 0.4),
            shake_rot * jnp.sin(t * 31.0 + 2.1),
            shake_rot * jnp.sin(t * 41.0 + 0.9),
            shake_rot * 0.5 * jnp.sin(t * 23.0 + 1.7),
        ]).astype(dtype)
        return jnp.matmul(base[i], se3_exp(xi), precision=_PREC)

    return jax.vmap(shake)(jnp.arange(num_frames))


def make_noisy_sequence(
    num_frames: int,
    intr: Intrinsics,
    seed: int = 0,
    aggressive: bool = True,
    **noise_kw,
):
    """Generator of noise-corrupted Frames along the handheld trajectory.

    Frames carry the EXACT ground-truth poses (for ATE) but corrupted
    depth; colors are left clean (the reference's RGB noise is negligible
    next to its depth noise).
    """
    poses = (
        handheld_trajectory(num_frames) if aggressive
        else orbit_trajectory(num_frames)
    )
    keys = jax.random.split(jax.random.PRNGKey(seed), num_frames)
    for i in range(num_frames):
        yield add_sensor_noise(render_frame(poses[i], intr), keys[i], **noise_kw)
