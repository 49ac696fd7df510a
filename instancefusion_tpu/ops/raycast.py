"""TSDF raycasting: predicted vertex/normal/depth/color maps.

jnp reference implementation.  Replaces the reference's GLSL splatting
pipeline (`IndexMap::combinedPredict`, `Core/src/Shaders/splat.*` —
expected layout, SURVEY.md §4.4): instead of rendering surfels, we march
camera rays through the TSDF and extract the zero crossing
(KinectFusion-style), which supplies the frame-to-model ICP target maps
and the data-association maps for instance fusion.

This is the dense-volume march; `ops/blocks.raycast` is the block-map
version the per-frame engine runs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.config import RaycastConfig, TsdfConfig
from instancefusion_tpu.geometry.camera import Intrinsics, ray_directions
from instancefusion_tpu.ops.tsdf import (
    TsdfVolume,
    sample_color_trilinear,
    sample_trilinear,
    sdf_gradient,
)


class RaycastMaps(NamedTuple):
    vertex_w: jnp.ndarray  # f32[H,W,3] world-frame surface points
    normal_w: jnp.ndarray  # f32[H,W,3] world-frame surface normals
    depth: jnp.ndarray  # f32[H,W] z-depth in the camera frame (0 = miss)
    color: jnp.ndarray  # f32[H,W,3]
    valid: jnp.ndarray  # bool[H,W]


def raycast(
    volume: TsdfVolume,
    T_wc: jnp.ndarray,
    intr: Intrinsics,
    tsdf_cfg: TsdfConfig,
    cfg: RaycastConfig,
    with_color: bool = True,
) -> RaycastMaps:
    """March all pixels' rays; find the first +/- zero crossing.

    Fixed step count (static shapes): coarse steps of `step_scale * trunc`
    along the ray, then a secant refinement of the crossing.  The whole
    march is a `lax.fori_loop` carrying per-pixel state, so it stays
    on-device under jit.
    """
    rays_c = ray_directions(intr)  # unit-z
    ray_norm = jnp.linalg.norm(rays_c, axis=-1)  # |dir| per pixel
    R = T_wc[:3, :3]
    origin_w = T_wc[:3, 3]
    dirs_w = jnp.matmul(
        rays_c.reshape(-1, 3), R.T, precision=jax.lax.Precision.HIGHEST
    ).reshape(rays_c.shape)
    dirs_w = dirs_w / jnp.maximum(ray_norm[..., None], 1e-12)  # unit length

    step = cfg.step_scale * tsdf_cfg.trunc
    num_steps = math.ceil((cfg.far - cfg.near) / step) + 1

    h, w = intr.height, intr.width
    shape = (h, w)

    def sample_at(t):
        p = origin_w + t[..., None] * dirs_w
        return sample_trilinear(volume, p, tsdf_cfg)

    def body(i, carry):
        prev_sdf, prev_valid, t_hit_lo, t_hit_hi, sdf_lo, sdf_hi, found = carry
        t = cfg.near + i * step
        s, v = sample_at(jnp.full(shape, t))
        crossing = (
            prev_valid & v & (prev_sdf > 0.0) & (s <= 0.0) & jnp.logical_not(found)
        )
        t_hit_lo = jnp.where(crossing, t - step, t_hit_lo)
        t_hit_hi = jnp.where(crossing, t, t_hit_hi)
        sdf_lo = jnp.where(crossing, prev_sdf, sdf_lo)
        sdf_hi = jnp.where(crossing, s, sdf_hi)
        found = found | crossing
        return s, v, t_hit_lo, t_hit_hi, sdf_lo, sdf_hi, found

    init = (
        jnp.zeros(shape),
        jnp.zeros(shape, bool),
        jnp.zeros(shape),
        jnp.zeros(shape),
        jnp.zeros(shape),
        jnp.zeros(shape),
        jnp.zeros(shape, bool),
    )
    _, _, t_lo, t_hi, s_lo, s_hi, found = jax.lax.fori_loop(
        0, num_steps, body, init
    )

    # Secant estimate of the crossing, then a few secant refinements with
    # fresh trilinear samples for sub-voxel accuracy.
    denom = jnp.maximum(s_lo - s_hi, 1e-12)
    t_star = t_lo + (t_hi - t_lo) * s_lo / denom

    def refine(_, t_cur):
        s, v = sample_at(t_cur)
        # Move along the ray by the (unnormalized-sdf) distance; stored sdf
        # is normalized by trunc.
        t_next = t_cur + jnp.where(v, s * tsdf_cfg.trunc, 0.0)
        return jnp.clip(t_next, t_lo, t_hi)

    t_star = jax.lax.fori_loop(0, cfg.refine_steps, refine, t_star)

    p_hit = origin_w + t_star[..., None] * dirs_w
    normal_w, nvalid = sdf_gradient(volume, p_hit, tsdf_cfg)
    valid = found & nvalid
    # z-depth: distance along ray * (unit-z dir z-component / |dir|) —
    # dirs were normalized, camera z of the hit = t * (R^T(p-o))_z; compute
    # directly from the camera-frame ray geometry: z = t / |dir_unit_z|.
    depth = jnp.where(valid, t_star / ray_norm, 0.0)
    if with_color and volume.color.size:
        color = sample_color_trilinear(volume, p_hit, tsdf_cfg)
    else:
        color = jnp.zeros((h, w, 3), jnp.float32)
    zero3 = jnp.zeros_like(p_hit)
    return RaycastMaps(
        vertex_w=jnp.where(valid[..., None], p_hit, zero3),
        normal_w=jnp.where(valid[..., None], normal_w, zero3),
        depth=depth,
        color=jnp.where(valid[..., None], color, 0.0),
        valid=valid,
    )
