"""Splat prediction: the listed blocks' voxels rasterized into the image.

An alternative to the marched raycast (`ops/blocks.raycast`) for the
per-frame tracking prediction, selected by `RaycastConfig.use_splat`.  It
inverts the loop the way the reference renders its model by splatting
surfels (`IndexMap::combinedPredict`, SURVEY.md §4.4):

- For the projective TSDF, ``depth(pixel) ~= z_voxel + sdf * trunc`` for
  every near-surface voxel projecting to that pixel, so each voxel casts
  a *vote* for the surface depth, weighted by ``relu(1-|sdf|)^2`` (the
  out-of-band/unobserved sentinel sdf=2 self-masks to weight 0).
- A vote lands on the image through a separable tent footprint of radius
  ``r`` (from the block-center depth, clipped to ``rmax``), applied as a
  loop of (2*rmax+1)^2 scatter-add passes (all channels per pass).
- Occlusion (two surfaces voting on one ray) resolves by softmin
  compositing: votes carry ``exp(-lam * depth)`` so nearer surfaces
  dominate; num/den ratios cancel the scale exactly.

The scatter-add count grows as (2*rmax+1)^2, so this plain version is far
slower than the march at rmax 8; it stays for the sharded engine's
compositing path (`raw=True` accumulators sum exactly across disjoint
block sets) and the local-loop inactive view.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.config import TsdfConfig
from instancefusion_tpu.geometry.camera import Intrinsics
from instancefusion_tpu.geometry.se3 import se3_inverse

_PREC = jax.lax.Precision.HIGHEST
# Softmin sharpness (1/m) and reference depth (m) for the compositing
# exponent; exp(lam * (zref - d)) stays inside f32 exponent range for
# d in [0.1, 6] m.
_LAM = 20.0
_ZREF = 2.0
# Vote-mass threshold for a pixel to be a valid surface hit.
_DEN_TAU = 0.05


class SplatImages(NamedTuple):
    depth: jnp.ndarray  # f32[H, W] composited z-depth (0 where invalid)
    valid: jnp.ndarray  # bool[H, W]
    color: jnp.ndarray  # f32[H, W, 3]


def finish_splat_images(
    outs,  # 6 accumulator planes [>=H, >=W] (num, dens, denr, r, g, b)
    intr: Intrinsics,
    tsdf_cfg: TsdfConfig,
    with_color: bool = True,
    depth_prior: jnp.ndarray | None = None,
) -> SplatImages:
    """Normalize summed splat accumulators into composited images.

    `depth_prior` (f32[H,W], the just-fused depth / previous prediction)
    band-limits validity like the marched fast path: votes that land more
    than ~1.5 trunc from the prior are silhouette bleed (a foreground
    block's tent footprint dilating over background pixels).
    """
    h, w = intr.height, intr.width
    num, dens, denr, outr, outg, outb = (o[:h, :w] for o in outs)

    valid = (denr > _DEN_TAU) & (dens > 1e-30)
    dsafe = jnp.maximum(dens, 1e-30)
    depth = jnp.where(valid, num / dsafe, 0.0)
    valid = valid & (depth > 0.05)
    if depth_prior is not None:
        band = 1.5 * tsdf_cfg.trunc
        valid = valid & (depth_prior > 0.0) & (
            jnp.abs(depth - depth_prior) <= band
        )
    depth = jnp.where(valid, depth, 0.0)
    if with_color:
        col = jnp.stack([outr / dsafe, outg / dsafe, outb / dsafe], axis=-1)
        col = jnp.where(valid[..., None], col, 0.0)
    else:
        col = jnp.zeros((h, w, 3), jnp.float32)
    return SplatImages(depth=depth, valid=valid, color=col)


def _vote_terms(
    coords, sdf, weight, color, slot_valid, T_cw, intr, tsdf_cfg, with_color
):
    """Per-voxel vote quantities: (u, v, w, sm, d_abs, colors), f32[K, B^3]."""
    b = tsdf_cfg.block_size
    idx = jnp.arange(b * b * b, dtype=jnp.int32)
    local = jnp.stack([idx // (b * b), (idx // b) % b, idx % b], -1)  # (B^3,3)
    origin = jnp.asarray(tsdf_cfg.origin, jnp.float32)
    p_w = (
        origin
        + (coords[:, None, :].astype(jnp.float32) * b
           + local[None].astype(jnp.float32) + 0.5)
        * tsdf_cfg.voxel_size
    )  # (K,B^3,3)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    p_c = jnp.matmul(p_w, R.T, precision=_PREC) + t
    z = p_c[..., 2]
    vis = z > 0.05
    zs = jnp.where(vis, z, 1.0)
    u = intr.fx * p_c[..., 0] / zs + intr.cx
    v = intr.fy * p_c[..., 1] / zs + intr.cy
    s = sdf
    w = jnp.maximum(1.0 - jnp.abs(s), 0.0)
    conf = jnp.minimum(weight * 0.25, 1.0)
    w = w * w * conf * vis * slot_valid[:, None]
    d_abs = jnp.clip(z + s * tsdf_cfg.trunc, 0.05, 8.0)
    sm = jnp.exp(_LAM * (_ZREF - d_abs))
    # Packed color rows: [r | g | b] channel segments of b^3 lanes each.
    b3 = b * b * b
    cols = (
        [color[:, c * b3 : (c + 1) * b3] for c in range(3)]
        if with_color
        else [jnp.zeros_like(s)] * 3
    )
    return u, v, w, sm, d_abs, cols


def splat_depth(
    slots: jnp.ndarray,  # i32[K] payload rows to render
    slot_valid: jnp.ndarray,  # bool[K]
    block_coords: jnp.ndarray,  # i32[C, 3] slot -> block coord
    sdf: jnp.ndarray,  # f32[C, B^3]
    weight: jnp.ndarray,  # f32[C, B^3] fusion weights
    color: jnp.ndarray,  # f32[C, 3*B^3] packed (ignored if not with_color)
    T_wc: jnp.ndarray,
    intr: Intrinsics,
    tsdf_cfg: TsdfConfig,
    with_color: bool = True,
    depth_prior: jnp.ndarray | None = None,
    rmax: int = 8,
    raw: bool = False,
) -> SplatImages:
    """Rasterize the listed blocks into composited depth/color images.

    `raw=True` returns the six accumulator planes (num, dens, denr, r, g,
    b) instead of finished images: the sharded engine sums the disjoint
    shards' planes and normalizes once (`finish_splat_images`).  Blocks
    straddling the camera plane are dropped whole (their footprint is
    meaningless).
    """
    h, w_img = intr.height, intr.width
    if color.size == 0 or not with_color:
        with_color = False
        color = jnp.zeros((sdf.shape[0], 3 * sdf.shape[1]), jnp.float32)
    rows = jnp.where(slot_valid, slots, 0)
    coords = block_coords[rows]
    T_cw = se3_inverse(T_wc)
    b = tsdf_cfg.block_size
    bsz = b * tsdf_cfg.voxel_size
    origin = jnp.asarray(tsdf_cfg.origin, jnp.float32)
    corner = jnp.stack(
        [jnp.array([i // 4, (i // 2) % 2, i % 2], jnp.float32) for i in range(8)]
    )
    pw = origin + (coords[:, None, :].astype(jnp.float32) + corner[None]) * bsz
    zmin = jnp.min(jnp.matmul(pw, T_cw[2, :3], precision=_PREC) + T_cw[2, 3], axis=1)
    slot_valid = slot_valid & (zmin > 1e-3)
    u, v, w, sm, d_abs, cols = _vote_terms(
        coords, sdf[rows], weight[rows], color[rows], slot_valid,
        T_cw, intr, tsdf_cfg, with_color,
    )
    # Per-block tent radius from the block-center depth.
    centers = origin + (coords.astype(jnp.float32) + 0.5) * bsz
    pc = jnp.matmul(centers, T_cw[:3, :3].T, precision=_PREC) + T_cw[:3, 3]
    r_t = jnp.clip(
        0.7 * intr.fx * tsdf_cfg.voxel_size / jnp.maximum(pc[:, 2], 0.3),
        1.0,
        float(rmax),
    )[:, None]
    inv_r = 1.0 / r_t

    wsm = w * sm
    chans = [wsm * d_abs, wsm, w] + ([wsm * c for c in cols] if with_color else [])
    chans = jnp.stack(chans, axis=-1)  # (K, B^3, C)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    n = 2 * rmax + 1

    def tap(i, acc):
        """Scatter-add every vote into pixel offset (dy, dx) of its tent."""
        dy = i // n - rmax
        dx = i % n - rmax
        tv = jnp.maximum(1.0 - jnp.abs(v - (vi + dy).astype(jnp.float32)) * inv_r, 0.0)
        tu = jnp.maximum(1.0 - jnp.abs(u - (ui + dx).astype(jnp.float32)) * inv_r, 0.0)
        t2 = tv * tu
        py = vi + dy
        px = ui + dx
        ok = (py >= 0) & (py < h) & (px >= 0) & (px < w_img) & (t2 > 0.0)
        flat = jnp.where(ok, py * w_img + px, h * w_img)  # OOB -> dropped
        vals = chans * jnp.where(ok, t2, 0.0)[..., None]
        return acc.at[flat.reshape(-1)].add(
            vals.reshape(-1, vals.shape[-1]), mode="drop"
        )

    acc = jax.lax.fori_loop(
        0, n * n, tap, jnp.zeros((h * w_img, chans.shape[-1]), jnp.float32)
    )
    acc = [acc[:, c].reshape(h, w_img) for c in range(acc.shape[1])]
    if not with_color:
        acc += [jnp.zeros((h, w_img), jnp.float32)] * 3
    if raw:
        return tuple(acc)
    return finish_splat_images(
        acc, intr, tsdf_cfg, with_color=with_color, depth_prior=depth_prior
    )
