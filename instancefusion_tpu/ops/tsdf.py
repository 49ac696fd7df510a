"""Dense TSDF volume: allocation, projective integration, trilinear sampling.

jnp reference implementation of the volumetric map.  The reference system
keeps a *surfel* map fused via GLSL transform feedback
(`Core/src/GlobalModel.cpp` + `Shaders/` — expected layout, SURVEY.md §3);
the BASELINE.json contract replaces it with a KinectFusion-style TSDF
volume.  This module is the dense (config-1, 128^3) variant and the
golden reference for the block-sparse version (ops/blocks.py).

Layout: `sdf`, `weight` are `f32[N, N, N]` indexed `[ix, iy, iz]`; voxel
center world position is `origin + (idx + 0.5) * voxel_size`.  `color` is
`f32[N, N, N, 3]` in [0, 1].  SDF values are stored *normalized* to the
truncation band: stored = clamp(signed_dist / trunc, -1, 1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from instancefusion_tpu.config import TsdfConfig
from instancefusion_tpu.geometry.camera import Intrinsics, project
from instancefusion_tpu.geometry.se3 import se3_inverse, transform_points


class TsdfVolume(NamedTuple):
    sdf: jnp.ndarray  # f32[N,N,N], normalized to [-1, 1]
    weight: jnp.ndarray  # f32[N,N,N]
    color: jnp.ndarray  # f32[N,N,N,3]


def allocate(cfg: TsdfConfig, with_color: bool = True) -> TsdfVolume:
    n = cfg.grid_size
    return TsdfVolume(
        sdf=jnp.ones((n, n, n), jnp.float32),
        weight=jnp.zeros((n, n, n), jnp.float32),
        color=jnp.zeros((n, n, n, 3), jnp.float32)
        if with_color
        else jnp.zeros((0, 0, 0, 3), jnp.float32),
    )


def voxel_world_coords(cfg: TsdfConfig, dtype=jnp.float32) -> jnp.ndarray:
    """World position of every voxel center: f32[N,N,N,3]."""
    n = cfg.grid_size
    ii = jax.lax.broadcasted_iota(dtype, (n, n, n), 0)
    jj = jax.lax.broadcasted_iota(dtype, (n, n, n), 1)
    kk = jax.lax.broadcasted_iota(dtype, (n, n, n), 2)
    origin = jnp.asarray(cfg.origin, dtype)
    return origin + (jnp.stack([ii, jj, kk], axis=-1) + 0.5) * cfg.voxel_size


def integrate(
    volume: TsdfVolume,
    depth: jnp.ndarray,
    color: jnp.ndarray | None,
    T_wc: jnp.ndarray,
    intr: Intrinsics,
    cfg: TsdfConfig,
) -> TsdfVolume:
    """Fuse one depth (+color) frame into the volume.

    Voxel-projective integration (each voxel projects into the frame and
    samples depth at the nearest pixel), with the standard weighted running
    average — the TSDF analog of the reference's surfel data-fusion pass.
    """
    p_w = voxel_world_coords(cfg)  # [N,N,N,3]
    T_cw = se3_inverse(T_wc)
    p_c = transform_points(T_cw, p_w.reshape(-1, 3)).reshape(p_w.shape)
    u, v, z = project(intr, p_c)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    in_img = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    uic = jnp.clip(ui, 0, intr.width - 1)
    vic = jnp.clip(vi, 0, intr.height - 1)
    d = depth[vic, uic]
    sdf_obs = d - z  # positive in front of the surface
    valid = in_img & (z > 0.0) & (d > 0.0) & (sdf_obs > -cfg.trunc)
    psi = jnp.clip(sdf_obs / cfg.trunc, -1.0, 1.0)
    w_obs = jnp.where(valid, 1.0, 0.0)
    w_new = volume.weight + w_obs
    denom = jnp.maximum(w_new, 1e-6)
    sdf_new = (volume.sdf * volume.weight + psi * w_obs) / denom
    new_color = volume.color
    if color is not None and volume.color.size:
        c = color[vic, uic]
        new_color = (
            volume.color * volume.weight[..., None] + c * w_obs[..., None]
        ) / denom[..., None]
    w_new = jnp.minimum(w_new, cfg.max_weight)
    return TsdfVolume(sdf=sdf_new, weight=w_new, color=new_color)


def _flat_gather(arr: jnp.ndarray, i: jnp.ndarray, j: jnp.ndarray, k: jnp.ndarray):
    n = arr.shape[0]
    flat = arr.reshape(-1, *arr.shape[3:])
    idx = (i * n + j) * n + k
    return flat[idx]


def sample_trilinear(
    volume: TsdfVolume, p_w: jnp.ndarray, cfg: TsdfConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Trilinear SDF sample at world points p_w (..., 3).

    Returns (sdf, valid); valid requires all 8 corner voxels observed
    (weight > 0) and in bounds.
    """
    n = cfg.grid_size
    g = (p_w - jnp.asarray(cfg.origin, p_w.dtype)) / cfg.voxel_size - 0.5
    g0 = jnp.floor(g)
    frac = g - g0
    g0i = g0.astype(jnp.int32)
    inb = jnp.all((g0i >= 0) & (g0i < n - 1), axis=-1)
    g0c = jnp.clip(g0i, 0, n - 2)
    val = jnp.zeros(p_w.shape[:-1], p_w.dtype)
    wmin = jnp.full(p_w.shape[:-1], jnp.inf, p_w.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                i = g0c[..., 0] + di
                j = g0c[..., 1] + dj
                k = g0c[..., 2] + dk
                s = _flat_gather(volume.sdf, i, j, k)
                w = _flat_gather(volume.weight, i, j, k)
                tw = (
                    (frac[..., 0] if di else 1.0 - frac[..., 0])
                    * (frac[..., 1] if dj else 1.0 - frac[..., 1])
                    * (frac[..., 2] if dk else 1.0 - frac[..., 2])
                )
                val = val + tw * s
                wmin = jnp.minimum(wmin, w)
    valid = inb & (wmin > 0.0)
    return val, valid


def sample_color_trilinear(
    volume: TsdfVolume, p_w: jnp.ndarray, cfg: TsdfConfig
) -> jnp.ndarray:
    """Trilinear color sample at world points p_w (..., 3) -> (..., 3)."""
    n = cfg.grid_size
    g = (p_w - jnp.asarray(cfg.origin, p_w.dtype)) / cfg.voxel_size - 0.5
    g0 = jnp.floor(g)
    frac = g - g0
    g0c = jnp.clip(g0.astype(jnp.int32), 0, n - 2)
    val = jnp.zeros(p_w.shape[:-1] + (3,), p_w.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                c = _flat_gather(
                    volume.color, g0c[..., 0] + di, g0c[..., 1] + dj, g0c[..., 2] + dk
                )
                tw = (
                    (frac[..., 0] if di else 1.0 - frac[..., 0])
                    * (frac[..., 1] if dj else 1.0 - frac[..., 1])
                    * (frac[..., 2] if dk else 1.0 - frac[..., 2])
                )
                val = val + tw[..., None] * c
    return val


def sdf_gradient(
    volume: TsdfVolume, p_w: jnp.ndarray, cfg: TsdfConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Central-difference SDF gradient at world points (surface normals)."""
    h = cfg.voxel_size
    grads = []
    valid = None
    for axis in range(3):
        e = jnp.zeros(3, p_w.dtype).at[axis].set(h)
        sp, vp = sample_trilinear(volume, p_w + e, cfg)
        sm, vm = sample_trilinear(volume, p_w - e, cfg)
        grads.append(sp - sm)
        v = vp & vm
        valid = v if valid is None else (valid & v)
    g = jnp.stack(grads, axis=-1)
    norm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    n = g / jnp.maximum(norm, 1e-12)
    return n, valid & (norm[..., 0] > 1e-12)
