"""Frame preprocessing: bilateral filter, vertex/normal maps, pyramids.

Plain jnp version of the reference's CUDA preprocessing kernels
(`computeBilateralFilter`, `createVMap`, `createNMap`, `pyrDown*` in the
expected `Core/src/Cuda/cudafuncs.cu` — SURVEY.md §3 "Frame preprocessing").
The 5x5 stencil is bandwidth-bound; XLA fuses it on every backend.

Invalid depth is encoded as 0 (TUM convention); all ops propagate validity.
"""

from __future__ import annotations

import jax.numpy as jnp

from instancefusion_tpu.config import PreprocessConfig
from instancefusion_tpu.geometry.camera import Intrinsics, backproject


def clamp_depth(depth: jnp.ndarray, cfg: PreprocessConfig) -> jnp.ndarray:
    """Zero out depth outside [depth_min, depth_max] (0 = invalid)."""
    valid = (depth >= cfg.depth_min) & (depth <= cfg.depth_max)
    return jnp.where(valid, depth, 0.0)


def bilateral_filter(depth: jnp.ndarray, cfg: PreprocessConfig) -> jnp.ndarray:
    """Edge-preserving depth smoothing over a (2r+1)^2 window.

    Weights: spatial Gaussian x depth-difference Gaussian; pixels with
    invalid (0) depth contribute nothing; an invalid center stays invalid.
    """
    r = cfg.bilateral_radius
    inv2ss = 0.5 / (cfg.bilateral_sigma_space**2)
    inv2sd = 0.5 / (cfg.bilateral_sigma_depth**2)
    center = depth
    valid_c = center > 0.0

    acc = jnp.zeros_like(depth)
    wacc = jnp.zeros_like(depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = jnp.roll(depth, shift=(dy, dx), axis=(0, 1))
            # jnp.roll wraps; invalidate wrapped rows/cols via border mask.
            h, w = depth.shape
            vv = jnp.arange(h)[:, None]
            uu = jnp.arange(w)[None, :]
            inb = (
                (vv - dy >= 0) & (vv - dy < h) & (uu - dx >= 0) & (uu - dx < w)
            )
            valid = (shifted > 0.0) & inb & valid_c
            wgt = jnp.exp(
                -(dy * dy + dx * dx) * inv2ss
                - (shifted - center) ** 2 * inv2sd
            )
            wgt = jnp.where(valid, wgt, 0.0)
            acc = acc + wgt * shifted
            wacc = wacc + wgt
    out = jnp.where(wacc > 1e-8, acc / jnp.maximum(wacc, 1e-8), 0.0)
    return jnp.where(valid_c, out, 0.0)


def pyr_down_depth(depth: jnp.ndarray) -> jnp.ndarray:
    """Halve resolution, averaging only valid pixels in each 2x2 block."""
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (d > 0.0).astype(depth.dtype)
    num = jnp.sum(d * valid, axis=(1, 3))
    den = jnp.sum(valid, axis=(1, 3))
    return jnp.where(den > 0, num / jnp.maximum(den, 1.0), 0.0)


def pyr_down_intensity(img: jnp.ndarray) -> jnp.ndarray:
    """Plain 2x2 mean for intensity images."""
    h, w = img.shape
    d = img[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    return jnp.mean(d, axis=(1, 3))


def compute_normals(vmap: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Normal map from central differences of the vertex map.

    Returns (nmap, valid). Normals point toward the camera (-z half-space),
    matching the reference's `createNMap` convention so point-to-plane
    residual signs are consistent.
    """
    valid_v = vmap[..., 2] > 0.0
    dx = jnp.roll(vmap, -1, axis=1) - jnp.roll(vmap, 1, axis=1)
    dy = jnp.roll(vmap, -1, axis=0) - jnp.roll(vmap, 1, axis=0)
    vx = jnp.roll(valid_v, -1, axis=1) & jnp.roll(valid_v, 1, axis=1)
    vy = jnp.roll(valid_v, -1, axis=0) & jnp.roll(valid_v, 1, axis=0)
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    # Orient toward camera: camera looks along +z, so normals face -z.
    n = jnp.where(n[..., 2:3] > 0.0, -n, n)
    valid = valid_v & vx & vy & (norm[..., 0] > 1e-12)
    # Border pixels use wrapped neighbors — invalidate them.
    valid = valid.at[0, :].set(False).at[-1, :].set(False)
    valid = valid.at[:, 0].set(False).at[:, -1].set(False)
    n = jnp.where(valid[..., None], n, 0.0)
    return n, valid


def rgb_to_intensity(rgb: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3) in [0,1] -> luma (H, W)."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def build_frame_pyramid(
    depth: jnp.ndarray,
    intr: Intrinsics,
    cfg: PreprocessConfig,
    levels: int,
    intensity: jnp.ndarray | None = None,
):
    """Full preprocessing: clamp -> bilateral -> per-level vmap/nmap.

    Returns a list over levels (fine -> coarse) of dicts with keys
    'depth', 'vmap', 'nmap', 'valid', optionally 'intensity'.

    """
    d = bilateral_filter(clamp_depth(depth, cfg), cfg)
    out = []
    i = intensity
    for lvl in range(levels):
        il = intr.level(lvl)
        vmap = backproject(il, d)
        nmap, nvalid = compute_normals(vmap)
        entry = {
            "depth": d,
            "vmap": vmap,
            "nmap": nmap,
            "valid": (d > 0.0) & nvalid,
        }
        if i is not None:
            entry["intensity"] = i
        out.append(entry)
        if lvl + 1 < levels:
            d = pyr_down_depth(d)
            if i is not None:
                i = pyr_down_intensity(i)
    return out
