"""Offline visualization: raycast the map to shaded / instance-colored PNGs.

Replaces the reference's Pangolin GUI (SURVEY.md §2 L7): no interactive
window on an accelerator host, so inspection is headless — render the model from
any pose via the same raycaster the tracker uses, shade with normals (and
optionally instance colors), write PNGs or an image sequence.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from instancefusion_tpu.engine.instances import instance_color
from instancefusion_tpu.ops import blocks as blk, labels as lbl, raycast as rc


def render_view(volume, T_wc, intr, tsdf_cfg, rc_cfg, votes=None):
    """Raycast + shade one view.

    Returns dict of uint8 images: 'shaded' (H,W,3), 'depth' (H,W),
    'color' (H,W,3), and 'instances' (H,W,3) when `votes` is given.
    """
    is_blocks = hasattr(volume, "directory")
    caster = blk.raycast if is_blocks else rc.raycast
    maps = caster(volume, T_wc, intr, tsdf_cfg, rc_cfg)

    n = np.asarray(maps.normal_w)
    valid = np.asarray(maps.valid)
    light = np.array([0.4, -0.3, -0.85])
    light /= np.linalg.norm(light)
    lam = np.clip(-np.sum(n * light, axis=-1), 0.0, 1.0)
    shade = (0.25 + 0.75 * lam)[..., None]
    base = np.asarray(maps.color)
    has_color = base.size and base.max() > 0
    lit = (base if has_color else np.full_like(n, 0.8)) * shade
    out = {
        "shaded": (np.where(valid[..., None], np.clip(lit, 0, 1), 0) * 255).astype(np.uint8),
        "depth": (
            np.clip(np.asarray(maps.depth) / max(rc_cfg.far, 1e-6), 0, 1) * 255
        ).astype(np.uint8),
        "color": (np.clip(base, 0, 1) * 255).astype(np.uint8)
        if has_color
        else np.zeros(n.shape, np.uint8),
    }
    if votes is not None and is_blocks:
        gids = lbl.sample_nearest(votes, volume, maps.vertex_w, maps.valid, tsdf_cfg)
        cols = np.asarray(instance_color(gids))
        inst = np.where(
            (np.asarray(gids) >= 0)[..., None], cols, lit * 0.5
        )
        out["instances"] = (
            np.where(valid[..., None], np.clip(inst, 0, 1), 0) * 255
        ).astype(np.uint8)
    return out


def save_png(path: str, image: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(image).save(path)


def render_sequence(volume, poses, intr, tsdf_cfg, rc_cfg, out_dir,
                    votes=None, prefix="view"):
    """Render a pose list to numbered PNGs (offline flythrough)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, T in enumerate(poses):
        imgs = render_view(volume, jnp.asarray(T), intr, tsdf_cfg, rc_cfg, votes)
        p = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
        save_png(p, imgs["shaded"])
        paths.append(p)
    return paths
