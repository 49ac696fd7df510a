"""Splat-predictor tests: splat vs marched raycast, and engine-level ATE
parity (SURVEY.md §5 kernel-test strategy)."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from instancefusion_tpu.config import RaycastConfig
from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.engine import slam
from instancefusion_tpu.ops import blocks as blk
from instancefusion_tpu.ops.splat import splat_depth
from instancefusion_tpu.utils.ate import ate_rmse
from tests.helpers import SMALL_CFG, SMALL_INTR, SMALL_TSDF

BLOCKS_TSDF = dataclasses.replace(
    SMALL_TSDF, block_size=8, table_capacity=1728, touched_capacity=512
)
RMAX = 3


def _fused_map(n_frames=3):
    poses = synthetic.orbit_trajectory(max(n_frames, 3))
    bm = blk.allocate(BLOCKS_TSDF)
    frames = []
    for i in range(n_frames):
        f = synthetic.render_frame(poses[i], SMALL_INTR)
        frames.append(f)
        bm = blk.integrate(bm, f.depth, f.color, poses[i], SMALL_INTR, BLOCKS_TSDF)
    return bm, poses, frames


def test_splat_ref_matches_marched_raycast():
    """The splat reproduces the marched raycaster's depth within a
    fraction of a voxel wherever both are valid (in the prior band)."""
    bm, poses, frames = _fused_map()
    f = frames[0]
    touched = blk.touched_blocks_mask(f.depth, poses[0], SMALL_INTR, BLOCKS_TSDF)
    slots, valid = blk.compact_touched_slots(bm, touched, BLOCKS_TSDF, 512)

    imgs = splat_depth(
        slots, valid, bm.block_coords, bm.sdf, bm.weight, bm.color,
        poses[0], SMALL_INTR, BLOCKS_TSDF,
        depth_prior=f.depth, rmax=RMAX,
    )
    march = blk.raycast(
        bm, poses[0], SMALL_INTR, BLOCKS_TSDF,
        RaycastConfig(near=0.2, far=4.0),
        with_color=True, screen_space_normals=True,
    )
    vs = np.asarray(imgs.valid)
    vm = np.asarray(march.valid)
    band_ok = vm & (np.abs(np.asarray(march.depth) - np.asarray(f.depth))
                    <= 1.5 * BLOCKS_TSDF.trunc) & (np.asarray(f.depth) > 0)
    both = vs & band_ok
    # Coverage: comparable pixel count to the march in-band, with
    # substantial overlap (each sees some pixels the other misses —
    # splat loses near-range tent gaps, march loses crossing/normal
    # validity at different pixels).
    assert vs.sum() > 0.8 * band_ok.sum(), (vs.sum(), band_ok.sum())
    assert both.sum() > 0.6 * band_ok.sum(), (both.sum(), band_ok.sum())
    err = np.abs(np.asarray(imgs.depth) - np.asarray(march.depth))[both]
    assert np.median(err) < 0.3 * BLOCKS_TSDF.voxel_size, np.median(err)
    assert np.percentile(err, 90) < 1.5 * BLOCKS_TSDF.voxel_size


def test_engine_splat_end_to_end():
    """Engine ATE with the splat predictor matches the marched engine's
    bound on the synthetic sweep (the config-2 fast path at test scale)."""
    cfg = dataclasses.replace(
        SMALL_CFG,
        map_kind="blocks",
        tsdf=BLOCKS_TSDF,
        raycast=RaycastConfig(
            near=0.2, far=4.0, use_depth_prior=True,
            screen_space_normals=True, use_splat=True, splat_rmax=RMAX,
        ),
    )
    n = 12
    poses_gt = synthetic.orbit_trajectory(n)
    frames = [synthetic.render_frame(poses_gt[i], SMALL_INTR) for i in range(n)]
    state = slam.init_state(cfg, frames[0].T_wc)
    est, infos = [], []
    for f in frames:
        state, info = slam.step(cfg, state, f.depth, f.color)
        est.append(np.asarray(state.T_wc))
        infos.append(info)
    assert all(bool(i.track_ok) for i in infos)
    ate = ate_rmse(np.stack(est), np.asarray(poses_gt[:n]))
    assert ate < BLOCKS_TSDF.voxel_size, ate
    # The prediction keeps healthy coverage for the next frame's ICP.
    assert int(jnp.sum(state.pred.valid)) > 5000


def test_color_cadence_unbiased():
    """color_every>1 must not darken fused colors (round-3 advisor finding):
    off-frames inflate the shared fusion weight, so on-frames scale the
    color observation by the cadence.  The cadenced map's colors must
    match the every-frame map's on commonly-observed voxels."""
    import jax.numpy as jnp

    base = dataclasses.replace(
        SMALL_CFG,
        map_kind="blocks",
        tsdf=BLOCKS_TSDF,
        raycast=RaycastConfig(
            near=0.2, far=4.0, use_depth_prior=True,
            screen_space_normals=True, use_splat=True, splat_rmax=RMAX,
        ),
    )
    n = 16
    poses = synthetic.orbit_trajectory(n)
    frames = [synthetic.render_frame(poses[i], SMALL_INTR) for i in range(n)]

    def run(cfg):
        state = slam.init_state(cfg, frames[0].T_wc)
        for i, f in enumerate(frames):
            state, _ = slam.step_gt(cfg, state, f.depth, f.color, poses[i])
        return state.volume

    bm1 = run(base)  # color_every = 1
    bm4 = run(dataclasses.replace(base, color_every=4))

    w1 = np.asarray(bm1.weight)
    w4 = np.asarray(bm4.weight)
    c1 = np.asarray(bm1.color)
    c4 = np.asarray(bm4.color)
    # Same depth fusion either way: weights must be identical.
    np.testing.assert_allclose(w4, w1, atol=1e-4)
    both = (w1 > 4.0) & (w4 > 4.0)  # well-observed voxels (per channel x3)
    both3 = np.concatenate([both, both, both], axis=1)
    lit = both3 & (c1 > 0.05)  # skip never-colored/black voxels
    assert lit.sum() > 1000
    err = np.abs(c4[lit] - c1[lit])
    assert np.median(err) < 0.03, np.median(err)
    # No systematic darkening: mean brightness within 10% of every-frame.
    ratio = c4[lit].mean() / c1[lit].mean()
    assert 0.9 < ratio < 1.1, ratio
