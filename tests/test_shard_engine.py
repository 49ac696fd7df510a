"""The sharded engine: splat step and chunked replay vs the single-device engine.

Runs on the virtual CPU mesh (tests/shard_common.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from instancefusion_tpu.config import RaycastConfig, TsdfConfig
from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.ops import blocks
from instancefusion_tpu.parallel import shard
from tests.helpers import SMALL_INTR
from tests.shard_common import CFG, NSHARDS, _frames, mesh  # noqa: F401 (fixture)


def test_sharded_splat_fast_path_matches_single(mesh):
    """The fused fast path (list-based replicated allocation + slot
    integrate + per-shard splat + pmin composite) tracks the single-chip
    splat engine: same trajectory (sub-voxel), same allocation set modulo
    pose-divergence boundary blocks."""
    from instancefusion_tpu.config import RaycastConfig as RC_
    from instancefusion_tpu.engine import slam, slam_sharded
    from tests.helpers import SMALL_CFG

    cfg = dataclasses.replace(
        SMALL_CFG,
        map_kind="blocks",
        tsdf=dataclasses.replace(CFG, touched_capacity=512),
        raycast=RC_(near=0.2, far=4.0, use_depth_prior=True,
                    screen_space_normals=True, use_splat=True, splat_rmax=3),
    )
    n = 6
    poses_gt = synthetic.orbit_trajectory(n)
    frames = [synthetic.render_frame(poses_gt[i], SMALL_INTR) for i in range(n)]
    s1 = slam.init_state(cfg, frames[0].T_wc)
    s2 = slam_sharded.init_state(cfg, mesh, frames[0].T_wc)
    step2 = slam_sharded.make_step(cfg, mesh, donate=True)
    for f in frames:
        s1, i1 = slam.step(cfg, s1, f.depth, f.color)
        s2, i2 = step2(s2, f.depth, f.color)
        assert bool(i2.track_ok)
    # Trajectories agree to well under a voxel.
    assert float(jnp.max(jnp.abs(s1.T_wc - s2.T_wc))) < 0.5 * CFG.voxel_size
    # Same allocation set modulo a few boundary blocks from the tiny pose
    # divergence between the two engines' band sampling.
    d1 = np.asarray(s1.volume.directory) >= 0
    d2 = np.asarray(s2.volume.directory) >= 0
    assert (d1 != d2).sum() <= 0.02 * d1.sum() + 2, (d1.sum(), d2.sum())
    # The composited prediction has comparable coverage.
    v1 = int(s1.pred.valid.sum())
    v2 = int(s2.pred.valid.sum())
    assert abs(v1 - v2) < 0.1 * max(v1, v2), (v1, v2)
    # Payload rows spread over shards (not all on one).
    counts = np.asarray(s2.volume.n_active)
    assert (counts > 0).sum() >= 2, counts


def test_sharded_run_chunk_matches_stepping(mesh):
    """slam_sharded.make_run_chunk (lax.scan replay, one dispatch per K
    frames) == K sequential make_step calls: same pose, same occupancy,
    same prediction."""
    from instancefusion_tpu.config import (
        EngineConfig, IcpConfig, PreprocessConfig,
        RaycastConfig as RC_, TsdfConfig as TC_,
    )
    from instancefusion_tpu.engine import slam_sharded

    ecfg = EngineConfig(
        intrinsics=SMALL_INTR,
        tsdf=dataclasses.replace(CFG, table_capacity=4096, touched_capacity=512),
        icp=IcpConfig(iters=(6, 4, 4), min_valid=60, rgb_weight=0.0),
        raycast=RC_(near=0.2, far=4.0, use_depth_prior=True,
                    screen_space_normals=True, use_splat=True, splat_rmax=3),
        preprocess=PreprocessConfig(),
        map_kind="blocks", num_shards=NSHARDS,
    )
    frames = _frames(3)
    s_ref = slam_sharded.init_state(ecfg, mesh, frames[0].T_wc)
    step = slam_sharded.make_step(ecfg, mesh)
    for f in frames:
        s_ref, _ = step(s_ref, f.depth, f.color)

    s_chk = slam_sharded.init_state(ecfg, mesh, frames[0].T_wc)
    run_chunk = slam_sharded.make_run_chunk(ecfg, mesh)
    depths = jnp.stack([f.depth for f in frames])
    colors = jnp.stack([f.color for f in frames])
    s_chk, infos = run_chunk(s_chk, depths, colors)

    np.testing.assert_allclose(
        np.asarray(s_chk.T_wc), np.asarray(s_ref.T_wc), atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(s_chk.volume.n_active), np.asarray(s_ref.volume.n_active)
    )
    np.testing.assert_allclose(
        np.asarray(s_chk.pred.depth), np.asarray(s_ref.pred.depth), atol=1e-4
    )
    assert infos.track_ok.shape == (3,)
