"""Sharded instance fusion: label voting, and data/tensor-parallel segmentation.

Runs on the virtual CPU mesh (tests/shard_common.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.ops import blocks
from instancefusion_tpu.parallel import shard
from tests.shard_common import CFG, NSHARDS, RC, mesh  # noqa: F401 (fixture)


def test_sharded_label_voting_matches_single(mesh):
    """Distributed label voting (BASELINE: masks fused into the *sharded*
    volume): per-voxel votes on sharded rows match the single-device
    ops/labels golden, and the pmax-composited predicted-id image matches
    the single-device nearest-label sampling."""
    from instancefusion_tpu.geometry.camera import Intrinsics
    from instancefusion_tpu.ops import labels

    tiny = Intrinsics(fx=64.6, fy=64.5, cx=39.5, cy=29.5, width=80, height=60)
    f = synthetic.render_frame(synthetic.orbit_trajectory(2)[0], tiny)
    single = blocks.integrate(
        blocks.allocate(CFG), f.depth, f.color, f.T_wc, tiny, CFG
    )
    sh = shard.integrate(
        shard.allocate(CFG, NSHARDS), f.depth, f.color, f.T_wc, mesh, tiny, CFG
    )

    # Two instance ids split left/right across the image.
    half = jnp.arange(tiny.width)[None, :] < tiny.width // 2
    gid = jnp.where(f.depth > 0, jnp.where(half, 3, 11), -1).astype(jnp.int32)

    v0 = labels.fuse(
        labels.allocate(CFG), single, gid, f.depth, f.T_wc, tiny, CFG
    )
    vh = shard.fuse_labels(
        shard.allocate_votes(CFG, NSHARDS), sh, gid, f.depth, f.T_wc,
        mesh, tiny, CFG,
    )
    n0 = int(jnp.sum((v0.count > 0) & (v0.label >= 0)))
    assert n0 > 500

    # Directory-addressed vote planes identical.
    sdir = np.asarray(single.directory).reshape(-1)
    hdir = np.asarray(sh.directory).reshape(-1)
    sel = np.nonzero(sdir >= 0)[0]
    np.testing.assert_array_equal(
        np.asarray(vh.label)[hdir[sel]], np.asarray(v0.label)[sdir[sel]]
    )
    np.testing.assert_allclose(
        np.asarray(vh.count)[hdir[sel]], np.asarray(v0.count)[sdir[sel]],
        atol=1e-6,
    )

    # Predicted-id image: sharded pmax composite vs single-device lookup.
    maps = blocks.raycast(single, f.T_wc, tiny, CFG, RC)
    g0 = labels.sample_nearest(v0, single, maps.vertex_w, maps.valid, CFG)
    gh = shard.sample_labels(vh, sh, maps.vertex_w, maps.valid, mesh, CFG)
    np.testing.assert_array_equal(np.asarray(gh), np.asarray(g0))


def test_dp_and_tp_segmentation_match_single(mesh):
    """DP (batch-sharded) and TP (channel-sharded params) segmentation
    produce the single-device result (SURVEY §3.2)."""
    import jax

    from instancefusion_tpu.models import parallel as mpar, segmentation as seg

    h, w, nc, k, width = 48, 64, 8, 8, 16
    params = seg.init_params(jax.random.PRNGKey(0), h, w, nc, width=width)
    rng = jax.random.PRNGKey(1)
    rgb = jax.random.uniform(rng, (NSHARDS, h, w, 3))

    single = [seg.segment(params, rgb[i], nc, k, width) for i in range(NSHARDS)]

    dp = mpar.dp_segment_fn(mesh, nc, k, width)
    out = dp(params, rgb)
    for i in range(NSHARDS):
        np.testing.assert_array_equal(
            np.asarray(out.mask_id[i]), np.asarray(single[i].mask_id)
        )
        np.testing.assert_array_equal(
            np.asarray(out.classes[i]), np.asarray(single[i].classes)
        )

    shard_params, tp = mpar.tp_segment_fn(mesh, nc, k, width)
    p_tp = shard_params(params)
    got = tp(p_tp, rgb[0])
    np.testing.assert_array_equal(
        np.asarray(got.mask_id), np.asarray(single[0].mask_id)
    )
    np.testing.assert_allclose(
        np.asarray(got.scores), np.asarray(single[0].scores), atol=1e-4
    )
