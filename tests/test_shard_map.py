"""Sharded block map: integrate and halo-healed raycast vs the single map, and
graceful degradation when a shard is lost.

Runs on the virtual CPU mesh (tests/shard_common.py).
"""

import jax.numpy as jnp
import numpy as np

from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.ops import blocks
from instancefusion_tpu.parallel import shard
from tests.helpers import SMALL_INTR
from tests.shard_common import CFG, NSHARDS, RC, _frames, mesh  # noqa: F401 (fixture)


def test_sharded_integrate_matches_single(mesh):
    frames = _frames(2)
    single = blocks.allocate(CFG)
    sh = shard.allocate(CFG, NSHARDS)
    for f in frames:
        single = blocks.integrate(single, f.depth, f.color, f.T_wc, SMALL_INTR, CFG)
        sh = shard.integrate(sh, f.depth, f.color, f.T_wc, mesh, SMALL_INTR, CFG)

    # Same set of allocated blocks.
    ds = np.asarray(single.directory) >= 0
    dh = np.asarray(sh.directory) >= 0
    np.testing.assert_array_equal(ds, dh)
    assert int(sh.n_active.sum()) == int(single.n_active)
    assert int(sh.overflow.sum()) == 0

    # Same voxel contents: compare via directory lookups.
    nb = CFG.grid_size // CFG.block_size
    sdir = np.asarray(single.directory).reshape(-1)
    hdir = np.asarray(sh.directory).reshape(-1)
    ssdf = np.asarray(single.sdf)
    hsdf = np.asarray(sh.sdf)
    sw = np.asarray(single.weight)
    hw = np.asarray(sh.weight)
    sel = np.nonzero(sdir >= 0)[0]
    np.testing.assert_allclose(hw[hdir[sel]], sw[sdir[sel]], atol=1e-5)
    np.testing.assert_allclose(hsdf[hdir[sel]], ssdf[sdir[sel]], atol=1e-4)


def test_sharded_raycast_matches_single(mesh):
    # Tiny camera: the shard_map raycast compile on 4 virtual CPU devices
    # dominates test time, and resolution is irrelevant to seam healing.
    from instancefusion_tpu.geometry.camera import Intrinsics

    tiny = Intrinsics(fx=64.6, fy=64.5, cx=39.5, cy=29.5, width=80, height=60)
    f = synthetic.render_frame(synthetic.orbit_trajectory(2)[0], tiny)
    single = blocks.integrate(
        blocks.allocate(CFG), f.depth, f.color, f.T_wc, tiny, CFG
    )
    sh = shard.integrate(
        shard.allocate(CFG, NSHARDS), f.depth, f.color, f.T_wc, mesh, tiny, CFG
    )
    ms = blocks.raycast(single, f.T_wc, tiny, CFG, RC)
    mh = shard.raycast(sh, f.T_wc, mesh, tiny, CFG, RC)
    vs = np.asarray(ms.valid)
    vh = np.asarray(mh.valid)
    both = vs & vh
    # Halo exchange heals slab seams: nearly all single-map hits survive.
    assert both.sum() / max(vs.sum(), 1) > 0.97, (both.sum(), vs.sum())
    np.testing.assert_allclose(
        np.asarray(mh.depth)[both], np.asarray(ms.depth)[both], atol=2e-3
    )
    cos = np.sum(np.asarray(mh.normal_w)[both] * np.asarray(ms.normal_w)[both], -1)
    assert np.median(cos) > 0.999


def test_fault_injection_shard_loss_degrades_gracefully(mesh):
    """SURVEY §6 fault injection: wipe one shard's payload (host loss) —
    compositing must stay finite, surviving shards keep their surface, and
    the wiped slab simply disappears (recovery = checkpoint restore,
    exercised in tests/test_pipeline.py)."""
    from instancefusion_tpu.geometry.camera import Intrinsics

    tiny = Intrinsics(fx=64.6, fy=64.5, cx=39.5, cy=29.5, width=80, height=60)
    f = synthetic.render_frame(synthetic.orbit_trajectory(2)[0], tiny)
    sh = shard.integrate(
        shard.allocate(CFG, NSHARDS), f.depth, f.color, f.T_wc, mesh, tiny, CFG
    )
    healthy = shard.raycast(sh, f.T_wc, mesh, tiny, CFG, RC)
    n_healthy = int(healthy.valid.sum())
    assert n_healthy > 500

    # Wipe shard 1's rows: a lost host loses its payload entirely, so both
    # planes reset — sdf to the UNOBSERVED sentinel (what the raycaster
    # samples; weights are never gathered on the sampling path) and weight
    # to zero (what integrate/clean consult).
    cl = sh.sdf.shape[0] // NSHARDS
    w = np.array(sh.weight)
    s = np.array(sh.sdf)
    w[cl : 2 * cl] = 0.0
    s[cl : 2 * cl] = blocks.UNOBSERVED
    sh_broken = sh._replace(weight=jnp.asarray(w), sdf=jnp.asarray(s))
    broken = shard.raycast(sh_broken, f.T_wc, mesh, tiny, CFG, RC)
    n_broken = int(broken.valid.sum())
    assert np.isfinite(np.asarray(broken.depth)).all()
    assert 0 < n_broken < n_healthy
    # Pixels that survive agree with the healthy map.
    both = np.asarray(broken.valid) & np.asarray(healthy.valid)
    np.testing.assert_allclose(
        np.asarray(broken.depth)[both], np.asarray(healthy.depth)[both],
        atol=5e-3,
    )
