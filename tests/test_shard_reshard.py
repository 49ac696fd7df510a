"""Sharded map hygiene: all_to_all re-sharding, clean, and streaming.

Runs on the virtual CPU mesh (tests/shard_common.py).
"""

import jax.numpy as jnp
import numpy as np

from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.ops import blocks
from instancefusion_tpu.parallel import shard
from tests.helpers import SMALL_INTR
from tests.shard_common import CFG, NSHARDS, RC, _frames, mesh  # noqa: F401 (fixture)


def test_reshard_migrates_rows_to_slab_owners(mesh):
    """all_to_all re-sharding (SURVEY §6): a map whose rows all sit on
    shard 0 — exactly what loading a single-process checkpoint onto an
    S-shard mesh produces — migrates every row to its slab owner and then
    behaves identically to a natively-sharded map."""
    from instancefusion_tpu.geometry.camera import Intrinsics

    tiny = Intrinsics(fx=64.6, fy=64.5, cx=39.5, cy=29.5, width=80, height=60)
    f = synthetic.render_frame(synthetic.orbit_trajectory(2)[0], tiny)
    single = blocks.integrate(
        blocks.allocate(CFG), f.depth, f.color, f.T_wc, tiny, CFG
    )
    cl = CFG.table_capacity // NSHARDS
    n0 = int(single.n_active)
    assert 0 < n0 <= cl, n0

    # Pack everything into shard 0's slot range (gslot == local slot there).
    sh0 = shard.ShardedBlockMap(
        directory=single.directory,
        block_coords=single.block_coords[: CFG.table_capacity],
        n_active=jnp.array([n0] + [0] * (NSHARDS - 1), jnp.int32),
        overflow=jnp.zeros((NSHARDS,), jnp.int32),
        sdf=single.sdf[: CFG.table_capacity],
        weight=single.weight[: CFG.table_capacity],
        color=single.color[: CFG.table_capacity],
        cuts=shard.uniform_cuts(CFG, NSHARDS),
    )
    bm, _, migrated, leftover = shard.reshard(sh0, mesh, CFG, migrate_cap=cl)
    assert int(leftover.sum()) == 0
    assert int(migrated.sum()) > 0
    assert int(bm.n_active.sum()) == n0
    assert int(bm.overflow.sum()) == 0

    # Every live row now sits in its owner's slot range.
    nb = CFG.grid_size // CFG.block_size
    coords = np.asarray(bm.block_coords)
    nact = np.asarray(bm.n_active)
    for s in range(NSHARDS):
        rows = coords[s * cl : s * cl + nact[s]]
        owners = np.clip(rows[:, 0] // (nb // NSHARDS), 0, NSHARDS - 1)
        assert (owners == s).all()

    # Directory-addressed contents unchanged.
    sdir = np.asarray(single.directory).reshape(-1)
    hdir = np.asarray(bm.directory).reshape(-1)
    sel = np.nonzero(sdir >= 0)[0]
    np.testing.assert_array_equal(hdir >= 0, sdir >= 0)
    np.testing.assert_allclose(
        np.asarray(bm.sdf)[hdir[sel]], np.asarray(single.sdf)[sdir[sel]],
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(bm.weight)[hdir[sel]], np.asarray(single.weight)[sdir[sel]],
        atol=1e-6,
    )

    # The resharded map raycasts like the single-device golden.
    ms = blocks.raycast(single, f.T_wc, tiny, CFG, RC)
    mh = shard.raycast(bm, f.T_wc, mesh, tiny, CFG, RC)
    both = np.asarray(ms.valid) & np.asarray(mh.valid)
    assert both.sum() / max(np.asarray(ms.valid).sum(), 1) > 0.97
    np.testing.assert_allclose(
        np.asarray(mh.depth)[both], np.asarray(ms.depth)[both], atol=2e-3
    )

    # Small migrate_cap drains over repeated rounds.
    bm2, _, _, left = shard.reshard(sh0, mesh, CFG, migrate_cap=32)
    rounds = 1
    while int(left.sum()) > 0:
        bm2, _, _, left = shard.reshard(bm2, mesh, CFG, migrate_cap=32)
        rounds += 1
        assert rounds < 32
    assert int(bm2.n_active.sum()) == n0
    np.testing.assert_array_equal(
        np.asarray(bm2.directory) >= 0, np.asarray(single.directory) >= 0
    )


def test_reshard_policy_rebalances_skew(mesh):
    """The reshard POLICY (VERDICT r4 Missing #1): a camera dwelling in a
    few x-slabs skews per-shard occupancy; occupancy-balanced cuts + the
    all_to_all drain drop the max blocks/shard while the map stays
    bit-equal (same directory set, same directory-addressed contents)."""
    f = _frames(1)[0]
    sh = shard.allocate(CFG, NSHARDS)
    sh = shard.integrate(sh, f.depth, f.color, f.T_wc, mesh, SMALL_INTR, CFG)
    counts0 = np.asarray(sh.n_active)
    assert counts0.max() > 1.2 * counts0.mean(), counts0  # genuinely skewed

    before = {
        "dirset": np.asarray(sh.directory) >= 0,
        "n": int(sh.n_active.sum()),
    }
    sdir = np.asarray(sh.directory).reshape(-1)
    sel = np.nonzero(sdir >= 0)[0]
    sdf_before = np.asarray(sh.sdf)[sdir[sel]]

    sh = sh._replace(cuts=shard.balanced_cuts(sh.directory, CFG, NSHARDS))
    moved = 0
    for _ in range(8):
        sh, _, migrated, leftover = shard.reshard(sh, mesh, CFG, migrate_cap=64)
        moved += int(migrated.sum())
        if int(leftover.sum()) == 0:
            break
    assert int(leftover.sum()) == 0
    assert moved > 0
    counts1 = np.asarray(sh.n_active)
    assert counts1.max() < counts0.max(), (counts0, counts1)
    assert int(sh.n_active.sum()) == before["n"]
    np.testing.assert_array_equal(
        np.asarray(sh.directory) >= 0, before["dirset"]
    )
    hdir = np.asarray(sh.directory).reshape(-1)
    np.testing.assert_allclose(
        np.asarray(sh.sdf)[hdir[sel]], sdf_before, atol=1e-6
    )


def test_sharded_clean_matches_single(mesh):
    """Sharded hygiene (SURVEY §6 / VERDICT r4 Missing #2): per-shard row
    culling + compaction matches blocks.clean on the same map — same
    surviving block set, same directory-addressed contents."""
    frames = _frames(2)
    single = blocks.allocate(CFG)
    sh = shard.allocate(CFG, NSHARDS)
    for f in frames:
        single = blocks.integrate(single, f.depth, f.color, f.T_wc, SMALL_INTR, CFG)
        sh = shard.integrate(sh, f.depth, f.color, f.T_wc, mesh, SMALL_INTR, CFG)

    # min_weight=1.5 culls the single-observation fringe rows (frame 2
    # only partially overlaps frame 1), exercising real culling.
    s_out, _ = blocks.clean(single, CFG, min_weight=1.5)
    h_out, _ = shard.clean(sh, mesh, CFG, min_weight=1.5)
    assert int(s_out.n_active) < int(single.n_active)  # something culled
    np.testing.assert_array_equal(
        np.asarray(s_out.directory) >= 0, np.asarray(h_out.directory) >= 0
    )
    assert int(h_out.n_active.sum()) == int(s_out.n_active)

    sdir = np.asarray(s_out.directory).reshape(-1)
    hdir = np.asarray(h_out.directory).reshape(-1)
    sel = np.nonzero(sdir >= 0)[0]
    np.testing.assert_allclose(
        np.asarray(h_out.sdf)[hdir[sel]], np.asarray(s_out.sdf)[sdir[sel]],
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(h_out.weight)[hdir[sel]], np.asarray(s_out.weight)[sdir[sel]],
        atol=1e-6,
    )


def test_sharded_streaming_evict_admit_roundtrip(mesh):
    """Sharded active-window streaming: every shard evicts its own cold
    rows to the host store; admission re-appends each row on its slab
    owner, bit-exact."""
    from instancefusion_tpu.engine.streaming import ShardedBlockStreamer

    frames = _frames(2)
    sh = shard.allocate(CFG, NSHARDS)
    for f in frames:
        sh = shard.integrate(sh, f.depth, f.color, f.T_wc, mesh, SMALL_INTR, CFG)
    n0 = int(sh.n_active.sum())
    assert n0 > 20

    def rows_by_coord(bm):
        coords = np.asarray(bm.block_coords)
        sdf = np.asarray(bm.sdf)
        w = np.asarray(bm.weight)
        out = {}
        for i in range(coords.shape[0]):
            if coords[i, 0] >= 0:
                out[tuple(coords[i])] = (sdf[i], w[i])
        return out

    golden = rows_by_coord(sh)
    streamer = ShardedBlockStreamer(
        CFG, mesh, radius=0.4, evict_cap=512, admit_cap=512
    )
    far = np.array([50.0, 50.0, 50.0], np.float32)
    vol, _, _, n_out = streamer.evict(sh, None, far)
    assert n_out == n0
    assert int(vol.n_active.sum()) == 0
    assert len(streamer.store) == n0
    assert int(jnp.sum(vol.directory >= 0)) == 0

    # Save/load the store (the evict/resume invariant), then re-admit.
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "store.npz")
        streamer.save(path)
        streamer.store = {}
        streamer.load(path)
    streamer.radius = 1e9
    vol, _, _, n_in = streamer.admit(vol, None, np.zeros(3, np.float32))
    assert n_in == n0
    assert len(streamer.store) == 0
    assert int(vol.n_active.sum()) == n0
    got = rows_by_coord(vol)
    assert set(got) == set(golden)
    for k in golden:
        np.testing.assert_array_equal(golden[k][0], got[k][0])
        np.testing.assert_array_equal(golden[k][1], got[k][1])
    # Every re-admitted row landed on its cuts-owner shard.
    cl = CFG.table_capacity // NSHARDS
    coords = np.asarray(vol.block_coords)
    nact = np.asarray(vol.n_active)
    cuts = np.asarray(vol.cuts)
    for s in range(NSHARDS):
        rows = coords[s * cl : s * cl + nact[s]]
        owners = np.searchsorted(cuts, rows[:, 0], side="right")
        assert (owners == s).all()
