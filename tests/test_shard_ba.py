"""Sharded pose-graph and Schur BA reductions vs their unsharded counterparts.

Runs on the virtual CPU mesh (tests/shard_common.py).
"""

import jax.numpy as jnp
import numpy as np

from instancefusion_tpu.ops import ba
from instancefusion_tpu.parallel import shard
from tests.test_ba import _ba_problem, _chain_with_loop
from tests.shard_common import NSHARDS, mesh  # noqa: F401 (fixture)


def test_sharded_pose_graph_matches_single(mesh):
    gt, est, g = _chain_with_loop()
    H0, b0, c0 = ba.pose_graph_normal_eqs(jnp.asarray(est), g)
    # Shard the edge set (capacity is divisible by NSHARDS).
    H1, b1, c1 = shard.sharded_pose_graph_normal_eqs(mesh, jnp.asarray(est), g)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-5)


def test_sharded_schur_ba_matches_single(mesh):
    gt_poses, gt_pts, noisy_poses, noisy_pts, obs = _ba_problem(m=4, L=8)
    # Pad observations to a shard-divisible count (invalid rows are inert).
    n = obs.k.shape[0]
    pad = (-n) % NSHARDS
    obs = ba.BAObservations(
        k=jnp.pad(obs.k, (0, pad)),
        l=jnp.pad(obs.l, (0, pad)),
        z=jnp.pad(obs.z, ((0, pad), (0, 0))),
        weight=jnp.pad(obs.weight, (0, pad)),
        valid=jnp.pad(obs.valid, (0, pad)),
    )
    p0, x0, c0 = ba.optimize_ba(
        jnp.asarray(noisy_poses), jnp.asarray(noisy_pts), obs, iters=4
    )
    p1, x1, c1 = ba.optimize_ba(
        jnp.asarray(noisy_poses), jnp.asarray(noisy_pts), obs, iters=4,
        partials_fn=shard.sharded_ba_partials(mesh),
    )
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), atol=1e-4)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), atol=1e-4)


def test_sharded_paired_terms_match_single(mesh):
    """The distributed paired-Schur reducer: psum'd S/rhs/cost equal the
    single-device terms, and the full hybrid solve through the sharded
    terms_fn matches the unsharded solve."""
    from tests.test_ba import _paired_problem

    gt, pts, noisy, npts, pobs, g = _paired_problem(m=5, L=32)
    poses = jnp.asarray(noisy)
    points = jnp.asarray(npts)

    S0, rhs0, _, _, _, _, c0 = ba.paired_terms(poses, points, pobs)
    terms = shard.sharded_paired_terms(mesh)
    S1, rhs1, Hll_inv1, Wa1, Wb1, bl1, c1 = terms(poses, points, pobs)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(rhs1), np.asarray(rhs0), atol=1e-5)
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-5)
    assert Hll_inv1.shape == (32, 3, 3)  # landmark-aligned leaves intact

    p0, x0, _ = ba.optimize_hybrid_paired(poses, g, points, pobs, iters=6)
    p1, x1, _ = ba.optimize_hybrid_paired(
        poses, g, points, pobs, iters=6, terms_fn=terms
    )
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), atol=1e-4)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0), atol=1e-4)
