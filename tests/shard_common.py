"""Shared fixtures of the distributed-layer tests (tests/test_shard_*.py).

They run on the 8-device virtual CPU mesh (SURVEY §5): the sharded block
map must agree with the single-device block map (its golden), the halo
exchange must heal slab seams, and the psum'd BA reductions must match
their unsharded counterparts.  The tests are split by subsystem into
several files so that `--dist loadfile` spreads them over the workers.
"""

import jax
import pytest

from instancefusion_tpu.config import RaycastConfig, TsdfConfig
from instancefusion_tpu.datasets import synthetic
from instancefusion_tpu.parallel import mesh as meshmod
from tests.helpers import SMALL_INTR

NSHARDS = 4

CFG = TsdfConfig(
    voxel_size=0.04,
    trunc=0.12,
    grid_size=96,  # Nb=12 blocks per axis; 4 shards x 3-block slabs
    origin=(-1.92, -1.92, -0.4),
    block_size=8,
    table_capacity=1728,
)
RC = RaycastConfig(near=0.2, far=4.0)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= NSHARDS
    return meshmod.make_mesh(NSHARDS)


def _frames(n=2):
    poses = synthetic.orbit_trajectory(max(n, 2))
    return [synthetic.render_frame(poses[i], SMALL_INTR) for i in range(n)]
