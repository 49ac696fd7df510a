"""Compute ops for the SLAM pipeline (plain jnp/lax, compiled by XLA)."""

from instancefusion_tpu.ops import (  # noqa: F401
    ba,
    blocks,
    ferns,
    icp,
    labels,
    preprocess,
    raycast,
    tsdf,
)
