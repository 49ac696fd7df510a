"""Instance-level dense RGB-D SLAM in JAX.

A JAX/XLA framework with the capabilities of the reference
``Fancomi2017/InstanceFusion`` (instance-level dense SLAM built on
ElasticFusion), redesigned for XLA rather than ported:

- frame-to-model tracking: point-to-plane ICP + photometric term, 3-level
  pyramid, the whole iteration loop on-device under one ``jit``
  (reference: ``Core/src/RGBDOdometry.cpp`` + CUDA ``icpStep``/``rgbStep``
  kernels — expected upstream layout, see SURVEY.md §0 provenance caveat);
- map: TSDF voxel volume (dense and voxel-block-hashed) with plain XLA
  integrate + raycast (reference: surfel map in ``Core/src/GlobalModel.cpp``
  + GLSL; the TSDF representation is mandated by the BASELINE.json
  contract);
- instances: JAX segmentation head + per-voxel label voting
  (reference: Mask R-CNN + CUDA label kernels);
- loop closure: keyframe pose graph + Schur-complement BA with collective
  reductions (reference: ferns + embedded deformation graph);
- distribution: voxel blocks sharded over a 1-D device mesh via
  ``shard_map``, with halo exchange (new — the reference is single-GPU).
"""

__version__ = "0.1.0"

# Public API: the stable entry points a user of the framework needs.
from instancefusion_tpu.config import (  # noqa: E402,F401
    EngineConfig,
    IcpConfig,
    InstanceConfig,
    PoseGraphConfig,
    PreprocessConfig,
    PRESETS,
    RaycastConfig,
    TsdfConfig,
)
from instancefusion_tpu.geometry.camera import Intrinsics  # noqa: E402,F401


def __getattr__(name):
    """Lazy submodule access (keeps `import instancefusion_tpu` light)."""
    import importlib

    if name in {
        "engine", "ops", "models", "parallel", "datasets", "utils", "geometry",
    }:
        return importlib.import_module(f"instancefusion_tpu.{name}")
    raise AttributeError(f"module 'instancefusion_tpu' has no attribute {name!r}")
