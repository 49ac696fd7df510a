"""Frozen, hashable engine configuration.

Replaces the reference's CLI-flag singletons (``Utils/Parse``,
``Resolution``, ``Intrinsics`` — expected upstream layout, SURVEY.md §3/§6).
A single frozen dataclass is hashable so it can be a `static_argnum` to
``jit``; the five BASELINE.json graded configs ship as named presets.
"""

from __future__ import annotations

import dataclasses

from instancefusion_tpu.geometry.camera import Intrinsics, TUM_FR1, TUM_FR3


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    # Iterations per pyramid level, coarse -> fine (reference runs ~(10,5,4)
    # fine->coarse in RGBDOdometry::getIncrementalTransformation).
    iters: tuple[int, ...] = (10, 5, 4)
    levels: int = 3
    dist_thresh: float = 0.10  # m, association gate
    angle_thresh: float = 0.34  # sin(angle) gate, ~20 deg
    # Photometric (RGB) term weight: the FRACTION of the joint system's
    # information the photometric term carries (trust-fraction
    # normalized by the Hgeo/Hrgb trace ratio at solve time, so it is
    # resolution-independent — raw photometric JtJ scales with fx^2 and
    # a fixed blend would bury the geometric term ~10^3:1 at VGA).
    # 0 disables the RGB term.  The reference blends wICP*ICP + wRGB*RGB
    # with fixed weights instead.
    # Default 0.0: on the textured noisy fr1-calibrated synthetic rig the
    # term did not improve accuracy (the synthetic scenes are geometry-
    # rich, so the geometric system is never degenerate) and it forces the
    # intensity prediction.  It DOES rescue geometry-poor cases
    # (tests/test_icp.py test_photometric_term_end_to_end); enable per-run
    # when scenes have low geometric texture (flat walls).
    rgb_weight: float = 0.0
    damping: float = 1e-6  # Levenberg-style diagonal damping for the 6x6 solve
    # Huber IRLS weight on the point-to-plane residual (meters; 0 = hard
    # gating only, the reference behavior).  Downweights residuals beyond
    # delta — association outliers and TSDF-bias regions (curved/grazing
    # surfaces reconstruct a few mm off at coarse voxels) stop dragging
    # the solution; same elementwise cost as the binary mask.
    huber_delta: float = 0.0
    # Re-run projective association every k Gauss-Newton steps (1 = every
    # step, the reference behavior; 2 halves the gather cost — a fixed-
    # correspondence inner loop).  A tuple gives a per-level schedule,
    # coarse -> fine like `iters` — the fine level's full-resolution
    # gather is the expensive one, and its GN increments are sub-voxel,
    # so a sparser schedule there (e.g. (2, 2, 4)) loses no accuracy.
    assoc_every: int | tuple[int, ...] = 1
    # Constant-velocity motion-model seed: the ICP initial pose replays
    # `vel_seed` x the previous frame's twist (0 = previous-pose seed, the
    # reference behavior; 1 = full constant velocity).  Partial damping
    # trades basin-of-convergence reach against error amplification when
    # the previous estimate itself drifted.
    # Default 0.8 (r5): on an out-and-back reversal with low prediction
    # coverage (~35% valid) the previous-pose seed mis-converges 130 mm
    # in one frame while the damped velocity seed holds <20 mm; every
    # graded rig (_check_ate512, _check_drift_pipeline, bench) already
    # ran 0.8 explicitly.
    vel_seed: float = 0.8
    min_valid: int = 100  # tracking-health gate: min associated pixels


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    voxel_size: float = 0.02  # m
    trunc: float = 0.08  # m, truncation band
    max_weight: float = 64.0
    # Dense grid resolution (config 1) or virtual extent of the block map.
    grid_size: int = 128
    # Volume origin in world coords (meters): the grid spans
    # [origin, origin + grid_size * voxel_size)^3.
    origin: tuple[float, float, float] = (-1.28, -1.28, 0.0)
    # Sparse block map (config 2+):
    block_size: int = 8  # voxels per block edge
    table_capacity: int = 16384  # max live blocks (hash-table slots)
    # Static per-frame touched-block list size (integrate + splat predict);
    # overflow beyond this is skipped for the frame and counted.  Typical
    # frames touch 500-2500 blocks at 512^3.
    touched_capacity: int = 4096


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    step_scale: float = 0.75  # coarse step, in units of trunc
    refine_steps: int = 6  # bisection refinements at the zero crossing
    near: float = 0.1  # m
    far: float = 5.0  # m
    # Per-frame prediction fast paths (ops/blocks.raycast): bound the march
    # by the just-fused depth (~7 steps instead of ~60) and take normals
    # from image-space hit differences (0 gathers vs ~100/ray).  Off by
    # default (goldens, offline rendering); enabled in the 512^3 presets.
    use_depth_prior: bool = False
    screen_space_normals: bool = False
    # Predict by splatting the touched blocks into the image (ops/splat.py,
    # scatter-add rasterization) instead of the per-pixel march (blocks
    # map only).  The sharded engine composites shards exactly through
    # it, and the local-loop inactive view always uses it.
    use_splat: bool = False
    # Max tent-splat radius (px): voxel footprints nearer than
    # ~0.7*fx*voxel/rmax meters get coverage gaps.  The scatter count
    # grows as (2*rmax+1)^2, so tests use a small value.
    splat_rmax: int = 8
    # Render predicted color maps every frame.  The prediction's color is
    # only consumed by the photometric ICP term and by visualization; map
    # color is fused regardless (use_color).  Forced on whenever
    # icp.rgb_weight > 0.
    predict_color: bool = True


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    bilateral_radius: int = 2  # 5x5 window, as in the reference's CUDA filter
    bilateral_sigma_space: float = 1.7
    bilateral_sigma_depth: float = 0.04  # m
    depth_min: float = 0.1  # m, clamp
    depth_max: float = 5.0  # m


@dataclasses.dataclass(frozen=True)
class InstanceConfig:
    max_instances: int = 96  # instance-table capacity (reference: fixed max)
    num_classes: int = 41  # NYU40 + background
    # Segmentation-head cadence: the pipeline dispatches the head every k
    # frames (device-async) and fuses the result one frame later
    # (engine/pipeline.py "Pipeline overlap"; the reference's async
    # Mask R-CNN thread).  1 = every frame.
    seg_every: int = 8
    # (No per-voxel top-k vote buffer: the per-voxel label store is a
    # single-slot Boyer-Moore streaming majority (ops/labels.py) — same
    # asymptotic answer as a top-k histogram at 1/k the HBM traffic.)
    iou_match_thresh: float = 0.3
    # A mask whose SECOND-best predicted-region IoU clears this merges the
    # runner-up table row into the winner (the object was first seen from
    # two sides and got two rows — engine/instances.find_merges).
    merge_iou_thresh: float = 0.25
    min_mask_pixels: int = 200


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    keyframe_every: int = 20
    max_keyframes: int = 512
    max_edges: int = 2048
    fern_count: int = 512  # global-descriptor size
    loop_dist_thresh: float = 0.08  # descriptor distance for loop candidates
    ba_iters: int = 8
    huber_delta: float = 0.05
    # Landmark (loop-closure) bundle adjustment — the BASELINE-mandated
    # "loop-closure bundle adjustment as a distributed Schur-complement
    # reduction".  Each verified loop samples `landmarks_per_loop` points
    # from the loop keyframe pair (engine/posegraph.build_loop_landmarks)
    # into a fixed-capacity bank; graph corrections then run the joint
    # pose-graph + landmark Schur solve (ops/ba.optimize_hybrid_paired)
    # instead of pose-graph GN alone.
    use_landmark_ba: bool = True
    landmarks_per_loop: int = 192
    max_landmarks: int = 2048  # bank capacity; landmarks beyond are dropped
    # Per-observation weight vs graph edges.  A verified loop contributes
    # ~100+ 3-vector landmark residuals vs one 6-vector edge at weight 10
    # (w^2 in the quadratic form); 5.0 makes the raw re-measurement of the
    # loop-pair geometry dominate the single ICP-derived rigid edge, which
    # then mainly serves connectivity/fallback.
    landmark_weight: float = 5.0
    # Local (active/inactive) loop closure — the reference registers the
    # active model against the inactive model every frame (ElasticFusion's
    # time-windowed local loops; SURVEY.md §3 "Local loop closure").  The
    # block-map analog raycasts only blocks last fused more than
    # `local_window` frames ago and ICPs the current frame against that
    # inactive prediction (engine/localloop.py).  Requires
    # EngineConfig.track_stamps.
    local_window: int = 150  # frames since last fusion for "inactive"
    local_min_pixels: int = 3000  # inactive-view coverage to attempt ICP
    local_min_inlier_frac: float = 0.5  # inliers / attempted pixels gate


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    intrinsics: Intrinsics = TUM_FR1
    icp: IcpConfig = IcpConfig()
    tsdf: TsdfConfig = TsdfConfig()
    raycast: RaycastConfig = RaycastConfig()
    preprocess: PreprocessConfig = PreprocessConfig()
    instances: InstanceConfig = InstanceConfig()
    posegraph: PoseGraphConfig = PoseGraphConfig()
    use_color: bool = True
    # Fuse frame color into the map every k-th frame only (1 = every
    # frame, the reference behavior).  On-frames scale the color sample by
    # the cadence (color_gain) so the depth-inflated fusion weight does
    # not bias the color average — the EMA keeps the every-frame time
    # constant; the only residual bias is a voxel's FIRST color sample
    # landing at gain/(w_old+gain) of its value.  Applies to the
    # block-map splat path (both `step` and `step_gt`).
    color_every: int = 1
    use_instances: bool = False
    # Maintain a per-block last-fused frame stamp (i32[capacity] in the
    # engine state) — enables active/inactive local loop closure
    # (engine/localloop.py) and age-based diagnostics.  blocks map only.
    track_stamps: bool = False
    # 'dense' (config 1) or 'blocks' (config 2+)
    map_kind: str = "dense"
    # Number of map shards (1 = unsharded; >1 = shard_map over the 1-D
    # 'shards' mesh axis; 0 = one shard per visible device, resolved by
    # the entry point before the engine starts — `resolve_shards`).
    num_shards: int = 1
    # Map-consistency sentinel (SURVEY §6 failure detection): slow
    # map-feedback drift — frames fusing slightly misaligned so the map
    # drags the next solve — keeps inliers HIGH, so the per-frame
    # tracking-health gate is blind to it.  The sentinel runs a cheap
    # coarse-level frame-to-FRAME ICP (no map in the loop) each frame and
    # EWMAs its disagreement with the frame-to-model increment; a biased
    # map shows up as a persistent per-frame offset the EWMA integrates
    # while honest ICP noise averages out.
    consistency_check: bool = False
    # EWMA coefficient (~1/alpha frames of memory).
    consistency_alpha: float = 0.05
    # Norm of the world-frame disagreement-bias EWMA (meters) that raises
    # the alarm.  Calibrated on the synthetic 512^3/VGA rig: clean-sensor
    # runs sit well below it with zero alarms; Kinect-noise runs whose
    # map feedback inflates tracking error integrate a bias of a few mm
    # and alarm persistently.  1.2 mm sits between the two regimes.  The
    # sentinel separates healthy-map from degraded-map tracking; it does
    # not grade drift magnitude.
    consistency_thresh: float = 0.0012


# ----- BASELINE.json graded presets (SURVEY.md §0.1) -----

def config1_tum_fr1_desk() -> EngineConfig:
    """Config 1: TUM fr1_desk 640x480, 128^3 dense TSDF, 3-level pyramid ICP,
    no segmentation, single process."""
    return EngineConfig(
        intrinsics=TUM_FR1,
        tsdf=TsdfConfig(voxel_size=0.025, trunc=0.1, grid_size=128,
                        origin=(-1.6, -1.6, 0.0)),
        map_kind="dense",
        use_instances=False,
    )


def config2_tum_fr3_long_office() -> EngineConfig:
    """Config 2: TUM fr3_long_office, 512^3 voxel-block-hashed TSDF +
    raycast tracking, single chip."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.01, trunc=0.04, grid_size=512,
                        origin=(-2.56, -2.56, 0.0), block_size=8,
                        table_capacity=65536),
        map_kind="blocks",
        use_instances=False,
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True),
    )


def config3_scannet_instances() -> EngineConfig:
    """Config 3: ScanNet scene with instance-mask fusion + per-voxel label
    voting, single host."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.01, trunc=0.04, grid_size=512,
                        origin=(-2.56, -2.56, 0.0), block_size=8,
                        table_capacity=65536),
        map_kind="blocks",
        use_instances=True,
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True),
    )


def config4_posegraph_sharded() -> EngineConfig:
    """Config 4: multi-room with keyframe pose graph + loop-closure Schur BA,
    map blocks sharded on 1 host."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.02, trunc=0.08, grid_size=512,
                        origin=(-5.12, -5.12, 0.0), block_size=8,
                        table_capacity=65536),
        map_kind="blocks",
        use_instances=False,
        num_shards=0,  # one shard per device (resolve_shards)
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True),
    )


def config5_multihost() -> EngineConfig:
    """Config 5: large run sharded across N>=2 hosts: distributed block
    fusion + collective BA."""
    return EngineConfig(
        intrinsics=TUM_FR3,
        icp=IcpConfig(assoc_every=(2, 2, 4)),
        tsdf=TsdfConfig(voxel_size=0.02, trunc=0.08, grid_size=1024,
                        origin=(-10.24, -10.24, 0.0), block_size=8,
                        table_capacity=131072),
        map_kind="blocks",
        use_instances=True,
        num_shards=0,  # one shard per device (resolve_shards)
        raycast=RaycastConfig(use_depth_prior=True, screen_space_normals=True),
    )


PRESETS = {
    "config1": config1_tum_fr1_desk,
    "config2": config2_tum_fr3_long_office,
    "config3": config3_scannet_instances,
    "config4": config4_posegraph_sharded,
    "config5": config5_multihost,
}


def resolve_shards(cfg: EngineConfig, requested: int = 0) -> EngineConfig:
    """Fix the shard count: `requested` if given, else the preset's, else
    (preset 0) one shard per visible device.  Initializes the JAX backend
    only in that last case."""
    n = requested or cfg.num_shards
    if n == 0:
        import jax

        n = jax.device_count()
    return dataclasses.replace(cfg, num_shards=n)
