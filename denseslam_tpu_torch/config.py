"""Configuration tree: a jax-free copy of denseslam_tpu/config.py with the
same field names and defaults (tests/test_torch_config.py holds the two
field for field). The rationale behind each default is documented in the
JAX package's config.py; shape-defining fields are static Python ints."""

from __future__ import annotations

import dataclasses

from .utils.camera import Intrinsics, StereoRig


@dataclasses.dataclass(frozen=True)
class VoxelDecayParams:
    enabled: bool = False
    min_decay_age: int = 30
    max_decay_weight: int = 2


@dataclasses.dataclass(frozen=True)
class SlideWindowParams:
    enabled: bool = False
    max_age: int = 60


@dataclasses.dataclass(frozen=True)
class OnlineCorrectionParams:
    enabled: bool = False
    correction_num: int = 5
    start_correction_num: int = 10
    min_error: float = 0.015
    inactive_min_error: float = 0.05


@dataclasses.dataclass(frozen=True)
class PostProcessParams:
    enabled: bool = False
    filter_threshold: float = 0.1
    filter_area: float = 0.5


@dataclasses.dataclass(frozen=True)
class WeightParams:
    """Depth-dependent fusion weighting."""
    depth_weighting: bool = False
    max_new_w: int = 5
    max_distance: float = 30.0


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    """Voxel-hashed TSDF volume geometry + table capacities (static)."""
    voxel_size_m: float = 0.06
    trunc_dist_m: float = 0.24
    max_weight: float = 100.0
    table_slots: int = 1 << 15
    probe_len: int = 16
    max_visible_blocks: int = 4096
    max_alloc_per_frame: int = 4096
    min_depth_m: float = 0.3
    max_depth_m: float = 50.0
    raycast_steps: int = 192
    bilinear_fusion: bool = False
    alloc_subsample: int = 1
    fuse_color: bool = True
    gray_color_fusion: bool = True
    # "gather": plain packed nearest gather; "pallas": the tile-sampler
    # semantics (kernel 1, csrc/tile_sample.cu) incl. overflow accounting
    sampler: str = "gather"
    pallas_overflow_cap: int = 512
    storage_dtype: str = "float32"
    weights: WeightParams = WeightParams()

    @property
    def block_size_m(self) -> float:
        return self.voxel_size_m * 8.0


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Sparse frontend: detection, matching, refinement and RANSAC of the
    stereo and RGB-D steps (models/frontend.py), and the gains and target
    of the per-frame path's PD controller on the RANSAC budget
    (models/system.py). Not ported: feature_type="orb" and the mono
    step's fields (camera_height_m, camera_pitch_rad); they are kept so
    configs round-trip."""
    max_features: int = 2048
    feature_type: str = "gradient"
    orb_levels: int = 3
    orb_thresh: float = 18.0
    nms_radius: int = 4
    nms_tau: float = 25.0
    bucket_w: int = 50
    bucket_h: int = 50
    max_per_bucket: int = 8
    match_radius_px: float = 100.0
    stereo_band_px: float = 3.0
    use_motion_prior_gate: bool = True
    predictive_gate_px: float = 24.0
    outlier_removal: bool = True
    outlier_knn: int = 8
    outlier_flow_tol_px: float = 5.0
    outlier_disp_tol_px: float = 5.0
    outlier_min_support: int = 2
    gain_normalization: bool = True
    ransac_iters: int = 256
    edge_reweighting: bool = True
    ransac_thresh_px: float = 2.0
    gn_iters: int = 8
    refine_iters: int = 12
    subpixel_refine: bool = True
    refine_patch: int = 9
    refine_search: int = 2
    refine_cap: int = 384
    refine_mode: str = "temporal"
    camera_height_m: float = 1.65
    camera_pitch_rad: float = 0.0
    pd_kp: float = 0.8
    pd_kd: float = 0.08
    target_frame_ms: float = 100.0


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    max_disparity: int = 128
    patch_radius: int = 3
    sgm_p1: float = 8.0
    sgm_p2: float = 96.0
    lr_check_px: float = 1.5
    uniq_ratio: float = 0.9
    use_sgm: bool = True
    cost_dtype: str = "float32"
    # both backends run kernel 2 (csrc/sgm.cu); they differ only in how the
    # four directions are summed
    sgm_backend: str = "xla"


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Local BA + pose graph capacities."""
    window_keyframes: int = 8
    max_landmarks: int = 1024
    max_obs_per_landmark: int = 8
    ba_iters: int = 12
    huber_px: float = 2.0
    outlier_px: float = 5.0
    pg_iters: int = 20
    max_pg_nodes: int = 256
    max_pg_edges: int = 512
    retrieval_capacity: int = 2048


@dataclasses.dataclass(frozen=True)
class SplatParams:
    """Forward-splat renderer caps (ops/splat.py SplatConfig)."""
    max_blocks: int = 4096
    max_voxels: int = 1 << 19
    surface_eta: float = 0.8
    z_bits: int = 12
    fill_levels: int = 3
    bleed_rel: float = 0.15
    bleed_abs: float = 0.5


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    fusion_db_capacity: int = 64
    fusion_db_quantized: bool = True
    keyframe_every: int = 1
    new_submap_threshold: float = -1.0
    use_external_odometry: bool = True
    bilateral_filter: bool = False
    sensor: str = "stereo"
    parallel_alloc: str = "exchange"
    renderer: str = "splat"
    splat_refine: int = 0
    splat_prune_sdf: float = 0.0
    map_memory_budget_mb: float = -1.0


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    rig: StereoRig
    tsdf: TsdfConfig = TsdfConfig()
    frontend: FrontendConfig = FrontendConfig()
    stereo: StereoConfig = StereoConfig()
    backend: BackendConfig = BackendConfig()
    pipeline: PipelineConfig = PipelineConfig()
    splat: SplatParams = SplatParams()
    decay: VoxelDecayParams = VoxelDecayParams()
    slide_window: SlideWindowParams = SlideWindowParams()
    correction: OnlineCorrectionParams = OnlineCorrectionParams()
    postprocess: PostProcessParams = PostProcessParams()


def tiny_test_config(width: int = 80, height: int = 60,
                     baseline_m: float = 0.12,
                     **overrides) -> SystemConfig:
    """Small config for unit tests (CPU-runnable)."""
    f = 0.75 * width
    intr = Intrinsics(fx=f, fy=f, cx=width / 2 - 0.5,
                      cy=height / 2 - 0.5, width=width, height=height)
    rig = StereoRig(intr=intr, baseline_m=baseline_m)
    tsdf = TsdfConfig(
        voxel_size_m=0.05,
        trunc_dist_m=0.2,
        table_slots=1 << 12,
        max_visible_blocks=1024,
        max_alloc_per_frame=1024,
        max_depth_m=10.0,
        raycast_steps=96,
    )
    cfg = SystemConfig(rig=rig, tsdf=tsdf)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
