"""Configuration tree mirroring the reference's ~80 rosparams.

Names and defaults follow the reference launch files and nodelet param reads
(reference: launch/hdl_graph_slam.launch:37-170 and the per-nodelet
``private_nh.param`` calls). Presets reproduce the four launch variants
(base, 501 indoor, 400 outdoor, kitti) per SURVEY.md §2.4.

A copy of hdl_graph_slam_tpu/core/config.py (numpy-free, framework-free):
the port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class PrefilterConfig:
    # apps/prefiltering_nodelet.cpp:52-103
    downsample_method: str = "VOXELGRID"  # VOXELGRID | APPROX_VOXELGRID | NONE
    downsample_resolution: float = 0.1
    outlier_removal_method: str = "STATISTICAL"  # STATISTICAL | RADIUS | NONE
    statistical_mean_k: int = 20
    statistical_stddev: float = 1.0
    radius_radius: float = 0.8
    radius_min_neighbors: int = 2
    use_distance_filter: bool = True
    distance_near_thresh: float = 1.0
    distance_far_thresh: float = 100.0
    deskewing: bool = False
    scan_period: float = 0.1


@dataclass
class RegistrationConfig:
    # src/hdl_graph_slam/registrations.cpp:22-124
    registration_method: str = "FAST_GICP"
    reg_num_threads: int = 0  # kept for config parity; TPU ignores it
    reg_transformation_epsilon: float = 0.01
    reg_maximum_iterations: int = 64
    reg_max_correspondence_distance: float = 2.5
    reg_correspondence_randomness: int = 20
    reg_resolution: float = 1.0  # VGICP voxel / NDT cell size
    reg_use_reciprocal_correspondences: bool = False
    reg_max_optimizer_iterations: int = 20
    reg_nn_search_method: str = "DIRECT7"  # KDTREE | DIRECT1 | DIRECT7 (NDT)
    # TPU-native knob (no reference analog): carry the correspondence /
    # NDT-cell association across optimizer iterations until the accumulated
    # per-point displacement bound exceeds this many meters (0.0 = the
    # reference's per-iteration re-association). The terminal pose always
    # satisfies the same fixed-point condition — convergence is only
    # declared on a fresh association (registration/base.py lm_loop,
    # registration/ndt.py). Saves the per-iteration NN / Mahalanobis /
    # voxel-gather work on TPU; 0.1 (GICP) and 0.5 (NDT, 2 m cells) are
    # endpoint-parity-tested settings (tests/test_registration.py).
    reg_reassoc_displacement: float = 0.0
    # physical span (m per axis) the NDT/VGICP dense voxel grid must cover —
    # the target cloud's extent, i.e. 2 * the prefilter far threshold. None
    # = derived from prefilter.distance_far_thresh when this config is wired
    # through SlamConfig (wire_derived below); standalone uses fall back to
    # ops.voxel.DENSE_GRID_SPAN_M (256 m = 2 * the largest preset threshold).
    reg_dense_span_m: "float | None" = None


@dataclass
class OdometryConfig:
    # apps/scan_matching_odometry_nodelet.cpp:63-96
    keyframe_delta_trans: float = 0.25
    keyframe_delta_angle: float = 0.15
    keyframe_delta_time: float = 1.0
    transform_thresholding: bool = False
    max_acceptable_trans: float = 1.0
    max_acceptable_angle: float = 1.0
    downsample_method: str = "NONE"
    downsample_resolution: float = 0.1
    enable_imu_frontend: bool = False  # msf EKF init-guess hook equivalent
    # external robot-odometry init guess (scan_matching_odometry_nodelet.cpp:
    # 193-207: tf delta of the sensor between prev_time and stamp in the
    # robot_odom frame). Feed poses via SlamPipeline.add_robot_odometry().
    enable_robot_odometry_init_guess: bool = False
    # constant-velocity warm start (opt-in; no reference analog — the
    # reference's zero-velocity guess is the default): seed each align with
    # prev_trans translated by the previous frame delta's TRANSLATION
    # (sanity-capped at 2 m/frame). Rotation is deliberately NOT
    # extrapolated: on attitude-jittered platforms it feeds each frame's
    # jitter forward into the next guess, which walked NDT out of its basin
    # and (uncapped) ran away geometrically — PERF.md round 5. Cuts
    # Newton/LM iterations for slow-converging methods where motion is
    # smooth. Do not combine with an external msf/robot-odometry guess
    # (both would be applied).
    constant_velocity_guess: bool = False
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)


@dataclass
class FloorDetectionConfig:
    # apps/floor_detection_nodelet.cpp:57-67
    enabled: bool = False
    tilt_deg: float = 0.0
    sensor_height: float = 2.0
    height_clip_range: float = 1.0
    floor_pts_thresh: int = 512
    floor_normal_thresh: float = 10.0
    use_normal_filtering: bool = True
    normal_filter_thresh: float = 20.0
    # RANSAC internals (pcl::RandomSampleConsensus defaults)
    ransac_distance_thresh: float = 0.1
    ransac_hypotheses: int = 1024  # batched hypotheses (PCL iterates sequentially)


@dataclass
class LoopDetectorConfig:
    # include/hdl_graph_slam/loop_detector.hpp:39-50
    distance_thresh: float = 5.0
    accum_distance_thresh: float = 8.0
    min_edge_interval: float = 5.0
    fitness_score_max_range: float = float("inf")
    fitness_score_thresh: float = 0.5
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    max_candidates: int = 8  # batched candidate alignments per new keyframe


@dataclass
class InformationMatrixConfig:
    # src/hdl_graph_slam/information_matrix_calculator.cpp:10-21
    use_const_inf_matrix: bool = False
    const_stddev_x: float = 0.5
    const_stddev_q: float = 0.1
    var_gain_a: float = 20.0
    min_stddev_x: float = 0.1
    max_stddev_x: float = 5.0
    min_stddev_q: float = 0.05
    max_stddev_q: float = 0.2
    fitness_score_thresh: float = 0.5


@dataclass
class BackendConfig:
    # apps/hdl_graph_slam_nodelet.cpp params
    keyframe_delta_trans: float = 2.0
    keyframe_delta_angle: float = 2.0
    max_keyframes_per_update: int = 10
    graph_update_interval: float = 3.0
    map_cloud_update_interval: float = 10.0
    map_cloud_resolution: float = 0.05
    fix_first_node: bool = False
    fix_first_node_stddev: str = "1 1 1 1 1 1"
    fix_first_node_adaptive: bool = True
    g2o_solver_type: str = "lm_var_cholmod"
    g2o_solver_num_iterations: int = 512
    # robust kernels per edge family (name, size); NONE disables
    odometry_edge_robust_kernel: str = "NONE"
    odometry_edge_robust_kernel_size: float = 1.0
    loop_closure_edge_robust_kernel: str = "Huber"
    loop_closure_edge_robust_kernel_size: float = 1.0
    gps_edge_robust_kernel: str = "NONE"
    gps_edge_robust_kernel_size: float = 1.0
    imu_orientation_edge_robust_kernel: str = "NONE"
    imu_orientation_edge_robust_kernel_size: float = 1.0
    imu_acceleration_edge_robust_kernel: str = "NONE"
    imu_acceleration_edge_robust_kernel_size: float = 1.0
    floor_edge_robust_kernel: str = "NONE"
    floor_edge_robust_kernel_size: float = 1.0
    # sensor fusion toggles / weights
    enable_gps: bool = True
    gps_time_offset: float = 0.0
    gps_edge_stddev_xy: float = 10000.0
    gps_edge_stddev_z: float = 10.0
    enable_imu_orientation: bool = False
    enable_imu_acceleration: bool = False
    imu_time_offset: float = 0.0
    imu_orientation_edge_stddev: float = 0.1
    imu_acceleration_edge_stddev: float = 3.0
    floor_edge_stddev: float = 10.0
    # --- TPU-native distribution / map scaling (no reference analog;
    # SURVEY.md §2.5 mapping, §5 "map scaling" slot) ---
    # optimize with edge-sharded LM over the jax device mesh (all local
    # devices; spans processes when jax.distributed is initialized)
    distributed: bool = False
    # >0: when the graph exceeds this many pose nodes, optimize via the
    # hierarchical submap partition (parallel/partition.py) — per-host
    # keyframe blocks refined independently + condensed base graph
    submap_block_size: int = 0


@dataclass
class SlamConfig:
    prefilter: PrefilterConfig = field(default_factory=PrefilterConfig)
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    floor: FloorDetectionConfig = field(default_factory=FloorDetectionConfig)
    loop: LoopDetectorConfig = field(default_factory=LoopDetectorConfig)
    information: InformationMatrixConfig = field(default_factory=InformationMatrixConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)


def wire_derived(cfg: SlamConfig) -> SlamConfig:
    """Fill in cross-section derived parameters (in place; returns cfg).

    reg_dense_span_m: the NDT/VGICP dense voxel grid must cover the target
    cloud's physical extent, which the prefilter bounds at
    2 * distance_far_thresh. Called by SlamPipeline/HdlGraphSlam so a
    non-preset far threshold > 128 m cannot silently shrink voxel coverage
    (ADVICE r2 — the grid span was a hardcoded 256 m)."""
    span = 2.0 * float(cfg.prefilter.distance_far_thresh)
    for reg in (cfg.odometry.registration, cfg.loop.registration):
        if reg.reg_dense_span_m is None:
            reg.reg_dense_span_m = span
    return cfg


def _apply(cfg: SlamConfig, **sections) -> SlamConfig:
    new = dataclasses.replace(cfg)
    for section, updates in sections.items():
        sub = dataclasses.replace(getattr(new, section), **updates)
        new = dataclasses.replace(new, **{section: sub})
    return new


def preset_base() -> SlamConfig:
    """launch/hdl_graph_slam.launch defaults."""
    cfg = SlamConfig()
    cfg = _apply(
        cfg,
        odometry=dict(keyframe_delta_trans=1.0, keyframe_delta_angle=1.0, keyframe_delta_time=10000.0),
        loop=dict(distance_thresh=20.0, accum_distance_thresh=35.0, min_edge_interval=5.0, fitness_score_thresh=0.5),
        backend=dict(keyframe_delta_trans=2.0),
        prefilter=dict(outlier_removal_method="NONE"),
    )
    return cfg


def preset_indoor() -> SlamConfig:
    """launch/hdl_graph_slam_501.launch (indoor, hdl_501)."""
    cfg = preset_base()
    cfg = _apply(
        cfg,
        prefilter=dict(outlier_removal_method="RADIUS", radius_radius=0.5, radius_min_neighbors=2),
        odometry=dict(keyframe_delta_trans=0.25),
        backend=dict(keyframe_delta_trans=1.0),
        loop=dict(distance_thresh=1.0, accum_distance_thresh=3.0, min_edge_interval=1.0, fitness_score_thresh=0.5),
        floor=dict(enabled=True),
    )
    return cfg


def preset_outdoor() -> SlamConfig:
    """launch/hdl_graph_slam_400.launch (outdoor, hdl_400)."""
    cfg = preset_base()
    cfg = _apply(
        cfg,
        prefilter=dict(outlier_removal_method="RADIUS"),
        odometry=dict(keyframe_delta_trans=1.0),
        backend=dict(keyframe_delta_trans=2.0),
        loop=dict(distance_thresh=15.0, accum_distance_thresh=25.0, min_edge_interval=15.0, fitness_score_thresh=2.5),
        floor=dict(enabled=True),
    )
    return cfg


def preset_kitti() -> SlamConfig:
    """launch/hdl_graph_slam_kitti.launch."""
    cfg = preset_base()
    cfg = _apply(
        cfg,
        prefilter=dict(downsample_resolution=0.25, outlier_removal_method="RADIUS", distance_far_thresh=100.0),
        odometry=dict(keyframe_delta_trans=5.0),
        backend=dict(keyframe_delta_trans=5.0, enable_gps=True),
        loop=dict(distance_thresh=30.0, accum_distance_thresh=25.0, min_edge_interval=15.0, fitness_score_thresh=2.5),
        floor=dict(enabled=True),
    )
    return cfg


def preset_imu() -> SlamConfig:
    """launch/hdl_graph_slam_imu.launch: IMU-deskewed NDT odometry (coarse
    10 m cells) with the msf EKF init-guess frontend enabled, GICP loop
    matching, 1.5 s backend cadence, floor detection off by default (the
    launch's enable_floor_detection arg defaults false)."""
    cfg = SlamConfig()
    cfg = _apply(
        cfg,
        prefilter=dict(
            deskewing=True, scan_period=0.1, use_distance_filter=True,
            distance_near_thresh=0.2, distance_far_thresh=100.0,
            downsample_method="VOXELGRID", downsample_resolution=0.1,
            outlier_removal_method="RADIUS", radius_radius=0.5, radius_min_neighbors=2,
        ),
        odometry=dict(
            enable_imu_frontend=True, keyframe_delta_trans=0.25,
            keyframe_delta_angle=2.0, keyframe_delta_time=10000.0,
            registration=RegistrationConfig(
                registration_method="NDT_OMP", reg_resolution=10.0,
                reg_nn_search_method="DIRECT7",
            ),
        ),
        loop=dict(
            distance_thresh=1.0, accum_distance_thresh=3.0,
            min_edge_interval=1.0, fitness_score_thresh=0.5,
            registration=RegistrationConfig(registration_method="GICP", reg_resolution=1.0),
        ),
        backend=dict(
            keyframe_delta_trans=1.0, keyframe_delta_angle=2.0,
            fix_first_node=True, fix_first_node_stddev="10 10 10 1 1 1",
            fix_first_node_adaptive=True,
            gps_edge_stddev_xy=20.0, gps_edge_stddev_z=5.0,
            imu_orientation_edge_stddev=1.0, imu_acceleration_edge_stddev=1.0,
            graph_update_interval=1.5, map_cloud_update_interval=3.0,
            map_cloud_resolution=0.01,
        ),
    )
    return cfg


PRESETS = {
    "base": preset_base,
    "indoor": preset_indoor,
    "hdl_501": preset_indoor,
    "outdoor": preset_outdoor,
    "hdl_400": preset_outdoor,
    "kitti": preset_kitti,
    "imu": preset_imu,
}
