"""The benchmark drives: ``bench.py``'s (make_course), reproduced scan for
scan, and the course and configuration of ``benchmarks/golden_town.py``.

A straight street drive through a lidar_sim town: 32x512-beam scans with
first-hit occlusion, range noise and dropout (~10-12k returns per frame),
from n_frames+1 sensor poses at ``step`` m/frame; scans[0] bootstraps the
keyframe. The sensor carries per-frame attitude jitter (roll/pitch ~
N(0, 0.4 deg)) and height jitter (z ~ N(0, 1 cm)). The random draws happen in
the same order as bench.py's, so the scans are identical.
"""

from __future__ import annotations

import numpy as np

from . import lidar_sim as L

BENCH_STEP = 0.08  # m/frame (0.8 m/s at 10 Hz)
BENCH_FRAMES = 256  # frames measured (frame 0 bootstraps the keyframe)
BENCH_RAW_CAPACITY = 16384


def bench_course_scene(seed: int = 0):
    """The bench course's town and lidar model: (town, model)."""
    return (L.make_town(seed=seed + 1, blocks=3),
            L.LidarModel(rings=32, azimuth_steps=512, max_range=60.0, range_noise=0.02, dropout=0.05))


def bench_course_poses(n_frames: int = BENCH_FRAMES, step: float = BENCH_STEP, seed: int = 0) -> list:
    """The n_frames+1 sensor poses (4, 4) of make_course, its random draws
    in bench.py's order; scan i is ``L.scan(town, poses[i], model,
    seed=100000 * seed + i)``."""
    rng = np.random.default_rng(777 + seed)
    poses = []
    for i in range(n_frames + 1):
        roll, pitch = rng.normal(0.0, np.deg2rad(0.4), 2)
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[0, 3] = -5.0 + step * i  # along the y=-5 street of the block grid
        T[1, 3] = -5.0
        T[2, 3] = 1.8 + rng.normal(0.0, 0.01)
        poses.append(T)
    return poses


def make_course(n_frames: int = BENCH_FRAMES, step: float = BENCH_STEP, seed: int = 0):
    """List of n_frames+1 raw scans, (M_i, 3) float32 in the sensor frame."""
    town, model = bench_course_scene(seed)
    return [L.scan(town, T, model, seed=100000 * seed + i)
            for i, T in enumerate(bench_course_poses(n_frames, step, seed))]


# -- benchmarks/golden_town.py's course, "base" and "floor" modes ----------------

GOLDEN_CLOUD_CAPACITY = 4096
GOLDEN_RAW_CAPACITY = 16384
GOLDEN_WINDOW = 16
GOLDEN_SENSOR_HEIGHT = 1.8


def golden_town_sensor_poses():
    """The 601 sensor poses of benchmarks/golden_town.py: two laps around a
    city block (town_course(blocks=2, loops=2, step=1.2)), 1.8 m above the
    ground; frame i is stamped float(i)."""
    out = []
    for pose in L.town_course(blocks=2, loops=2, step=1.2):
        sensor = pose.copy()
        sensor[2, 3] += GOLDEN_SENSOR_HEIGHT
        out.append(sensor)
    return out


def golden_town_scene():
    """(town, lidar model) of benchmarks/golden_town.py."""
    town = L.make_town(seed=1, blocks=3)
    model = L.LidarModel(rings=32, azimuth_steps=512, max_range=60.0, range_noise=0.02, dropout=0.05)
    return town, model


def golden_town_config(mode: str = "base"):
    """benchmarks/golden_town.py make_cfg(mode), mode "base" or "floor".
    base: FAST_GICP odometry and loop matching with 0.1 m gated
    re-association, 0.5 m voxels out to 60 m, 4 m keyframes, the
    reference's outdoor loop gates (15 / 25 / 15 m, fitness 2.5), 60 LM
    iterations per cycle, a 10 s cycle, floor off. floor
    (golden_town.py:94-101): floor detection on, sensor height 1.8 m, a
    1 m clip band, 256 floor points at least."""
    from ..core.config import RegistrationConfig, SlamConfig

    if mode not in ("base", "floor"):
        raise ValueError(f"golden_town mode {mode!r}: the port has base and floor")

    reg = RegistrationConfig(registration_method="FAST_GICP", reg_reassoc_displacement=0.1)
    cfg = SlamConfig()
    cfg.prefilter.downsample_resolution = 0.5
    cfg.prefilter.outlier_removal_method = "NONE"
    cfg.prefilter.distance_far_thresh = 60.0
    cfg.odometry.registration = reg
    cfg.odometry.keyframe_delta_trans = 4.0
    cfg.odometry.keyframe_delta_time = 1e9
    cfg.backend.keyframe_delta_trans = 4.0
    cfg.backend.fix_first_node = True
    cfg.backend.fix_first_node_stddev = "10 10 1000 1 1 1"
    cfg.backend.g2o_solver_num_iterations = 60
    cfg.backend.graph_update_interval = 10.0
    cfg.loop.registration = reg
    cfg.loop.distance_thresh = 15.0
    cfg.loop.accum_distance_thresh = 25.0
    cfg.loop.min_edge_interval = 15.0
    cfg.loop.fitness_score_thresh = 2.5
    cfg.floor.enabled = mode == "floor"
    if mode == "floor":
        cfg.floor.sensor_height = GOLDEN_SENSOR_HEIGHT
        cfg.floor.height_clip_range = 1.0
        cfg.floor.floor_pts_thresh = 256
    return cfg


def golden_town_outdoor_config():
    """golden_town "floor" with the outdoor (hdl_400) preset's prefilter
    outlier filter (core/config.py preset_outdoor): RADIUS, 0.8 m, at least
    2 neighbours."""
    cfg = golden_town_config("floor")
    cfg.prefilter.outlier_removal_method = "RADIUS"
    cfg.prefilter.radius_radius = 0.8
    cfg.prefilter.radius_min_neighbors = 2
    return cfg


GRAVITY = 9.80665


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z), w >= 0, of a rotation matrix."""
    w = 0.5 * np.sqrt(max(0.0, 1.0 + np.trace(R)))
    if w > 1e-3:
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (4.0 * w)
        return np.concatenate([[w], v])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q if q[0] >= 0 else -q


def _so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation vector of a rotation matrix (angles below pi)."""
    c = np.clip(0.5 * (np.trace(R) - 1.0), -1.0, 1.0)
    theta = np.arccos(c)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return 0.5 * v if theta < 1e-8 else theta / (2.0 * np.sin(theta)) * v


def golden_town_imu(truth, lead: float = 0.05) -> list:
    """IMU messages for golden_town built from its truth sensor poses, one
    per frame, frame i's stamped float(i) - lead: (stamp, orientation
    (w, x, y, z) of R_i, the specific force R_i^T (0, 0, g) of a sensor
    at rest under gravity, the body angular velocity log(R_{i-1}^T R_i) /
    1 s, the frames being 1 s apart (zero for frame 0)). Feed each with
    SlamPipeline.add_imu before its frame."""
    out = []
    for i, T in enumerate(truth):
        R = np.asarray(T, dtype=np.float64)[:3, :3]
        w = _so3_log(np.asarray(truth[i - 1], dtype=np.float64)[:3, :3].T @ R) if i else np.zeros(3)
        out.append((float(i) - lead, _quat_wxyz(R), R.T @ np.array([0.0, 0.0, GRAVITY]), w))
    return out
