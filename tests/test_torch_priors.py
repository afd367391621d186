"""Parity of the port's GPS and IMU priors through the backend
(hdl_graph_slam_tpu_torch/backend/slam.py _flush_gps_queue and
_flush_imu_queue) with the JAX backend, on the CPU.

Mirrors tests/test_pipeline.py::test_gps_constraints (with an XYZ and an
XY-only fix) and, at a cut size, tests/test_golden.py::
test_golden_gps_imu_course: the UTM datum, XY against XYZ priors, the
quaternion sign rule and the gravity vector, with the same measurements fed
to both backends.
"""

import math

import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.backend import GpsMeasurement as JGpsMeasurement
from hdl_graph_slam_tpu.backend import HdlGraphSlam as JHdlGraphSlam
from hdl_graph_slam_tpu.backend import ImuMeasurement as JImuMeasurement
from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import SlamConfig as JSlamConfig
from hdl_graph_slam_tpu_torch.backend import GpsMeasurement, HdlGraphSlam, ImuMeasurement
from hdl_graph_slam_tpu_torch.core import cloud, se3
from hdl_graph_slam_tpu_torch.core.config import SlamConfig
from hdl_graph_slam_tpu_torch.io import trajectory as traj_io
from hdl_graph_slam_tpu_torch.io.geodesy import wgs84_to_utm
from test_golden import TOWN, TOWN_MODEL, L, _drifted_odometry


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's CPU work: the tier-1 lane runs
    six workers on the machine's cores, where more threads a worker only
    contend (as tests/test_torch_cli.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PRIOR_TABLES = ("se3_prior_xy", "se3_prior_xyz", "se3_prior_quat", "se3_prior_vec")


def both_backends(setup):
    """(port, JAX) backends with the same configuration edits."""
    cfg, cfg_j = SlamConfig(), JSlamConfig()
    setup(cfg)
    setup(cfg_j)
    return HdlGraphSlam(cfg, device="cpu"), JHdlGraphSlam(cfg_j)


def assert_priors_equal(slam, slam_j):
    """Every prior table: the same nodes, measurements and information."""
    for name in PRIOR_TABLES:
        rows, rows_j = slam.graph.edge_rows[name], slam_j.graph.edge_rows[name]
        assert len(rows) == len(rows_j), name
        for r, rj in zip(rows, rows_j):
            assert r["vi"] == rj["vi"]
            np.testing.assert_array_equal(np.asarray(r["meas"]), np.asarray(rj["meas"]))
            np.testing.assert_array_equal(np.asarray(r["info"]), np.asarray(rj["info"]))


@pytest.mark.parametrize("alt", [10.0, math.nan], ids=["xyz", "xy"])
def test_gps_constraints_match_jax(alt):
    """test_gps_constraints: GPS fixes 1 m apart east anchor the graph in the
    UTM frame. The same datum (zero_utm), the same keyframes with UTM
    coordinates, the same XYZ (altitude given) or XY (NaN altitude, the NMEA
    path) prior edges, and optimized poses within 1e-6 m of JAX's (one
    float64 graph)."""

    def setup(cfg):
        cfg.backend.gps_edge_stddev_xy = 1.0
        cfg.backend.keyframe_delta_trans = 0.5
        cfg.backend.max_keyframes_per_update = 100

    slam, slam_j = both_backends(setup)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    lat0, lon0 = 35.0, 139.0
    for i in range(12):
        T = np.eye(4)
        T[0, 3] = float(i)
        slam.add_frame(float(i), T, cloud.from_numpy(pts, device="cpu"))
        slam_j.add_frame(float(i), T, jcloud.from_numpy(pts))
        dlon = i * 1.0 / (111320.0 * np.cos(np.radians(lat0)))
        slam.add_gps(GpsMeasurement(stamp=float(i), lat=lat0, lon=lon0 + dlon, alt=alt))
        slam_j.add_gps(JGpsMeasurement(stamp=float(i), lat=lat0, lon=lon0 + dlon, alt=alt))
    for s in (slam, slam_j):
        s.optimize_cycle()
        s.optimize_cycle()
    np.testing.assert_array_equal(slam.zero_utm, slam_j.zero_utm)
    n_utm = sum(1 for k in slam.keyframes if k.utm_coord is not None)
    assert n_utm == sum(1 for k in slam_j.keyframes if k.utm_coord is not None)
    assert n_utm >= len(slam.keyframes) - 2
    table = "se3_prior_xyz" if alt == alt else "se3_prior_xy"
    assert len(slam.graph.edge_rows[table]) == n_utm
    assert_priors_equal(slam, slam_j)
    est, est_j = slam.trajectory(), slam_j.trajectory()
    assert [s for s, _ in est] == [s for s, _ in est_j]
    np.testing.assert_allclose(np.stack([T for _, T in est]), np.stack([np.asarray(T) for _, T in est_j]), atol=1e-6)


def test_gps_imu_course_matches_jax():
    """test_golden_gps_imu_course at a cut size (8 of its 16 frames, town
    scans at 4096 rows): drifted odometry with GPS XYZ priors and IMU
    orientation and gravity priors. Every second quaternion is given with a
    negative w (the same rotation; both backends flip it). The same prior
    tables as JAX's, optimized poses within 1e-4 m of JAX's, and JAX's own
    gates: unaligned ATE below 0.3 x the odometry's and below 0.1 m."""
    n = 8
    truth_sensor = []
    for i in range(n):
        T = np.eye(4)
        ang = 0.04 * i
        T[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
        T[0, 3] = 1.2 * i
        T[1, 3] = 0.02 * i * i
        T[2, 3] = 1.8
        truth_sensor.append(T)
    odo = _drifted_odometry(truth_sensor, yaw_bias=0.01, trans_bias=0.03)

    def setup(cfg):
        cfg.backend.keyframe_delta_trans = 1.0
        cfg.backend.max_keyframes_per_update = 100
        cfg.backend.g2o_solver_num_iterations = 80
        cfg.backend.gps_edge_stddev_xy = 0.05
        cfg.backend.gps_edge_stddev_z = 0.1
        cfg.backend.enable_imu_orientation = True
        cfg.backend.enable_imu_acceleration = True
        cfg.backend.imu_orientation_edge_stddev = 0.05
        cfg.backend.imu_acceleration_edge_stddev = 0.1
        cfg.loop.distance_thresh = 0.0

    slam, slam_j = both_backends(setup)
    lat0, lon0 = 35.0, 139.0
    e0, n0, _ = wgs84_to_utm(lat0, lon0)
    h = 1e-6
    e_lat, n_lat, _ = wgs84_to_utm(lat0 + h, lon0)
    e_lon, n_lon, _ = wgs84_to_utm(lat0, lon0 + h)
    Jinv = np.linalg.inv(np.array([[(e_lat - e0) / h, (e_lon - e0) / h], [(n_lat - n0) / h, (n_lon - n0) / h]]))
    for i, T in enumerate(truth_sensor):
        scan = L.scan(TOWN, T, TOWN_MODEL, seed=i)
        slam.add_frame(float(i), odo[i], cloud.from_numpy(scan, capacity=4096, device="cpu"))
        slam_j.add_frame(float(i), odo[i], jcloud.from_numpy(scan, capacity=4096))
        dlat, dlon = Jinv @ np.array([T[0, 3], T[1, 3]])
        fix = dict(stamp=float(i), lat=lat0 + dlat, lon=lon0 + dlon, alt=10.0 + T[2, 3])
        slam.add_gps(GpsMeasurement(**fix))
        slam_j.add_gps(JGpsMeasurement(**fix))
        q = se3.quat_from_mat(torch.from_numpy(T[:3, :3])).numpy() * (-1.0 if i % 2 else 1.0)
        accel = T[:3, :3].T @ np.array([0.0, 0.0, -1.0]) * 9.80665
        slam.add_imu(ImuMeasurement(stamp=float(i), orientation=q, acceleration=accel))
        slam_j.add_imu(JImuMeasurement(stamp=float(i), orientation=q, acceleration=accel))
    slam.flush()
    slam_j.flush()

    assert_priors_equal(slam, slam_j)
    assert all(np.asarray(r["meas"])[0] >= 0 for r in slam.graph.edge_rows["se3_prior_quat"])
    est, est_j = slam.trajectory(), slam_j.trajectory()
    assert [s for s, _ in est] == [s for s, _ in est_j]
    np.testing.assert_allclose(np.stack([T for _, T in est]), np.stack([np.asarray(T) for _, T in est_j]), atol=1e-4)
    for name in ("se3_prior_xyz", "se3_prior_quat", "se3_prior_vec"):
        assert len(slam.graph.edge_rows[name]) >= len(slam.keyframes) - 2, name
    datum = truth_sensor[0][:3, 3]
    truth_anchored = []
    for i, T in enumerate(truth_sensor):
        Ta = T.copy()
        Ta[:3, 3] -= datum
        truth_anchored.append((float(i), Ta))
    kf_stamps = {t for t, _ in est}
    odom_traj = [(float(i), odo[i]) for i in range(n) if float(i) in kf_stamps]
    ate_opt = traj_io.ate_rmse(est, truth_anchored, align=False)
    ate_odom = traj_io.ate_rmse(odom_traj, [(float(i), T) for i, T in enumerate(truth_sensor)], align=True)
    assert ate_odom > 0.05, ate_odom
    assert ate_opt < 0.3 * ate_odom and ate_opt < 0.1, (ate_opt, ate_odom)
