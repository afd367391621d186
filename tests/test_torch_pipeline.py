"""The port's slice end to end on the CPU: SlamPipeline.run_windowed
(hdl_graph_slam_tpu_torch/pipeline.py) against the JAX pipeline on a cut
course, plus the port's guards for this slice (no quiet CPU fallback, every
branch left out raises naming its ROADMAP item).

The course is tests/test_golden.py's occluded room square
(test_golden_square_loop_ate: ray-cast frames, 1.5 m steps) driven once and
then 11 frames on into a second lap (40 frames, three loop closures), with
floor detection off and the clouds cut to 2048 rows on a 0.5 m grid.
"""

import functools

import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core.config import RegistrationConfig as JRegistrationConfig
from hdl_graph_slam_tpu.core.config import SlamConfig as JSlamConfig
from hdl_graph_slam_tpu.pipeline import SlamPipeline as JSlamPipeline
from hdl_graph_slam_tpu_torch.core.config import RegistrationConfig, SlamConfig
from hdl_graph_slam_tpu_torch.io import trajectory as traj_io
from hdl_graph_slam_tpu_torch.pipeline import AsyncBackend, SlamPipeline
from test_golden import room_scan
from test_pipeline import drive_square

WINDOW = 8
CLOUD_CAPACITY = 2048
RAW_CAPACITY = 4096


def course_cfg(cfg, reg_cls):
    """test_golden_square_loop_ate's config, floor off, 0.5 m voxels,
    keyframes every 3 m (every second frame on a side, 1 m clear of the
    admission threshold)."""
    reg = reg_cls(registration_method="FAST_GICP", reg_reassoc_displacement=0.1)
    cfg.prefilter.downsample_resolution = 0.5
    cfg.prefilter.outlier_removal_method = "NONE"
    cfg.odometry.registration = reg
    cfg.odometry.keyframe_delta_trans = 2.0
    cfg.odometry.keyframe_delta_time = 1e9
    cfg.backend.keyframe_delta_trans = 2.0
    cfg.backend.fix_first_node = True
    cfg.backend.fix_first_node_stddev = "10 10 1000 1 1 1"
    cfg.backend.g2o_solver_num_iterations = 60
    cfg.backend.graph_update_interval = 8.0
    cfg.loop.registration = reg
    cfg.loop.distance_thresh = 3.0
    cfg.loop.accum_distance_thresh = 8.0
    cfg.loop.min_edge_interval = 4.0
    cfg.loop.fitness_score_thresh = 1.0
    return cfg


@functools.lru_cache(maxsize=1)
def course():
    poses = drive_square(side=4.5, step=1.5, turn_steps=4)
    poses = poses + [poses[-1] @ p for p in poses[1:12]]
    truth, frames = [], []
    for i, pose in enumerate(poses):
        sensor = pose.copy()
        sensor[2, 3] += 1.8
        truth.append((float(i), sensor))
        frames.append((float(i), room_scan(sensor, seed=i), None))
    return frames, truth


def test_run_windowed_matches_jax_pipeline():
    """run_windowed on both sides: the same frame and keyframe count, the
    same keyframe stamps and loop-edge vertex pairs, odometry poses within
    2e-3 m/rad (the odometry window's parity tolerance,
    test_torch_window.py) and optimized keyframe poses within 5e-3 m (the
    odometry differences carried through the graph); optimization beats the
    odometry on ATE on both sides."""
    frames, truth = course()
    pipe = SlamPipeline(course_cfg(SlamConfig(), RegistrationConfig), cloud_capacity=CLOUD_CAPACITY, device="cpu")
    res = pipe.run_windowed(list(frames), window=WINDOW, raw_capacity=RAW_CAPACITY)
    pipe_j = JSlamPipeline(course_cfg(JSlamConfig(), JRegistrationConfig), cloud_capacity=CLOUD_CAPACITY)
    res_j = pipe_j.run_windowed(list(frames), window=WINDOW, raw_capacity=RAW_CAPACITY)

    assert res.num_frames == res_j.num_frames == len(frames)
    assert res.num_keyframes == res_j.num_keyframes
    for (s, T), (sj, Tj) in zip(res.odometry_trajectory, res_j.odometry_trajectory):
        assert s == sj
        np.testing.assert_allclose(T, Tj, atol=2e-3)
    assert [s for s, _ in res.trajectory] == [s for s, _ in res_j.trajectory]
    rows, rows_j = pipe.slam.graph.edge_rows["se3_se3"], pipe_j.slam.graph.edge_rows["se3_se3"]
    assert [(r["vi"], r["vj"]) for r in rows] == [(r["vi"], r["vj"]) for r in rows_j]
    n_loops = len(rows) - (res.num_keyframes - 1) - 1  # chain + anchor
    assert n_loops >= 2
    for (_, T), (_, Tj) in zip(res.trajectory, res_j.trajectory):
        np.testing.assert_allclose(T[:3, 3], Tj[:3, 3], atol=5e-3)
    kf = {s for s, _ in res.trajectory}
    odom_kf = [(s, T) for s, T in res.odometry_trajectory if s in kf]
    assert traj_io.ate_rmse(res.trajectory, truth) < traj_io.ate_rmse(odom_kf, truth)
    Rs = np.stack([T[:3, :3] for _, T in res.odometry_trajectory])
    assert np.abs(np.linalg.det(Rs) - 1.0).max() < 1e-4


def test_unported_pipeline_branches_raise():
    """What the port had not: the backend on a worker thread (item 13), NDT
    odometry (item 8) and VGICP odometry (item 7) are ported: AsyncBackend
    builds, run_windowed(overlap_backend=True) runs, and pipelines with
    NDT_OMP and FAST_VGICP odometry run frames per frame and windowed."""
    cfg = course_cfg(SlamConfig(), RegistrationConfig)
    pipe = SlamPipeline(cfg, cloud_capacity=CLOUD_CAPACITY, device="cpu")
    frames, _ = course()
    assert pipe.run_windowed(frames[:2], overlap_backend=True, raw_capacity=RAW_CAPACITY).num_frames == 2
    assert AsyncBackend(pipe.slam).interval == cfg.backend.graph_update_interval
    cfg = course_cfg(SlamConfig(), RegistrationConfig)
    cfg.odometry.registration = RegistrationConfig(registration_method="NDT_OMP", reg_resolution=2.0)
    res = SlamPipeline(cfg, cloud_capacity=CLOUD_CAPACITY, device="cpu").run(frames[:3])
    assert res.num_frames == 3 and np.isfinite(np.stack([T for _, T in res.odometry_trajectory])).all()
    res = SlamPipeline(cfg, cloud_capacity=CLOUD_CAPACITY, device="cpu").run_windowed(frames[:3],
                                                                                       raw_capacity=RAW_CAPACITY)
    assert res.num_frames == 3
    cfg.odometry.registration = RegistrationConfig(registration_method="FAST_VGICP", reg_resolution=1.0)
    res = SlamPipeline(cfg, cloud_capacity=CLOUD_CAPACITY, device="cpu").run_windowed(frames[:3],
                                                                                       raw_capacity=RAW_CAPACITY)
    assert res.num_frames == 3 and np.isfinite(np.stack([T for _, T in res.odometry_trajectory])).all()


def test_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        assert SlamPipeline().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SlamPipeline()
