"""Parity of the port's per-frame frontend with the JAX reference, on the CPU:
the radius count and exact k-NN (hdl_graph_slam_tpu_torch/ops/knn.py), the
outlier filters and plane clip (ops/filters.py, frontend/prefilter.py), the
IMU predictor (frontend/imu_prediction.py), ScanMatchingOdometry
(frontend/odometry.py) and the per-frame pipeline (pipeline.py run /
process_frame with floor detection and the RADIUS filter).

Inputs are float32 arrays made with numpy from a seed and fed to both sides.
On CPU tensors the kernel wrappers run their plain twins; chip_smoke.py holds
the kernels against those on the card. Tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import OdometryConfig as JOdometryConfig
from hdl_graph_slam_tpu.core.config import PrefilterConfig as JPrefilterConfig
from hdl_graph_slam_tpu.core.config import RegistrationConfig as JRegistrationConfig
from hdl_graph_slam_tpu.core.config import SlamConfig as JSlamConfig
from hdl_graph_slam_tpu.frontend import ScanMatchingOdometry as JScanMatchingOdometry
from hdl_graph_slam_tpu.frontend.imu_prediction import ImuPredictor as JImuPredictor
from hdl_graph_slam_tpu.frontend.prefilter import Prefilter as JPrefilter
from hdl_graph_slam_tpu.ops import filters as jfilters
from hdl_graph_slam_tpu.ops import knn as jknn
from hdl_graph_slam_tpu.pipeline import SlamPipeline as JSlamPipeline
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import OdometryConfig, PrefilterConfig, RegistrationConfig, SlamConfig
from hdl_graph_slam_tpu_torch.frontend import Prefilter, ScanMatchingOdometry
from hdl_graph_slam_tpu_torch.frontend.imu_prediction import ImuPredictor
from hdl_graph_slam_tpu_torch.io import trajectory as traj_io
from hdl_graph_slam_tpu_torch.ops import filters, knn
from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline
from test_pipeline import drive_square, make_world, scan_at
from test_torch_pipeline import CLOUD_CAPACITY, course, course_cfg

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def world():
    return make_world()


def padded(rng, n, n_pad, half=4.0):
    x = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    x[n - n_pad:] = cloud.PAD_COORD
    return x


def lattice(rng, side=8):
    g = np.arange(side, dtype=np.float32)
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return x[rng.permutation(np.r_[np.arange(len(x)), rng.integers(0, len(x), 64)])]


# -- ops/knn.py: radius_count, knn -----------------------------------------------


@pytest.mark.parametrize("case", ["uniform", "lattice"])
def test_radius_count_matches_jax(case):
    """Counts within r, self included. The JAX op expands |q|^2 - 2 q.t +
    |t|^2, the port takes the difference form: on uniform points the counts
    are equal on every row but rows holding a pair with |d^2 - r^2| <=
    10 eps32 (|q|^2 + |t|^2), the expanded form's rounding. On an integer
    lattice with r = 1 every d^2 is exact, so the strict < must give equal
    counts on every row."""
    rng = np.random.default_rng(70)
    if case == "uniform":
        q, t, r = padded(rng, 700, 0), padded(rng, 1500, 100), 0.8
    else:
        q = t = lattice(rng)
        r = 1.0
    got = knn.radius_count(torch.from_numpy(q), torch.from_numpy(t), r).numpy()
    ref = np.asarray(jknn.radius_count(jnp.asarray(q), jnp.asarray(t), r))
    assert got.dtype == np.int32 and got.shape == (q.shape[0],)
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    d2 = ((q64[:, None] - t64[None]) ** 2).sum(-1)
    exact = (d2 < r * r).sum(-1)
    if case == "lattice":
        np.testing.assert_array_equal(got, exact)
        np.testing.assert_array_equal(ref, exact)
        return
    near = (np.abs(d2 - r * r) <= 10 * EPS32 * ((q64 ** 2).sum(-1)[:, None] + (t64 ** 2).sum(-1)[None])).any(-1)
    assert near.mean() < 0.05
    np.testing.assert_array_equal(got[~near], ref[~near])
    np.testing.assert_array_equal(got[~near], exact[~near])
    assert (exact > 1).mean() > 0.5  # the radius reaches neighbours


@pytest.mark.parametrize("k", [10, 21])
def test_knn_matches_jax(k):
    """Exact k-NN at the floor normals' k (10) and the statistical filter's
    mean_k + 1 (21): the same indices on every valid row (uniform points have
    no exact ties) and exact squared distances within 1e-5 relative (the two
    sides sum the three squares in another order)."""
    rng = np.random.default_rng(71 + k)
    x = padded(rng, 1200, 100)
    i_t, d_t = knn.knn(torch.from_numpy(x), torch.from_numpy(x), k)
    i_j, d_j = jknn.knn(jnp.asarray(x), jnp.asarray(x), k)
    assert i_t.dtype == torch.int32 and i_t.shape == (1200, k)
    np.testing.assert_array_equal(i_t.numpy()[:1100], np.asarray(i_j)[:1100])
    np.testing.assert_allclose(d_t.numpy()[:1100], np.asarray(d_j)[:1100], rtol=1e-5, atol=1e-7)
    assert (d_t[:, 1:] >= d_t[:, :-1]).all()


def test_knn_and_radius_count_never_fall_back():
    """A device other than the CPU never takes the plain twins; the CPU path
    launches no kernel."""
    meta = torch.zeros(30, 3, device="meta")
    with pytest.raises(ValueError):
        knn.radius_count(meta, meta, 0.5)
    with pytest.raises(ValueError):
        knn.knn(meta, meta, 10)
    x = torch.zeros(30, 3)
    before = knn.radius_count.launches
    assert knn.radius_count(x, x, 0.5).tolist() == [30] * 30
    assert knn.radius_count.launches == before


# -- ops/filters.py, frontend/prefilter.py ---------------------------------------


def scan_cloud(world, seed, capacity=4096):
    scan = scan_at(world, np.eye(4), seed=seed, n_keep=3000).astype(np.float32)
    # a few isolated points for the outlier filters to remove
    outliers = np.random.default_rng(seed).uniform(-20, 20, (40, 3)).astype(np.float32)
    xyz = np.concatenate([scan, outliers])
    return cloud.from_numpy(xyz, capacity=capacity, device="cpu"), jcloud.from_numpy(xyz, capacity=capacity)


@pytest.mark.parametrize("name", ["statistical", "radius", "clip_keep", "clip_drop"])
def test_filters_match_jax(world, name):
    """The filters' masks equal the JAX filters' on a room scan with
    outliers (statistical: mean_k 20, 1 std; radius: 0.5 m, 2 neighbours;
    the plane clip of the floor detector's band, both polarities). The kept
    xyz equal exactly (masking moves no point)."""
    c, jc = scan_cloud(world, 5)
    plane = np.array([0.0, 0.0, 1.0, 1.3], np.float32)
    if name == "statistical":
        out, ref = filters.statistical_outlier_removal(c, 20, 1.0), jfilters.statistical_outlier_removal(jc, 20, 1.0)
    elif name == "radius":
        out, ref = filters.radius_outlier_removal(c, 0.5, 2), jfilters.radius_outlier_removal(jc, 0.5, 2)
    else:
        neg = name == "clip_drop"
        out = filters.plane_clip(c, torch.from_numpy(plane), negative=neg)
        ref = jfilters.plane_clip(jc, jnp.asarray(plane), negative=neg)
    m = out.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(ref.mask))
    assert 0 < m.sum() < c.mask.sum()
    np.testing.assert_array_equal(out.xyz.numpy(), np.asarray(ref.xyz))


@pytest.mark.parametrize("method", ["STATISTICAL", "RADIUS"])
def test_prefilter_outlier_branch_matches_jax(world, method):
    """The prefilter chain with each outlier branch after the 0.2 m voxel
    grid: the same voxels kept; centroids within 1e-5 m (the JAX test of
    the chain without the filters holds the same, test_torch_ops.py)."""
    scan = scan_at(world, np.eye(4), seed=6, n_keep=3000).astype(np.float32)
    kw = dict(downsample_resolution=0.2, outlier_removal_method=method, radius_radius=0.5)
    out = Prefilter(PrefilterConfig(**kw), out_capacity=2048, device="cpu")(
        cloud.from_numpy(scan, capacity=4096, device="cpu"))
    ref = JPrefilter(JPrefilterConfig(**kw), out_capacity=2048)(jcloud.from_numpy(scan, capacity=4096))
    m = out.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(ref.mask))
    assert 0 < m.sum() < (np.abs(out.xyz.numpy()) < 1e5).all(-1).sum() + 1
    np.testing.assert_allclose(out.xyz.numpy()[m], np.asarray(ref.xyz)[m], atol=1e-5)


def golden_reference_tool():
    """tools/golden_town_reference.py, the JAX side's golden_town driver."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "golden_town_reference.py")
    spec = importlib.util.spec_from_file_location("golden_town_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["base", "floor", "outdoor"])
def test_golden_town_configs_match_the_reference_tool(mode):
    """utils/course.py's golden_town configurations equal, field for field,
    the ones tools/golden_town_reference.py runs through the JAX package."""
    import dataclasses

    from hdl_graph_slam_tpu_torch.utils import course as tcourse

    ours = tcourse.golden_town_outdoor_config() if mode == "outdoor" else tcourse.golden_town_config(mode)
    assert dataclasses.asdict(ours) == dataclasses.asdict(golden_reference_tool().make_cfg(mode))


@pytest.mark.parametrize("frame", [0, 120, 240, 360, 480, 600])
def test_outdoor_prefilter_matches_jax_on_golden_town(frame):
    """golden_town frame ``frame`` (16384-row raw capacity, 4096-row cloud)
    through the outdoor configuration's prefilter, 0.5 m voxels then RADIUS
    0.8 m / 2 neighbours, on both sides: the port casts the same scan as the
    JAX package's lidar_sim, bit for bit; the same rows survive the filter
    on every frame sampled (no radius count crosses the gate within rounding
    of r^2 here); centroids within 1e-5 m, as the prefilter chain's test."""
    import chip_smoke
    from hdl_graph_slam_tpu_torch.utils import course as tcourse

    tool = golden_reference_tool()
    xyz = chip_smoke._golden_scan(frame)
    np.testing.assert_array_equal(xyz, tool.cast(frame))

    def ours(cfg):
        return Prefilter(cfg.prefilter, out_capacity=tcourse.GOLDEN_CLOUD_CAPACITY, device="cpu")(
            cloud.from_numpy(xyz, capacity=tcourse.GOLDEN_RAW_CAPACITY, device="cpu"))

    out = ours(tcourse.golden_town_outdoor_config())
    ref = JPrefilter(tool.make_cfg("outdoor").prefilter, out_capacity=tool.CLOUD_CAPACITY)(
        jcloud.from_numpy(xyz, capacity=tool.RAW_CAPACITY))
    m = out.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(ref.mask))
    assert 1000 < m.sum() < ours(tcourse.golden_town_config("floor")).mask.sum()  # RADIUS removes voxels
    np.testing.assert_allclose(out.xyz.numpy()[m], np.asarray(ref.xyz)[m], atol=1e-5)


# -- frontend/imu_prediction.py --------------------------------------------------


def test_imu_predictor_matches_jax():
    """Deltas over five frames of 100 Hz gyro and accelerometer samples
    (random, seeded), a frame without samples and a repeated stamp: within
    1e-6 (the JAX side's so3_exp runs in float64 under the tests' x64)."""
    rng = np.random.default_rng(9)
    ours, ref = ImuPredictor(), JImuPredictor()
    stamps = [0.0, 0.1, 0.2, 0.2, 0.35, 0.5]
    t = 0.0
    for p in (ours, ref):
        p.predict_delta(stamps[0])
    samples = []
    while t < 0.5:
        t += 0.01
        if 0.2 < t < 0.3:
            continue  # no samples between those frames
        samples.append((t, rng.normal(0, 0.5, 3), rng.normal(0, 0.3, 3) + [0.0, 0.0, 9.80665]))
    for p in (ours, ref):
        for s in samples:
            p.add_imu(*s)
    for stamp in stamps[1:]:
        np.testing.assert_allclose(ours.predict_delta(stamp), ref.predict_delta(stamp), atol=1e-6)
    ours.reset()
    np.testing.assert_array_equal(ours.predict_delta(1.0), np.eye(4))


# -- frontend/odometry.py ----------------------------------------------------------


def odom_cfg(cls, reg_cls):
    return cls(keyframe_delta_trans=2.0, keyframe_delta_angle=0.8, keyframe_delta_time=1e9,
               transform_thresholding=True, max_acceptable_trans=1.5,
               registration=reg_cls(registration_method="FAST_GICP"))


def test_scan_matching_odometry_matches_jax(world):
    """ScanMatchingOdometry over 14 frames of a square drive (keyframe
    switches on translation and angle), every third frame with an exact
    robot-odometry delta as init guess: poses within 2e-3 m/rad (the
    odometry window's parity tolerance, test_torch_window.py), and the
    status: the same convergence flag and labels, matching error within
    1e-3 relative, inlier fraction within 1e-3, relative pose and
    prediction error within 2e-3."""
    ours = ScanMatchingOdometry(odom_cfg(OdometryConfig, RegistrationConfig), device="cpu")
    ref = JScanMatchingOdometry(odom_cfg(JOdometryConfig, JRegistrationConfig))
    poses = drive_square(side=4.0, step=1.0, turn_steps=6)[:14]
    switches = 0
    for i, pose in enumerate(poses):
        scan = scan_at(world, pose, seed=i)
        delta = np.linalg.inv(poses[i - 1]) @ pose if i and i % 3 == 0 else None
        kf = ours.keyframe
        got = ours.step(float(i) * 0.1, cloud.from_numpy(scan, capacity=2560, device="cpu"), msf_delta=delta,
                        msf_source="odometry")
        want = ref.step(float(i) * 0.1, jcloud.from_numpy(scan, capacity=2560), msf_delta=delta,
                        msf_source="odometry")
        switches += kf is not None and ours.keyframe is not kf
        assert got.dtype == np.float64 and got.shape == (4, 4)
        np.testing.assert_allclose(got, want, atol=2e-3)
        np.testing.assert_allclose(ours.keyframe_pose, ref.keyframe_pose, atol=2e-3)
        if i == 0:
            assert ours.last_status is None
            continue
        s, sj = ours.last_status, ref.last_status
        assert s.has_converged == sj.has_converged and s.prediction_labels == sj.prediction_labels
        np.testing.assert_allclose(s.matching_error, sj.matching_error, rtol=1e-3)
        np.testing.assert_allclose(s.inlier_fraction, sj.inlier_fraction, atol=1e-3)
        np.testing.assert_allclose(s.relative_pose, sj.relative_pose, atol=2e-3)
        assert len(s.prediction_errors) == len(sj.prediction_errors) == (delta is not None)
        for e, ej in zip(s.prediction_errors, sj.prediction_errors):
            np.testing.assert_allclose(e, ej, atol=2e-3)
    assert switches >= 2
    err = np.linalg.inv(poses[-1]) @ got
    assert np.linalg.norm(err[:3, 3]) < 0.25


# -- pipeline.py: run / process_frame -------------------------------------------------


def test_robot_odometry_init_guess_seeds_scan_matching(world):
    """enable_robot_odometry_init_guess (tests/test_pipeline.py:533-564 on
    the port): the delta between external poses at consecutive frame times
    seeds the matcher and is labelled "odometry" in the status
    (scan_matching_odometry_nodelet.cpp:193-207); the odometry tracks the
    drive within 0.1 m."""
    cfg = SlamConfig()
    cfg.prefilter.downsample_resolution = 0.4
    cfg.prefilter.outlier_removal_method = "NONE"
    cfg.odometry.keyframe_delta_trans = 3.0
    cfg.odometry.keyframe_delta_time = 1e9
    cfg.odometry.enable_robot_odometry_init_guess = True
    cfg.backend.graph_update_interval = 1e9
    cfg.floor.enabled = False
    pipe = SlamPipeline(cfg, cloud_capacity=4096, device="cpu")
    for i in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.5 * i
        pipe.add_robot_odometry(float(i), pose)
        pipe.process_frame(float(i), scan_at(world, pose, seed=i, n_keep=3000))
    st = pipe.odometry.last_status
    assert st.prediction_labels == ("odometry",)
    assert st.prediction_errors[0].shape == (4, 4) and np.isfinite(st.prediction_errors[0]).all()
    assert abs(pipe.odometry_trajectory[-1][1][0, 3] - 1.5) < 0.1
    assert pipe.process_frame(4.0, np.zeros((0, 3), np.float32)) is pipe.odometry_trajectory[-1][1]


@pytest.mark.parametrize("preset", ["base", "indoor", "outdoor", "kitti", "SlamConfig()"])
def test_gicp_presets_run_per_frame_and_windowed(world, preset):
    """Every GICP launch preset (floor detection and the RADIUS filter on
    all but base) and SlamConfig()'s STATISTICAL default go through run()
    and run_windowed: four frames of a straight 0.3 m/frame drive, every
    frame processed, the last odometry pose within 0.1 m of the drive on
    both entry points (the pose graph, test_torch_pipeline.py's, is not
    optimized here)."""
    from hdl_graph_slam_tpu_torch.core.config import PRESETS

    cfg = SlamConfig() if preset == "SlamConfig()" else PRESETS[preset]()
    cfg.backend.graph_update_interval = 1e9
    poses = []
    for i in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.3 * i
        poses.append(pose)
    frames = [(float(i), scan_at(world, p, seed=i, n_keep=2000), None) for i, p in enumerate(poses)]
    for entry in ("run", "run_windowed"):
        pipe = SlamPipeline(cfg, cloud_capacity=1024, device="cpu")
        res = pipe.run(list(frames)) if entry == "run" else pipe.run_windowed(list(frames), window=2)
        assert res.num_frames == len(frames), entry
        np.testing.assert_allclose(res.odometry_trajectory[-1][1][:3, 3], poses[-1][:3, 3], atol=0.1, err_msg=entry)


def windowed_cfg():
    """tests/test_pipeline.py TestWindowedPipeline's config: floor on."""
    cfg = SlamConfig()
    cfg.prefilter.downsample_resolution = 0.4
    cfg.prefilter.outlier_removal_method = "NONE"
    cfg.odometry.keyframe_delta_trans = 1.0
    cfg.odometry.keyframe_delta_time = 1e9
    cfg.backend.keyframe_delta_trans = 1.0
    cfg.backend.graph_update_interval = 3.0
    cfg.floor.enabled = True
    cfg.floor.sensor_height = 1.8
    cfg.floor.floor_pts_thresh = 50
    return cfg


def test_run_device_odometry_matches_run_windowed(world):
    """tests/test_pipeline.py:569-600 on the port: run() with the device
    odometry step against run_windowed over 9 frames of a square drive with
    floor detection on. The same keyframes; odometry within 1e-4 (one
    device step, per frame or per window); optimized poses within 2e-3
    (run() detects the floor on every frame and runs its cycles on other
    frames than the windows do)."""
    poses = drive_square(side=4.0, step=1.0)[:9]
    frames = [(float(i), scan_at(world, p, seed=i, n_keep=3000), None) for i, p in enumerate(poses)]
    seq = SlamPipeline(windowed_cfg(), cloud_capacity=4096, device_odometry=True, device="cpu")
    r_seq = seq.run(list(frames))
    r_win = SlamPipeline(windowed_cfg(), cloud_capacity=4096, device="cpu").run_windowed(list(frames), window=4)
    assert r_win.num_frames == r_seq.num_frames == 9
    assert r_win.num_keyframes == r_seq.num_keyframes
    assert len(seq.slam.graph.edge_rows["se3_plane"]) == r_seq.num_keyframes
    for (s1, T1), (s2, T2) in zip(r_seq.trajectory, r_win.trajectory):
        assert s1 == s2
        np.testing.assert_allclose(T1, T2, atol=2e-3)
    for (s1, T1), (s2, T2) in zip(r_seq.odometry_trajectory, r_win.odometry_trajectory):
        assert s1 == s2
        np.testing.assert_allclose(T1, T2, atol=1e-4)


def floor_course_cfg(cfg, reg_cls):
    """tests/test_torch_pipeline.py's course config with the outdoor
    preset's floor detection and RADIUS outlier filter (0.8 m, 2
    neighbours); the course's sensor rides 1.8 m above the floor."""
    cfg = course_cfg(cfg, reg_cls)
    cfg.prefilter.outlier_removal_method = "RADIUS"
    cfg.prefilter.radius_radius = 0.8
    cfg.prefilter.radius_min_neighbors = 2
    cfg.floor.enabled = True
    cfg.floor.sensor_height = 1.8
    cfg.floor.floor_pts_thresh = 64
    return cfg


def test_run_matches_jax_pipeline_with_floor_and_radius_filter():
    """run() on both sides over the first 24 frames of the room course
    (most of a lap, three optimize cycles; loop closure parity on this
    course is test_torch_pipeline.py's) with floor detection on every frame
    and the RADIUS prefilter: the same frames, keyframes, edge pairs and
    floor-edge count; odometry within 2e-3 m/rad (the odometry's parity
    tolerance). Optimized keyframe positions: x and y within 2e-3 m, the
    odometry's tolerance (the floor edges constrain height, roll and pitch,
    not the horizontal). Heights: the two sides draw different RANSAC
    triplets, so each keyframe's floor plane is another 1024-hypothesis
    winner inside the 0.1 m inlier band, and the floor edges pull the
    keyframe heights to the planes measured; the heights may differ by the
    two sides' largest plane offsets from the truth added (d against the
    sensor's 1.8 m) plus the odometry tolerance. Each side's planes lie
    inside the band (d within 0.1 m of 1.8, normal within 0.05 of +z), and
    optimization beats the odometry on ATE on both sides."""
    frames, truth = course()
    frames = frames[:24]
    pipe = SlamPipeline(floor_course_cfg(SlamConfig(), RegistrationConfig), cloud_capacity=CLOUD_CAPACITY,
                        device="cpu")
    res = pipe.run(list(frames))
    pipe_j = JSlamPipeline(floor_course_cfg(JSlamConfig(), JRegistrationConfig), cloud_capacity=CLOUD_CAPACITY)
    res_j = pipe_j.run(list(frames))

    assert res.num_frames == res_j.num_frames == len(frames)
    assert res.num_keyframes == res_j.num_keyframes
    for (s, T), (sj, Tj) in zip(res.odometry_trajectory, res_j.odometry_trajectory):
        assert s == sj
        np.testing.assert_allclose(T, Tj, atol=2e-3)
    assert [s for s, _ in res.trajectory] == [s for s, _ in res_j.trajectory]
    rows, rows_j = pipe.slam.graph.edge_rows, pipe_j.slam.graph.edge_rows
    assert [(r["vi"], r["vj"]) for r in rows["se3_se3"]] == [(r["vi"], r["vj"]) for r in rows_j["se3_se3"]]
    assert len(rows["se3_plane"]) == len(rows_j["se3_plane"]) >= 0.9 * res.num_keyframes
    offsets = []
    for p in (pipe, pipe_j):
        planes = np.stack([kf.floor_coeffs for kf in p.slam.keyframes if kf.floor_coeffs is not None])
        assert np.abs(planes[:, :3] - [0, 0, 1]).max() < 0.05
        offsets.append(np.abs(planes[:, 3] - 1.8).max())
        assert offsets[-1] < 0.1
    xyz, xyz_j = (np.stack([T[:3, 3] for _, T in r.trajectory]) for r in (res, res_j))
    np.testing.assert_allclose(xyz[:, :2], xyz_j[:, :2], atol=2e-3)
    np.testing.assert_allclose(xyz[:, 2], xyz_j[:, 2], atol=sum(offsets) + 2e-3)
    kf = {s for s, _ in res.trajectory}
    for r in (res, res_j):
        odom_kf = [(s, T) for s, T in r.odometry_trajectory if s in kf]
        assert traj_io.ate_rmse(r.trajectory, truth) < traj_io.ate_rmse(odom_kf, truth)
