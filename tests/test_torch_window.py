"""The port's slice end to end on the CPU: windowed FAST_GICP odometry
(hdl_graph_slam_tpu_torch/frontend/window.py) against the JAX OdometryWindow,
plus the port's guards (no JAX import, no quiet CPU fallback).

The JAX window bootstraps the keyframe; its state is carried across as numpy
arrays (state.odom_state_from_numpy) and both windows run the same frames
from the same start.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import OdometryConfig as JOdometryConfig
from hdl_graph_slam_tpu.core.config import PrefilterConfig as JPrefilterConfig
from hdl_graph_slam_tpu.core.config import RegistrationConfig as JRegistrationConfig
from hdl_graph_slam_tpu.frontend import odometry_device as jodo
from hdl_graph_slam_tpu.frontend.window import OdometryWindow as JOdometryWindow
from hdl_graph_slam_tpu.registration import base as jbase
from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu_torch import state as statelib
from hdl_graph_slam_tpu_torch.core import cloud, se3
from hdl_graph_slam_tpu_torch.core.config import OdometryConfig, PrefilterConfig, RegistrationConfig
from hdl_graph_slam_tpu_torch.frontend import DeviceOdometry, FloorDetector, OdometryWindow, Prefilter, ScanMatchingOdometry
from hdl_graph_slam_tpu_torch.frontend import odometry_device as odo
from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
from hdl_graph_slam_tpu_torch.ops import knn
from hdl_graph_slam_tpu_torch.registration import base, gicp
from hdl_graph_slam_tpu_torch.utils import course

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 6
RAW_CAPACITY = 2560
OUT_CAPACITY = 2048
# bench.py:142-151
ODO = dict(keyframe_delta_trans=2.0, keyframe_delta_time=1e9)
REG = dict(reg_reassoc_displacement=0.1)
PF = dict(downsample_resolution=0.2, outlier_removal_method="NONE")


@functools.lru_cache(maxsize=1)
def scans():
    return course.make_course(N_FRAMES)


def jax_state_to_numpy(s):
    return {
        "tgt_xyz": np.asarray(s.tgt.xyz), "tgt_mask": np.asarray(s.tgt.mask), "tgt_covs": np.asarray(s.tgt.covs),
        "keyframe_pose": np.asarray(s.keyframe_pose), "prev_trans": np.asarray(s.prev_trans),
        "keyframe_stamp": np.asarray(s.keyframe_stamp), "prev_delta": np.asarray(s.prev_delta),
    }


def port_window():
    return OdometryWindow(OdometryConfig(**ODO, registration=RegistrationConfig(**REG)),
                          prefilter_cfg=PrefilterConfig(**PF), out_capacity=OUT_CAPACITY, device="cpu")


def test_window_matches_jax_window():
    """Per-frame poses, convergence and keyframe switches of the port's
    window against the JAX window from the same bootstrap state.

    Pose tolerance 2e-3 m / 2e-3 rad. At this cut size (2560 raw rows voxel-
    filtered into 2048, which keeps the lowest voxel keys) the course is
    poorly constrained and LM runs ~20 iterations a frame; LM stops inside
    reg_transformation_epsilon=0.01, so a rounding-level flip of one accept
    moves the stop point (measured: 9.8e-4 m and 3.9e-4 in the rotation block
    on one frame, at most 2.1e-4 m on the others). The well-conditioned
    alignment parity is held at 1e-4 in test_torch_gicp.py."""
    sc = scans()
    jwin = JOdometryWindow(JOdometryConfig(**ODO, registration=JRegistrationConfig(**REG)),
                           prefilter_cfg=JPrefilterConfig(**PF), out_capacity=OUT_CAPACITY)
    jstate0 = jwin.init_state(0.0, jcloud.from_numpy(sc[0], capacity=RAW_CAPACITY))
    xyz, mask = stack_scans(sc[1:], capacity=RAW_CAPACITY)
    stamps = (0.1 * np.arange(1, N_FRAMES + 1)).astype(np.float32)
    _, odoms_j, status_j = jwin.run(jstate0, xyz, mask, stamps)
    odoms_j = np.asarray(odoms_j)

    state0 = statelib.odom_state_from_numpy(jax_state_to_numpy(jstate0), "cpu")
    _, odoms, status = port_window().run(state0, xyz, mask, stamps)
    odoms = odoms.numpy()

    assert odoms.shape == (N_FRAMES, 4, 4)
    np.testing.assert_array_equal(status["converged"].numpy(), np.asarray(status_j["converged"]))
    np.testing.assert_array_equal(status["keyframe_switched"].numpy(), np.asarray(status_j["keyframe_switched"]))
    np.testing.assert_array_equal(status["num_inliers"].numpy(), np.asarray(status_j["num_inliers"]))
    np.testing.assert_allclose(odoms[:, :3, 3], odoms_j[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(odoms[:, :3, :3], odoms_j[:, :3, :3], atol=2e-3)
    np.testing.assert_array_equal(odoms[:, 3], odoms_j[:, 3])
    for key in ("error", "iterations", "inlier_fraction", "relative_pose", "prediction_error"):
        assert status[key].shape == np.asarray(status_j[key]).shape, key


def test_bootstrap_state_matches_jax():
    """The port's init_state (prefilter + GICP preprocess of frame 0) against
    the JAX one: same keyframe rows, covariances within the preprocess
    tolerance of test_torch_gicp.py."""
    sc = scans()
    jwin = JOdometryWindow(JOdometryConfig(**ODO, registration=JRegistrationConfig(**REG)),
                           prefilter_cfg=JPrefilterConfig(**PF), out_capacity=OUT_CAPACITY)
    j = jax_state_to_numpy(jwin.init_state(0.0, jcloud.from_numpy(sc[0], capacity=RAW_CAPACITY)))
    p = statelib.odom_state_to_numpy(
        port_window().init_state(0.0, cloud.from_numpy(sc[0], capacity=RAW_CAPACITY, device="cpu")))
    np.testing.assert_array_equal(p["tgt_mask"], j["tgt_mask"])
    np.testing.assert_allclose(p["tgt_xyz"], j["tgt_xyz"], atol=1e-5)
    np.testing.assert_allclose(p["tgt_covs"], j["tgt_covs"], atol=1e-3)
    for key in ("keyframe_pose", "prev_trans", "keyframe_stamp", "prev_delta"):
        np.testing.assert_array_equal(p[key], j[key])


def test_per_frame_device_odometry_matches_window():
    """DeviceOdometry + Prefilter frame by frame run the same device step as
    the window: identical poses."""
    sc = scans()[:4]
    win = port_window()
    state = win.init_state(0.0, cloud.from_numpy(sc[0], capacity=RAW_CAPACITY, device="cpu"))
    xyz, mask = stack_scans(sc[1:], capacity=RAW_CAPACITY)
    _, odoms, _ = win.run(state, xyz, mask, 0.1 * np.arange(1, len(sc)))
    pf = Prefilter(PrefilterConfig(**PF), out_capacity=OUT_CAPACITY, device="cpu")
    dev = DeviceOdometry(OdometryConfig(**ODO, registration=RegistrationConfig(**REG)), device="cpu")
    for i, s in enumerate(sc):
        odom = dev.step(0.1 * i, pf(cloud.from_numpy(s, capacity=RAW_CAPACITY, device="cpu")))
        if i:
            np.testing.assert_allclose(odom.numpy(), odoms[i - 1].numpy(), atol=1e-6)
    assert dev.last_status["prediction_labels"] == ()


# (motion twist of the align result, converged, transform_thresholding,
#  constant_velocity_guess)
GATE_CASES = {
    "small_motion": ([0.05, 0.01, 0.0, 0.0, 0.0, 0.01], True, False, False),
    "keyframe_by_translation": ([1.2, 0.1, 0.0, 0.0, 0.0, 0.02], True, False, False),
    "keyframe_by_angle": ([0.0, 0.0, 0.0, 0.0, 0.0, 0.9], True, False, False),
    "not_converged": ([1.2, 0.0, 0.0, 0.0, 0.0, 0.0], False, False, False),
    "thresholding_rejects": ([1.5, 0.0, 0.0, 0.0, 0.0, 0.0], True, True, False),
    "thresholding_accepts": ([0.5, 0.0, 0.0, 0.0, 0.0, 0.1], True, True, False),
    "constant_velocity": ([0.1, 0.0, 0.0, 0.0, 0.0, 0.0], True, False, True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_device_step_gates_match_jax(case):
    """device_step_impl's convergence gate, SO(3) projection, transform
    thresholding, keyframe switch and constant-velocity guess against the JAX
    step, with the same stand-in aligner on both sides (it returns the guess
    moved by a fixed twist). Exact logic; poses within atol 1e-6."""
    twist, conv, thresh, cv = GATE_CASES[case]
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-5, 5, (32, 3)).astype(np.float32)
    mask = np.arange(32) < 28
    prev = np.asarray(se3.se3_exp(torch.tensor([0.3, -0.1, 0.02, 0.01, 0.0, 0.05])), np.float32)
    prev_delta = np.asarray(se3.se3_exp(torch.tensor([0.12, 0.01, 0.0, 0.0, 0.0, 0.0])), np.float32)
    kf = np.asarray(se3.se3_exp(torch.tensor([4.0, 1.0, 0.0, 0.0, 0.0, 0.3])), np.float32)
    arrays = {"tgt_xyz": xyz + 0.5, "tgt_mask": np.ones(32, bool), "tgt_covs": np.tile(np.eye(3, dtype=np.float32), (32, 1, 1)),
              "keyframe_pose": kf, "prev_trans": prev, "keyframe_stamp": np.float32(0.5), "prev_delta": prev_delta}
    kw = dict(keyframe_delta_trans=1.0, keyframe_delta_angle=0.3, keyframe_delta_time=10.0,
              transform_thresholding=thresh, max_acceptable_trans=1.0, max_acceptable_angle=1.0,
              constant_velocity_guess=cv)
    D = np.asarray(se3.se3_exp(torch.tensor(twist)), np.float32)

    def fake(lib, gicp_mod, base_mod, asarray, eye3):
        prep = lambda c: gicp_mod.GicpCloud(xyz=c.xyz, mask=c.mask, covs=eye3)
        align = lambda tgt, src, guess: base_mod.AlignResult(
            transformation=guess @ asarray(D), converged=asarray(conv), iterations=asarray(np.int32(3)),
            error=asarray(np.float32(1.0)), num_inliers=asarray(np.int32(20)))
        return prep, (lambda c, s: s), align

    eye = np.eye(4, dtype=np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32), (32, 1, 1))
    st_t, od_t, stat_t = odo.device_step_impl(
        statelib.odom_state_from_numpy(arrays, "cpu"), cloud.PointCloud(torch.from_numpy(xyz), torch.from_numpy(mask)),
        torch.tensor(0.7), torch.from_numpy(eye),
        *fake(torch, gicp, base, lambda a: torch.as_tensor(np.asarray(a)), torch.from_numpy(covs)), **kw)
    jstate = jodo.OdomState(
        tgt=jgicp.GicpCloud(xyz=jnp.asarray(arrays["tgt_xyz"]), mask=jnp.asarray(arrays["tgt_mask"]),
                            covs=jnp.asarray(arrays["tgt_covs"])),
        keyframe_pose=jnp.asarray(kf), prev_trans=jnp.asarray(prev), keyframe_stamp=jnp.asarray(np.float32(0.5)),
        prev_delta=jnp.asarray(prev_delta))
    st_j, od_j, stat_j = jodo.device_step_impl(
        jstate, jcloud.PointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)), jnp.asarray(np.float32(0.7)),
        jnp.asarray(eye), *fake(jnp, jgicp, jbase, lambda a: jnp.asarray(np.asarray(a)), jnp.asarray(covs)), **kw)

    for key in ("converged", "keyframe_switched"):
        assert bool(stat_t[key]) == bool(stat_j[key]), key
    np.testing.assert_allclose(od_t.numpy(), np.asarray(od_j), atol=1e-6)
    ours, ref = statelib.odom_state_to_numpy(st_t), jax_state_to_numpy(st_j)
    for key in statelib.STATE_KEYS:
        np.testing.assert_allclose(ours[key], ref[key], atol=1e-6, err_msg=key)
    for key in ("relative_pose", "prediction_error", "inlier_fraction"):
        np.testing.assert_allclose(stat_t[key].numpy(), np.asarray(stat_j[key]), atol=1e-6, err_msg=key)
    switched = {"keyframe_by_translation", "keyframe_by_angle"}
    assert bool(stat_t["keyframe_switched"]) == (case in switched)


def test_course_matches_bench_make_course():
    """utils/course.py reproduces bench.make_course scan for scan."""
    sys.path.insert(0, REPO)
    import bench

    ref = bench.make_course(2)
    ours = course.make_course(2)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_state_round_trip():
    rng = np.random.default_rng(3)
    arrays = {
        "tgt_xyz": rng.standard_normal((16, 3)).astype(np.float32),
        "tgt_mask": rng.random(16) < 0.7,
        "tgt_covs": rng.standard_normal((16, 3, 3)).astype(np.float32),
        "keyframe_pose": np.eye(4, dtype=np.float32),
        "prev_trans": rng.standard_normal((4, 4)).astype(np.float32),
        "keyframe_stamp": np.float32(1.5),
        "prev_delta": rng.standard_normal((4, 4)).astype(np.float32),
    }
    back = statelib.odom_state_to_numpy(statelib.odom_state_from_numpy(arrays, "cpu"))
    for key in statelib.STATE_KEYS:
        np.testing.assert_array_equal(back[key], arrays[key])
    with pytest.raises(KeyError):
        statelib.odom_state_from_numpy({"tgt_xyz": arrays["tgt_xyz"]}, "cpu")


def test_port_never_imports_jax():
    """Importing every module of the port loads neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hdl_graph_slam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'hdl_graph_slam_tpu'"
        " or m.startswith('hdl_graph_slam_tpu.')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 41, names\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=""), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_cuda_and_never_fall_back():
    """device=None means cuda; without a GPU every entry point raises instead
    of running on the CPU."""
    ctors = [
        lambda: OdometryWindow(),
        lambda: DeviceOdometry(),
        lambda: Prefilter(PrefilterConfig(**PF)),
        lambda: cloud.from_numpy(np.zeros((4, 3), np.float32)),
        lambda: FloorDetector(),
        lambda: ScanMatchingOdometry(),
    ]
    if torch.cuda.is_available():
        assert OdometryWindow().device.type == "cuda"
    else:
        for make in ctors:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    with pytest.raises(NotImplementedError):
        OdometryWindow(OdometryConfig(registration=RegistrationConfig(registration_method="NDT_OMP")), device="cpu")
    # a kernel wrapper on a device that is neither the CPU nor CUDA raises
    meta = torch.zeros(8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        knn.radius_count(meta, meta, 0.5)
