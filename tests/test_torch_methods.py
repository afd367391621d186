"""The VGICP and ICP slice end to end on the CPU: the odometry entry points
(ScanMatchingOdometry, DeviceOdometry, OdometryWindow), the loop detector's
batched match and the odometry state carried across from the JAX package
(state.py), against the JAX reference on the same seeded float32 scans.

Mirrors tests/test_pipeline.py test_vgicp_odometry / test_icp_odometry,
tests/test_window.py test_vgicp_device / test_icp_device /
test_vgicp_window_matches_device and the FAST_VGICP / ICP rows of
test_small_step_progress, and tests/test_loop_detector.py
TestBatchedParity's FAST_VGICP and ICP rows.

Tolerances: the per-frame odometry 1e-3 m of JAX's (five chained aligns,
each within float32 rounding of JAX's, as tests/test_torch_ndt.py); the
windows 2e-3 of JAX's per-frame poses (the cut-cloud windows'
tolerance, tests/test_torch_window.py) and 1e-5 of the port's own per-frame
path; loop matches 1e-4 of JAX's and 1e-5 of the port's sequential path.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.backend.loop_detector import _batched_match as j_batched_match
from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import OdometryConfig as JOdometryConfig
from hdl_graph_slam_tpu.core.config import RegistrationConfig as JRegistrationConfig
from hdl_graph_slam_tpu.frontend import odometry_device as jodo
from hdl_graph_slam_tpu.frontend.odometry import ScanMatchingOdometry as JScanMatchingOdometry
from hdl_graph_slam_tpu.ops import voxel as jvoxel
from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu.registration import ndt as jndt
from hdl_graph_slam_tpu.registration import vgicp as jvgicp
from hdl_graph_slam_tpu_torch import state as statelib
from hdl_graph_slam_tpu_torch.backend.loop_detector import LoopDetector
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import OdometryConfig, RegistrationConfig
from hdl_graph_slam_tpu_torch.frontend import DeviceOdometry, OdometryWindow, ScanMatchingOdometry
from hdl_graph_slam_tpu_torch.frontend import odometry_device as odo
from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
from hdl_graph_slam_tpu_torch.registration import vgicp
from test_pipeline import make_world, scan_at
from test_torch_backend import guesses_for, line_course, port_loop_cfg

METHODS = ["FAST_VGICP", "ICP"]
RES = {"FAST_VGICP": 1.0, "ICP": 1.0, "NDT_OMP": 2.0}
ODOM_ATOL = 1e-3
WINDOW_ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's CPU work (tests/test_torch_ndt.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def world(n=12000):
    return make_world(n=n)


@functools.lru_cache(maxsize=None)
def drive(n=5, step=0.4, n_keep=2500, world_n=12000):
    """Scans every ``step`` m along x of a make_world(n=world_n) room
    (tests/test_window.py _drive_scans)."""
    scans = []
    for i in range(n):
        pose = np.eye(4)
        pose[0, 3] = step * i
        scans.append(scan_at(world(world_n), pose, n_keep=n_keep, seed=i))
    return scans


def odom_cfg(cls, reg_cls, method, keyframe_delta_trans):
    return cls(keyframe_delta_trans=keyframe_delta_trans, keyframe_delta_time=1e9,
               registration=reg_cls(registration_method=method, reg_resolution=RES[method]))


@functools.lru_cache(maxsize=None)
def jax_host_odometry(method, keyframe_delta_trans, *drive_args):
    """The JAX ScanMatchingOdometry's poses over drive(*drive_args)."""
    o = JScanMatchingOdometry(odom_cfg(JOdometryConfig, JRegistrationConfig, method, keyframe_delta_trans))
    return np.stack([np.asarray(o.step(0.1 * i, jcloud.from_numpy(s, capacity=2560)))
                     for i, s in enumerate(drive(*drive_args))])


@pytest.mark.parametrize("method", METHODS)
def test_odometry_matches_jax(method):
    """test_vgicp_odometry / test_icp_odometry: ScanMatchingOdometry over 5
    frames 0.4 m apart tracks x within 0.15 m, on JAX's poses (1e-3)."""
    o = ScanMatchingOdometry(odom_cfg(OdometryConfig, RegistrationConfig, method, 3.0), device="cpu")
    ours = np.stack([o.step(0.1 * i, cloud.from_numpy(s, capacity=2560, device="cpu")) for i, s in enumerate(drive())])
    np.testing.assert_allclose(ours, jax_host_odometry(method, 3.0), atol=ODOM_ATOL)
    assert max(abs(T[0, 3] - 0.4 * i) for i, T in enumerate(ours)) < 0.15


@pytest.mark.parametrize("method", METHODS)
def test_device_odometry_and_window_match_jax(method):
    """test_vgicp_device / test_icp_device / test_vgicp_window_matches_device:
    DeviceOdometry over 5 frames 0.4 m apart tracks x within 0.15 m; the
    OdometryWindow over the same frames equals it (1e-5) with a keyframe
    switch inside the window (a VGICP target rebuilt on that frame only, an
    ICP target selected elementwise); both within 2e-3 of the JAX
    odometry's poses."""
    cfg = odom_cfg(OdometryConfig, RegistrationConfig, method, 0.9)
    scans = drive()
    dev = DeviceOdometry(cfg, device="cpu", max_voxels=2048)
    per_frame = np.stack([dev.step(0.1 * i, cloud.from_numpy(s, capacity=2560, device="cpu")).numpy()
                          for i, s in enumerate(scans)])
    assert max(abs(T[0, 3] - 0.4 * i) for i, T in enumerate(per_frame)) < 0.15
    win = OdometryWindow(cfg, device="cpu", max_voxels=2048)
    state = win.init_state(0.0, cloud.from_numpy(scans[0], capacity=2560, device="cpu"))
    xyz, mask = stack_scans(scans[1:], capacity=2560)
    state, odoms, status = win.run(state, xyz, mask, 0.1 * np.arange(1, 5))
    np.testing.assert_allclose(odoms.numpy(), per_frame[1:], atol=1e-5)
    assert bool(status["keyframe_switched"].any()) and bool(status["converged"].all())
    assert isinstance(state.tgt, vgicp.VgicpTarget if method == "FAST_VGICP" else cloud.PointCloud)
    np.testing.assert_allclose(per_frame, jax_host_odometry(method, 0.9), atol=WINDOW_ATOL)


@pytest.mark.parametrize("method,tol_frac", [("FAST_VGICP", 0.25), ("ICP", 0.5)])
def test_small_step_progress(method, tol_frac):
    """TestWindowedTracking::test_small_step_progress: 6 frames 0.1 m apart
    (2400 points of a 9000-point room) through the window track the drive
    within tol_frac, each pose within 2e-3 of the JAX odometry's."""
    scans = drive(7, 0.1, 2400, 9000)
    cfg = odom_cfg(OdometryConfig, RegistrationConfig, method, 5.0)
    win = OdometryWindow(cfg, device="cpu", max_voxels=2048)
    state = win.init_state(0.0, cloud.from_numpy(scans[0], capacity=2560, device="cpu"))
    xyz, mask = stack_scans(scans[1:], capacity=2560)
    _, odoms, _ = win.run(state, xyz, mask, 0.1 * np.arange(1, 7))
    got = float(odoms[-1, 0, 3])
    assert abs(got - 0.6) < tol_frac * 0.6, (method, got)
    np.testing.assert_allclose(odoms.numpy(), jax_host_odometry(method, 5.0, 7, 0.1, 2400, 9000)[1:], atol=WINDOW_ATOL)


# -- the loop detector -------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_batched_match_matches_jax_and_sequential(method):
    """TestBatchedParity FAST_VGICP / ICP rows: the batched loop match
    (padded to 4 with a repeated candidate) equals the port's sequential
    per-candidate path (transforms 1e-5, fitness 1e-5 relative, the same
    flags), and the JAX ``_batched_match`` on the same clouds (transforms
    1e-4, ICP's 5e-4; the same flags; fitness 1e-4 relative).

    ICP's tolerance: candidate 0 stops after one iteration, whose Procrustes
    step takes the cross-covariance S of 2000 pairs about 15 m out. JAX's
    float32 centroid sums leave its S 2.1e-3 off the float64 S (|S| 29),
    the port's 7e-6, so JAX's rotation is 2.1e-4 from the float64 answer and
    the port's 6e-8 (measured on this course); given the same S, the two
    rotations agree to 1e-6 (test_torch_vgicp_icp.py)."""
    kfs, new, est, pk, pn = line_course()
    ids = [0, 1, 2]
    guesses = guesses_for(est, new.node_id, ids)
    det = LoopDetector(port_loop_cfg(method, reg_resolution=RES[method]))
    sb = det._match_batched([pk[i].cloud for i in ids], pn.cloud, guesses)
    ss = det._match_sequential([pk[i].cloud for i in ids], pn.cloud, guesses)
    np.testing.assert_allclose(np.asarray(sb[0], np.float64), ss[0], rtol=1e-5, atol=1e-9)
    for tb, ts in zip(sb[1], ss[1]):
        np.testing.assert_allclose(tb, ts, atol=1e-5)
    assert [bool(c) for c in sb[2]] == ss[2] and any(ss[2])

    c = det.cfg.registration
    if method == "FAST_VGICP":
        tgt_state = jvgicp.preprocess_target(new.cloud, c.reg_resolution, max_voxels=8192, k=20,
                                             grid_size=jvoxel.dense_grid_size_for(c.reg_resolution))
        jmethod = "VGICP"
    else:
        tgt_state, jmethod = new.cloud, "ICP"
    srcs = [kfs[i].cloud for i in ids] + [kfs[ids[0]].cloud]
    tj, cj, fj = j_batched_match(
        tgt_state, jnp.where(new.cloud.mask[:, None], new.cloud.xyz, 1.0e6),
        jnp.stack([s.xyz for s in srcs]), jnp.stack([s.mask for s in srcs]),
        jnp.asarray(np.stack(guesses + [guesses[0]]), jnp.float32),
        method=jmethod, k=20, max_corr_dist=c.reg_max_correspondence_distance,
        transformation_epsilon=c.reg_transformation_epsilon, max_iterations=c.reg_maximum_iterations,
        reassoc_displacement=c.reg_reassoc_displacement, nn_search=c.reg_nn_search_method,
        use_reciprocal=c.reg_use_reciprocal_correspondences, fitness_max_range=float("inf"))
    for b in range(len(ids)):
        np.testing.assert_allclose(sb[1][b], np.asarray(tj[b]), atol=1e-4 if method == "FAST_VGICP" else 5e-4)
        assert bool(sb[2][b]) == bool(cj[b])
        np.testing.assert_allclose(float(sb[0][b]), float(fj[b]), rtol=1e-4, atol=1e-9)


# -- the odometry state carried across ---------------------------------------------------


def jax_state_to_numpy(s):
    """The numpy form (state.py) of a JAX OdomState, field for field."""
    t = s.tgt
    out = {k: np.asarray(getattr(s, k)) for k in statelib.ODOM_KEYS}
    if isinstance(t, jgicp.GicpCloud):
        return {**out, "tgt_xyz": np.asarray(t.xyz), "tgt_mask": np.asarray(t.mask), "tgt_covs": np.asarray(t.covs)}
    if isinstance(t, jcloud.PointCloud):
        return {**out, "tgt_kind": "icp", "tgt_xyz": np.asarray(t.xyz), "tgt_mask": np.asarray(t.mask)}
    vox, kind = (t.voxels, "ndt") if isinstance(t, jndt.NdtTarget) else (t, "vgicp")
    out.update(tgt_kind=kind, tgt_keys=np.asarray(vox.keys), tgt_means=np.asarray(vox.means),
               tgt_covs=np.asarray(vox.covs), tgt_mask=np.asarray(vox.mask), tgt_resolution=np.asarray(vox.resolution),
               tgt_origin=np.asarray(vox.origin), tgt_grid_size=0 if t.grid is None else jvoxel.grid_dim(t.grid))
    if kind == "ndt":
        out.update(tgt_counts=np.asarray(vox.counts), tgt_icovs=np.asarray(t.icovs), tgt_d1=np.asarray(t.d1),
                   tgt_d2=np.asarray(t.d2))
    return out


@pytest.mark.parametrize("method", ["FAST_VGICP", "ICP", "NDT_OMP"])
def test_state_carries_the_jax_odometry_target(method):
    """A JAX OdomState whose target is VGICP's voxels, ICP's cloud or NDT's
    cells, carried into the port through its numpy form: the dense grid
    rebuilt from the keys equal to JAX's, the structure (keys, masks,
    origin, grid) equal to the port's own target of the same cloud, a
    bit-exact round trip, and one odometry step from it within 1e-3 of the
    JAX step's pose."""
    jcfg = odom_cfg(JOdometryConfig, JRegistrationConfig, method, 3.0)
    cfg = odom_cfg(OdometryConfig, RegistrationConfig, method, 3.0)
    scans = drive()
    jprep, jmake, jalign = jodo.make_method_fns(jcfg.registration, max_voxels=2048)
    c0 = jcloud.from_numpy(scans[0], capacity=2560)
    jstate = jodo.OdomState(tgt=jmake(c0, jprep(c0)), keyframe_pose=jnp.eye(4, dtype=jnp.float32),
                            prev_trans=jnp.eye(4, dtype=jnp.float32), keyframe_stamp=jnp.asarray(0.0, jnp.float32),
                            prev_delta=jnp.eye(4, dtype=jnp.float32))
    arrays = jax_state_to_numpy(jstate)
    state = statelib.odom_state_from_numpy(arrays, "cpu")
    prep, make_tgt, align = odo.make_method_fns(cfg.registration, max_voxels=2048)
    p0 = cloud.from_numpy(scans[0], capacity=2560, device="cpu")
    own = make_tgt(p0, prep(p0))
    assert type(state.tgt) is type(own)
    if method == "ICP":
        assert torch.equal(state.tgt.xyz, own.xyz) and torch.equal(state.tgt.mask, own.mask)
    else:
        np.testing.assert_array_equal(state.tgt.grid.numpy(), np.asarray(jstate.tgt.grid))
        vox, own_vox = (state.tgt.voxels, own.voxels) if method == "NDT_OMP" else (state.tgt, own)
        for name in ("keys", "mask", "origin"):
            assert torch.equal(getattr(vox, name), getattr(own_vox, name)), name
        assert torch.equal(state.tgt.grid, own.grid) and vox.resolution == own_vox.resolution
        if method == "NDT_OMP":
            assert torch.equal(state.tgt.cell_rows, torch.cat([vox.means, state.tgt.icovs.reshape(-1, 9)], 1))
            assert (state.tgt.d1, state.tgt.d2) == (own.d1, own.d2)
    back = statelib.odom_state_to_numpy(state)
    for key, val in arrays.items():
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(val), err_msg=key)
    kw = dict(keyframe_delta_trans=3.0, keyframe_delta_angle=jcfg.keyframe_delta_angle, keyframe_delta_time=1e9,
              transform_thresholding=False, max_acceptable_trans=1.0, max_acceptable_angle=1.0)
    c1 = jcloud.from_numpy(scans[1], capacity=2560)
    _, od_j, _ = jodo.device_step_impl(jstate, c1, jnp.asarray(0.1, jnp.float32), jnp.eye(4, dtype=jnp.float32),
                                       jprep, jmake, jalign, **kw)
    _, od, _ = odo.device_step_impl(state, cloud.from_numpy(scans[1], capacity=2560, device="cpu"), torch.tensor(0.1),
                                    torch.eye(4), prep, make_tgt, align, **kw)
    np.testing.assert_allclose(od.numpy(), np.asarray(od_j), atol=ODOM_ATOL)
    with pytest.raises(ValueError, match="kind"):
        statelib.odom_state_from_numpy(dict(arrays, tgt_kind="loam"), "cpu")
