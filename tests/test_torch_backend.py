"""Parity of the port's backend (hdl_graph_slam_tpu_torch/backend/, the batched
GICP and the batched kernel wrappers) with the JAX reference, on the CPU.

The loop-detector cases use tests/test_loop_detector.py's room clouds; the
backend course is tests/test_golden.py's drift-injection square
(test_golden_loop_closure_corrects_injected_drift) cut to 2048-row clouds.
Both sides get the same numpy clouds and odometry.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_detector as jtl
from hdl_graph_slam_tpu.backend import HdlGraphSlam as JHdlGraphSlam
from hdl_graph_slam_tpu.backend.information_matrix import InformationMatrixCalculator as JInfo
from hdl_graph_slam_tpu.backend.keyframe import KeyframeUpdater as JKeyframeUpdater
from hdl_graph_slam_tpu.backend.loop_detector import _batched_match as j_batched_match
from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import SlamConfig as JSlamConfig
from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu_torch.backend import HdlGraphSlam, InformationMatrixCalculator, KeyFrame, KeyframeUpdater
from hdl_graph_slam_tpu_torch.backend.loop_detector import LoopDetector
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import LoopDetectorConfig, RegistrationConfig, SlamConfig
from hdl_graph_slam_tpu_torch.io import trajectory as traj_io
from hdl_graph_slam_tpu_torch.ops import knn
from hdl_graph_slam_tpu_torch.registration import factory, gicp
from test_golden import _drifted_odometry, room_scan
from test_pipeline import drive_square


def port_cloud(jc):
    return cloud.PointCloud(xyz=torch.from_numpy(np.array(jc.xyz)), mask=torch.from_numpy(np.array(jc.mask)))


def port_kf(k):
    return KeyFrame(stamp=k.stamp, odom=k.odom, accum_distance=k.accum_distance, node_id=k.node_id,
                    cloud=port_cloud(k.cloud))


def port_loop_cfg(method="FAST_GICP", **extra):
    """tests/test_loop_detector.py::_cfg on the port's config classes."""
    cfg = LoopDetectorConfig()
    cfg.registration = RegistrationConfig(registration_method=method, **extra)
    cfg.distance_thresh, cfg.accum_distance_thresh = 3.0, 8.0
    cfg.min_edge_interval, cfg.fitness_score_thresh = 0.0, 2.0
    return cfg


@functools.lru_cache(maxsize=1)
def line_course():
    kfs, new, est = jtl._line_course()
    return kfs, new, est, [port_kf(k) for k in kfs], port_kf(new)


def guesses_for(est, new_id, ids):
    out = []
    for i in ids:
        g = np.linalg.inv(est[new_id]) @ est[i]
        g[2, 3] = 0.0
        out.append(g)
    return out


# -- keyframes, fitness, information -----------------------------------------


def test_keyframe_updater_matches_jax():
    rng = np.random.default_rng(0)
    ours, ref = KeyframeUpdater(1.0, 0.3), JKeyframeUpdater(1.0, 0.3)
    pose = np.eye(4)
    for _ in range(60):
        step = np.eye(4)
        step[:3, 3] = rng.normal(0.0, 0.4, 3)
        c, s = np.cos(rng.normal(0.0, 0.1)), np.sin(rng.normal(0.0, 0.1))
        step[:2, :2] = [[c, -s], [s, c]]
        pose = pose @ step
        assert ours.would_update(pose) == ref.would_update(pose)
        assert ours.update(pose) == ref.update(pose)
        assert ours.get_accum_distance() == ref.get_accum_distance()


def test_fitness_and_information_match_jax():
    """Per pair and batched (one nn1_batched call on the card): fitness
    within float32 rounding (rtol 1e-5), information matrices 1e-5
    relative; a mixed-capacity batch takes the per-pair path."""
    kfs, _, est, pk, _ = line_course()
    pairs = [(0, 1), (1, 2), (2, 4), (3, 5)]
    rel = [np.linalg.inv(est[a]) @ est[b] for a, b in pairs]
    calc, jcalc = InformationMatrixCalculator(), JInfo()
    ours = calc.calc_information_matrices_batched([(pk[a].cloud, pk[b].cloud, r) for (a, b), r in zip(pairs, rel)])
    ref = jcalc.calc_information_matrices_batched([(kfs[a].cloud, kfs[b].cloud, r) for (a, b), r in zip(pairs, rel)])
    for (a, b), r, io, ir in zip(pairs, rel, ours, ref):
        f = calc.calc_fitness_score(pk[a].cloud, pk[b].cloud, r)
        fj = jcalc.calc_fitness_score(kfs[a].cloud, kfs[b].cloud, r)
        np.testing.assert_allclose(f, fj, rtol=1e-5)
        np.testing.assert_allclose(io, ir, rtol=1e-5)
        # per pair vs batched: the moved points round differently in a
        # batched product (measured 4.7e-6 relative in the information)
        np.testing.assert_allclose(calc.calc_information_matrix(pk[a].cloud, pk[b].cloud, r), io, rtol=1e-5)
    small = cloud.PointCloud(xyz=pk[0].cloud.xyz[:1024], mask=pk[0].cloud.mask[:1024])
    mixed = calc.calc_information_matrices_batched([(pk[1].cloud, pk[0].cloud, rel[0]), (pk[2].cloud, small, rel[1])])
    np.testing.assert_allclose(mixed[0], ours[0], rtol=1e-5)


@pytest.mark.parametrize("shared", [True, False])
def test_batched_kernel_wrappers_equal_per_row(shared):
    """nn1_batched / knn_select_batched on CPU tensors (their plain twins)
    and the batched fitness score equal the unbatched calls row by row,
    with ragged valid counts (PAD_COORD rows)."""
    rng = np.random.default_rng(4)
    q = rng.uniform(-20, 20, (3, 300, 3)).astype(np.float32)
    t = rng.uniform(-20, 20, (3, 400, 3)).astype(np.float32)
    for b, nv in enumerate((400, 250, 30)):
        t[b, nv:] = cloud.PAD_COORD
    q, t = torch.from_numpy(q), torch.from_numpy(t)
    i, d = knn.nn1_batched(q, t)
    s_i, s_d = knn.knn_select_batched(t, t, 20)
    for b in range(3):
        i1, d1 = knn.nn1(q[b], t[b])
        assert torch.equal(i[b], i1) and torch.equal(d[b], d1)
        si1, sd1 = knn.knn_select(t[b], t[b], 20)
        assert torch.equal(s_i[b], si1) and torch.equal(s_d[b], sd1)
    mask = torch.ones(q.shape[:2], dtype=torch.bool)
    mask[1, 200:] = False
    rel = torch.eye(4).expand(3, 4, 4).clone()
    rel[:, 0, 3] = torch.tensor([0.1, -0.2, 0.3])
    tgt = t[0] if shared else t
    f = knn.fitness_score(tgt, q, mask, rel)
    for b in range(3):
        fb = knn.fitness_score(tgt if shared else t[b], q[b], mask[b], rel[b])
        np.testing.assert_allclose(float(f[b]), float(fb), rtol=1e-6)
    with pytest.raises(ValueError):
        knn.nn1_batched(q, t[:2])
    with pytest.raises(ValueError):
        knn.knn_select_batched(q[0], t[0], 20)


# -- loop detection ---------------------------------------------------------------


def test_find_candidates_matches_jax():
    kfs, new, est, pk, pn = line_course()
    cand = LoopDetector(port_loop_cfg()).find_candidates(pk, pn, est)
    cand_j = jtl.LoopDetector(jtl._cfg("FAST_GICP")).find_candidates(kfs, new, est)
    assert cand == cand_j and len(cand) >= 2
    rng = np.random.default_rng(1)
    for cap in (1, 3, 16):
        cfg, cfg_j = port_loop_cfg(), jtl._cfg("FAST_GICP")
        cfg.distance_thresh = cfg_j.distance_thresh = 20.0
        cfg.accum_distance_thresh = cfg_j.accum_distance_thresh = float(rng.uniform(0.0, 12.0))
        cfg.max_candidates = cfg_j.max_candidates = cap
        assert (LoopDetector(cfg).find_candidates(pk, pn, est)
                == jtl.LoopDetector(cfg_j).find_candidates(kfs, new, est))


@pytest.mark.parametrize("reassoc", [0.0, 0.1])
def test_batched_match_matches_jax_and_sequential(reassoc):
    """The batched GICP loop match (padded to 4 with a repeated candidate)
    against the JAX ``_batched_match`` on the same clouds: transforms within
    1e-4 (test_torch_gicp.py's alignment tolerance), the same convergence
    and fitness within 1e-4 relative; and the port's batch equals its own
    sequential per-candidate path within 1e-5, with the same flags."""
    kfs, new, est, pk, pn = line_course()
    ids = [0, 1, 2]
    guesses = guesses_for(est, new.node_id, ids)
    det = LoopDetector(port_loop_cfg(reg_reassoc_displacement=reassoc))
    sb = det._match_batched([pk[i].cloud for i in ids], pn.cloud, guesses)
    ss = det._match_sequential([pk[i].cloud for i in ids], pn.cloud, guesses)
    np.testing.assert_allclose(np.asarray(sb[0], np.float64), ss[0], rtol=1e-5)
    for tb, ts in zip(sb[1], ss[1]):
        np.testing.assert_allclose(tb, ts, atol=1e-5)
    assert [bool(c) for c in sb[2]] == ss[2]

    # the JAX reference, batch padded as _match_batched pads it
    c = det.cfg.registration
    srcs = [kfs[i].cloud for i in ids] + [kfs[ids[0]].cloud]
    gs = guesses + [guesses[0]]
    tgt_state = jgicp.preprocess(new.cloud, k=20)
    tj, cj, fj = j_batched_match(
        tgt_state, jnp.where(new.cloud.mask[:, None], new.cloud.xyz, 1.0e6),
        jnp.stack([s.xyz for s in srcs]), jnp.stack([s.mask for s in srcs]), jnp.asarray(np.stack(gs), jnp.float32),
        method="GICP", k=20, max_corr_dist=c.reg_max_correspondence_distance,
        transformation_epsilon=c.reg_transformation_epsilon, max_iterations=c.reg_maximum_iterations,
        reassoc_displacement=reassoc, nn_search=c.reg_nn_search_method,
        use_reciprocal=c.reg_use_reciprocal_correspondences, fitness_max_range=float("inf"))
    for b in range(len(ids)):
        np.testing.assert_allclose(sb[1][b], np.asarray(tj[b]), atol=1e-4)
        assert bool(sb[2][b]) == bool(cj[b])
        np.testing.assert_allclose(float(sb[0][b]), float(fj[b]), rtol=1e-4)


def test_batched_align_rows_equal_unbatched_align():
    """Row b of the batched gicp.align (and preprocess) is the
    unbatched align of candidate b: poses within 1e-5, the same convergence
    and iteration count."""
    _, _, est, pk, pn = line_course()
    ids = [0, 1, 3, 4]
    tgt = gicp.preprocess(pn.cloud)
    xyz = torch.stack([pk[i].cloud.xyz for i in ids])
    mask = torch.stack([pk[i].cloud.mask for i in ids])
    src = gicp.preprocess(cloud.PointCloud(xyz=xyz, mask=mask))
    guesses = torch.from_numpy(np.stack(guesses_for(est, pn.node_id, ids))).float()
    res = gicp.align(tgt, src, guesses, max_iterations=20, reassoc_displacement=0.1)
    for b, i in enumerate(ids):
        one = gicp.preprocess(pk[i].cloud)
        np.testing.assert_allclose(src.covs[b].numpy(), one.covs.numpy(), atol=1e-5)
        r = gicp.align(tgt, one, guesses[b], max_iterations=20, reassoc_displacement=0.1)
        np.testing.assert_allclose(res.transformation[b].numpy(), r.transformation.numpy(), atol=1e-5)
        assert bool(res.converged[b]) == bool(r.converged)
        assert int(res.iterations[b]) == int(r.iterations)


def test_detect_picks_the_jax_candidate():
    kfs, new, est, pk, pn = line_course()
    loops = LoopDetector(port_loop_cfg()).detect(pk, [pn], est)
    loops_j = jtl.LoopDetector(jtl._cfg("FAST_GICP")).detect(kfs, [new], est)
    assert len(loops) == len(loops_j) == 1
    assert loops[0].key2.node_id == loops_j[0].key2.node_id == 0
    np.testing.assert_allclose(loops[0].relative_pose, loops_j[0].relative_pose, atol=1e-4)
    np.testing.assert_allclose(loops[0].fitness, loops_j[0].fitness, rtol=1e-4)


# -- the backend on a course -------------------------------------------------------


def _course_cfg(cfg):
    """test_golden_loop_closure_corrects_injected_drift's backend config."""
    cfg.backend.keyframe_delta_trans = 1.5
    cfg.backend.max_keyframes_per_update = 100
    cfg.backend.g2o_solver_num_iterations = 60
    cfg.loop.distance_thresh = 4.0
    cfg.loop.accum_distance_thresh = 8.0
    cfg.loop.min_edge_interval = 4.0
    cfg.loop.fitness_score_thresh = 1.0
    return cfg


def test_backend_course_matches_jax():
    """HdlGraphSlam on both sides, fed the same drifted odometry and the
    same 2048-row room scans around a closed square: the same keyframes
    (stamps), the same loop-edge vertex pairs, trajectories within 1e-3 m
    (loop transforms differ by float32 alignment rounding, ~1e-5, which the
    float64 solve carries into the poses), and loop closure halves ATE."""
    poses = drive_square(side=4.5, step=1.5, turn_steps=4)
    truth = []
    for p in poses:
        s = p.copy()
        s[2, 3] += 1.8
        truth.append(s)
    odo = _drifted_odometry(truth)
    slam = HdlGraphSlam(_course_cfg(SlamConfig()), device="cpu")
    slam_j = JHdlGraphSlam(_course_cfg(JSlamConfig()))
    for i in range(len(poses)):
        scan = room_scan(truth[i], seed=i)
        slam.add_frame(float(i), odo[i], cloud.from_numpy(scan, capacity=2048, device="cpu"))
        slam_j.add_frame(float(i), odo[i], jcloud.from_numpy(scan, capacity=2048))
        if i % 5 == 4:
            assert slam.optimize_cycle() == slam_j.optimize_cycle()
    slam.flush()
    slam_j.flush()

    est, est_j = slam.trajectory(), slam_j.trajectory()
    assert [s for s, _ in est] == [s for s, _ in est_j]
    rows, rows_j = slam.graph.edge_rows["se3_se3"], slam_j.graph.edge_rows["se3_se3"]
    assert [(r["vi"], r["vj"]) for r in rows] == [(r["vi"], r["vj"]) for r in rows_j]
    n_loops = len(rows) - (len(slam.keyframes) - 1)
    assert n_loops >= 1
    for r, rj in zip(rows, rows_j):
        np.testing.assert_allclose(r["meas"], rj["meas"], atol=1e-4)
        np.testing.assert_allclose(r["info"], rj["info"], rtol=1e-3)
    for (_, T), (_, Tj) in zip(est, est_j):
        np.testing.assert_allclose(T, Tj, atol=1e-3)
    ref = [(float(i), T) for i, T in enumerate(truth)]
    odom_kf = [(float(i), odo[i]) for i in range(len(odo)) if float(i) in {s for s, _ in est}]
    assert traj_io.ate_rmse(est, ref) < 0.5 * traj_io.ate_rmse(odom_kf, ref)


# -- what is left out, and the device rule -------------------------------------------


@pytest.mark.parametrize("method,item", [("FAST_VGICP", "7"), ("NDT_OMP", "8"), ("ICP", "9")])
def test_unported_registration_methods_raise(method, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        factory.select_registration_method(RegistrationConfig(registration_method=method))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        LoopDetector(port_loop_cfg(method))


def test_unported_backend_branches_raise():
    slam = HdlGraphSlam(SlamConfig(), device="cpu")
    for call in (lambda: slam.generate_map(), lambda: slam.save_map("x.pcd"), lambda: slam.dump("d"),
                 lambda: slam.load("d")):
        with pytest.raises(NotImplementedError, match="item 12"):
            call()
    for field in ("distributed", "submap_block_size"):
        cfg = SlamConfig()
        setattr(cfg.backend, field, True if field == "distributed" else 16)
        with pytest.raises(NotImplementedError, match="item 14"):
            HdlGraphSlam(cfg, device="cpu")


def test_backend_defaults_to_cuda():
    if torch.cuda.is_available():
        assert HdlGraphSlam().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HdlGraphSlam()
