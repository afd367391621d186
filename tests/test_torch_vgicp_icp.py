"""Parity of the port's VGICP and ICP (hdl_graph_slam_tpu_torch/registration/
vgicp.py, icp.py, the VGICP and ICP branches of factory.py) with the JAX
reference, on the CPU, where the kernel wrappers run their plain twins.

Mirrors tests/test_registration.py TestVGICP, TestGatedReassociation
(FAST_VGICP), TestDenseGridParity::test_vgicp_dense_grid_matches_search,
TestICP and TestProcrustesRotation, with the same float32 inputs through
both packages (the JAX suite runs with x64 on, so every array handed to JAX
here is float32 explicitly).

Tolerances: single aligns 1e-4 on the pose (POSE_ATOL, as
tests/test_torch_ndt.py); the VGICP association identical rows; the
Procrustes rotation 1e-6 against JAX's.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import RegistrationConfig as JRegistrationConfig
from hdl_graph_slam_tpu.registration import Registration as JRegistration
from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu.registration import icp as jicp
from hdl_graph_slam_tpu.registration import vgicp as jvgicp
from hdl_graph_slam_tpu_torch.core import cloud, se3
from hdl_graph_slam_tpu_torch.core.config import RegistrationConfig
from hdl_graph_slam_tpu_torch.ops import voxel
from hdl_graph_slam_tpu_torch.registration import factory, gicp, icp, ndt, vgicp
from test_registration import synthetic_scene, true_transform

POSE_ATOL = 1e-4
PROCRUSTES_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's CPU work (tests/test_torch_ndt.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def scene(n=2000, seed=0):
    """(target, source, T_true): the source is the scene in its own frame,
    the target the scene seen from T_true (test_registration._check_recovery)."""
    pts = synthetic_scene(n, seed=seed)
    T_true = np.asarray(true_transform(np.float32), dtype=np.float32)
    return (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32), pts, T_true


def pc(x, capacity=None):
    return cloud.from_numpy(x, capacity=capacity, device="cpu")


@functools.lru_cache(maxsize=None)
def vgicp_targets(grid_size=voxel.DENSE_GRID_SIZE, res=1.0):
    tgt_pts, _, _ = scene()
    tj = jvgicp.preprocess_target(jcloud.from_numpy(tgt_pts), res, max_voxels=4096, grid_size=grid_size)
    tp = vgicp.preprocess_target(pc(tgt_pts), res, max_voxels=4096, grid_size=grid_size)
    return tj, tp


@functools.lru_cache(maxsize=None)
def sources():
    _, pts, _ = scene()
    return jgicp.preprocess(jcloud.from_numpy(pts)), gicp.preprocess(pc(pts))


def assert_same_result(res, res_j, atol=POSE_ATOL):
    """Pose within atol, iterations within 1, the same convergence."""
    np.testing.assert_allclose(res.transformation.numpy(), np.asarray(res_j.transformation), atol=atol)
    assert abs(int(res.iterations) - int(res_j.iterations)) <= 1
    assert bool(res.converged) == bool(res_j.converged)


def trans_err(T, T_true):
    return float(np.linalg.norm((np.linalg.inv(np.asarray(T, np.float64)) @ T_true)[:3, 3]))


# -- the VGICP target and its association ---------------------------------------------


@pytest.mark.parametrize("grid_size", [voxel.DENSE_GRID_SIZE, 0])
def test_vgicp_preprocess_target_matches_jax(grid_size):
    """Keys, mask, origin and the dense grid identical; voxel means exact to
    float32 summation (1e-6 m), covariances within the GICP preprocess
    tolerance (1e-4; test_torch_gicp.py); ``src=`` (the cloud's own
    prepared source) builds the same target bit for bit."""
    tj, tp = vgicp_targets(grid_size)
    np.testing.assert_array_equal(tp.keys.numpy(), np.asarray(tj.keys))
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(tj.mask))
    np.testing.assert_array_equal(tp.origin.numpy(), np.asarray(tj.origin))
    assert tp.resolution == float(np.float32(tj.resolution))
    m = tp.mask.numpy()
    assert m.sum() > 100
    np.testing.assert_allclose(tp.means.numpy(), np.asarray(tj.means), atol=1e-6)
    np.testing.assert_allclose(tp.covs.numpy()[m], np.asarray(tj.covs)[m], atol=1e-4)
    if grid_size:
        np.testing.assert_array_equal(tp.grid.numpy(), np.asarray(tj.grid))
    else:
        assert tp.grid is None and tj.grid is None
    tgt_pts, _, _ = scene()
    again = vgicp.preprocess_target(pc(tgt_pts), 1.0, max_voxels=4096, grid_size=grid_size,
                                    src=gicp.preprocess(pc(tgt_pts)))
    for f in dataclasses.fields(tp):
        a, b = getattr(again, f.name), getattr(tp, f.name)
        assert a == b if not isinstance(a, torch.Tensor) else torch.equal(a, b), f.name


def test_vgicp_target_keeps_every_occupied_voxel():
    """ADDITIVE aggregation: a voxel holding a single point is kept (no
    min_points), its covariance the point's own regularized covariance;
    over capacity the lowest keys win, as the JAX target's."""
    tgt_pts, _, _ = scene()
    tp = vgicp.preprocess_target(pc(tgt_pts), 1.0, max_voxels=64, grid_size=0)
    tj = jvgicp.preprocess_target(jcloud.from_numpy(tgt_pts), 1.0, max_voxels=64, grid_size=0)
    np.testing.assert_array_equal(tp.keys.numpy(), np.asarray(tj.keys))
    assert bool(tp.mask.all())
    lone = np.array([[0.0, 0.0, 0.0], [5.5, 5.5, 5.5]] + [[0.1 * i, 0.05 * i, 0.0] for i in range(30)], np.float32)
    t1 = vgicp.preprocess_target(pc(lone), 1.0, max_voxels=64, grid_size=0)
    g = gicp.preprocess(pc(lone))
    row = int(torch.nonzero(t1.keys == voxel.pack_local_keys(voxel.local_cells(torch.tensor(lone[1:2]), 1.0),
                                                             t1.origin, torch.tensor([True])))[0, 0])
    assert bool(t1.mask[row])
    np.testing.assert_array_equal(t1.covs[row].numpy(), g.covs[1].numpy())
    np.testing.assert_array_equal(t1.means[row].numpy(), lone[1])


@pytest.mark.parametrize("grid_size", [voxel.DENSE_GRID_SIZE, 0])
def test_vgicp_association_matches_jax(grid_size):
    """associate_cells (DIRECT1) over the VGICP voxel table against the JAX
    ``_correspond`` at a pose off the truth: identical rows and flags, one
    problem and a batch of 3 (each row its own pose); and the NDT wrapper
    ``associate`` is associate_cells over the target's cells."""
    tj, tp = vgicp_targets(grid_size)
    _, pts, T_true = scene()
    rng = np.random.default_rng(2)
    poses = np.stack([T_true @ np.asarray(se3.se3_exp(torch.tensor(rng.normal(0, 0.05, 6), dtype=torch.float32)))
                      for _ in range(3)]).astype(np.float32)
    src = pc(pts)
    xyz = src.xyz[None].expand(3, -1, -1).contiguous()
    mask = src.mask[None].expand(3, -1).contiguous()
    idx, found = ndt.associate_cells(tp, tp.grid, xyz, mask, torch.from_numpy(poses), "DIRECT1")
    for b in range(3):
        T = poses[b]
        moved = jnp.asarray(src.xyz.numpy()) @ jnp.asarray(T[:3, :3]).T + jnp.asarray(T[:3, 3])
        idx_j, found_j = jvgicp._correspond(tj, moved, jnp.asarray(np.asarray(src.mask)))
        fj = np.asarray(found_j)
        np.testing.assert_array_equal(found[b, :, 0].numpy(), fj)
        np.testing.assert_array_equal(idx[b, :, 0].numpy()[fj], np.asarray(idx_j)[fj])
        assert fj.sum() > 0.4 * len(pts)  # the floor's points straddle z cell faces
        one = ndt.associate_cells(tp, tp.grid, xyz[:1], mask[:1], torch.from_numpy(poses[b:b + 1]), "DIRECT1")
        assert torch.equal(one[0][0], idx[b]) and torch.equal(one[1][0], found[b])
    nt = ndt.preprocess_target(pc(scene()[0]), 2.0, max_voxels=1024, grid_size=grid_size)
    T = torch.from_numpy(poses[:1])
    for a, c in zip(ndt.associate(nt, xyz[:1], mask[:1], T, "DIRECT7"),
                    ndt.associate_cells(nt.voxels, nt.grid, xyz[:1], mask[:1], T, "DIRECT7")):
        assert torch.equal(a, c)


# -- VGICP alignment ---------------------------------------------------------------------


def test_vgicp_recover_transform_matches_jax():
    """TestVGICP::test_recover_transform through both factories (1.0 m
    voxels, max_voxels 4096): converged, within 0.05 m / 0.02 rad of the
    truth, on JAX's pose."""
    tgt_pts, pts, T_true = scene()
    reg = factory.Registration(RegistrationConfig(registration_method="FAST_VGICP", reg_resolution=1.0),
                               max_voxels=4096)
    reg.set_target(pc(tgt_pts))
    res = reg.align(pc(pts))
    reg_j = JRegistration(JRegistrationConfig(registration_method="FAST_VGICP", reg_resolution=1.0), max_voxels=4096)
    reg_j.set_target(jcloud.from_numpy(tgt_pts))
    res_j = reg_j.align(jcloud.from_numpy(pts), guess=jnp.eye(4, dtype=jnp.float32))
    assert_same_result(res, res_j)
    assert bool(res.converged) and trans_err(res.transformation.numpy(), T_true) < 0.05
    err = np.linalg.inv(res.transformation.numpy().astype(np.float64)) @ T_true
    assert float(se3.rotation_angle(torch.from_numpy(err[:3, :3]))) < 0.02
    assert reg.method == "VGICP" and isinstance(reg._target_state, vgicp.VgicpTarget)
    # mean squared 1-NN distance ~7e-7 m^2: poses 1e-4 apart move it by ~1e-10
    np.testing.assert_allclose(reg.get_fitness_score(), reg_j.get_fitness_score(), rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("disp", [0.0, 0.1])
def test_vgicp_gated_reassociation_matches_jax(disp):
    """TestGatedReassociation FAST_VGICP row (3000 points, 1.0 m): each of
    per-iteration re-association and the 0.1 m displacement gate on JAX's
    pose; the two within 5e-3 of each other and 0.05 m of the truth."""
    pts = synthetic_scene(3000)
    T_true = np.asarray(true_transform(np.float32), dtype=np.float32)
    tgt_pts = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    out = {}
    for d in (0.0, disp):
        cfg = RegistrationConfig(registration_method="FAST_VGICP", reg_resolution=1.0, reg_reassoc_displacement=d)
        reg = factory.Registration(cfg, max_voxels=4096)
        reg.set_target(pc(tgt_pts))
        out[d] = reg.align(pc(pts))
        assert bool(out[d].converged)
    cfg_j = JRegistrationConfig(registration_method="FAST_VGICP", reg_resolution=1.0, reg_reassoc_displacement=disp)
    reg_j = JRegistration(cfg_j, max_voxels=4096)
    reg_j.set_target(jcloud.from_numpy(tgt_pts))
    assert_same_result(out[disp], reg_j.align(jcloud.from_numpy(pts), guess=jnp.eye(4, dtype=jnp.float32)))
    d = np.linalg.inv(out[0.0].transformation.numpy().astype(np.float64)) @ out[disp].transformation.numpy()
    assert np.linalg.norm(d[:3, 3]) < 5e-3
    assert trans_err(out[disp].transformation.numpy(), T_true) < 0.05


def test_vgicp_dense_grid_matches_search():
    """TestDenseGridParity::test_vgicp_dense_grid_matches_search: the 64³
    grid and the key search land on the same pose (1e-5), each on JAX's."""
    _, sp = sources()
    sj, _ = sources()
    res = {}
    for G in (64, 0):
        tj, tp = vgicp_targets(G)
        res[G] = vgicp.align(tp, sp, torch.eye(4))
        assert_same_result(res[G], jvgicp.align(tj, sj, jnp.eye(4, dtype=jnp.float32)))
    np.testing.assert_allclose(res[64].transformation.numpy(), res[0].transformation.numpy(), atol=1e-5)


def test_vgicp_linearization_matches_jax():
    """One association and linearization at a pose off the truth: the same
    inlier count, H and b within 1e-4 of their largest entry, cost 1e-5
    relative (the float32 covariances' rounding)."""
    tj, tp = vgicp_targets()
    sj, sp = sources()
    T = torch.from_numpy(scene()[2]) @ se3.se3_exp(torch.tensor([0.05, -0.03, 0.01, 0.005, 0.0, -0.01]))
    Tj = jnp.asarray(T.numpy())
    corr = vgicp._associate(T[None], gicp.GicpCloud(sp.xyz[None], sp.mask[None], sp.covs[None]), tp)
    corr_j = jvgicp._associate(Tj, sj, tj)
    assert int(corr.num[0]) == int(corr_j.num)
    H, b, cost, _ = gicp.linearize(T[None], corr, gicp.GicpCloud(sp.xyz[None], sp.mask[None], sp.covs[None]),
                                   tp.means)
    H_j, b_j, cost_j, _ = jvgicp._linearize_at(Tj, corr_j, sj, tj)
    H_j, b_j = np.asarray(H_j), np.asarray(b_j)
    assert np.abs(H[0].numpy() - H_j).max() <= 1e-4 * np.abs(H_j).max()
    assert np.abs(b[0].numpy() - b_j).max() <= 1e-4 * np.abs(b_j).max()
    np.testing.assert_allclose(float(cost[0]), float(cost_j), rtol=1e-5)


# -- ICP --------------------------------------------------------------------------------


@pytest.mark.parametrize("reciprocal", [False, True])
def test_icp_recover_transform_matches_jax(reciprocal):
    """TestICP::test_recover_transform (2000 points; within 0.1 m / 0.05
    rad), with and without reciprocal correspondences, on JAX's pose, the
    same iterations, inliers and error to float32 rounding."""
    tgt_pts, pts, T_true = scene()
    cfg = RegistrationConfig(registration_method="ICP", reg_use_reciprocal_correspondences=reciprocal)
    reg = factory.Registration(cfg, max_voxels=4096)
    reg.set_target(pc(tgt_pts))
    res = reg.align(pc(pts))
    res_j = jicp.align(jcloud.from_numpy(tgt_pts), jcloud.from_numpy(pts), jnp.eye(4, dtype=jnp.float32),
                       use_reciprocal=reciprocal)
    assert_same_result(res, res_j)
    assert int(res.num_inliers) == int(res_j.num_inliers)
    # the mean squared pair distance (~1e-6 m^2) of poses within POSE_ATOL:
    # |d2 - d2'| <= 2 sqrt(d2) 1e-4 + 1e-8 ~ 2.2e-7
    np.testing.assert_allclose(float(res.error), float(res_j.error), atol=3e-7)
    assert bool(res.converged) and trans_err(res.transformation.numpy(), T_true) < 0.1
    assert reg.method == "ICP" and factory.elementwise_target(reg._target_state)


@pytest.mark.parametrize("method", ["FAST_VGICP", "ICP"])
def test_batched_align_rows_equal_single_aligns(method):
    """A leading batch of 3 sources (each its own guess and cloud) against
    one target: row b within 1e-5 of the single align of b with the same
    iterations and flags, and a batch of one is the single align bit for
    bit (the single source is the batch of one)."""
    tgt_pts, pts, T_true = scene()
    cfg = RegistrationConfig(registration_method=method, reg_resolution=1.0)
    tgt = factory.make_target(cfg, pc(tgt_pts), 4096)
    rng = np.random.default_rng(5)
    clouds = [pc(synthetic_scene(2000, seed=s)) for s in (0, 1, 2)]
    guesses = torch.stack([se3.se3_exp(torch.tensor(rng.normal(0, 0.05, 6), dtype=torch.float32)) for _ in range(3)])
    batch = cloud.PointCloud(xyz=torch.stack([c.xyz for c in clouds]), mask=torch.stack([c.mask for c in clouds]))
    src = factory.prepare_source(cfg, batch)
    res = factory.align(cfg, tgt, src, guesses)
    for b in range(3):
        one_src = factory.prepare_source(cfg, clouds[b])
        one = factory.align(cfg, tgt, one_src, guesses[b])
        np.testing.assert_allclose(res.transformation[b].numpy(), one.transformation.numpy(), atol=1e-5)
        assert int(res.iterations[b]) == int(one.iterations) and bool(res.converged[b]) == bool(one.converged)
    row0 = type(src)(**{f.name: getattr(src, f.name)[:1] for f in dataclasses.fields(src)
                        if getattr(src, f.name) is not None})
    b1 = factory.align(cfg, tgt, row0, guesses[:1])
    single = factory.align(cfg, tgt, type(src)(**{f.name: getattr(row0, f.name)[0] for f in dataclasses.fields(row0)
                                                  if getattr(row0, f.name) is not None}), guesses[0])
    for x, y in zip(b1, single):
        assert torch.equal(x[0], y)


def svd_ref(S):
    U, _, Vt = np.linalg.svd(S)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    return Vt.T @ np.diag([1.0, 1.0, d]) @ U.T


def test_procrustes_matches_jax_and_svd():
    """TestProcrustesRotation::test_matches_svd_solution: 20 generic (half
    reflected) and 5 near-planar cross-covariances in float64, and the same
    in float32: within 1e-6 of JAX's rotation, a proper rotation, within
    5e-4 of the SVD solution; all 25 in one batched call too."""
    rng = np.random.default_rng(4)
    cases = [rng.normal(size=(3, 3)) for _ in range(20)]
    for _ in range(5):
        A = rng.normal(size=(3, 3))
        A[:, 2] *= 1e-5
        cases.append(A)
    batch = icp.procrustes_rotation(torch.from_numpy(np.stack(cases)))
    for i, S in enumerate(cases):
        R = icp.procrustes_rotation(torch.from_numpy(S)).numpy()
        np.testing.assert_allclose(R, np.asarray(jicp.procrustes_rotation(jnp.asarray(S))), atol=PROCRUSTES_ATOL)
        assert abs(np.linalg.det(R) - 1.0) < 1e-6
        np.testing.assert_allclose(R, svd_ref(S), atol=5e-4)
        np.testing.assert_allclose(batch[i].numpy(), R, atol=1e-12)
        S32 = S.astype(np.float32)
        R32 = icp.procrustes_rotation(torch.from_numpy(S32)).numpy()
        np.testing.assert_allclose(R32, np.asarray(jicp.procrustes_rotation(jnp.asarray(S32))), atol=PROCRUSTES_ATOL)


def test_degenerate_cross_covariance_stays_on_so3():
    """TestProcrustesRotation::test_degenerate_cross_covariance_stays_on_so3:
    zero, rank-1, z-aligned rank-1 and tiny-noise cross-covariances give a
    proper rotation (the identity for the no-information cases), JAX's
    within 1e-6."""
    rng = np.random.default_rng(5)
    z = np.zeros((3, 3))
    rank1 = np.outer([0.0, 0.0, 1.0], [0.0, 0.0, 1.0])
    rank1b = np.outer([1.0, 0.0, 0.0], [0.6, 0.8, 0.0])
    tiny = rng.normal(size=(3, 3)) * 1e-14
    for S in (z, rank1, rank1b, tiny):
        S32 = S.astype(np.float32)
        R = icp.procrustes_rotation(torch.from_numpy(S32)).numpy()
        assert np.isfinite(R).all(), S
        assert abs(np.linalg.det(R) - 1.0) < 1e-4, (S, R)
        assert np.abs(R @ R.T - np.eye(3)).max() < 1e-4, (S, R)
        np.testing.assert_allclose(R, np.asarray(jicp.procrustes_rotation(jnp.asarray(S32))), atol=PROCRUSTES_ATOL)
    np.testing.assert_allclose(icp.procrustes_rotation(torch.zeros(3, 3)).numpy(), np.eye(3), atol=1e-6)


def test_svd_rigid_matches_jax():
    """The weighted Umeyama step on the same pairs: within 1e-6."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=(500, 3)).astype(np.float32) * 5
    T = np.asarray(se3.se3_exp(torch.tensor([0.2, -0.1, 0.05, 0.03, -0.02, 0.1])), np.float32)
    b = (a @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, a.shape)).astype(np.float32)
    w = (rng.random(500) < 0.8).astype(np.float32)
    got = icp._svd_rigid(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(w)).numpy()
    ref = np.asarray(jicp._svd_rigid(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got, T, atol=5e-3)


def test_factory_maps_every_reference_method():
    """method_of as the JAX factory maps the reference's names; GICP and ICP
    targets may switch elementwise, NDT's and VGICP's are builds."""
    names = {"FAST_GICP": "GICP", "GICP": "GICP", "GICP_OMP": "GICP", "FAST_VGICP": "VGICP",
             "FAST_VGICP_CUDA": "VGICP", "ICP": "ICP", "NDT": "NDT", "NDT_OMP": "NDT"}
    for name, family in names.items():
        cfg = RegistrationConfig(registration_method=name)
        assert factory.method_of(cfg) == family == JRegistration(JRegistrationConfig(registration_method=name)).method
    c = pc(scene()[0][:500])
    assert factory.elementwise_target(factory.make_target(RegistrationConfig(registration_method="ICP"), c))
    assert not factory.elementwise_target(
        factory.make_target(RegistrationConfig(registration_method="FAST_VGICP"), c, 1024))
