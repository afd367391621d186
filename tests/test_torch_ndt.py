"""Parity of the port's NDT (hdl_graph_slam_tpu_torch/registration/ndt.py,
the Gaussian-voxel and dense-grid half of ops/voxel.py) with the JAX
reference, on the CPU, where the kernel wrappers run their plain twins.

Each JAX test of NDT is mirrored (tests/test_registration.py TestNDT,
TestDenseGridParity, TestNdtFixedCellLineSearch, TestNdtQuadExp,
TestNdtAnalyticDerivatives, TestNdtSmallStepLargeScene, TestNdtKdtreeMode;
tests/test_ops.py's indefinite-icov belt; tests/test_window.py
test_ndt_device; tests/test_pipeline.py test_ndt_odometry and
test_runs_with_imu), with the same float32 inputs through both packages.
The JAX suite runs with x64 enabled, so every array handed to JAX here is
float32 explicitly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.backend.loop_detector import _batched_match as j_batched_match
from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core import se3 as jse3
from hdl_graph_slam_tpu.core.config import OdometryConfig as JOdometryConfig
from hdl_graph_slam_tpu.core.config import RegistrationConfig as JRegistrationConfig
from hdl_graph_slam_tpu.frontend.odometry import ScanMatchingOdometry as JScanMatchingOdometry
from hdl_graph_slam_tpu.ops import voxel as jvoxel
from hdl_graph_slam_tpu.registration import Registration as JRegistration
from hdl_graph_slam_tpu.registration import ndt as jndt
from hdl_graph_slam_tpu_torch.core import cloud, se3
from hdl_graph_slam_tpu_torch.core.config import PRESETS, OdometryConfig, RegistrationConfig
from hdl_graph_slam_tpu_torch.frontend import DeviceOdometry, OdometryWindow, ScanMatchingOdometry
from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
from hdl_graph_slam_tpu_torch.ops import voxel
from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline
from hdl_graph_slam_tpu_torch.registration import factory, ndt
from hdl_graph_slam_tpu_torch.backend.loop_detector import batched_match
from test_pipeline import drive_square, make_world, scan_at
from test_registration import synthetic_scene, true_transform


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's CPU work: the tier-1 lane runs
    six workers on the machine's cores, where more threads a worker only
    contend (as tests/test_torch_cli.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Final poses of the same align on both sides. Both run the same float32
# Newton loop; they differ by rounding (einsum orders, the closed-form
# eigensolver's float32 cos/arccos), which moves a pose by ~1e-6 here.
POSE_ATOL = 1e-4


def tgt_and_src(n=2000):
    pts = synthetic_scene(n)
    T_true = np.asarray(true_transform(np.float32), dtype=np.float32)
    return (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32), pts, T_true


def both_targets(tgt_pts, res=2.0, max_voxels=4096, grid_size=voxel.DENSE_GRID_SIZE, capacity=None):
    tj = jndt.preprocess_target(jcloud.from_numpy(tgt_pts, capacity=capacity), res, max_voxels=max_voxels,
                                grid_size=grid_size)
    tp = ndt.preprocess_target(cloud.from_numpy(tgt_pts, capacity=capacity, device="cpu"), res,
                               max_voxels=max_voxels, grid_size=grid_size)
    return tj, tp


def trans_err(T, T_true):
    return float(np.linalg.norm((np.linalg.inv(np.asarray(T, np.float64)) @ T_true)[:3, 3]))


def assert_same_result(res, res_j):
    """Pose within POSE_ATOL, iterations within 1, the same convergence."""
    np.testing.assert_allclose(res.transformation.numpy(), np.asarray(res_j.transformation), atol=POSE_ATOL)
    assert abs(int(res.iterations) - int(res_j.iterations)) <= 1
    assert bool(res.converged) == bool(res_j.converged)


# -- ops/voxel.py ------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def voxel_case():
    rng = np.random.default_rng(0)
    x = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    x[:, 2] *= 0.1
    m = rng.random(3000) < 0.9
    x[~m] = cloud.PAD_COORD
    gj = jvoxel.build_gaussian_voxels(jcloud.PointCloud(xyz=jnp.asarray(x), mask=jnp.asarray(m)), 2.0, 1024)
    gp = voxel.build_gaussian_voxels(cloud.PointCloud(xyz=torch.from_numpy(x), mask=torch.from_numpy(m)), 2.0, 1024)
    return gj, gp


def test_build_gaussian_voxels_matches_jax():
    """Keys, means, counts, mask and origin equal; covariances within 1e-4 of
    the largest entry on the valid cells. The raw sums are the same
    row-order sums; the eigenvalue floor's closed-form float32 eigensolver
    (cos/arccos of both libraries) rounds differently (measured 2e-5 of
    0.67). Masked cells carry no usable covariance (icov 0)."""
    gj, gp = voxel_case()
    for f in ("keys", "means", "counts", "mask", "origin"):
        np.testing.assert_array_equal(getattr(gp, f).numpy(), np.asarray(getattr(gj, f)), err_msg=f)
    valid = gp.mask.numpy()
    covs, covs_j = gp.covs.numpy()[valid], np.asarray(gj.covs)[valid]
    np.testing.assert_allclose(covs, covs_j, atol=1e-4 * np.abs(covs_j).max())
    assert gp.resolution == 2.0 and valid.sum() > 50


def test_dense_grid_and_lookups_match_jax():
    """build_dense_grid, neighbor_query_keys, lookup_dense and lookup_voxels
    equal, element for element, on queries inside and outside the grid."""
    gj, gp = voxel_case()
    grid_j, grid_p = jvoxel.build_dense_grid(gj.keys, gj.mask, 64), voxel.build_dense_grid(gp.keys, gp.mask, 64)
    np.testing.assert_array_equal(grid_p.numpy(), np.asarray(grid_j))
    assert voxel.grid_dim(grid_p) == 64 and voxel.dense_grid_size_for(2.0) == jvoxel.dense_grid_size_for(2.0)
    assert [voxel.dense_grid_size_for(r) for r in (0.5, 1.0, 2.0, 10.0)] == [256, 256, 128, 64]
    rng = np.random.default_rng(1)
    q = rng.uniform(-25, 140, (500, 3)).astype(np.float32)
    qm = rng.random(500) < 0.95
    for method in ("DIRECT7", "DIRECT1"):
        kj = jvoxel.neighbor_query_keys(gj, jnp.asarray(q), jnp.asarray(qm), jvoxel.neighbor_offsets(method))
        kp = voxel.neighbor_query_keys(gp, torch.from_numpy(q), torch.from_numpy(qm), voxel.neighbor_offsets(method))
        np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
        for a, b in zip(voxel.lookup_dense(grid_p, kp.reshape(-1), 64), jvoxel.lookup_dense(grid_j, kj.reshape(-1), 64)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(voxel.lookup_voxels(gp, kp.reshape(-1)), jvoxel.lookup_voxels(gj, kj.reshape(-1))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(voxel.query_keys_for(gp, torch.from_numpy(q), torch.from_numpy(qm)).numpy(),
                                  np.asarray(jvoxel.query_keys_for(gj, jnp.asarray(q), jnp.asarray(qm))))


def test_sort_and_search_helpers_match_jax():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 50, 300).astype(np.int32)
    ks, order = voxel.sort_with_order(torch.from_numpy(keys))
    ks_j, order_j = jvoxel.sort_with_order(jnp.asarray(keys))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(ks_j))
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    q = rng.integers(-5, 60, 100).astype(np.int32)
    np.testing.assert_array_equal(voxel.searchsorted32(ks, torch.from_numpy(q)).numpy(),
                                  np.asarray(jvoxel.searchsorted32(ks_j, jnp.asarray(q))))


# -- registration/ndt.py pieces ------------------------------------------------------


def test_preprocess_target_matches_jax():
    """Mixture constants within float32 rounding; cell rows [mean | icov]
    within 1e-4 of the largest entry on the valid cells (the icovs invert
    the floor-regularized covariances above); the grid equal."""
    tgt_pts, _, _ = tgt_and_src()
    tj, tp = both_targets(tgt_pts)
    np.testing.assert_allclose([tp.d1, tp.d2], [float(tj.d1), float(tj.d2)], rtol=1e-6)
    np.testing.assert_array_equal(tp.grid.numpy(), np.asarray(tj.grid))
    valid = tp.voxels.mask.numpy()
    rows, rows_j = tp.cell_rows.numpy()[valid], np.asarray(tj.cell_rows)[valid]
    np.testing.assert_array_equal(rows[:, :3], rows_j[:, :3])
    np.testing.assert_allclose(rows[:, 3:], rows_j[:, 3:], atol=1e-4 * np.abs(rows_j[:, 3:]).max())
    assert not tp.icovs.numpy()[~valid].any()


@pytest.mark.parametrize("method", ["DIRECT7", "DIRECT1"])
def test_association_and_scores_match_jax(method):
    """At a pose off the truth: the association (indices and flags) equals
    JAX's _gather_cells; the trial scores of 10 poses equal _score within
    1e-5 relative; derivatives equal score_derivatives within 1e-5 of the
    largest |entry| (the same inputs: JAX's cells gathered by the same
    indices)."""
    tgt_pts, src_pts, _ = tgt_and_src()
    tj, tp = both_targets(tgt_pts)
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.2, -0.1, 0.03, 0.01, 0.02, 0.05], jnp.float32)))
    src_j = jcloud.from_numpy(src_pts)
    src = cloud.from_numpy(src_pts, device="cpu")
    xyz, mask, Tt = src.xyz[None], src.mask[None], torch.from_numpy(T.copy())[None]
    moved_j = jse3.transform_points(jnp.asarray(T), src_j.xyz)
    idx_j, found_j = jndt._gather_cells(tj, moved_j, src_j.mask, jvoxel.neighbor_offsets(method))
    idx, found = ndt.associate(tp, xyz, mask, Tt, method)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(found[0].numpy(), np.asarray(found_j))

    means_j, icovs_j = jndt._gather_mean_icov(tj, idx_j)
    g_j, H_j, s_j = jndt.score_derivatives(tj.d1, tj.d2, moved_j, src_j.mask, means_j, icovs_j, found_j)
    g, H, s = ndt.derivatives(tp, xyz, mask, Tt, idx, found)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(g_j), atol=1e-5 * np.abs(np.asarray(g_j)).max())
    np.testing.assert_allclose(H[0].numpy(), np.asarray(H_j), atol=1e-5 * np.abs(np.asarray(H_j)).max())
    np.testing.assert_allclose(float(s[0]), float(s_j), rtol=1e-5)

    steps = np.linspace(0.0, 0.2, 10, dtype=np.float32)
    Ts = np.stack([np.asarray(jse3.compose(jse3.se3_exp(jnp.asarray([a, 0, 0, 0, 0, a / 4], jnp.float32)),
                                           jnp.asarray(T))) for a in steps])
    trial = ndt.trial_scores(tp, xyz, mask, torch.from_numpy(Ts)[None], idx, found)[0].numpy()
    trial_j = np.asarray(jax.vmap(lambda Tl: jndt._score(tj, jse3.transform_points(Tl, src_j.xyz), src_j.mask,
                                                         means_j, icovs_j, found_j))(jnp.asarray(Ts)))
    np.testing.assert_allclose(trial, trial_j, rtol=1e-5)
    assert np.argmin(trial) == np.argmin(trial_j)


@pytest.mark.parametrize("method", ["DIRECT7", "DIRECT1"])
def test_association_key_search_matches_jax(method):
    """The association's key-search branch (targets without a dense grid,
    lookup_voxels' binary search) equals JAX's _gather_cells, indices and
    flags, at the pose off the truth and at one that moves part of the
    source out of the target's cells."""
    tgt_pts, src_pts, _ = tgt_and_src()
    tj, tp = both_targets(tgt_pts, grid_size=0)
    assert tj.grid is None and tp.grid is None
    src_j = jcloud.from_numpy(src_pts)
    src = cloud.from_numpy(src_pts, device="cpu")
    for twist in ([0.2, -0.1, 0.03, 0.01, 0.02, 0.05], [6.0, -4.0, 1.0, 0.0, 0.0, 0.3]):
        T = np.asarray(jse3.se3_exp(jnp.asarray(twist, jnp.float32)))
        moved_j = jse3.transform_points(jnp.asarray(T), src_j.xyz)
        idx_j, found_j = jndt._gather_cells(tj, moved_j, src_j.mask, jvoxel.neighbor_offsets(method))
        idx, found = ndt.associate(tp, src.xyz[None], src.mask[None], torch.from_numpy(T.copy())[None], method)
        np.testing.assert_array_equal(idx[0].numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(found[0].numpy(), np.asarray(found_j))
        assert 0 < int(found.sum()) < found.numel()


def test_kdtree_association_matches_jax():
    """KDTREE: the 8 nearest cell means within the resolution, as the JAX
    knn_approx (exact on the CPU) finds them."""
    tgt_pts, src_pts, _ = tgt_and_src(1000)
    tj, tp = both_targets(tgt_pts, max_voxels=1024)
    src_j = jcloud.from_numpy(src_pts)
    src = cloud.from_numpy(src_pts, device="cpu")
    idx_j, found_j = jndt._gather_cells_kdtree(tj, src_j.xyz, src_j.mask)
    idx, found = ndt._gather_cells_kdtree(tp, src.xyz, src.mask)
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(np.where(found.numpy(), idx.numpy(), -1), np.where(np.asarray(found_j), idx_j, -1))


def test_score_finite_under_indefinite_icov():
    """tests/test_ops.py::test_ndt_score_finite_under_indefinite_icov: with a
    deliberately indefinite icov row the score and the derivatives stay
    finite (the Mahalanobis form is clamped at 0), in the plain function and
    through the wrappers' path; and equal JAX's within 1e-5 relative."""
    N, K = 64, 7
    rng = np.random.default_rng(25)
    moved = (rng.standard_normal((N, 3)) * 5.0).astype(np.float32)
    means = (rng.standard_normal((N, K, 3)) * 5.0).astype(np.float32)
    icovs = np.tile(np.eye(3, dtype=np.float32), (N, K, 1, 1))
    icovs[0, 0] = np.diag([-9.8e4, 2.5, 128.0]).astype(np.float32)  # the observed bad row
    found = np.ones((N, K), bool)
    mask = np.ones(N, bool)
    d1, d2 = float(np.float32(-4.1965)), float(np.float32(0.2484))
    g, H, s = ndt.score_derivatives(d1, d2, *map(torch.from_numpy, (moved, mask, means, icovs, found)))
    assert np.isfinite(float(s)) and torch.isfinite(g).all() and torch.isfinite(H).all()
    g_j, H_j, s_j = jndt.score_derivatives(jnp.float32(d1), jnp.float32(d2), *map(jnp.asarray, (moved, mask, means,
                                                                                                 icovs, found)))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(g_j)).max())
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-5)


def test_analytic_derivatives_match_autodiff_and_jax():
    """TestNdtAnalyticDerivatives: score_derivatives equals torch.func's
    gradient and Hessian of the composed mixture score through the
    quadratic exp truncation at delta = 0 (float64, rtol 1e-9), and JAX's
    score_derivatives on the same float64 inputs (rtol 1e-9)."""
    rng = np.random.default_rng(7)
    N, K = 50, 7
    moved0 = rng.normal(size=(N, 3)) * 3.0
    means = moved0[:, None, :] + rng.normal(size=(N, K, 3)) * 0.5
    A = rng.normal(size=(N, K, 3, 3)) * 0.4
    icovs = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(3)
    mask = rng.random(N) < 0.9
    found = rng.random((N, K)) < 0.8
    d1, d2 = -1.2, 0.9
    t = dict(zip(("moved0", "means", "icovs", "mask", "found"), map(torch.from_numpy, (moved0, means, icovs, mask,
                                                                                        found))))

    def quad_exp(delta):
        W = torch.zeros((4, 4), dtype=delta.dtype)
        W = W.index_put((torch.arange(3)[:, None], torch.arange(3)[None]), se3.hat(delta[3:]))
        W = W.index_put((torch.arange(3), torch.full((3,), 3)), delta[:3])
        return torch.eye(4, dtype=delta.dtype) + W + 0.5 * (W @ W)

    def loss(delta):
        T = quad_exp(delta)
        moved = t["moved0"] @ T[:3, :3].T + T[:3, 3]
        q = moved[:, None, :] - t["means"]
        md = torch.einsum("nki,nkij,nkj->nk", q, t["icovs"], q)
        return (d1 * torch.exp(-0.5 * d2 * md) * (t["found"] & t["mask"][:, None])).sum()

    zero = torch.zeros(6, dtype=torch.float64)
    g_ref, H_ref = torch.func.grad(loss)(zero), torch.func.hessian(loss)(zero)
    g, H, score = ndt.score_derivatives(d1, d2, t["moved0"], t["mask"], t["means"], t["icovs"], t["found"])
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(H.numpy(), H_ref.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(float(score), float(loss(zero)), rtol=1e-9)
    g_j, H_j, s_j = jndt.score_derivatives(jnp.asarray(d1), jnp.asarray(d2), *map(jnp.asarray, (moved0, mask, means,
                                                                                                 icovs, found)))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=1e-9, atol=1e-10)


def test_quadratic_exp_derivatives_match_exact():
    """TestNdtQuadExp: the quadratic truncation of exp that the analytic
    derivatives differentiate has the exact exponential's value, Jacobian
    and Hessian at delta = 0 (the port's se3_exp, float64)."""

    def quad(delta):
        W = torch.zeros((4, 4), dtype=delta.dtype)
        W = W.index_put((torch.arange(3)[:, None], torch.arange(3)[None]), se3.hat(delta[3:]))
        W = W.index_put((torch.arange(3), torch.full((3,), 3)), delta[:3])
        return torch.eye(4, dtype=delta.dtype) + W + 0.5 * (W @ W)

    zero = torch.zeros(6, dtype=torch.float64)
    np.testing.assert_allclose(se3.se3_exp(zero).numpy(), quad(zero).numpy(), atol=1e-12)
    jac = torch.func.jacfwd
    np.testing.assert_allclose(jac(se3.se3_exp)(zero).numpy(), jac(quad)(zero).numpy(), atol=1e-9)
    np.testing.assert_allclose(jac(jac(se3.se3_exp))(zero).numpy(), jac(jac(quad))(zero).numpy(), atol=1e-9)


def test_newton_direction_takes_the_first_certified_rung():
    """The PD shift ladder: on an SPD H the least-damped rung (Marquardt
    margin only) wins; on an indefinite H the direction is still a descent
    direction of a certified rung."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6))
    H_spd = torch.from_numpy((A @ A.T + np.eye(6)).astype(np.float32))[None]
    g = torch.from_numpy(rng.standard_normal(6).astype(np.float32))[None]
    d = ndt._newton_direction(H_spd, g, kdtree=False)
    margin = 1e-3 * torch.diagonal(H_spd[0]).abs()
    np.testing.assert_allclose(d[0].numpy(), (-torch.linalg.solve(H_spd[0] + torch.diag(margin), g[0])).numpy(),
                               rtol=1e-4, atol=1e-6)
    H_ind = H_spd.clone()
    H_ind[0, 0, 0] = -50.0
    d = ndt._newton_direction(H_ind, g, kdtree=False)
    assert float((g * d).sum()) < 0.0 and torch.isfinite(d).all()


# -- align ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["DIRECT7", "DIRECT1"])
def test_recover_transform_matches_jax(method):
    """TestNDT (test_recover_transform, test_direct1) through both
    factories: the transform recovered as the JAX test requires (0.1 m
    DIRECT7 with 0.05 rad, 0.15 m DIRECT1), and the same result as JAX."""
    tgt_pts, src_pts, T_true = tgt_and_src()
    cfg = dict(registration_method="NDT_OMP", reg_resolution=2.0, reg_nn_search_method=method)
    reg = factory.select_registration_method(RegistrationConfig(**cfg), max_voxels=4096)
    reg.set_target(cloud.from_numpy(tgt_pts, device="cpu"))
    res = reg.align(cloud.from_numpy(src_pts, device="cpu"))
    reg_j = JRegistration(JRegistrationConfig(**cfg), max_voxels=4096)
    reg_j.set_target(jcloud.from_numpy(tgt_pts))
    res_j = reg_j.align(jcloud.from_numpy(src_pts))
    assert_same_result(res, res_j)
    assert trans_err(res.transformation.numpy(), T_true) < (0.1 if method == "DIRECT7" else 0.15)
    assert reg.method == "NDT" and bool(res.converged)
    assert abs(reg.get_fitness_score() - reg_j.get_fitness_score()) < 1e-4


@pytest.mark.parametrize("fixed_cells", [True, False])
def test_dense_grid_and_search_match_jax(fixed_cells):
    """TestDenseGridParity::test_ndt_dense_grid_matches_search and
    TestNdtFixedCellLineSearch: the dense grid (64^3) and the binary search
    land on the same pose (1e-5), with fixed-cell and re-associating line
    searches alike, and on JAX's pose; the two line searches agree within
    0.05 m of each other and recover the transform (0.1 m)."""
    tgt_pts, src_pts, T_true = tgt_and_src()
    src = cloud.from_numpy(src_pts, device="cpu")
    src_j = jcloud.from_numpy(src_pts)
    out = {}
    for gs in (64, 0):
        tj, tp = both_targets(tgt_pts, grid_size=gs)
        res = ndt.align(tp, src, torch.eye(4), line_search_fixed_cells=fixed_cells)
        res_j = jndt.align(tj, src_j, jnp.eye(4, dtype=jnp.float32), line_search_fixed_cells=fixed_cells)
        assert_same_result(res, res_j)
        out[gs] = res
        assert bool(res.converged) and trans_err(res.transformation.numpy(), T_true) < 0.1
    np.testing.assert_allclose(out[64].transformation.numpy(), out[0].transformation.numpy(), atol=1e-5)
    if not fixed_cells:
        _, tp = both_targets(tgt_pts)
        fast = ndt.align(tp, src, torch.eye(4), line_search_fixed_cells=True)
        assert trans_err(fast.transformation.numpy(), out[64].transformation.numpy().astype(np.float64)) < 0.05


def test_small_step_large_scene_matches_jax():
    """TestNdtSmallStepLargeScene: an 8 cm offset against points at 50 m
    range is recovered (< 0.04 m; the old spectral margin left the full
    offset), on JAX's pose."""
    rng = np.random.default_rng(7)
    n = 8192
    floor = np.stack([rng.uniform(-50, 50, n // 2), rng.uniform(-50, 50, n // 2), rng.normal(0, 0.02, n // 2)], 1)
    walls = np.stack([rng.uniform(-50, 50, n // 2), rng.normal(25, 0.05, n // 2), rng.uniform(0, 4, n // 2)], 1)
    walls[n // 4:] = walls[n // 4:][:, [1, 0, 2]]
    pts = np.concatenate([floor, walls]).astype(np.float32)
    offset = np.array([0.08, 0.0, 0.0], np.float32)
    tgt_pts = pts + offset
    tj, tp = both_targets(tgt_pts, max_voxels=8192)
    res = ndt.align(tp, cloud.from_numpy(pts, device="cpu"), torch.eye(4), nn_search_method="DIRECT7")
    res_j = jndt.align(tj, jcloud.from_numpy(pts), jnp.eye(4, dtype=jnp.float32), nn_search_method="DIRECT7")
    assert_same_result(res, res_j)
    assert np.linalg.norm(res.transformation.numpy()[:3, 3] - offset) < 0.04


def test_kdtree_mode_matches_jax():
    """TestNdtKdtreeMode::test_kdtree_matches_direct7_accuracy at a cut size
    (1500 points at capacity 2048): every mode converges and recovers the
    transform (0.15 m), KDTREE within 0.1 m of DIRECT7's error, each on
    JAX's pose."""
    tgt_pts, src_pts, T_true = tgt_and_src(1500)
    tj, tp = both_targets(tgt_pts, max_voxels=2048, capacity=2048)
    src = cloud.from_numpy(src_pts, capacity=2048, device="cpu")
    src_j = jcloud.from_numpy(src_pts, capacity=2048)
    errs = {}
    for mode in ("DIRECT7", "KDTREE", "DIRECT1"):
        res = ndt.align(tp, src, torch.eye(4), nn_search_method=mode)
        res_j = jndt.align(tj, src_j, jnp.eye(4, dtype=jnp.float32), nn_search_method=mode)
        assert_same_result(res, res_j)
        errs[mode] = trans_err(res.transformation.numpy(), T_true)
        assert bool(res.converged), mode
    assert errs["KDTREE"] < 0.15 and errs["DIRECT7"] < 0.15, errs
    assert abs(errs["KDTREE"] - errs["DIRECT7"]) < 0.1, errs


def test_factory_kdtree_mode():
    """TestNdtKdtreeMode::test_factory_kdtree_mode: the factory passes
    KDTREE through (1000 points)."""
    tgt_pts, src_pts, T_true = tgt_and_src(1000)
    cfg = RegistrationConfig(registration_method="NDT_OMP", reg_resolution=2.0, reg_nn_search_method="KDTREE")
    reg = factory.Registration(cfg, max_voxels=1024)
    reg.set_target(cloud.from_numpy(tgt_pts, device="cpu"))
    res = reg.align(cloud.from_numpy(src_pts, device="cpu"))
    assert trans_err(res.transformation.numpy(), T_true) < 0.15


def test_batched_align_rows_equal_single_aligns():
    """align with a leading batch of 3 sources (different guesses, one
    padded smaller cloud) against one target: each row equals the single
    align of that source (1e-6: the same float32 operations, batched),
    iterations equal."""
    tgt_pts, src_pts, _ = tgt_and_src(1500)
    _, tp = both_targets(tgt_pts, max_voxels=2048)
    cap = 2048
    srcs = [cloud.from_numpy(src_pts, capacity=cap, device="cpu"),
            cloud.from_numpy(src_pts[:900], capacity=cap, device="cpu"),
            cloud.from_numpy(src_pts[::2], capacity=cap, device="cpu")]
    guesses = [np.eye(4, dtype=np.float32) for _ in srcs]
    guesses[1][:3, 3] = [0.2, 0.1, 0.0]
    guesses[2][:3, 3] = [-0.1, 0.3, 0.05]
    xyz = torch.stack([s.xyz for s in srcs])
    mask = torch.stack([s.mask for s in srcs])
    res = ndt.align(tp, cloud.PointCloud(xyz=xyz, mask=mask), torch.from_numpy(np.stack(guesses)))
    for b, (s, g) in enumerate(zip(srcs, guesses)):
        one = ndt.align(tp, s, torch.from_numpy(g))
        np.testing.assert_allclose(res.transformation[b].numpy(), one.transformation.numpy(), atol=1e-6)
        assert int(res.iterations[b]) == int(one.iterations)
        assert bool(res.converged[b]) == bool(one.converged)
        assert int(res.num_inliers[b]) == int(one.num_inliers)


def test_rescue_carries_the_align_when_every_line_search_fails(monkeypatch):
    """The rescue (JAX ndt.py:421-443), which runs only when an iteration's
    flag read shows a live problem needing it: with every fixed-association
    trial scored above the current score (each problem's trials shifted by
    their range + 1, their order kept), no line search improves, so each
    step is a rescue's (the best candidate re-scored under a fresh
    association). It must
    fire, carry the single align to the transform as TestNDT requires of
    DIRECT7 (0.1 m), and a batch of 3, whose rows need rescues in different
    iterations, must give each row the single align's result (1e-6, as
    the batched align test)."""
    tgt_pts, src_pts, T_true = tgt_and_src(1500)
    _, tp = both_targets(tgt_pts, max_voxels=2048)
    trial_scores, associate = ndt.trial_scores, ndt.associate
    fresh = []

    def failing_trials(tgt, xyz, mask, T, idx, found):
        out = trial_scores(tgt, xyz, mask, T, idx, found)
        if T.shape[1] == 1:
            return out
        return out + (out.amax(-1, keepdim=True) - out.amin(-1, keepdim=True) + 1.0)

    def counted_associate(*args):
        fresh.append(1)
        return associate(*args)

    monkeypatch.setattr(ndt, "trial_scores", failing_trials)
    monkeypatch.setattr(ndt, "associate", counted_associate)
    cap = 2048
    src = cloud.from_numpy(src_pts, capacity=cap, device="cpu")
    one = ndt.align(tp, src, torch.eye(4))
    # the first association, then one fresh association per rescue: a
    # rescued step carries its own, and no other step moves the pose
    assert len(fresh) - 1 >= int(one.iterations) - 1 >= 2
    assert bool(one.converged) and trans_err(one.transformation.numpy(), T_true) < 0.1

    guesses = [np.eye(4, dtype=np.float32) for _ in range(3)]
    guesses[1][:3, 3] = [0.2, 0.1, 0.0]
    guesses[2][:3, 3] = [-0.1, 0.3, 0.05]
    xyz, mask = src.xyz.expand(3, -1, -1).contiguous(), src.mask.expand(3, -1).contiguous()
    res = ndt.align(tp, cloud.PointCloud(xyz=xyz, mask=mask), torch.from_numpy(np.stack(guesses)))
    assert len(set(res.iterations.tolist())) > 1
    for b, g in enumerate(guesses):
        single = ndt.align(tp, src, torch.from_numpy(g))
        np.testing.assert_allclose(res.transformation[b].numpy(), single.transformation.numpy(), atol=1e-6)
        assert int(res.iterations[b]) == int(single.iterations)
        assert bool(res.converged[b]) == bool(single.converged)
        assert int(res.num_inliers[b]) == int(single.num_inliers)


def test_batched_match_ndt_matches_jax():
    """The loop detector's NDT branch (batched_match over 4 candidates
    against one target) against the JAX _batched_match: transforms within
    POSE_ATOL, the same convergence. The fitness (mean squared 1-NN
    distance, ~2.6e-5 m^2 on this exact overlap) moves by 2 d |dT| with the
    pose: within 1e-4 relative or 1e-7 m^2 (measured 7.8e-9)."""
    tgt_pts, src_pts, _ = tgt_and_src(1200)
    cap = 2048
    cfg = dict(registration_method="NDT_OMP", reg_resolution=2.0)
    rng = np.random.default_rng(5)
    xyz = np.full((4, cap, 3), 1.0e6, np.float32)
    mask = np.zeros((4, cap), bool)
    guesses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for b in range(4):
        keep = rng.permutation(len(src_pts))[:1000 + 50 * b]
        xyz[b, :len(keep)], mask[b, :len(keep)] = src_pts[keep], True
        guesses[b, :3, 3] = rng.normal(0, 0.1, 3)
    tgt = cloud.from_numpy(tgt_pts, capacity=cap, device="cpu")
    tgt_j = jcloud.from_numpy(tgt_pts, capacity=cap)
    c = RegistrationConfig(**cfg)
    tp = factory.make_target(c, tgt, 4096)
    tj = jndt.preprocess_target(tgt_j, 2.0, max_voxels=4096, grid_size=voxel.dense_grid_size_for(2.0))
    kw = dict(k=20, max_corr_dist=c.reg_max_correspondence_distance, transformation_epsilon=c.reg_transformation_epsilon,
              max_iterations=c.reg_maximum_iterations, reassoc_displacement=c.reg_reassoc_displacement,
              fitness_max_range=1.0)
    T, conv, fit = batched_match(c, tp, tgt.valid_xyz(), torch.from_numpy(xyz), torch.from_numpy(mask),
                                 torch.from_numpy(guesses), fitness_max_range=kw["fitness_max_range"])
    Tj, cj, fj = j_batched_match(tj, jnp.where(tgt_j.mask[:, None], tgt_j.xyz, 1.0e6), jnp.asarray(xyz),
                                 jnp.asarray(mask), jnp.asarray(guesses), method="NDT", nn_search="DIRECT7",
                                 use_reciprocal=False, **kw)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=POSE_ATOL)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    np.testing.assert_allclose(fit.numpy(), np.asarray(fj), rtol=1e-4, atol=1e-7)


# -- odometry ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def world():
    return make_world()


def ndt_odom_cfg(cls, reg_cls, keyframe_delta_trans):
    return cls(keyframe_delta_trans=keyframe_delta_trans, keyframe_delta_time=1e9,
               registration=reg_cls(registration_method="NDT_OMP", reg_resolution=2.0))


def test_ndt_odometry_matches_jax():
    """tests/test_pipeline.py test_ndt_odometry: ScanMatchingOdometry with
    NDT over 5 frames 0.4 m apart tracks x within 0.2 m, with JAX's poses
    (within 1e-3 m: five chained aligns, each within float32 rounding of
    JAX's)."""
    odo = ScanMatchingOdometry(ndt_odom_cfg(OdometryConfig, RegistrationConfig, 3.0), device="cpu")
    odo_j = JScanMatchingOdometry(ndt_odom_cfg(JOdometryConfig, JRegistrationConfig, 3.0))
    errs = []
    for i in range(5):
        pose = np.eye(4)
        pose[0, 3] = 0.4 * i
        scan = scan_at(world(), pose, seed=i)
        est = odo.step(float(i) * 0.1, cloud.from_numpy(scan, capacity=2560, device="cpu"))
        est_j = odo_j.step(float(i) * 0.1, jcloud.from_numpy(scan, capacity=2560))
        np.testing.assert_allclose(est, np.asarray(est_j), atol=1e-3)
        errs.append(abs(est[0, 3] - pose[0, 3]))
    assert max(errs) < 0.2, errs


def test_ndt_device_odometry_and_window():
    """tests/test_window.py test_ndt_device: DeviceOdometry with NDT over 5
    frames 0.4 m apart tracks x within 0.25 m; and the OdometryWindow over
    the same frames equals the per-frame path (1e-5), with a keyframe switch
    inside the window (the target rebuilt on that frame only)."""
    cfg = ndt_odom_cfg(OdometryConfig, RegistrationConfig, 0.9)
    scans = []
    for i in range(5):
        pose = np.eye(4)
        pose[0, 3] = 0.4 * i
        scans.append(scan_at(world(), pose, seed=i))
    dev = DeviceOdometry(cfg, device="cpu", max_voxels=2048)
    per_frame = [dev.step(0.1 * i, cloud.from_numpy(s, capacity=2560, device="cpu")).numpy()
                 for i, s in enumerate(scans)]
    assert max(abs(T[0, 3] - 0.4 * i) for i, T in enumerate(per_frame)) < 0.25
    win = OdometryWindow(cfg, device="cpu", max_voxels=2048)
    state = win.init_state(0.0, cloud.from_numpy(scans[0], capacity=2560, device="cpu"))
    xyz, mask = stack_scans(scans[1:], capacity=2560)
    _, odoms, status = win.run(state, xyz, mask, 0.1 * np.arange(1, 5))
    np.testing.assert_allclose(odoms.numpy(), np.stack(per_frame[1:]), atol=1e-5)
    assert bool(status["keyframe_switched"].any()) and bool(status["converged"].all())


def test_imu_preset_runs_per_frame_with_imu():
    """tests/test_pipeline.py test_runs_with_imu: the imu preset (NDT_OMP at
    10 m cells, deskewing, the IMU frontend) through SlamPipeline on 3
    frames with IMU messages, against the JAX pipeline's odometry (within
    1e-3 m)."""
    from hdl_graph_slam_tpu.core.config import PRESETS as JPRESETS
    from hdl_graph_slam_tpu.pipeline import SlamPipeline as JSlamPipeline

    w = make_world(n=8000)
    poses = drive_square(side=4.0, step=1.0)[:3]
    pipes = []
    for presets, make in ((PRESETS, lambda c: SlamPipeline(c, cloud_capacity=4096, device="cpu")),
                          (JPRESETS, lambda c: JSlamPipeline(c, cloud_capacity=4096))):
        cfg = presets["imu"]()
        cfg.floor.enabled = False
        pipe = make(cfg)
        for i, p in enumerate(poses):
            pipe.add_imu(float(i) - 0.05, orientation_wxyz=(1.0, 0, 0, 0), acceleration=(0.0, 0.0, 9.81),
                         angular_velocity=(0.0, 0.0, 0.0))
            pipe.process_frame(float(i), scan_at(w, p, seed=i, n_keep=2500))
        pipe.finish()
        pipes.append(pipe)
    assert len(pipes[0].odometry_trajectory) == len(pipes[1].odometry_trajectory) == 3
    for (s, T), (sj, Tj) in zip(pipes[0].odometry_trajectory, pipes[1].odometry_trajectory):
        assert s == sj
        np.testing.assert_allclose(T, np.asarray(Tj), atol=1e-3)


def test_wrappers_never_fall_back():
    """On a device that is neither the CPU nor CUDA every wrapper raises."""
    tgt_pts, _, _ = tgt_and_src(500)
    _, tp = both_targets(tgt_pts, max_voxels=512)
    meta = torch.zeros(1, 8, 3, device="meta")
    mmask = torch.zeros(1, 8, dtype=torch.bool, device="meta")
    T = torch.eye(4, device="meta")[None]
    idx = torch.zeros(1, 8, 7, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ndt.associate(tp, meta, mmask, T)
    with pytest.raises(ValueError, match="unsupported device"):
        ndt.derivatives(tp, meta, mmask, T, idx, idx.bool())
    with pytest.raises(ValueError, match="unsupported device"):
        ndt.trial_scores(tp, meta, mmask, T[:, None], idx, idx.bool())


def test_golden_ndt_odometry_only_cut():
    """tests/test_golden.py::test_golden_ndt_odometry_only (slow there) at a
    cut size: NDT DIRECT7 frame-to-keyframe odometry alone, 2.0 m cells, on
    occluded ray-cast room scans, over the first 24 of its 89 frames (the
    first side and its 16-frame turn): odometry ATE below the JAX test's
    0.05 m, and JAX's odometry on the same frames within 5e-3 m.

    Why 5e-3 and not float32 rounding: the DIRECT7 association is
    discontinuous in the pose, so a rounding-level pose difference moves a
    few face points to another cell, the scores then differ by a few units
    of |d1|, and the two line searches can take different steps. Both stop
    when a step is below transformation_epsilon = 0.01, so their optima may
    lie up to that far apart (measured here: 2.0e-3 m at most over the 24
    frames)."""
    from hdl_graph_slam_tpu.core.config import SlamConfig as JSlamConfig
    from hdl_graph_slam_tpu.pipeline import SlamPipeline as JSlamPipeline
    from hdl_graph_slam_tpu_torch.core.config import SlamConfig
    from hdl_graph_slam_tpu_torch.io import trajectory as traj_io
    from test_golden import room_scan

    poses = drive_square(side=4.5, step=0.75, turn_steps=16)[:24]
    pipes = []
    for slam_cfg, reg_cls, make in ((SlamConfig, RegistrationConfig,
                                     lambda c: SlamPipeline(c, cloud_capacity=4096, device="cpu")),
                                    (JSlamConfig, JRegistrationConfig, lambda c: JSlamPipeline(c, cloud_capacity=4096))):
        cfg = slam_cfg()
        cfg.prefilter.downsample_resolution = 0.3
        cfg.prefilter.outlier_removal_method = "NONE"
        cfg.odometry.registration = reg_cls(registration_method="NDT_OMP", reg_resolution=2.0,
                                            reg_nn_search_method="DIRECT7")
        cfg.odometry.keyframe_delta_trans = 1.5
        cfg.odometry.keyframe_delta_time = 1e9
        cfg.loop.distance_thresh = 0.0
        cfg.backend.graph_update_interval = 1e9
        pipes.append(make(cfg))
    truth = []
    for i, pose in enumerate(poses):
        sensor = pose.copy()
        sensor[2, 3] += 1.8
        truth.append((float(i), sensor))
        scan = room_scan(sensor, seed=i)
        for pipe in pipes:
            pipe.process_frame(float(i), scan)
    ate = traj_io.ate_rmse(pipes[0].odometry_trajectory, truth, align=True)
    assert np.isfinite(ate) and ate < 0.05, ate
    np.testing.assert_allclose(np.stack([T for _, T in pipes[0].odometry_trajectory]),
                               np.stack([np.asarray(T) for _, T in pipes[1].odometry_trajectory]), atol=5e-3)
