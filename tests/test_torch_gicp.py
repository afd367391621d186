"""Parity of the port's GICP (hdl_graph_slam_tpu_torch/registration/gicp.py,
registration/base.py lm_loop) with the JAX reference, on the CPU.

Both sides get the same float32 clouds: two frames of the bench course
(course.make_course), prefiltered once with the port's CPU prefilter.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core.cloud import PointCloud as JPointCloud
from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu_torch.core import cloud, se3
from hdl_graph_slam_tpu_torch.core.config import PrefilterConfig
from hdl_graph_slam_tpu_torch.frontend.prefilter import Prefilter
from hdl_graph_slam_tpu_torch.registration import base, gicp
from hdl_graph_slam_tpu_torch.utils.course import make_course


@functools.lru_cache(maxsize=1)
def course_clouds():
    """Frames 0 and 3 of the bench course on a 0.6 m voxel grid (about 2900
    of 4096 rows valid, no overflow), as numpy (xyz, mask) pairs."""
    scans = make_course(3)
    pf = Prefilter(PrefilterConfig(downsample_resolution=0.6, outlier_removal_method="NONE"),
                   out_capacity=4096, device="cpu")
    out = []
    for s in (scans[0], scans[3]):
        c = pf(cloud.from_numpy(s, capacity=16384, device="cpu"))
        out.append((c.xyz.numpy().copy(), c.mask.numpy().copy()))
    return out


def port_cloud(xyz, mask):
    return cloud.PointCloud(xyz=torch.from_numpy(xyz), mask=torch.from_numpy(mask))


def jax_cloud(xyz, mask):
    return JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask))


def test_preprocess_matches_exact_jax():
    """Covariances against gicp.preprocess(exact=True). The plane-regularized
    covariance I - (1 - 1e-3) v v^T carries the float32 rounding of the
    closed-form smallest eigenvector (ops/eig3.py), amplified by 1/gap where
    the two smallest eigenvalues nearly coincide (measured: median row error
    2e-8, 99th percentile 7e-5, max 3.3e-4): at least 99% of rows within
    atol 1e-4, every row within atol 1e-3."""
    xyz, mask = course_clouds()[0]
    g = gicp.preprocess(port_cloud(xyz, mask), k=20)
    gj = jgicp.preprocess(jax_cloud(xyz, mask), k=20, exact=True)
    np.testing.assert_array_equal(g.xyz.numpy(), np.asarray(gj.xyz))
    np.testing.assert_array_equal(g.mask.numpy(), np.asarray(gj.mask))
    covs, covs_j = g.covs.numpy(), np.asarray(gj.covs)
    row_err = np.abs(covs - covs_j).reshape(len(covs), -1).max(axis=1)
    assert np.mean(row_err <= 1e-4) >= 0.99, np.mean(row_err <= 1e-4)
    np.testing.assert_allclose(covs, covs_j, atol=1e-3)
    np.testing.assert_array_equal(covs[~mask], np.broadcast_to(np.eye(3, dtype=np.float32), covs[~mask].shape))


@pytest.mark.parametrize("reassoc", [0.0, 0.1])
def test_align_matches_jax(reassoc):
    """align from the same guess, ungated and with the bench's 0.1 m gated
    re-association: the same convergence, inlier count and final pose.
    Pose tolerance 1e-4 m / 1e-4 rad: LM stops inside
    reg_transformation_epsilon=0.01, so the two sides may stop one rounding-
    level accept apart; measured here they agree to float32 rounding."""
    (xt, mt), (xs, ms) = course_clouds()
    tgt, src = gicp.preprocess(port_cloud(xt, mt)), gicp.preprocess(port_cloud(xs, ms))
    tgt_j = jgicp.preprocess(jax_cloud(xt, mt), exact=True)
    src_j = jgicp.preprocess(jax_cloud(xs, ms), exact=True)
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = [0.1, -0.05, 0.02]
    res = gicp.align(tgt, src, torch.from_numpy(guess), reassoc_displacement=reassoc)
    res_j = jgicp.align(tgt_j, src_j, jnp.asarray(guess), reassoc_displacement=reassoc)
    assert bool(res.converged) and bool(res.converged) == bool(res_j.converged)
    assert int(res.num_inliers) == int(res_j.num_inliers)
    T, T_j = res.transformation.numpy(), np.asarray(res_j.transformation)
    np.testing.assert_allclose(T[:3, 3], T_j[:3, 3], atol=1e-4)
    np.testing.assert_allclose(T[:3, :3], T_j[:3, :3], atol=1e-4)
    assert abs(int(res.iterations) - int(res_j.iterations)) <= 1
    # the course moves 0.08 m per frame along x: frame 3 sits ~0.24 m ahead
    assert abs(T[0, 3] - 0.24) < 0.05


def test_associate_linearize_cost_match_jax():
    """One linearization at a perturbed pose: H, b and cost within float32
    summation-order rounding (rtol 1e-4 of their scale)."""
    (xt, mt), (xs, ms) = course_clouds()
    tgt, src = gicp.preprocess(port_cloud(xt, mt)), gicp.preprocess(port_cloud(xs, ms))
    tgt_j = jgicp.GicpCloud(xyz=jnp.asarray(xt), mask=jnp.asarray(mt), covs=jnp.asarray(tgt.covs.numpy()))
    src_j = jgicp.GicpCloud(xyz=jnp.asarray(xs), mask=jnp.asarray(ms), covs=jnp.asarray(src.covs.numpy()))
    T = se3.se3_exp(torch.tensor([0.2, 0.01, -0.02, 0.002, -0.001, 0.01]))
    corr = gicp._associate(T, src, tgt, 2.5)
    corr_j = jgicp._associate(jnp.asarray(T.numpy()), src_j, tgt_j, 2.5)
    assert np.mean(corr.idx.numpy() == np.asarray(corr_j.idx)) > 0.999
    assert int(corr.num) == int(corr_j.num)
    H, b, cost, _ = gicp._linearize_at(T, corr, src, tgt)
    H_j, b_j, cost_j, _ = jgicp._linearize_at(jnp.asarray(T.numpy()), corr_j, src_j, tgt_j)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=1e-4, atol=1e-4 * float(np.abs(H_j).max()))
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-4 * float(np.abs(b_j).max()))
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-4)
    np.testing.assert_allclose(float(gicp._cost_at(T, corr, src, tgt)), float(cost), rtol=1e-6)


def test_se3_delta_converged():
    eps = 0.01
    small = se3.se3_exp(torch.tensor([0.004, 0.0, 0.0, 0.0, 0.0, 0.002]))
    large = se3.se3_exp(torch.tensor([0.02, 0.0, 0.0, 0.0, 0.0, 0.0]))
    assert bool(base.se3_delta_converged(small, eps)) and not bool(base.se3_delta_converged(large, eps))


def test_gated_requires_r_max():
    with pytest.raises(ValueError):
        base.lm_loop(lambda T: None, lambda T, c: (torch.eye(6), torch.zeros(6), torch.tensor(0.0), torch.tensor(0)),
                     lambda T, c: torch.tensor(0.0), torch.eye(4), 4, 0.01, reassoc_displacement=0.1)
