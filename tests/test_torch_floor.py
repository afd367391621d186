"""Parity of the port's floor detection (hdl_graph_slam_tpu_torch/ops/normals.py,
ops/ransac.py, frontend/floor.py) with the JAX reference, on the CPU.

Inputs are float32 arrays made with numpy from a seed (tests/test_pipeline.py's
room world and scans) and fed to both sides. On CPU tensors the kernel
wrappers (ops/knn.py knn_select under knn) run their plain twins; chip_smoke.py
holds the kernels against those on the card. RANSAC draws differ between the
two sides (threefry against torch.Generator), so RANSAC parity goes through
the JAX package's own triplets; tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import FloorDetectionConfig as JFloorDetectionConfig
from hdl_graph_slam_tpu.frontend.floor import FloorDetector as JFloorDetector
from hdl_graph_slam_tpu.ops import normals as jnormals
from hdl_graph_slam_tpu.ops import ransac as jransac
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import FloorDetectionConfig
from hdl_graph_slam_tpu_torch.frontend import FloorDetector
from hdl_graph_slam_tpu_torch.ops import normals, ransac
from test_pipeline import make_world, scan_at


@pytest.fixture(scope="module")
def world():
    return make_world()


def both(xyz, capacity):
    """The same float32 points as a port cloud and a JAX cloud."""
    return cloud.from_numpy(xyz, capacity=capacity, device="cpu"), jcloud.from_numpy(xyz, capacity=capacity)


def floor_band(world, seed=0):
    """A scan's points within 1 m of the floor (sensor frame), compacted:
    the cloud the floor detector's RANSAC sees."""
    scan = scan_at(world, np.eye(4), seed=seed)
    return scan[np.abs(scan[:, 2] + 1.8) < 1.0].astype(np.float32)


def test_estimate_normals_match_jax(world):
    """k = 10 PCA normals towards the floor detector's viewpoint. Tolerance:
    |dot| > 1 - 1e-4 with the same sign on rows whose neighbourhood is
    planar (smallest eigenvalue below 1e-2 of the middle one), where the
    eigenvector is well defined; float32 eigen-solves of the two sides
    differ by rounding."""
    scan = scan_at(world, np.eye(4), seed=3).astype(np.float32)
    c, jc = both(scan, 4096)
    vp = np.array([0.0, 0.0, 1.8], np.float32)
    n_t = normals.estimate_normals(c, 10, torch.from_numpy(vp)).numpy()
    n_j = np.asarray(jnormals.estimate_normals(jc, 10, jnp.asarray(vp)))
    m = scan.shape[0]
    nbrs = scan[np.argsort(((scan[:, None] - scan[None]) ** 2).sum(-1), axis=1)[:, :10]]
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", nbrs - nbrs.mean(1, keepdims=True),
                                      nbrs - nbrs.mean(1, keepdims=True)))
    planar = ev[:, 0] < 1e-2 * ev[:, 1]
    assert planar.mean() > 0.8
    dot = (n_t[:m] * n_j[:m]).sum(-1)
    assert (dot[planar] > 1 - 1e-4).all(), dot[planar].min()
    np.testing.assert_allclose(np.linalg.norm(n_t[:m], axis=-1), 1.0, atol=1e-5)


def test_sample_triplets_reduce_draws_modulo_count():
    """Draws come from [0, n) and are taken modulo the valid count, as the
    JAX package's randint(0, n) % count; a seeded generator repeats them."""
    g = torch.Generator().manual_seed(0)
    tri = ransac.sample_triplets(g, 1024, 500, 37)
    assert tri.shape == (1024, 3) and int(tri.min()) >= 0 and int(tri.max()) < 37
    again = ransac.sample_triplets(torch.Generator().manual_seed(0), 1024, 500, 37)
    assert torch.equal(tri, again)
    # count 0 is clipped to 1, as jnp.clip(count, 1)
    assert int(ransac.sample_triplets(g, 8, 500, 0).max()) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_plane_from_triplets_matches_jax(world, seed):
    """fit_plane_from_triplets fed the JAX package's own triplets, rebuilt as
    fit_plane draws them (randint(key, (K, 3), 0, n) % count): the same
    winning hypothesis, so the identical inlier count and mask, with
    coefficients within 1e-5 (float32 cross products and norms)."""
    band = floor_band(world, seed)
    c, jc = both(band, 2048)
    key = jax.random.PRNGKey(seed)
    res_j = jransac.fit_plane(jc, key, distance_thresh=0.1, num_hypotheses=1024)
    n = jc.xyz.shape[0]
    tri = np.array(jax.random.randint(key, (1024, 3), 0, n) % max(int(jc.count), 1))
    res = ransac.fit_plane_from_triplets(c, torch.from_numpy(tri).long(), distance_thresh=0.1)
    assert int(res.num_inliers) == int(res_j.num_inliers) > 0.5 * band.shape[0]
    np.testing.assert_array_equal(res.inlier_mask.numpy(), np.asarray(res_j.inlier_mask))
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(res_j.coeffs), atol=1e-5)


def test_fit_plane_scores_degenerate_triplets_below_any_plane():
    """A triplet of one repeated point is degenerate (zero normal) and
    scores -1; the first maximum wins among equal counts."""
    xyz = np.zeros((8, 3), np.float32)
    xyz[:, :2] = np.random.default_rng(5).uniform(-1, 1, (8, 2))
    c = cloud.from_numpy(xyz, capacity=8, device="cpu")
    tri = torch.tensor([[0, 0, 0], [0, 1, 2], [3, 4, 5]])
    res = ransac.fit_plane_from_triplets(c, tri, 0.1)
    assert int(res.num_inliers) == 8
    assert abs(abs(float(res.coeffs[2])) - 1.0) < 1e-6
    assert torch.equal(res.coeffs, ransac.fit_plane_from_triplets(c, tri[1:2], 0.1).coeffs)


def test_floor_prefilter_matches_jax(world):
    """The detector's tilt / double clip / normal filter / compact chain:
    the same points kept, in the same order, within 1e-5 m (the tilt's
    float32 products)."""
    scan = scan_at(world, np.eye(4), seed=1).astype(np.float32)
    c, jc = both(scan, 4096)
    det = FloorDetector(FloorDetectionConfig(sensor_height=1.8, floor_pts_thresh=100, tilt_deg=2.0), device="cpu")
    jdet = JFloorDetector(JFloorDetectionConfig(sensor_height=1.8, floor_pts_thresh=100, tilt_deg=2.0))
    ours = det._prefilter(c)
    ref = jdet._build_prefilter(det.tilt_matrix)(jc)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    m = ours.mask.numpy()
    assert m.sum() > 500
    np.testing.assert_allclose(ours.xyz.numpy()[m], np.asarray(ref.xyz)[m], atol=1e-5)


def test_floor_detector_near_truth_on_both_sides(world):
    """FloorDetector.detect on a room scan: both sides find the floor 1.8 m
    below the sensor with an upward normal (normal within 0.02 of +z, d
    within 0.1 m: the RANSAC draws differ, so each side is held to the
    truth, as tests/test_pipeline.py holds the JAX side), and agree with
    each other within the same bounds."""
    scan = scan_at(world, np.eye(4))
    c, jc = both(scan, 8192)
    coeffs = FloorDetector(FloorDetectionConfig(sensor_height=1.8, floor_pts_thresh=100), device="cpu").detect(c)
    ref = JFloorDetector(JFloorDetectionConfig(sensor_height=1.8, floor_pts_thresh=100)).detect(jc)
    for got in (coeffs, ref):
        assert got is not None and got.dtype == np.float64
        np.testing.assert_allclose(got[:3], [0, 0, 1], atol=0.02)
        assert abs(got[3] - 1.8) < 0.1
    np.testing.assert_allclose(coeffs, ref, atol=0.02)


def test_floor_detector_none_on_empty_scan():
    """Too few points in the floor band: None on both sides."""
    scan = np.random.default_rng(1).uniform(-5, 5, (50, 3)).astype(np.float32)
    c, jc = both(scan, 256)
    assert FloorDetector(FloorDetectionConfig(floor_pts_thresh=100), device="cpu").detect(c) is None
    assert JFloorDetector(JFloorDetectionConfig(floor_pts_thresh=100)).detect(jc) is None
