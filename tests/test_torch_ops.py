"""Parity of the port's ops (hdl_graph_slam_tpu_torch/ops, core/cloud.py,
frontend/prefilter.py) with the JAX reference, on the CPU.

Inputs are float32 arrays made with numpy from a seed and fed to both sides.
On CPU tensors the kernel wrappers (ops/knn.py nn1, knn_select) run their
plain PyTorch versions; the kernels themselves are held against those on the
card by chip_smoke.py. Tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import PrefilterConfig as JPrefilterConfig
from hdl_graph_slam_tpu.frontend.prefilter import Prefilter as JPrefilter
from hdl_graph_slam_tpu.ops import eig3 as jeig3
from hdl_graph_slam_tpu.ops import filters as jfilters
from hdl_graph_slam_tpu.ops import knn as jknn
from hdl_graph_slam_tpu.ops import small_solve as jsmall
from hdl_graph_slam_tpu.ops import voxel as jvoxel
from hdl_graph_slam_tpu.ops.pallas_nn import nn1_pallas
from hdl_graph_slam_tpu.registration.gicp import _inv3x3 as j_inv3x3
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import PrefilterConfig
from hdl_graph_slam_tpu_torch.frontend.prefilter import Prefilter
from hdl_graph_slam_tpu_torch.ops import eig3, filters, knn, small_solve, voxel
from hdl_graph_slam_tpu_torch.registration.gicp import _inv3x3
from hdl_graph_slam_tpu_torch.utils import lidar_sim


def f32(x):
    return np.asarray(x, dtype=np.float32)


def tt(x):
    return torch.from_numpy(f32(x))


def padded_cloud(rng, n, n_pad, lo=-10.0, hi=10.0):
    x = f32(rng.uniform(lo, hi, (n, 3)))
    x[n - n_pad:] = cloud.PAD_COORD
    return x


def random_covs(rng, n):
    """Covariances of small random point sets: anisotropic, PD."""
    pts = rng.standard_normal((n, 20, 3)) * rng.uniform(0.01, 1.0, (n, 1, 3))
    pts = pts - pts.mean(1, keepdims=True)
    return f32(np.einsum("nki,nkj->nij", pts, pts) / 20)


def sensor_scan(seed=0, n_max=4000):
    """A ray-cast room scan (float32, sensor frame)."""
    scene = lidar_sim.make_room(seed=seed)
    pose = np.eye(4)
    pose[:3, 3] = [1.0, -2.0, 1.2]
    pts = lidar_sim.scan(scene, pose, lidar_sim.LidarModel(rings=16, azimuth_steps=360), seed=seed)
    return pts[:n_max]


# -- nn1 --------------------------------------------------------------------


class TestNN1:
    """Bar of tests/test_ops.py TestPallasNN: index agreement > 0.999 and
    dist2 rtol 1e-4 (the expanded form can swap exact near-ties)."""

    @pytest.mark.parametrize("n,m,n_pad", [(300, 400, 0), (300, 400, 37), (512, 2048, 200),
                                           (7, 20000, 0), (1000, 20000, 500)])
    def test_plain_matches_xla_and_pallas(self, n, m, n_pad):
        """Against the XLA nn1 always and the Pallas kernel in interpret mode
        up to 2048 targets (20000 targets is more than one shared-memory
        stage of the CUDA kernel; interpret mode is too slow there)."""
        rng = np.random.default_rng(30 + n_pad)
        q = padded_cloud(rng, n, n_pad // 2)
        t = padded_cloud(rng, m, n_pad)
        i_t, d_t = knn.nn1(tt(q), tt(t))
        assert i_t.dtype == torch.int32
        refs = [jknn.nn1(jnp.asarray(q), jnp.asarray(t))]
        if m <= 2048:
            refs.append(nn1_pallas(jnp.asarray(q), jnp.asarray(t), interpret=True))
        for i_ref, d_ref in refs:
            assert np.mean(i_t.numpy() == np.asarray(i_ref)) > 0.999
            np.testing.assert_allclose(d_t.numpy(), np.asarray(d_ref), rtol=1e-4, atol=1e-5)

    def test_padded_targets_never_win_and_ties_take_lowest_index(self):
        t = f32([[cloud.PAD_COORD] * 3, [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
        q = f32([[0.0, 0.0, 0.0], [0.9, 0.0, 0.0], [5.0, 0.0, 0.0]])
        idx, d2 = knn.nn1(tt(q), tt(t))
        assert idx.tolist() == [1, 1, 1]  # 1 and 2 tie for q0; 1 and 3 coincide
        np.testing.assert_allclose(d2.numpy(), [1.0, 0.01, 16.0], rtol=1e-6)

    def test_map_frame_coordinates(self):
        """Far from the origin the bbox centring keeps selection exact."""
        rng = np.random.default_rng(31)
        t = f32(rng.uniform(-30, 30, (1000, 3)) + [5000.0, -3000.0, 20.0])
        q = f32(t[:400] + rng.normal(0, 0.05, (400, 3)))
        i_t, d_t = knn.nn1(tt(q), tt(t))
        i_x, d_x = jknn.nn1(jnp.asarray(q), jnp.asarray(t))
        assert np.mean(i_t.numpy() == np.asarray(i_x)) > 0.999
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_x), rtol=1e-4, atol=1e-5)

    def test_cpu_tensors_take_plain_path_without_launch(self):
        before = knn.nn1.launches
        rng = np.random.default_rng(32)
        i_w, d_w = knn.nn1(tt(padded_cloud(rng, 64, 4)), tt(padded_cloud(rng, 80, 8)))
        assert knn.nn1.launches == before

    def test_rejects_bad_inputs(self):
        with pytest.raises(ValueError):
            knn.nn1(torch.zeros(4, 3, dtype=torch.float64), torch.zeros(5, 3, dtype=torch.float64))
        with pytest.raises(ValueError):
            knn.nn1(torch.zeros(4, 2), torch.zeros(5, 3))
        with pytest.raises(ValueError):  # no plain fallback on a non-CPU device
            knn.nn1(torch.zeros(4, 3, device="meta"), torch.zeros(5, 3, device="meta"))

    def test_fitness_score_matches_jax(self):
        rng = np.random.default_rng(33)
        t = padded_cloud(rng, 500, 50)
        s = padded_cloud(rng, 400, 40)
        smask = np.arange(400) < 360
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1, -0.2, 0.05]
        for max_range in (float("inf"), 0.5):
            f_t = knn.fitness_score(tt(t), tt(s), torch.from_numpy(smask), tt(T), max_range)
            f_j = jknn.fitness_score(jnp.asarray(t), jnp.asarray(s), jnp.asarray(smask), jnp.asarray(T), max_range)
            np.testing.assert_allclose(float(f_t), float(f_j), rtol=1e-5)


# -- knn_select / knn -------------------------------------------------------


def rows_agree_up_to_ties(q, t, idx_a, idx_b, tol):
    """Per row: sorted exact float64 distances of the two neighbour sets agree
    within ``tol`` (sets equal up to exchanges of near-equidistant points)."""
    q, t = q.astype(np.float64), t.astype(np.float64)
    da = np.sort(((q[:, None] - t[idx_a]) ** 2).sum(-1), axis=1)
    db = np.sort(((q[:, None] - t[idx_b]) ** 2).sum(-1), axis=1)
    return np.abs(da - db).max(axis=1) <= tol


class TestKnnSelect:
    """Exact k nearest neighbours. Tolerance: the neighbour sets equal the
    JAX exact k-NN's up to ties — rows may differ only by exchanging points
    whose exact squared distances agree within 1e-4 (float32 expanded-form
    rounding at these coordinate scales)."""

    @pytest.mark.parametrize("k", [8, 20])
    def test_sets_match_exact_knn(self, k):
        rng = np.random.default_rng(40 + k)
        x = padded_cloud(rng, 1500, 100)
        i_t, d_t = knn.knn_select(tt(x), tt(x), k)
        assert i_t.shape == (1500, k) and i_t.dtype == torch.int32
        i_j, _ = jknn.knn(jnp.asarray(x), jnp.asarray(x), k)
        i_j = np.asarray(i_j)
        valid = slice(0, 1400)
        same = np.mean([set(a) == set(b) for a, b in zip(i_t.numpy()[valid], i_j[valid])])
        assert same > 0.99
        assert rows_agree_up_to_ties(x[valid], x, i_t.numpy()[valid], i_j[valid], 1e-4).all()
        # distances: ascending, equal to |q - t|^2 up to expanded-form rounding
        assert (d_t[:, 1:] >= d_t[:, :-1]).all()
        exact = ((x[valid, None].astype(np.float64) - x[i_t.numpy()[valid]]) ** 2).sum(-1)
        np.testing.assert_allclose(d_t.numpy()[valid], exact, atol=2e-4)

    def test_sets_match_knn_approx_as_gicp_calls_it(self):
        """gicp.preprocess's knn_approx(recall 0.85, exact_dists=False) is
        exact on the CPU, so its sets match knn_select's up to ties."""
        x = f32(sensor_scan(seed=3, n_max=2048))
        i_t, _ = knn.knn_select(tt(x), tt(x), 20)
        i_a, _ = jknn.knn_approx(jnp.asarray(x), jnp.asarray(x), 20, recall_target=0.85, exact_dists=False)
        assert rows_agree_up_to_ties(x, x, i_t.numpy(), np.asarray(i_a), 1e-4).all()

    @pytest.mark.parametrize("k", [8, 20])
    def test_lattice_ties_match_exact_knn_index_for_index(self, k):
        """An integer lattice with exact duplicates: every distance is exact
        in float32, so ties are exact and the lowest index must win them,
        as lax.top_k does; idx and distances must equal the JAX exact k-NN's
        element for element."""
        rng = np.random.default_rng(45)
        g = np.arange(8, dtype=np.float32)
        x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        x = x[rng.permutation(np.r_[np.arange(len(x)), rng.integers(0, len(x), 128)])]
        i_t, d_t = knn.knn_select(tt(x), tt(x), k)
        i_j, d_j = jknn.knn(jnp.asarray(x), jnp.asarray(x), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))

    def test_lex_key_orders_distance_then_index(self):
        d = torch.tensor([[0.5, -1.0, 0.5, -0.0, 0.0, float("inf"), -3.0e12, 2.0]])
        order = torch.argsort(knn._lex_key(d), dim=-1).tolist()[0]
        assert order == [6, 1, 3, 4, 0, 2, 7, 5]  # -0.0 ties +0.0; ties by index

    def test_exact_knn_matches_jax(self):
        rng = np.random.default_rng(44)
        q = padded_cloud(rng, 300, 0)
        t = padded_cloud(rng, 700, 30)
        i_t, d_t = knn.knn(tt(q), tt(t), 7)
        i_j, d_j = jknn.knn(jnp.asarray(q), jnp.asarray(t), 7)
        assert np.mean(i_t.numpy() == np.asarray(i_j)) > 0.999
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)

    def test_rejects_bad_k_and_devices(self):
        x = torch.zeros(10, 3)
        with pytest.raises(ValueError):
            knn.knn_select(x, x, 11)
        with pytest.raises(ValueError):
            knn.knn_select(torch.zeros(10, 3, device="meta"), torch.zeros(10, 3, device="meta"), 4)
        before = knn.knn_select.launches
        knn.knn_select(x, x, 3)
        assert knn.knn_select.launches == before


# -- eig3 / small_solve / inv3x3 --------------------------------------------


class TestEig3:
    """Closed-form 3x3 eigen-shaping against the JAX reference on the same
    float32 covariances: atol 1e-5 relative to the largest eigenvalue (the
    formulas are identical; the float32 transcendentals differ by ulps)."""

    def test_eigvalsh3_and_eigvec(self):
        rng = np.random.default_rng(20)
        A = random_covs(rng, 300)
        l_t = eig3.eigvalsh3(tt(A)).numpy()
        l_j = np.asarray(jeig3.eigvalsh3(jnp.asarray(A)))
        scale = l_j[:, 2:3]
        np.testing.assert_allclose(l_t / scale, l_j / scale, atol=1e-5)
        np.testing.assert_allclose(l_t, np.linalg.eigvalsh(A.astype(np.float64)), atol=1e-5 * scale.max())
        lam_t, v_t = eig3.smallest_eigenvector3(tt(A))
        _, v_j = jeig3.smallest_eigenvector3(jnp.asarray(A))
        # sign-free comparison of unit vectors
        cos = np.abs((v_t.numpy() * np.asarray(v_j)).sum(-1))
        assert (cos > 1 - 1e-4).all(), cos.min()

    def test_plane_and_floor_regularize(self):
        rng = np.random.default_rng(21)
        A = random_covs(rng, 300)
        np.testing.assert_allclose(
            eig3.plane_regularize(tt(A)).numpy(), np.asarray(jeig3.plane_regularize(jnp.asarray(A))), atol=1e-4
        )
        f_t = eig3.floor_regularize(tt(A)).numpy()
        f_j = np.asarray(jeig3.floor_regularize(jnp.asarray(A)))
        scale = np.linalg.eigvalsh(A.astype(np.float64))[:, 2, None, None]
        np.testing.assert_allclose(f_t / scale, f_j / scale, atol=1e-4)

    def test_isotropic_and_degenerate(self):
        A = f32(np.stack([np.eye(3) * 2.0, np.diag([1.0, 1.0, 0.0])]))
        np.testing.assert_allclose(eig3.eigvalsh3(tt(A)).numpy(), np.asarray(jeig3.eigvalsh3(jnp.asarray(A))), atol=1e-6)
        np.testing.assert_allclose(eig3.plane_regularize(tt(A)).numpy(),
                                   np.asarray(jeig3.plane_regularize(jnp.asarray(A))), atol=1e-6)

    def test_floor_regularize_pd_guard_on_rank1_f32(self):
        """Carried over from tests/test_ops.py: a near-rank-1 cell (ground
        ring-arc = a LINE of points) must come out PD by construction in
        float32 thanks to the rel_guard diagonal, and its inverse too."""
        rng = np.random.default_rng(24)
        covs = []
        for _ in range(200):
            t = rng.uniform(0, 1.2, 40)
            pts = np.stack([t, 0.02 * t * t, 1e-4 * rng.standard_normal(40)], 1)
            Q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
            covs.append(np.cov((pts @ Q.T).T))
        A = torch.from_numpy(f32(np.stack(covs)))
        R = eig3.floor_regularize(A).double().numpy()
        lams = np.linalg.eigvalsh(R)
        assert (lams[:, 0] >= 0.5e-3 * lams[:, 2]).all(), lams[:, 0].min()
        icovs = _inv3x3(torch.from_numpy(f32(R)) + 1e-6 * torch.eye(3)).double().numpy()
        assert (np.linalg.eigvalsh(icovs)[:, 0] > 0).all()


class TestSmallSolve:
    def test_solve_spd_matches_jax_and_numpy(self):
        rng = np.random.default_rng(17)
        for _ in range(5):
            A = rng.standard_normal((6, 6))
            A = f32(A @ A.T + 6 * np.eye(6))
            b = f32(rng.standard_normal(6))
            x = small_solve.solve_spd(tt(A), tt(b)).numpy()
            np.testing.assert_allclose(x, np.asarray(jsmall.solve_spd(jnp.asarray(A), jnp.asarray(b))), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=2e-4, atol=2e-5)

    def test_min_pivot_flags_indefinite(self):
        A = f32(np.diag([4.0, 3.0, -1.0, 2.0, 1.0, 5.0]))
        b = f32(np.ones(6))
        x, piv = small_solve.solve_spd_checked(tt(A), tt(b))
        x_j, piv_j = jsmall.solve_spd_checked(jnp.asarray(A), jnp.asarray(b))
        assert float(piv) <= 0 and float(piv) == pytest.approx(float(piv_j))
        np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-6)
        A = f32(np.diag([4.0, 3.0, 1.0, 2.0, 1.0, 5.0]))
        assert float(small_solve.solve_spd_checked(tt(A), tt(b))[1]) == pytest.approx(1.0)

    def test_gershgorin_lower_bounds_min_eig(self):
        rng = np.random.default_rng(18)
        A = rng.standard_normal((10, 6, 6)).astype(np.float32)
        A = A + np.swapaxes(A, -1, -2)
        g = small_solve.gershgorin_min(tt(A)).numpy()
        np.testing.assert_allclose(g, np.stack([np.asarray(jsmall.gershgorin_min(jnp.asarray(a))) for a in A]), rtol=1e-6)
        assert (g <= np.linalg.eigvalsh(A)[:, 0] + 1e-5).all()

    def test_inv3x3_matches_jax(self):
        rng = np.random.default_rng(19)
        M = random_covs(rng, 100) + f32(0.01 * np.eye(3))
        np.testing.assert_allclose(_inv3x3(tt(M)).numpy(), np.asarray(j_inv3x3(jnp.asarray(M))), rtol=1e-4, atol=1e-3)


# -- cloud, filters, voxel, prefilter ---------------------------------------


class TestCloudAndFilters:
    def test_from_numpy_strided_subsample(self):
        rng = np.random.default_rng(50)
        pts = f32(rng.uniform(-20, 20, (1000, 3)))
        for cap in (700, 1024):
            c = cloud.from_numpy(pts, capacity=cap, device="cpu")
            cj = jcloud.from_numpy(pts, capacity=cap)
            np.testing.assert_array_equal(c.xyz.numpy(), np.asarray(cj.xyz))
            np.testing.assert_array_equal(c.mask.numpy(), np.asarray(cj.mask))
        c = cloud.from_numpy(pts, device="cpu")
        assert c.capacity == 1024 and int(c.count) == 1000

    def test_transform_and_compact(self):
        rng = np.random.default_rng(51)
        pts = f32(rng.uniform(-20, 20, (300, 3)))
        c = cloud.from_numpy(pts, capacity=512, device="cpu")
        cj = jcloud.from_numpy(pts, capacity=512)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [1.0, 2.0, 3.0]
        T[:3, :3] = f32([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
        np.testing.assert_allclose(cloud.transform(c, tt(T)).xyz.numpy(),
                                   np.asarray(jcloud.transform(cj, jnp.asarray(T)).xyz), atol=1e-5)
        keep = rng.random(512) < 0.5
        cm = cloud.PointCloud(xyz=c.xyz, mask=c.mask & torch.from_numpy(keep))
        cjm = jcloud.PointCloud(xyz=cj.xyz, mask=cj.mask & jnp.asarray(keep))
        out, out_j = cloud.compact(cm, capacity=256), jcloud.compact(cjm, capacity=256)
        np.testing.assert_array_equal(out.xyz.numpy(), np.asarray(out_j.xyz))
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(out_j.mask))

    def test_distance_filter_matches_jax(self):
        rng = np.random.default_rng(52)
        pts = f32(rng.uniform(-120, 120, (2000, 3)))
        c = cloud.from_numpy(pts, capacity=2048, device="cpu")
        out = filters.distance_filter(c, 1.0, 100.0)
        out_j = jfilters.distance_filter(jcloud.from_numpy(pts, capacity=2048), 1.0, 100.0)
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(out_j.mask))
        np.testing.assert_array_equal(out.xyz.numpy(), np.asarray(out_j.xyz))

    def test_deskew_matches_jax(self):
        pts = f32(sensor_scan(seed=1, n_max=1500))
        c = cloud.from_numpy(pts, capacity=2048, device="cpu")
        w = f32([0.1, -0.3, 0.8])
        out = filters.deskew(c, tt(w), 0.1)
        out_j = jfilters.deskew(jcloud.from_numpy(pts, capacity=2048), jnp.asarray(w), 0.1)
        np.testing.assert_allclose(out.xyz.numpy(), np.asarray(out_j.xyz), atol=1e-5)


class TestVoxel:
    """Centroid voxel grid against the JAX reference: the same count, the same
    key order (masks equal row for row) and centroids within atol 1e-5 m (on
    the CPU both sum each voxel sequentially in sorted order)."""

    @pytest.mark.parametrize("max_voxels", [4096, 512])  # 512 exercises the overflow policy
    def test_local_matches_jax(self, max_voxels):
        pts = f32(sensor_scan(seed=2, n_max=3500))
        c = cloud.from_numpy(pts, capacity=4096, device="cpu")
        cj = jcloud.from_numpy(pts, capacity=4096)
        out = voxel.voxel_downsample_local(c, 0.2, max_voxels)
        out_j = jvoxel.voxel_downsample_local(cj, 0.2, max_voxels=max_voxels)
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(out_j.mask))
        m = out.mask.numpy()
        assert m.sum() > 0 and (max_voxels > 1000 or m.all())
        np.testing.assert_allclose(out.xyz.numpy()[m], np.asarray(out_j.xyz)[m], atol=1e-5)
        assert (out.xyz.numpy()[~m] == cloud.PAD_COORD).all()

    def test_global_keys_match_local_and_jax(self):
        pts = f32(sensor_scan(seed=4, n_max=3000))
        c = cloud.from_numpy(pts, capacity=4096, device="cpu")
        out = voxel.voxel_downsample(c, 0.25, 2048)
        out_l = voxel.voxel_downsample_local(c, 0.25, 2048)
        out_j = jvoxel.voxel_downsample(jcloud.from_numpy(pts, capacity=4096), 0.25, max_voxels=2048)
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(out_j.mask))
        np.testing.assert_array_equal(out.mask.numpy(), out_l.mask.numpy())
        m = out.mask.numpy()
        np.testing.assert_allclose(out.xyz.numpy()[m], np.asarray(out_j.xyz)[m], atol=1e-5)
        np.testing.assert_allclose(out.xyz.numpy()[m], out_l.xyz.numpy()[m], atol=1e-5)

    def test_local_grid_fits(self):
        assert voxel.local_grid_fits(200.0, 0.2) and not voxel.local_grid_fits(300.0, 0.2)
        assert voxel.local_grid_fits(200.0, 0.2) == jvoxel.local_grid_fits(200.0, 0.2)

    def test_prefilter_matches_jax(self):
        pts = f32(sensor_scan(seed=5, n_max=3800))
        cfg = dict(downsample_resolution=0.2, outlier_removal_method="NONE", distance_near_thresh=1.0,
                   distance_far_thresh=100.0)
        out = Prefilter(PrefilterConfig(**cfg), out_capacity=2048, device="cpu")(
            cloud.from_numpy(pts, capacity=4096, device="cpu"))
        out_j = JPrefilter(JPrefilterConfig(**cfg), out_capacity=2048)(jcloud.from_numpy(pts, capacity=4096))
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(out_j.mask))
        m = out.mask.numpy()
        np.testing.assert_allclose(out.xyz.numpy()[m], np.asarray(out_j.xyz)[m], atol=1e-5)

    def test_outlier_filters_not_in_this_slice(self):
        """Both outlier methods build and keep the same voxels as the JAX
        prefilter (tests/test_torch_frontend.py holds each filter against
        JAX)."""
        pts = f32(sensor_scan(seed=5, n_max=3800))
        for method in ("RADIUS", "STATISTICAL"):
            cfg = dict(downsample_resolution=0.2, outlier_removal_method=method)
            out = Prefilter(PrefilterConfig(**cfg), out_capacity=2048, device="cpu")(
                cloud.from_numpy(pts, capacity=4096, device="cpu"))
            out_j = JPrefilter(JPrefilterConfig(**cfg), out_capacity=2048)(jcloud.from_numpy(pts, capacity=4096))
            np.testing.assert_array_equal(out.mask.numpy(), np.asarray(out_j.mask))
