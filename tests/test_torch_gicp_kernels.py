"""The GICP association and linearization kernels' host side and plain
twins (hdl_graph_slam_tpu_torch/csrc/gicp.cu, wrapped in
registration/gicp.py), on the CPU.

The kernels run only on the card. Here the wrappers' CPU route is held to
the plain twins bit for bit, the plain twins to the JAX package's
``_associate`` / ``_linearize_at`` / ``_cost_at`` of GICP and VGICP, a batch
to its single problems, the kernels' arithmetic (the association's order of
roundings, the linearization's per-point terms) to the plain twins, and the
wrappers' launch arithmetic and input checks to the CUDA source.

Inputs are numpy from a seed: points on a few planes of a small scene
(2048 rows, padded rows and far outliers among them) with the port's
plane-regularized covariances, at random poses. Tolerances: Mw within 1e-5
of its largest |entry| (the inverse of C_tgt + R C_src R^T amplifies the
float32 rounding of the sum by its condition number, up to ~1e3 for two
plane covariances), H, b and the cost within 1e-4 of their largest |entry|
(float32 sums over the rows in another order), idx and num equal.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu.registration import vgicp as jvgicp
from hdl_graph_slam_tpu_torch.core import se3
from hdl_graph_slam_tpu_torch.core.cloud import PAD_COORD, PointCloud
from hdl_graph_slam_tpu_torch.registration import gicp, vgicp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "hdl_graph_slam_tpu_torch", "csrc", "gicp.cu")
N = 2048
N_PAD = 96  # padded rows at the end of each cloud
N_FAR = 24  # source rows 6 m above the scene: beyond the correspondence gate
MAX_CORR = 1.0


def scene(rng, n: int, n_pad: int, n_far: int = 0) -> tuple:
    """(xyz, mask) float32 / bool: n - n_pad points on a ground plane and two
    walls of a 20 m box with 2 cm noise, the last n_far of them lifted 6 m,
    then n_pad rows at PAD_COORD."""
    k = n - n_pad
    which = rng.integers(0, 3, k)
    u, v = rng.uniform(-10.0, 10.0, k), rng.uniform(0.0, 4.0, k)
    xyz = np.where(which[:, None] == 0, np.stack([u, rng.uniform(-10.0, 10.0, k), np.zeros(k)], 1),
                   np.where(which[:, None] == 1, np.stack([u, np.full(k, 8.0), v], 1),
                            np.stack([np.full(k, -9.0), u, v], 1)))
    xyz = xyz + rng.normal(0.0, 0.02, xyz.shape)
    xyz[k - n_far:k, 2] += 6.0 * (n_far > 0)
    xyz = np.concatenate([xyz, np.full((n_pad, 3), PAD_COORD)]).astype(np.float32)
    return xyz, np.arange(n) < k


def twist_pose(rng, scale: float) -> np.ndarray:
    tw = rng.normal(0.0, 1.0, 6) * np.array([scale, scale, scale, scale / 20, scale / 20, scale / 10])
    return se3.se3_exp(torch.from_numpy(tw.astype(np.float32))).numpy()


@functools.lru_cache(maxsize=1)
def clouds() -> tuple:
    """The target and three sources (GicpClouds on the CPU, covariances from
    gicp.preprocess) and a pose per source near the identity."""
    rng = np.random.default_rng(2024)
    tgt = gicp.preprocess(PointCloud(*map(torch.from_numpy, scene(rng, N, N_PAD))))
    srcs = [gicp.preprocess(PointCloud(*map(torch.from_numpy, scene(rng, N, N_PAD + 40 * b, N_FAR))))
            for b in range(3)]
    poses = np.stack([twist_pose(rng, 0.15) for _ in srcs])
    return tgt, srcs, torch.from_numpy(poses)


def stack(srcs) -> gicp.GicpCloud:
    return gicp.GicpCloud(*[torch.stack([getattr(s, f) for s in srcs]) for f in ("xyz", "mask", "covs")])


def jax_cloud(c: gicp.GicpCloud) -> jgicp.GicpCloud:
    return jgicp.GicpCloud(xyz=jnp.asarray(c.xyz.numpy()), mask=jnp.asarray(c.mask.numpy()),
                           covs=jnp.asarray(c.covs.numpy()))


def rel_to_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@functools.lru_cache(maxsize=1)
def vgicp_target() -> vgicp.VgicpTarget:
    return vgicp.preprocess_target(PointCloud(clouds()[0].xyz, clouds()[0].mask), 1.0, max_voxels=2048,
                                   grid_size=32, src=clouds()[0])


def jax_vgicp_target(t: vgicp.VgicpTarget) -> jvgicp.VgicpTarget:
    return jvgicp.VgicpTarget(keys=jnp.asarray(t.keys.numpy()), means=jnp.asarray(t.means.numpy()),
                              covs=jnp.asarray(t.covs.numpy()), mask=jnp.asarray(t.mask.numpy()),
                              resolution=jnp.asarray(t.resolution, dtype=jnp.float32),
                              origin=jnp.asarray(t.origin.numpy()), grid=jnp.asarray(t.grid.numpy()))


# -- the wrappers' CPU route ------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_cpu_wrappers_are_the_plain_twins(batched):
    """On CPU tensors associate, linearize and cost are their plain twins,
    bit for bit, with either gate, unbatched and batched."""
    tgt, srcs, poses = clouds()
    src, T = (stack(srcs), poses) if batched else (srcs[0], poses[0])
    idx, d2 = gicp._correspond(T, src, tgt)
    gate = gicp.DistanceGate(d2, tgt.mask, MAX_CORR)
    corr = gicp.associate(T, src, tgt.covs, idx, gate)
    assert same(corr, gicp.associate_plain(T, src, tgt.covs, idx, gate))
    found = d2 < 0.3
    assert same(gicp.associate(T, src, tgt.covs, idx, found), gicp.associate_plain(T, src, tgt.covs, idx, found))
    assert same(gicp.linearize(T, corr, src, tgt.xyz), gicp.linearize_plain(T, corr, src, tgt.xyz))
    assert torch.equal(gicp.cost(T, corr, src, tgt.xyz), gicp.cost_plain(T, corr, src, tgt.xyz))
    assert gicp.associate.launches == gicp.linearize.launches == gicp.cost.launches == 0


# -- the plain twins against the JAX package ---------------------------------------------


@pytest.mark.parametrize("b", [0, 1, 2])
def test_gicp_plain_twins_match_jax(b):
    """Source b at its pose: the JAX _associate's idx and num equal, Mw
    within 1e-5 of its largest entry; _linearize_at's H and b and _cost_at
    within 1e-4 of their largest entry."""
    tgt, srcs, poses = clouds()
    src, T = srcs[b], poses[b]
    tj, sj, Tj = jax_cloud(tgt), jax_cloud(src), jnp.asarray(T.numpy())
    corr = gicp._associate(T, src, tgt, MAX_CORR)
    corr_j = jgicp._associate(Tj, sj, tj, MAX_CORR)
    np.testing.assert_array_equal(corr.idx.numpy(), np.asarray(corr_j.idx))
    assert int(corr.num) == int(corr_j.num) and 0 < int(corr.num) < int(src.mask.sum())
    assert rel_to_max(corr.Mw, corr_j.Mw) <= 1e-5
    H, bb, c, _ = gicp.linearize_plain(T, corr, src, tgt.xyz)
    H_j, b_j, c_j, _ = jgicp._linearize_at(Tj, corr_j, sj, tj)
    assert rel_to_max(H, H_j) <= 1e-4 and rel_to_max(bb, b_j) <= 1e-4
    assert rel_to_max(c, c_j) <= 1e-4
    assert rel_to_max(gicp.cost_plain(T, corr, src, tgt.xyz), jgicp._cost_at(Tj, corr_j, sj, tj)) <= 1e-4


def test_vgicp_plain_twins_match_jax():
    """VGICP's association (the voxel lookup's found flags as the gate)
    and its linearization against the voxel means, against the JAX
    vgicp._associate, _linearize_at and _cost_at, with the same bars."""
    tgt = vgicp_target()
    tj = jax_vgicp_target(tgt)
    _, srcs, poses = clouds()
    src, T = srcs[1], poses[1]
    one = gicp.GicpCloud(src.xyz[None], src.mask[None], src.covs[None])
    Tj, sj = jnp.asarray(T.numpy()), jax_cloud(src)
    corr = vgicp._associate(T[None], one, tgt)
    corr_j = jvgicp._associate(Tj, sj, tj)
    np.testing.assert_array_equal(corr.idx[0].numpy(), np.asarray(corr_j.idx))
    assert int(corr.num[0]) == int(corr_j.num) and int(corr.num[0]) > N // 2
    assert rel_to_max(corr.Mw[0], corr_j.Mw) <= 1e-5
    H, bb, c, _ = gicp.linearize_plain(T[None], corr, one, tgt.means)
    H_j, b_j, c_j, _ = jvgicp._linearize_at(Tj, corr_j, sj, tj)
    assert rel_to_max(H[0], H_j) <= 1e-4 and rel_to_max(bb[0], b_j) <= 1e-4 and rel_to_max(c[0], c_j) <= 1e-4
    assert rel_to_max(gicp.cost_plain(T[None], corr, one, tgt.means)[0], jvgicp._cost_at(Tj, corr_j, sj, tj)) <= 1e-4


# -- batches, cost_only ---------------------------------------------------------------------


def test_batch_rows_equal_single_calls():
    """Row b of a B = 3 batch (ragged valid counts, its own pose) equals the
    single problem's association, H and cost bit for bit, and its b within
    1e-6 of the largest entry: on the CPU the plain twin's einsum for b
    sums a batch in another blocking than one problem (the kernels' rows
    are bit for bit the batch of one, chip_smoke.py's gicp_kernels gate)."""
    tgt, srcs, poses = clouds()
    src = stack(srcs)
    idx, d2 = gicp._correspond(poses, src, tgt)
    corr = gicp.associate(poses, src, tgt.covs, idx, gicp.DistanceGate(d2, tgt.mask, MAX_CORR))
    H, bb, c, num = gicp.linearize(poses, corr, src, tgt.xyz)
    cst = gicp.cost(poses, corr, src, tgt.xyz)
    assert torch.equal(num, corr.num) and num.tolist() == [int(x.num) for x in map(
        lambda b: gicp._associate(poses[b], srcs[b], tgt, MAX_CORR), range(3))]
    for b in range(3):
        one = gicp.associate(poses[b], srcs[b], tgt.covs, idx[b], gicp.DistanceGate(d2[b], tgt.mask, MAX_CORR))
        assert same(one, [x[b] for x in corr])
        H1, b1, c1, _ = gicp.linearize(poses[b], one, srcs[b], tgt.xyz)
        assert torch.equal(H1, H[b]) and torch.equal(c1, c[b]) and rel_to_max(b1, bb[b]) <= 1e-6
        assert torch.equal(gicp.cost(poses[b], one, srcs[b], tgt.xyz), cst[b])


def test_cost_only_is_the_full_calls_cost():
    """cost gives linearize's cost bit for bit, unbatched and batched."""
    tgt, srcs, poses = clouds()
    for T, src in ((poses[0], srcs[0]), (poses, stack(srcs))):
        corr = gicp._associate(T, src, tgt, MAX_CORR)
        assert torch.equal(gicp.cost(T, corr, src, tgt.xyz), gicp.linearize(T, corr, src, tgt.xyz)[2])


# -- the kernels' arithmetic ---------------------------------------------------------------


def associate_as_the_kernel(T, covs, tgt_covs, idx, valid) -> np.ndarray:
    """gicp_associate_kernel's roundings in numpy float32, one IEEE product
    or sum at a time in the kernel's order: RC = R C and A = C_tgt +
    (RC) R^T as left-to-right sums of three products, the adjugate's
    products and differences, the correctly rounded 1 / det with |det|
    clamped at 1e-20, then adj * inv_det * valid."""
    f = np.float32
    R, C, Ct = T[:3, :3], covs, tgt_covs[idx]
    RC = np.empty_like(C)
    A = np.empty_like(C)
    for r in range(3):
        for c in range(3):
            RC[:, r, c] = (R[r, 0] * C[:, 0, c] + R[r, 1] * C[:, 1, c]) + R[r, 2] * C[:, 2, c]
    for r in range(3):
        for c in range(3):
            A[:, r, c] = Ct[:, r, c] + ((RC[:, r, 0] * R[c, 0] + RC[:, r, 1] * R[c, 1]) + RC[:, r, 2] * R[c, 2])
    a, b, c, d, e, g_, h, i = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 0], A[:, 1, 1], A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    fF = A[:, 1, 2]
    cA, cB, cC = e * i - fF * h, -(d * i - fF * g_), d * h - e * g_
    det = (a * cA + b * cB) + c * cC
    inv_det = f(1.0) / np.where(np.abs(det) < f(1e-20), f(1e-20), det)
    adj = np.stack([cA, -(b * i - c * h), b * fF - c * e, cB, a * i - c * g_, -(a * fF - c * d),
                    cC, -(a * h - b * g_), a * e - b * d], -1).reshape(-1, 3, 3)
    return (adj * inv_det[:, None, None]) * valid.astype(f)[:, None, None]


@pytest.mark.parametrize("b", [0, 2])
def test_association_kernel_order_gives_the_plain_bits(b):
    """The association kernel's order of float32 roundings (mirrored in
    numpy) gives associate_plain's Mw bit for bit: the plain twin and the
    kernel round the same products and sums."""
    tgt, srcs, poses = clouds()
    src, T = srcs[b], poses[b]
    idx, d2 = gicp._correspond(T, src, tgt)
    corr = gicp.associate_plain(T, src, tgt.covs, idx, gicp.DistanceGate(d2, tgt.mask, MAX_CORR))
    valid = (src.mask & tgt.mask[idx] & (d2 < MAX_CORR * MAX_CORR)).numpy()
    mw = associate_as_the_kernel(T.numpy(), src.covs.numpy(), tgt.covs.numpy(), idx.numpy(), valid)
    np.testing.assert_array_equal(mw.view(np.int32), corr.Mw.numpy().view(np.int32))
    assert int(corr.num) == int(valid.sum())


def test_linearization_point_terms_sum_to_the_plain_twin():
    """The linearization kernel's per-point terms, b = [-Me, Me x p] and the
    upper triangle of H = [[M, -M S], [S M, -S M S]] with S = hat(p)
    mirrored, sum in float64 to linearize_plain's H and b (rtol 1e-9) for a
    symmetric M (the association's M is symmetric up to the rounding of
    R C R^T)."""
    rng = np.random.default_rng(7)
    n = 300
    p_src = rng.normal(0.0, 5.0, (n, 3))
    q = rng.normal(0.0, 5.0, (n, 3))
    A = rng.normal(0.0, 1.0, (n, 3, 3))
    M = A @ np.swapaxes(A, -1, -2) * (rng.random(n) < 0.8)[:, None, None]
    T = se3.se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.05, -0.02, 0.1], dtype=torch.float64)).numpy()
    p = p_src @ T[:3, :3].T + T[:3, 3]
    e = q - p
    Me = np.einsum("nij,nj->ni", M, e)
    b = np.concatenate([-Me, np.cross(Me, p)], 1).sum(0)
    H = np.zeros((6, 6))
    for k in range(n):
        S = se3.hat(torch.from_numpy(p[k])).numpy()
        MS = M[k] @ S
        upper = np.block([[M[k], -MS], [np.zeros((3, 3)), -S @ MS]])
        H += np.triu(upper) + np.triu(upper, 1).T
    src = gicp.GicpCloud(torch.from_numpy(p_src), torch.ones(n, dtype=torch.bool), torch.zeros(n, 3, 3))
    corr = gicp.GicpCorr(torch.arange(n), torch.from_numpy(M), torch.tensor(n))
    H_p, b_p, c_p, _ = gicp.linearize_plain(torch.from_numpy(T), corr, src, torch.from_numpy(q))
    np.testing.assert_allclose(H, H_p.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(b, b_p.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose((e * Me).sum(), float(c_p), rtol=1e-12)


# -- the CUDA source and the wrappers' launch arithmetic ----------------------------------


def source() -> str:
    with open(SRC) as f:
        return f.read()


def test_launch_constants_match_the_cuda_source():
    """The wrapper's threads, block cap and partial row are gicp.cu's, its
    block count is blocks_for(n) at every shape (the C entry point refuses
    any other), and neither grid depends on the batch but as its y
    dimension."""
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", source())}
    assert (gicp._THREADS, gicp._MAX_BLOCKS, gicp._ROW) == (c["kThreads"], c["kMaxBlocks"], c["kRow"])
    assert c["kWidth"] == 28 <= c["kRow"] and c["kOut"] == 43
    body = re.search(r"int blocks_for\(int n\) \{(.*?)\n\}", source(), re.S).group(1)
    assert "(n + kThreads - 1) / kThreads" in body and "b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks" in body
    for n, want in [(1, 1), (256, 1), (257, 2), (4096, 16), (8192, 32), (16384, 64), (262144, 1024), (10**6, 1024)]:
        assert gicp._blocks(n) == want, n
    assert "const dim3 grd((n + kThreads - 1) / kThreads, batch);" in source()
    assert "const dim3 grd(nblk, batch);" in source()


def test_cuda_source_has_one_launch_per_call_and_no_float_atomics():
    """Each entry point launches one kernel (the linearization one of its
    two instantiations); the only atomics are int32 (tickets and counts);
    the association rounds each product and sum on its own (no FMA
    contraction) and takes the correctly rounded reciprocal."""
    src = source()
    assert sorted(set(re.findall(r"\b(atomic\w+)\(", src))) == ["atomicAdd", "atomicExch"]
    assert sorted(re.findall(r"atomic\w+\(([a-z]+)", src)) == ["counters", "counters", "ticket"]
    for entry, kernels in (("hgs_gicp_associate", ["gicp_associate_kernel"]),
                           ("hgs_gicp_linearize", ["gicp_linearize_kernel<true>", "gicp_linearize_kernel<false>"])):
        body = re.search(rf"int {entry}\(.*?\n\}}", src, re.S).group(0)
        assert re.findall(r"(\w+(?:<\w+>)?)<<<grd, kThreads, 0,", body) == kernels
    kernel = re.search(r"gicp_associate_kernel\(.*?\n\}", src, re.S).group(0)
    assert "__frcp_rn(fabsf(det) < 1e-20f ? 1e-20f : det)" in kernel and "fmaf" not in kernel
    assert "__fdividef" not in src and "__expf" not in src


def test_kernel_input_checks():
    """What the kernels do not take raises before a launch (meta tensors
    stand in for the card's)."""
    tgt, srcs, poses = clouds()
    m = torch.device("meta")
    src = gicp.GicpCloud(*[getattr(srcs[0], f).to(m) for f in ("xyz", "mask", "covs")])
    T, covs = poses[0].to(m), tgt.covs.to(m)
    idx, d2 = torch.zeros(N, dtype=torch.int32, device=m), torch.zeros(N, device=m)
    gate = gicp.DistanceGate(d2, tgt.mask.to(m), MAX_CORR)
    corr = gicp.GicpCorr(idx, torch.zeros(N, 3, 3, device=m), torch.zeros((), dtype=torch.int32, device=m))
    with pytest.raises(ValueError, match="idx"):
        gicp.associate(T, src, covs, idx.long(), gate)
    with pytest.raises(ValueError, match="gate"):
        gicp.associate(T, src, covs, idx, d2)  # float flags
    with pytest.raises(ValueError, match="gate"):
        gicp.associate(T, src, covs, idx, gicp.DistanceGate(d2[:7], gate.tgt_mask, MAX_CORR))
    with pytest.raises(ValueError, match="poses"):
        gicp.associate(T.double(), src, covs, idx, gate)
    with pytest.raises(ValueError, match="tensors on"):
        gicp.associate(T, src, tgt.covs, idx, gate)
    with pytest.raises(ValueError, match="batch"):
        gicp.linearize(torch.zeros(0, 4, 4, device=m), corr, src, tgt.xyz.to(m))
    with pytest.raises(ValueError, match="Mw"):
        gicp.linearize(T, corr._replace(Mw=corr.Mw.double()), src, tgt.xyz.to(m))
    with pytest.raises(ValueError, match="target"):
        gicp.cost(T, corr, src, tgt.xyz.to(m)[:, :2])
