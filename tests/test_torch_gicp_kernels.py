"""The GICP association and linearization kernels' host side and plain
twins (hdl_graph_slam_tpu_torch/csrc/gicp.cu, wrapped in
registration/gicp.py), on the CPU.

The kernels run only on the card. Here the wrappers' CPU route is held to
the plain twins bit for bit, the plain twins to the JAX package's
``_associate`` / ``_linearize_at`` / ``_cost_at`` of GICP and VGICP, a batch
to its single problems, the fused twin to the association then the
linearization, the kernels' arithmetic (the association's order of
roundings, the linearization's per-point terms) to the plain twins, the
wrappers' launch arithmetic and input checks to the CUDA source, and the LM
loop that launches each form once per pose and correspondence set to the
loop that repeated them (a copy of it kept here), bit for bit.

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
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu.registration import vgicp as jvgicp
from hdl_graph_slam_tpu_torch.core import se3
from hdl_graph_slam_tpu_torch.core.cloud import PAD_COORD, PointCloud
from hdl_graph_slam_tpu_torch.ops.small_solve import solve_spd
from hdl_graph_slam_tpu_torch.registration import base, gicp, vgicp

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
    fc, fl = gicp.associate_linearize(T, src, tgt.covs, tgt.xyz, idx, gate)
    pc, pl = gicp.associate_linearize_plain(T, src, tgt.covs, tgt.xyz, idx, gate)
    assert same(fc, pc) and same(fl, pl)
    assert (gicp.associate.launches == gicp.linearize.launches == gicp.cost.launches
            == gicp.associate_linearize.launches == 0)


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


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("gate_kind", ["distance", "found"])
def test_fused_twin_is_associate_then_linearize(batched, gate_kind):
    """associate_linearize_plain (the fused form's twin) gives
    associate_plain then linearize_plain at the same poses bit for bit, and
    each call repeated gives its bits again, with either gate at B = 1 and
    B = 3; the linearization's cost is cost_plain's."""
    tgt, srcs, poses = clouds()
    src, T = (stack(srcs), poses) if batched else (srcs[0], poses[0])
    idx, d2 = gicp._correspond(T, src, tgt)
    gate = gicp.DistanceGate(d2, tgt.mask, MAX_CORR) if gate_kind == "distance" else d2 < 0.3
    corr, lin = gicp.associate_linearize_plain(T, src, tgt.covs, tgt.xyz, idx, gate)
    corr2 = gicp.associate_plain(T, src, tgt.covs, idx, gate)
    assert same(corr, corr2) and same(lin, gicp.linearize_plain(T, corr2, src, tgt.xyz))
    assert 0 < int(corr.num.min()) and int(corr.num.max()) < N
    again = gicp.associate_linearize_plain(T, src, tgt.covs, tgt.xyz, idx, gate)
    assert same(again[0], corr) and same(again[1], lin)
    assert torch.equal(gicp.cost_plain(T, corr, src, tgt.xyz), lin[2])


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
    """The wrapper's forms, threads a block and scratch row are gicp.cu's;
    its layout is layout_for(n) at every shape (the C entry point refuses
    any other): equal spans of whole 4-row groups covering n, never more
    rows a block than its threads, and the grid's y dimension the batch."""
    src = source()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (gicp._THREADS, gicp._ROW) == (c["kThreads"], c["kRow"])
    assert c["kWidth"] == 28 == c["kCountSlot"] < c["kRow"] and c["kOut"] == 43 and c["kRecord"] == 4 * (9 + 3)
    assert "enum Form : int { kAssociate = 0, kFused = 1, kLinearize = 2, kCost = 3 };" in src
    assert (gicp.ASSOCIATE, gicp.FUSED, gicp.LINEARIZE, gicp.COST) == (0, 1, 2, 3)
    body = re.search(r"Layout layout_for\(int n\) \{(.*?)\n\}", src, re.S).group(1)
    for line in ("const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;",
                 "const int span = ((n + blocks - 1) / blocks + 3) / 4 * 4;", "return {blocks, span > 0 ? span : 4};"):
        assert line in body, line
    for n, layout in {1: (1, 4), 128: (1, 128), 129: (2, 68), 4096: (32, 128), 8192: (64, 128),
                      8193: (65, 128)}.items():
        assert gicp._layout(n) == layout, n
    for n in (1, 3, 5, 1001, 2048, 4095, 4097, 8191, 12000, 16384, 100003):
        blocks, span = gicp._layout(n)
        assert span % 4 == 0 and blocks * span >= n > (blocks - 1) * span - 4 and span <= gicp._THREADS
    assert "gicp_step_kernel<kForm><<<dim3(a.blocks, a.batch), kThreads, 0, st>>>(a);" in src
    assert "__shared__ float4 smem4[kRecord * kThreads / 16];" in src


def test_cuda_source_has_one_launch_per_call_and_no_float_atomics():
    """The entry point launches one kernel (one launch statement, each form
    an instantiation); the only atomic is the int32 ticket; the association
    rounds each product and sum on its own (no FMA contraction) and takes
    the correctly rounded reciprocal; the linearization's row terms are
    explicit fmaf / IEEE products (one rounding order in every form); the
    cost form's warp sum and the blocks' sum use no float atomics."""
    src = source()
    assert re.findall(r"\b(atomic\w+)\(", src) == ["atomicAdd"]
    assert re.findall(r"atomicAdd\((\w+)", src) == ["ticket"]
    assert src.count("<<<") == 1 and "cudaLaunchKernelEx" not in src
    entry = re.search(r"int hgs_gicp_step\(.*?\n\}", src, re.S).group(0)
    assert re.findall(r"launch<(k\w+)>\(\*a, st\)", entry) == ["kAssociate", "kFused", "kLinearize", "kCost"]
    assoc = re.search(r"void mahalanobis\(.*?\n\}", src, re.S).group(0)
    assert "__frcp_rn(fabsf(det) < 1e-20f ? 1e-20f : det)" in assoc and "fmaf" not in assoc
    terms = re.search(r"void add_terms\(.*?\n\}", src, re.S).group(0)
    assert not re.search(r"\w\] \* \w", terms), "a bare product the compiler may contract"
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
    with pytest.raises(ValueError, match="idx"):
        gicp.associate_linearize(T, src, covs, tgt.xyz.to(m), idx[:9], gate)
    with pytest.raises(ValueError, match="poses"):  # 3 poses for one problem's rows
        gicp.associate(poses.to(m), src, covs, idx, gate)
    with pytest.raises(ValueError, match="poses"):
        gicp.cost(poses.to(m), corr, src, tgt.xyz.to(m))
    # the prepared call checks the align's sources and target once
    tx, tm = tgt.xyz.to(m), tgt.mask.to(m)
    with pytest.raises(ValueError, match="gicp prepared"):
        gicp.Prepared(gicp.GicpCloud(src.xyz.double(), src.mask, src.covs), covs, tx, tm, MAX_CORR)
    with pytest.raises(ValueError, match="gicp prepared"):
        gicp.Prepared(src, covs, tx[:5], tm, MAX_CORR)
    with pytest.raises(ValueError, match="gicp prepared"):
        gicp.Prepared(src, covs, tx, tm.float(), MAX_CORR)
    with pytest.raises(ValueError, match="gicp prepared"):
        gicp.Prepared(src, tgt.covs, tx, tm, MAX_CORR)  # a target on another device
    with pytest.raises(ValueError, match="gicp prepared"):
        gicp.Prepared(gicp.GicpCloud(src.xyz[None].expand(70000, -1, -1), src.mask[None].expand(70000, -1),
                                     src.covs[None].expand(70000, -1, -1, -1)), covs, tx, tm, MAX_CORR)


# -- the LM loop: each form once per pose and correspondence set ------------------------------
# The loop as it was before the fused form (its _lm_init, _lm_step, lm_loop
# and lm_loop_batched, kept here as the reference): an association, then a
# linearization at the same pose; every step linearizes at its pose again,
# the first one repeating _lm_init's; the ungated loop associates at the
# guess twice.


def _old_lm_init(associate_all, linearize_at, guess, lm_init_lambda_factor):
    corr = associate_all(guess)
    H0, _, cost0, n0 = linearize_at(guess, corr)
    lam0 = lm_init_lambda_factor * torch.diagonal(H0, dim1=-2, dim2=-1).abs().amax(-1)
    two = torch.full_like(lam0, 2.0)
    s = base.LMState(T=guess, lam=lam0, nu=two, converged=torch.zeros_like(lam0, dtype=torch.bool),
                     num_inliers=n0, error=cost0)
    return s, corr, lam0


def _old_lm_step(s, corr, linearize_at, cost_at, epsilon):
    H, b, cost, ninl = linearize_at(s.T, corr)
    A = H.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(s.lam[..., None])
    d = -solve_spd(A, b)
    delta = se3.se3_exp(d)
    T_new = se3.compose(delta, s.T)
    cost_new = cost_at(T_new, corr)
    accept = (cost_new < cost) & torch.isfinite(cost_new)
    denom = (d * (s.lam[..., None] * d - b)).sum(-1)
    rho = (cost - cost_new) / torch.where(denom.abs() < 1e-30, 1e-30, denom)
    lam_acc = s.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam = torch.where(accept, lam_acc, s.lam * s.nu)
    nu = torch.where(accept, 2.0, 2.0 * s.nu)
    conv = base.se3_delta_converged(delta, epsilon)
    s2 = base.LMState(T=torch.where(accept[..., None, None], T_new, s.T), lam=lam, nu=nu, converged=conv,
                      num_inliers=ninl, error=torch.where(accept, cost_new, cost))
    return s2, d, accept


def _old_select_rows(cond, new, old):
    return type(new)(*[torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b) for a, b in zip(new, old)])


def _old_put_rows(corr, rows, part):
    return type(corr)(*[c.index_put((rows,), p) for c, p in zip(corr, part)])


def old_lm_loop(associate, linearize_at, cost_at, guess, max_iterations, transformation_epsilon,
                lm_init_lambda_factor=1e-9, reassoc_displacement=0.0, r_max: Optional[torch.Tensor] = None):
    gated = bool(reassoc_displacement)
    s, corr, lam0 = _old_lm_init(associate, linearize_at, guess, lm_init_lambda_factor)
    it, converged = 0, False
    if not gated:
        while it < max_iterations and not converged:
            s, _, _ = _old_lm_step(s, associate(s.T), linearize_at, cost_at, transformation_epsilon)
            it += 1
            converged = bool(s.converged)
    else:
        disp = torch.zeros_like(lam0)
        while it < max_iterations and not converged:
            s2, d, accept = _old_lm_step(s, corr, linearize_at, cost_at, transformation_epsilon)
            it += 1
            s, refresh, disp = base._lm_gate(s, s2, d, accept, disp, r_max, reassoc_displacement, lam0)
            converged, do_refresh = torch.stack([s.converged, refresh]).tolist()
            if do_refresh:
                corr = associate(s.T)
        if not converged:
            s = s._replace(error=cost_at(s.T, associate(s.T)))
    return base.AlignResult(transformation=s.T, converged=s.converged,
                            iterations=torch.tensor(it, dtype=torch.int32, device=guess.device), error=s.error,
                            num_inliers=s.num_inliers)


def old_lm_loop_batched(associate, linearize_at, cost_at, guess, max_iterations, transformation_epsilon,
                        lm_init_lambda_factor=1e-9, reassoc_displacement=0.0, r_max=None):
    gated = bool(reassoc_displacement)
    dev = guess.device
    all_rows = torch.arange(guess.shape[0], device=dev)
    s, corr, lam0 = _old_lm_init(lambda T: associate(T, all_rows), linearize_at, guess, lm_init_lambda_factor)
    it = torch.zeros_like(lam0, dtype=torch.int32)
    live = torch.ones_like(lam0, dtype=torch.bool)
    disp = torch.zeros_like(lam0)
    for _ in range(max_iterations):
        s2, d, accept = _old_lm_step(s, corr, linearize_at, cost_at, transformation_epsilon)
        if gated:
            s2, refresh, disp_next = base._lm_gate(s, s2, d, accept, disp, r_max, reassoc_displacement, lam0)
            disp = torch.where(live, disp_next, disp)
            do_refresh = live & refresh
        s = _old_select_rows(live, s2, s)
        it = it + live.to(it.dtype)
        live = ~s.converged & (it < max_iterations)
        flags = torch.stack([live, do_refresh] if gated else [live, live]).cpu()
        if not bool(flags[0].any()):
            break
        rows = torch.nonzero(flags[1])[:, 0].to(dev)
        if rows.numel():
            corr = _old_put_rows(corr, rows, associate(s.T[rows], rows))
    if gated and not bool(s.converged.all()):
        fresh = cost_at(s.T, associate(s.T, all_rows))
        s = s._replace(error=torch.where(s.converged, s.error, fresh))
    return base.AlignResult(transformation=s.T, converged=s.converged, iterations=it, error=s.error,
                            num_inliers=s.num_inliers)


def old_align(tgt, src, guess, max_corr_dist, epsilon, iterations, reassoc):
    """gicp.align's arguments through the old loop and the plain twins."""
    r_max = None
    if reassoc:
        r_max = torch.sqrt(torch.where(src.mask, (src.xyz * src.xyz).sum(-1), 0.0).amax(-1))
    kw = dict(linearize_at=lambda T, c: gicp.linearize_plain(T, c, src, tgt.xyz),
              cost_at=lambda T, c: gicp.cost_plain(T, c, src, tgt.xyz), guess=guess, max_iterations=iterations,
              transformation_epsilon=epsilon, reassoc_displacement=reassoc, r_max=r_max)
    if guess.ndim == 2:
        return old_lm_loop(associate=lambda T: gicp._associate(T, src, tgt, max_corr_dist), **kw)

    def associate_rows(T, rows):
        part = gicp.GicpCloud(xyz=src.xyz[rows], mask=src.mask[rows], covs=src.covs[rows])
        return gicp._associate(T, part, tgt, max_corr_dist)

    return old_lm_loop_batched(associate=associate_rows, **kw)


# guesses off the poses the sources were drawn at; epsilon small and few
# iterations, so that trials are rejected, gated correspondences refresh,
# and some problems stop at max_iterations (the honest error's path)
LM_EPSILON, LM_ITERATIONS, LM_REASSOC = 1e-4, 6, 0.05


def lm_problem(batched: bool):
    tgt, srcs, poses = clouds()
    rng = np.random.default_rng(11)
    guesses = torch.from_numpy(np.stack([twist_pose(rng, 0.3) for _ in srcs])) @ poses
    return (tgt, stack(srcs), guesses) if batched else (tgt, srcs[0], guesses[0])


@pytest.mark.parametrize("reassoc", [0.0, LM_REASSOC], ids=["ungated", "gated"])
@pytest.mark.parametrize("batched", [False, True])
def test_lm_loop_gives_the_repeating_loops_result(batched, reassoc):
    """gicp.align through the new lm_loop / lm_loop_batched (the fused form
    at every association, the trial linearized in full when gated, the
    first step reusing _lm_init's calls) gives the old loop's AlignResult
    bit for bit on the plain twins, gated and ungated, one problem and a
    batch of three."""
    tgt, src, guess = lm_problem(batched)
    new = gicp.align(tgt, src, guess, max_corr_dist=MAX_CORR, transformation_epsilon=LM_EPSILON,
                     max_iterations=LM_ITERATIONS, reassoc_displacement=reassoc)
    old = old_align(tgt, src, guess, MAX_CORR, LM_EPSILON, LM_ITERATIONS, reassoc)
    assert same(new, old), (new, old)
    assert int(new.iterations.max()) > 1


def test_vgicp_batched_loop_gives_the_repeating_loops_result():
    """vgicp.align (lm_loop_batched over the voxel target, the found gate)
    against the old loop on the plain twins: bit for bit, ungated and
    gated."""
    tgt = vgicp_target()
    _, srcs, poses = clouds()
    src = stack(srcs)
    for reassoc in (0.0, LM_REASSOC):
        new = vgicp.align(tgt, src, poses, transformation_epsilon=LM_EPSILON, max_iterations=LM_ITERATIONS,
                          reassoc_displacement=reassoc)
        r_max = torch.sqrt(torch.where(src.mask, (src.xyz * src.xyz).sum(-1), 0.0).amax(-1)) if reassoc else None

        def associate_rows(T, rows):
            part = gicp.GicpCloud(xyz=src.xyz[rows], mask=src.mask[rows], covs=src.covs[rows])
            return vgicp._associate(T, part, tgt)

        old = old_lm_loop_batched(associate_rows, lambda T, c: gicp.linearize_plain(T, c, src, tgt.means),
                                  lambda T, c: gicp.cost_plain(T, c, src, tgt.means), poses, LM_ITERATIONS,
                                  LM_EPSILON, reassoc_displacement=reassoc, r_max=r_max)
        assert same(new, old), (reassoc, new, old)


class Counting:
    """The plain twins behind counters: the loop's GICP calls by form, and
    the poses each linearization ran at."""

    def __init__(self, tgt, src):
        self.tgt, self.src = tgt, src
        self.calls = dict(associate=0, associate_linearize=0, linearize=0, cost=0)
        self.linearized_at = []

    def associate(self, T):
        self.calls["associate"] += 1
        return gicp._associate(T, self.src, self.tgt, MAX_CORR)

    def associate_linearize(self, T):
        self.calls["associate_linearize"] += 1
        idx, d2 = gicp._correspond(T, self.src, self.tgt)
        return gicp.associate_linearize_plain(T, self.src, self.tgt.covs, self.tgt.xyz, idx,
                                              gicp.DistanceGate(d2, self.tgt.mask, MAX_CORR))

    def linearize(self, T, corr):
        self.calls["linearize"] += 1
        self.linearized_at.append(T.clone())
        return gicp.linearize_plain(T, corr, self.src, self.tgt.xyz)

    def cost(self, T, corr):
        self.calls["cost"] += 1
        return gicp.cost_plain(T, corr, self.src, self.tgt.xyz)

    def run(self, guess, reassoc, iterations):
        r_max = torch.sqrt(torch.where(self.src.mask, (self.src.xyz ** 2).sum(-1), 0.0).amax(-1)) if reassoc else None
        return base.lm_loop(self.associate, self.linearize, self.cost, guess, iterations, LM_EPSILON,
                            reassoc_displacement=reassoc, r_max=r_max, associate_linearize=self.associate_linearize)


@pytest.mark.parametrize("iterations", [3, 64])
def test_lm_loop_calls_each_form_once_per_pose(iterations):
    """Gated, an align makes 1 + refreshes fused calls and one
    linearization a step, never at the guess (the first step takes
    _lm_init's), and no cost-only call but the honest error's on a
    max-iterations exit: at most 1 + iterations + refreshes GICP calls
    (+ 2 on that exit). Ungated, one fused call a step (the first is
    _lm_init's) and one cost-only trial."""
    tgt, src, guess = lm_problem(False)
    c = Counting(tgt, src)
    out = c.run(guess, LM_REASSOC, iterations)
    it, converged = int(out.iterations), bool(out.converged)
    refreshes = c.calls["associate_linearize"] - 1
    assert c.calls["linearize"] == it and all(not torch.equal(T, guess) for T in c.linearized_at)
    assert c.calls["associate"] == c.calls["cost"] == (0 if converged else 1)
    assert sum(c.calls.values()) <= 1 + it + refreshes + (0 if converged else 2)
    assert (iterations == 3) != converged and refreshes >= 1
    u = Counting(tgt, src)
    out = u.run(guess, 0.0, iterations)
    assert u.calls == dict(associate=0, associate_linearize=int(out.iterations), linearize=0,
                           cost=int(out.iterations))


class RingPrepared(gicp.Prepared):
    """gicp.Prepared with its card path on the CPU: its rings of two output
    slots and its select over the kernel's (B, 43) rows, each launch the
    plain twin writing its outputs into the slot's tensors as the kernel
    writes them. The forms launched are kept in ``launched``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.cpu = False
        self.launched = []

    def _launch(self, form, T, idx, flags, Mw, num, out, name):
        self.launched.append(form)
        if form in (gicp.ASSOCIATE, gicp.FUSED):
            corr = gicp.associate_plain(T, self.src, self.tgt_covs, idx, self._plain_gate(flags))
            Mw.copy_(corr.Mw.reshape(Mw.shape))
            num.copy_(corr.num.reshape(num.shape))
        corr = gicp.GicpCorr(idx, Mw.reshape(idx.shape + (3, 3)), None)
        if form in (gicp.FUSED, gicp.LINEARIZE):
            H, b, c, _ = gicp.linearize_plain(T, corr, self.src, self.tgt_xyz)
            out.copy_(torch.cat([b.reshape(-1, 6), H.reshape(-1, 36), c.reshape(-1, 1)], 1))
        elif form == gicp.COST:
            out.copy_(gicp.cost_plain(T, corr, self.src, self.tgt_xyz).reshape(-1))


@pytest.mark.parametrize("case", ["gated", "ungated", "batched_gated", "batched_ungated", "vgicp_gated",
                                  "refresh_then_max_iterations"])
def test_prepared_rings_keep_the_loops_results(monkeypatch, case):
    """gicp.align and vgicp.align launching through Prepared's rings (the
    card's output slots, reused every second call of a kind) give the plain
    loop's AlignResult bit for bit: no result the loop still holds is
    overwritten. The last case exits at max_iterations right after a
    refresh, so the honest error's association runs while the state's
    inlier count is the last step's, a count that association changes."""
    tgt, src, guess = lm_problem(case.startswith("batched") or case.startswith("vgicp"))
    reassoc = 0.0 if case.endswith("ungated") else LM_REASSOC
    iterations = LM_ITERATIONS
    if case == "refresh_then_max_iterations":
        reassoc, iterations = 1e-6, 2  # every accepted step refreshes
    preps = []

    def make(*args, **kw):
        preps.append(RingPrepared(*args, **kw))
        return preps[-1]

    def run():
        if case.startswith("vgicp"):
            return vgicp.align(vgicp_target(), src, guess, transformation_epsilon=LM_EPSILON,
                               max_iterations=iterations, reassoc_displacement=reassoc)
        return gicp.align(tgt, src, guess, max_corr_dist=MAX_CORR, transformation_epsilon=LM_EPSILON,
                          max_iterations=iterations, reassoc_displacement=reassoc)

    plain = run()
    monkeypatch.setattr(gicp, "Prepared", make)
    ringed = run()
    assert len(preps) == 1 and preps[0].launched
    assert same(ringed, plain), (ringed, plain)
    if case == "refresh_then_max_iterations":
        assert not bool(plain.converged) and int(plain.iterations) == iterations
        assert preps[0].launched[-3:] == [gicp.FUSED, gicp.ASSOCIATE, gicp.COST]
        honest = gicp._associate(plain.transformation, src, tgt, MAX_CORR)
        assert int(honest.num) != int(plain.num_inliers)
