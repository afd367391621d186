"""The host side of the NDT reduction kernels (csrc/ndt.cu, wrapped in
hdl_graph_slam_tpu_torch/registration/ndt.py), on the CPU.

The kernels run only on the card; here the wrappers' launch arithmetic is
held against the constants of the CUDA source, their input checks are
exercised, and the kernels' (point, cell) pair decomposition of the NDT
derivatives is checked in float64 against ``score_derivatives``, which
tests/test_torch_ndt.py holds against the JAX package.
"""

import os
import re

import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu_torch.core import se3
from hdl_graph_slam_tpu_torch.registration import ndt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "hdl_graph_slam_tpu_torch", "csrc", "ndt.cu")


def source() -> str:
    with open(SRC) as f:
        return f.read()


def constants() -> dict:
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", source())}


def test_launch_constants_match_the_cuda_source():
    """The wrapper's threads, block cap, cell cap and trial cap are ndt.cu's,
    and its block count is blocks_for over the n x K pairs at every shape
    (the C entry points refuse any other count)."""
    c = constants()
    assert (ndt._THREADS, ndt._MAX_BLOCKS, ndt._MAX_K, ndt.MAX_TRIALS) == (
        c["kThreads"], c["kMaxBlocks"], c["kMaxK"], c["kMaxTrials"])
    assert ndt._DERIV_ROW == c["kDerivRow"] and re.search(r"constexpr int kScoreRow = kMaxTrials;", source())
    assert ndt._SCORE_ROW == ndt.MAX_TRIALS and ndt._DERIV_ROW >= c["kDerivWidth"]
    body = re.search(r"int blocks_for\(int pairs\) \{(.*?)\n\}", source(), re.S).group(1)
    assert "(pairs + kThreads - 1) / kThreads" in body and "b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks" in body

    def blocks_for(pairs):
        b = (pairs + c["kThreads"] - 1) // c["kThreads"]
        return (b if b > 0 else 1) if b < c["kMaxBlocks"] else c["kMaxBlocks"]

    for n, K in [(1, 1), (255, 1), (256, 1), (257, 1), (8192, 7), (8192, 1), (16384, 7), (16384, 8), (37449, 7),
                 (100000, 8)]:
        assert ndt._blocks(n, K) == blocks_for(n * K), (n, K)
    assert ndt._blocks(8192, 7) >= 132  # ndt_main's shape fills the H100's SMs


def test_cuda_source_has_one_launch_per_reduction_and_no_float_atomics():
    """Each reduction entry point launches its kernel once, over (blocks,
    batch) with no trial dimension; the only atomic is the int ticket."""
    src = source()
    assert "ndt_finish_kernel" not in src
    assert re.findall(r"\b(atomic\w+)\((\w+)", src) == [("atomicAdd", "ticket")]
    for entry, kernel in (("hgs_ndt_derivatives", "ndt_derivatives_kernel"), ("hgs_ndt_score", "ndt_score_kernel")):
        body = re.search(rf"int {entry}\(.*?\n\}}", src, re.S).group(0)
        assert re.findall(r"(\w+)<<<(dim3\([^)]*\))", body) == [(kernel, "dim3(nblk, batch)")]


def test_association_runs_one_pair_a_thread():
    """The association launches once over the reductions' pair grid,
    blocks_for(n K) x B blocks of kThreads, its kernel instantiated for K =
    1 and 7, each thread one (point, cell) pair writing its own idx and
    found entry."""
    src = source()
    body = re.search(r"int hgs_ndt_associate\(.*?\n\}", src, re.S).group(0)
    assert "const dim3 grd(blocks_for(n * K), batch);" in body
    assert re.findall(r"(ndt_associate_kernel<\d>)<<<grd, kThreads,", body) == [
        "ndt_associate_kernel<7>", "ndt_associate_kernel<1>"]
    kernel = re.search(r"ndt_associate_kernel\(.*?\n\}", src, re.S).group(0)
    assert "const int i = t / K, k = t - i * K;" in kernel
    assert "idx_out[pair] = id;" in kernel and "found_out[pair] = f;" in kernel and "for (int k = 0" not in kernel


def pair_terms(d1, d2, p, mu, icov):
    """One (point, cell) pair's share of g (6,), H (6, 6) and the score, as
    the derivative kernel adds it, in float64."""
    q = p - mu
    a = icov @ q
    E = d1 * np.exp(-0.5 * d2 * max(q @ a, 0.0))
    ea = E * a
    M = -d2 * np.outer(ea, a) + E * icov
    Hp = se3.hat(torch.from_numpy(p)).numpy()
    he = se3.hat(torch.from_numpy(ea)).numpy()
    Hvw = -M @ Hp + 0.5 * he
    Hww = -Hp @ M @ Hp + 0.5 * (np.outer(ea, p) + np.outer(p, ea)) - (ea @ p) * np.eye(3)
    H = np.block([[M, Hvw], [Hvw.T, Hww]])
    return -d2 * np.concatenate([ea, np.cross(p, ea)]), -d2 * H, E


def test_pair_decomposition_sums_to_score_derivatives():
    """The sum over found pairs of valid points of each pair's own terms is
    score_derivatives' g, H and score (float64, rtol 1e-9): the pair grid
    computes the same function as the per-point moments."""
    rng = np.random.default_rng(11)
    N, K = 60, 7
    moved0 = rng.normal(size=(N, 3)) * 4.0
    means = moved0[:, None, :] + rng.normal(size=(N, K, 3)) * 0.6
    A = rng.normal(size=(N, K, 3, 3)) * 0.4
    icovs = A @ np.swapaxes(A, -1, -2) + 0.3 * np.eye(3)
    mask = rng.random(N) < 0.85
    found = rng.random((N, K)) < 0.6
    d1, d2 = -1.3, 0.7
    g, H, s = np.zeros(6), np.zeros((6, 6)), 0.0
    for i, k in zip(*np.nonzero(found & mask[:, None])):
        dg, dH, ds = pair_terms(d1, d2, moved0[i], means[i, k], icovs[i, k])
        g, H, s = g + dg, H + dH, s + ds
    g_ref, H_ref, s_ref = ndt.score_derivatives(d1, d2, *map(torch.from_numpy, (moved0, mask, means, icovs, found)))
    np.testing.assert_allclose(g, g_ref.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(H, H_ref.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(s, float(s_ref), rtol=1e-9)
    np.testing.assert_allclose(H, H.T, rtol=1e-12, atol=1e-12)


def test_kernel_input_checks():
    """What the reduction kernels do not take raises before a launch."""
    xyz = torch.zeros(2, 16, 3)
    idx, found = torch.zeros(2, 16, 7, dtype=torch.int32), torch.zeros(2, 16, 7, dtype=torch.bool)
    rows = torch.zeros(5, 12)
    ndt._check_cells("t", xyz, idx, found, rows, trials=ndt.MAX_TRIALS)
    bad = [(idx.long(), found, rows, 1, "idx must be"), (idx[:1], found[:1], rows, 1, "idx must be"),
           (idx, found.int(), rows, 1, "found must be"), (idx, found[:, :, :6], rows, 1, "found must be"),
           (idx, found.to("meta"), rows, 1, "association on"), (idx, found, rows.to("meta"), 1, "cells on"),
           (idx, found, rows.double(), 1, "cell rows must be"), (idx, found, rows[:, :9], 1, "cell rows must be"),
           (idx, found, torch.zeros(12, 5).T, 1, "cell rows must be"),
           (torch.zeros(2, 16, 9, dtype=torch.int32), torch.zeros(2, 16, 9, dtype=torch.bool), rows, 1, "K = 9"),
           (idx, found, rows, ndt.MAX_TRIALS + 1, "trial poses"), (idx, found, rows, 0, "trial poses")]
    for i, f, r, trials, msg in bad:
        with pytest.raises(ValueError, match=msg):
            ndt._check_cells("t", xyz, i, f, r, trials=trials)


def test_workspace_is_kept_per_stream_and_grows():
    """One (tickets, partial) pair per (device, stream): zeroed tickets made
    once, reused while large enough, replaced to grow."""
    x = torch.zeros(1, 3)
    ndt._workspaces.clear()
    try:
        t1, p1 = ndt._workspace(x, 7, 3, 100)
        assert t1.dtype == torch.int32 and int(t1.abs().sum()) == 0 and t1.numel() >= 3 and p1.numel() >= 100
        t2, p2 = ndt._workspace(x, 7, 2, 50)
        assert t2 is t1 and p2 is p1
        t3, p3 = ndt._workspace(x, 7, 1000, p1.numel() + 1)
        assert t3.numel() >= 1000 and p3.numel() > p1.numel()
        assert ndt._workspace(x, 8, 1, 1)[0] is not t3  # another stream, its own
    finally:
        ndt._workspaces.clear()


def test_cpu_trial_scores_take_any_number_of_trials():
    """The trial cap is the kernel's: on the CPU the plain twin scores
    MAX_TRIALS + 1 poses, the first equal to a one-trial call."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-10, 10, (800, 3)).astype(np.float32)
    from hdl_graph_slam_tpu_torch.core import cloud

    tgt = ndt.preprocess_target(cloud.from_numpy(pts, capacity=1024, device="cpu"), 2.0, max_voxels=512, grid_size=16)
    xyz = torch.from_numpy(pts[:300] + rng.normal(0, 0.05, (300, 3)).astype(np.float32))[None]
    mask = torch.ones(1, 300, dtype=torch.bool)
    T = torch.eye(4)[None]
    idx, found = ndt.associate(tgt, xyz, mask, T)
    twists = torch.from_numpy(rng.normal(0, 0.02, (ndt.MAX_TRIALS + 1, 6)).astype(np.float32))
    Ts = se3.se3_exp(twists)[None]
    many = ndt.trial_scores(tgt, xyz, mask, Ts, idx, found)
    assert many.shape == (1, ndt.MAX_TRIALS + 1)
    assert torch.equal(ndt.trial_scores(tgt, xyz, mask, Ts[:, :1], idx, found), many[:, :1])
