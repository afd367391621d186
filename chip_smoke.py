#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hdl_graph_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed as one JSON line; any failure raises and exits non-zero
before the last line:

1. env     GPU name and power limit (nvidia-smi), torch and CUDA versions;
           TF32 must be off.
2. build   nvcc builds the kernels of hdl_graph_slam_tpu_torch/csrc/.
3. kernels At 8192 x 8192, on a prefiltered course scan pair and on uniform
           random clouds with padded rows, each kernel is held against its
           plain PyTorch version on the card and checked row by row in
           float64 (no chosen neighbour farther than the true ones beyond
           the expanded form's rounding); both are timed with CUDA events
           (kernel_ms: time per call, the host's launch overhead included;
           device_ms: device work alone; host_ms: the host's time to issue
           one call), and each kernel's launch plan and occupancy are
           printed. The GPU prefilter is held against the CPU one.
   kernel_edges  the same gates on shapes and data the main path does not
           reach: one query, m = k, a cloud larger than one shared-memory
           stage, a cloud with 25 valid rows, and an integer lattice with
           duplicated points, where ties are exact and the kernels must
           match their plain twins index for index.
4. main    bench.py's windowed FAST_GICP odometry (its configs, its course
           with seed 0, 16384-row raw scans, 8192-row filtered clouds) through
           the port's OdometryWindow on cuda, with bench.py's gates; kernel
           launch counts are read around this run.
   With --profile, torch.profiler then traces 16 more frames: device busy
   time, kernels launched per frame, the top kernels by device time and the
   port's own kernels' device time per launch, and
   the device idle share twice: over the profiled wall time (which the
   profiler inflates) and over the unprofiled main run's wall time per
   frame.
5. golden_course  benchmarks/golden_town.py's 601 ray-cast town scans, cast
           in a process pool (the script's, not the package's).
6. kernel_batched  the batched kernels (nn1_batched, knn_select_batched) at
           the loop shapes: B = 8 distinct 4096-row keyframe clouds of that
           course, and the same with ragged valid counts, against their plain
           twins with the float64 row check on every row; B = 1 must equal
           the unbatched entry point bit for bit. Also nn1 at the loop
           association shape (8 x 4096 queries flattened against one 4096-row
           target). Timed as the kernel phase.
   kernel_filters  radius_count against its plain twin and float64 counts
           (every row equal but rows holding a pair within the expanded
           form's rounding of r^2; on the integer lattice every row, bit for
           bit) on a golden keyframe cloud (r = 0.8 m), a bench cloud, a
           16384-row cloud scanned in two shared-memory stages and the
           kernel_edges shapes; knn_select at k = 10 and 21 through the
           kernel phase's check; the statistical and radius outlier masks,
           card against CPU. Timed as the kernel phase.
   floor   FloorDetector on the 8 keyframe clouds: the card's clipped cloud
           against the CPU's, RANSAC card against CPU through
           fit_plane_from_triplets with the same triplets (the same inlier
           count, coefficients within 1e-5), each floor within 1 degree of
           vertical and 0.05 m of the 1.8 m sensor height.
7. graph   the port's dense LM pose-graph optimize on a golden-sized
           synthetic graph (94 poses, 2 laps, 12 loop edges) in float64 on
           the card against the same code on the CPU; ms per iteration on
           both and the device operations per iteration (profiled).
8. slam    golden_town "base" through SlamPipeline.run_windowed on the
           card: all 601 frames, keyframes, loop edges, ATE (optimized and
           odometry keyframes, Umeyama-aligned as golden_town.py:179-180),
           det/orth error, fps, the host wall of the odometry windows, the
           optimize cycles and, within them, loop detection, information
           matrices and the graph solve (the script wraps those methods), the
           host syncs per optimize cycle, kernel launches on the path and the
           peak device memory. Gates: det/orth < 1e-4 on every odometry pose,
           >= 2 loop edges, optimized ATE below the odometry keyframes' ATE.
           Then slam_profile: torch.profiler over one odometry stretch (48
           frames of a fresh pipeline), one batched loop match and one graph
           solve of the finished run: device busy time and idle share of each.
9. slam_floor  golden_town "floor" through run_windowed, the slam gates plus
           floor edges >= 0.9 x keyframes; floor detection's host ms per call.
10. host   golden_town_outdoor_config() (floor, RADIUS prefilter) through the
           per-frame SlamPipeline.run(): ScanMatchingOdometry, the radius
           filter and floor detection on every frame, all 601 frames, the
           slam_floor gates plus one radius_count launch per frame at least;
           host syncs per frame and the device idle share over 16 traced
           frames of a fresh pipeline. Then the STATISTICAL prefilter's path:
           run(device_odometry=True) over 48 frames against run_windowed,
           odometry within 1e-4.
11. The kernels line (every kernel entry point), the card's name and power
   limit, then the last line {"ok": true, "device": {...}}.

Phases run in that order, every one on the card.

Without a GPU, or without the package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
import warnings
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_KERNEL = 8192  # kernel-phase shape: the main path's out_capacity
K_NEIGHBOURS = 20
SEED = 0  # course and uniform-cloud seed (bench.py's first course seed)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (hopper-kernels guide)
FP32_LANES_PER_SM = 128  # Hopper fp32 FMA lanes per SM; one FMA = 2 flops
# ops per (query, target) pair: 3 FMAs (6 flops) + compare and select (2)
OPS_PER_PAIR = 8
# GPU vs CPU voxel centroids: index_add_ sums each voxel with atomics on the
# GPU, in another order than the CPU's sequential sum; a float32 sum of n
# points of <= 100 m coordinates differs by at most ~n/2 ulp(100 n) / n,
# under 1e-3 m for the voxel populations of a 0.2 m grid.
CENTROID_ATOL_M = 1e-3
# nn1 kernel vs plain: the kernel ranks by an FMA chain, the plain version by
# a cuBLAS fp32 product; rounding can swap exact near-ties (the same bar as
# tests/test_ops.py TestPallasNN).
NN1_MIN_AGREEMENT = 0.999
NN1_DIST_RTOL = 1e-4
# knn_select kernel vs plain: the same rounding may swap the k-th and
# (k+1)-th neighbour of a row on an exact near-tie, so a few rows may hold
# another set; nearly all must agree exactly.
KNN_MIN_IDENTICAL_SETS = 0.999
# Row validity, exact in float64: a chosen neighbour may lose to an unchosen
# one by at most the expanded form's rounding. Each fp32 d = |t|^2 - 2 q.t
# carries <= 7 roundings of terms no larger than 2 S, S = |q_c|^2 + |t_c|^2
# of the two targets compared (centred), so two d's misorder only within
# ~9 eps32 S; centring adds far less.
ROW_ULPS = 10
EPS32 = float(np.finfo(np.float32).eps)
GOLDEN_B = 8  # loop candidates per batch (LoopDetectorConfig.max_candidates)
RADIUS_M = 0.8  # the outdoor preset's radius filter (core/config.py preset_outdoor)
# ops per (query, target) pair of radius_count: 3 FSUB, FMUL, 2 FFMA (4 flops),
# a compare and an add
RADIUS_OPS_PER_PAIR = 10
FLOOR_COEFF_ATOL = 1e-5  # RANSAC card vs CPU on the same triplets: float32 cross products
FLOOR_TILT_DEG = 1.0  # golden_town's ground is the plane z = 0 under a level sensor
FLOOR_HEIGHT_ATOL_M = 0.05
ODOM_PARITY_ATOL = 1e-4  # run(device_odometry=True) vs run_windowed: one device step
# graph phase, card vs CPU: the same float64 LM; the Cholesky and the sums
# round differently (cuSOLVER vs LAPACK), so accepts decided at the rounding
# floor may differ by an iteration, at poses equal far below 1e-6 m
GRAPH_POSE_ATOL = 1e-6
GRAPH_CHI2_RTOL = 1e-9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, batches: int = 5, device_only: bool = False) -> float:
    """Milliseconds per call: the median over ``batches`` of CUDA events
    around ``reps`` back-to-back calls, after warm-up. By default a call
    costs at least its host launch overhead (the time a caller sees). With
    ``device_only`` each batch is queued behind a device-side sleep longer
    than the host takes to queue it, so the events bracket device work
    only."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    sleep_cycles = 0
    if device_only:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        sleep_cycles = int(4 * (time.perf_counter() - t0) * 2.0e9) + 1_000_000  # SM cycles, clock <= 2 GHz
    per = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return float(np.median(per))


def host_ms(fn, reps: int = 200, batches: int = 5) -> float:
    """Host milliseconds to issue one call: the median over ``batches`` of
    the host clock around ``reps`` calls issued without a sync, starting
    from an idle device (the device runs behind; the launch queue holds
    them all)."""
    import torch

    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter() - t0) * 1e3 / reps)
    torch.cuda.synchronize()
    return float(np.median(per))


def _centred64(q, t):
    """Float64 query and target centred on the valid targets' bbox, and |.|^2."""
    import torch

    t64, q64 = t.double(), q.double()
    valid = (t.abs() < 1e5).all(-1)
    c = 0.5 * (t64[valid].amin(0) + t64[valid].amax(0)) if bool(valid.any()) else torch.zeros(3, dtype=t64.dtype,
                                                                                              device=t.device)
    qc, tc = q64 - c, t64 - c
    return qc, tc, (qc * qc).sum(-1), (tc * tc).sum(-1)


def rows_valid(q, t, idx, rows, chunk: int = 1024) -> tuple:
    """Exact float64 check of a selection on the card. idx (N,) for nn1 or
    (N,k): per row, the largest chosen exact squared distance must not exceed
    the smallest unchosen one (the true minimum for nn1) by more than
    ROW_ULPS eps32 S_row, S_row = |q_c|^2 + the larger |t_c|^2 of the two
    targets compared, and a (N,k) row must name k distinct targets (a
    target chosen twice would hide the k-th neighbour it displaced).
    Returns (fraction of ``rows`` valid, max excess in units of eps32 S_row;
    <= 0 means no chosen neighbour loses at all)."""
    import torch

    qc, tc, qn, tn = _centred64(q, t)
    idx = idx.long().reshape(idx.shape[0], -1)
    nn1 = idx.shape[1] == 1
    ok, excess = [], []
    for s in range(0, q.shape[0], chunk):
        sl = slice(s, s + chunk)
        e = qn[sl, None] + tn[None, :] - 2.0 * (qc[sl] @ tc.T)  # float64: off by ~1e-16 (|q_c|^2 + |t_c|^2)
        ii = idx[sl]
        chosen = e.gather(1, ii)
        cmax, carg = chosen.max(1)
        other = e if nn1 else e.scatter(1, ii, float("inf"))
        omin, oarg = other.min(1)
        t_big = torch.maximum(tn[ii.gather(1, carg[:, None])[:, 0]], tn[oarg])
        scale = EPS32 * (qn[sl] + t_big)
        x = torch.where(torch.isfinite(omin), (cmax - omin) / scale, -torch.inf)
        s = ii.sort(1).values
        ok.append((x <= ROW_ULPS) & (s[:, 1:] > s[:, :-1]).all(1))
        excess.append(x)
    ok, excess = torch.cat(ok)[rows], torch.cat(excess)[rows]
    return int(ok.sum()) / ok.numel(), float(excess.max())


def check_nn1(knn, q, t, rows, what: str) -> dict:
    """nn1 kernel vs its plain twin and the exact check; raises on a failed gate."""
    import torch

    i_k, d_k = knn.nn1(q, t)
    i_p, d_p = knn.nn1_plain(q, t)
    torch.cuda.synchronize()
    # dist2 of the same target; rows where the two chose another target of
    # (nearly) equal distance are judged by rows_valid
    same = (i_k == i_p) & rows
    rel = ((d_k - d_p).abs() / d_p.abs().clamp(min=1e-6))[same]
    valid, excess = rows_valid(q, t, i_k, rows)
    row = dict(kernel="nn1", case=what, n=q.shape[0], m=t.shape[0],
               idx_agreement=int(same.sum()) / int(rows.sum()), idx_identical=bool(torch.equal(i_k, i_p)),
               dist2_max_rel_err=float(rel.max()), max_abs_err=float((d_k - d_p)[rows].abs().max()),
               rows_valid=valid, max_excess_eps_s=excess)
    require(row["idx_agreement"] > NN1_MIN_AGREEMENT, f"nn1 {what}: idx agreement {row['idx_agreement']}")
    require(row["dist2_max_rel_err"] <= NN1_DIST_RTOL, f"nn1 {what}: dist2 rel err {row['dist2_max_rel_err']}")
    require(valid == 1.0, f"nn1 {what}: {1 - valid} of rows choose a farther target than the bound allows")
    return row


def check_knn(knn, q, t, rows, what: str, k: int = K_NEIGHBOURS, near_ties: bool = False) -> dict:
    """knn_select kernel vs its plain twin and the exact check. Where the
    data hold many near-ties at the k-th neighbour (voxel grids of a flat
    floor: ``near_ties``), the share of identical sets is reported but not
    gated; instead, on every row whose sets differ the plain twin's set must
    pass the same float64 check as the kernel's. Two sets of k distinct
    targets that both pass it differ only by neighbours whose float64
    distances tie within the bound: each is chosen by one side and left by
    the other."""
    import torch

    i_k, d_k = knn.knn_select(q, t, k)
    i_p, d_p = knn.knn_select_plain(q, t, k)
    torch.cuda.synchronize()
    same_all = (i_k.sort(1).values == i_p.sort(1).values).all(1)
    same = same_all[rows]
    valid, excess = rows_valid(q, t, i_k, rows)
    row = dict(kernel="knn_select", case=what, n=q.shape[0], m=t.shape[0], k=k,
               rows_identical_sets=int(same.sum()) / same.numel(), idx_identical=bool(torch.equal(i_k, i_p)),
               max_abs_err=float((d_k - d_p)[rows].abs().max()), rows_valid=valid, max_excess_eps_s=excess,
               sorted_ascending=bool((d_k[:, 1:] >= d_k[:, :-1]).all()))
    if near_ties:
        differ = rows & ~same_all
        row["plain_rows_valid_where_sets_differ"] = rows_valid(q, t, i_p, differ)[0] if bool(differ.any()) else 1.0
        require(row["plain_rows_valid_where_sets_differ"] == 1.0,
                f"knn_select {what}: sets differ from the plain twin's beyond near-ties: {row}")
    else:
        require(row["rows_identical_sets"] >= KNN_MIN_IDENTICAL_SETS,
                f"knn_select {what}: identical sets on only {row['rows_identical_sets']} of rows: {row}")
    require(valid == 1.0, f"knn_select {what}: {1 - valid} of rows hold a farther neighbour than the bound allows")
    require(row["sorted_ascending"], f"knn_select {what}: output not sorted")
    return row


def bench_configs() -> tuple:
    """bench.py:142-151: the main path's prefilter and odometry configs."""
    from hdl_graph_slam_tpu_torch.core.config import OdometryConfig, PrefilterConfig, RegistrationConfig

    pf_cfg = PrefilterConfig(downsample_resolution=0.2, outlier_removal_method="NONE")
    odo_cfg = OdometryConfig(keyframe_delta_trans=2.0, keyframe_delta_time=1e9,
                             registration=RegistrationConfig(reg_reassoc_displacement=0.1))
    return pf_cfg, odo_cfg


def main_path(scans) -> tuple:
    """The main path as bench.py drives it, on cuda: an OdometryWindow that
    filters to N_KERNEL rows, the first scan's cloud for its initial state,
    and the other scans stacked at the raw capacity with 0.1 s stamps.
    Returns (win, first, xyz, mask, stamps)."""
    import torch
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.frontend import OdometryWindow
    from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_RAW_CAPACITY

    pf_cfg, odo_cfg = bench_configs()
    win = OdometryWindow(odo_cfg, prefilter_cfg=pf_cfg, out_capacity=N_KERNEL, device="cuda")
    xyz, mask = stack_scans(scans[1:], capacity=BENCH_RAW_CAPACITY)
    stamps = (0.1 * np.arange(1, len(scans))).astype(np.float32)
    first = cloudlib.from_numpy(scans[0], capacity=BENCH_RAW_CAPACITY, device="cuda")
    return win, first, *(torch.from_numpy(a).to("cuda") for a in (xyz, mask, stamps))


def drive_window(win, first, xyz, mask, stamps) -> tuple:
    """Initialise the window's state from ``first`` and run it over the
    frames; the host clock runs from the start of the run to the poses'
    copy to the host. Returns (state0, poses as numpy, status, seconds)."""
    import torch

    state0 = win.init_state(0.0, first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, odoms, status = win.run(state0, xyz, mask, stamps)
    odoms = odoms.cpu().numpy()
    return state0, odoms, status, time.perf_counter() - t0


def profile_frames(win, state0, xyz, mask, stamps, n: int, main_s_per_frame: float) -> dict:
    """Trace ``n`` window frames: wall time, device busy time (union of the
    device intervals), kernels per frame and the top kernels by device time.
    The idle share is given over the profiled wall time and over
    ``main_s_per_frame``, the unprofiled main run's wall time per frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        win.run(state0, xyz[:n], mask[:n], stamps[:n])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    def dev_us(k):
        return getattr(k, "self_device_time_total", None) or getattr(k, "self_cuda_time_total", 0.0)
    averages = [k for k in prof.key_averages() if dev_us(k) > 0]
    top = sorted(averages, key=dev_us, reverse=True)[:12]
    port = [k for k in averages if "nn1_kernel" in k.key or "knn_select_kernel" in k.key]
    return dict(phase="profile", frames=n, wall_s=wall, device_busy_s=busy * 1e-6,
                device_busy_ms_per_frame=busy * 1e-3 / n,
                device_idle_share_profiled=1.0 - busy * 1e-6 / wall,
                device_idle_share_unprofiled=1.0 - busy * 1e-6 / n / main_s_per_frame,
                device_ops_per_frame=len(spans) / n,
                top_device=[dict(name=k.key[:80], calls=k.count, total_ms=dev_us(k) * 1e-3,
                                 mean_us=dev_us(k) / max(k.count, 1)) for k in top],
                port_kernels=[dict(name=k.key[:80], calls=k.count, total_ms=dev_us(k) * 1e-3,
                                   mean_us=dev_us(k) / max(k.count, 1)) for k in port])


# -- golden_town -----------------------------------------------------------------

_SCENE = None


def _golden_scan(i: int) -> np.ndarray:
    """Ray-cast golden_town frame i (a process-pool worker)."""
    global _SCENE
    if _SCENE is None:
        sys.path.insert(0, HERE)
        from hdl_graph_slam_tpu_torch.utils import course, lidar_sim

        _SCENE = (*course.golden_town_scene(), course.golden_town_sensor_poses(), lidar_sim)
    town, model, poses, lidar_sim = _SCENE
    return lidar_sim.scan(town, poses[i], model, seed=i)


def golden_scans(n: int, workers: int) -> list:
    """The n golden_town scans, cast in ``workers`` spawned processes."""
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_golden_scan, range(n), chunksize=8))


def check_batched(knn, kind: str, q, t, rows, what: str) -> dict:
    """A batched kernel against its plain twin: the plain twin's gates of
    check_nn1 / check_knn over the whole batch, and the float64 row check on
    every row of every problem."""
    import torch

    if kind == "nn1":
        (i_k, d_k), (i_p, d_p) = knn.nn1_batched(q, t), knn.nn1_batched_plain(q, t)
    else:
        (i_k, d_k), (i_p, d_p) = knn.knn_select_batched(q, t, K_NEIGHBOURS), knn.knn_select_batched_plain(
            q, t, K_NEIGHBOURS)
    torch.cuda.synchronize()
    valid, excess = [], []
    for b in range(q.shape[0]):
        v, e = rows_valid(q[b], t[b], i_k[b], rows[b])
        valid.append(v)
        excess.append(e)
    row = dict(kernel=f"{kind}_batched", case=what, batch=q.shape[0], n=q.shape[1], m=t.shape[1],
               valid_rows=[int(r.sum()) for r in rows], idx_identical=bool(torch.equal(i_k, i_p)),
               max_abs_err=float((d_k - d_p)[rows].abs().max()), rows_valid=min(valid), max_excess_eps_s=max(excess))
    if kind == "nn1":
        same = (i_k == i_p) & rows
        row["idx_agreement"] = int(same.sum()) / int(rows.sum())
        row["dist2_max_rel_err"] = float(((d_k - d_p).abs() / d_p.abs().clamp(min=1e-6))[same].max())
        require(row["idx_agreement"] > NN1_MIN_AGREEMENT, f"nn1_batched {what}: idx agreement {row['idx_agreement']}")
        require(row["dist2_max_rel_err"] <= NN1_DIST_RTOL, f"nn1_batched {what}: dist2 {row['dist2_max_rel_err']}")
    else:
        same = (i_k.sort(-1).values == i_p.sort(-1).values).all(-1)[rows]
        row["rows_identical_sets"] = int(same.sum()) / same.numel()
        row["sorted_ascending"] = bool((d_k[..., 1:] >= d_k[..., :-1]).all())
        require(row["rows_identical_sets"] >= KNN_MIN_IDENTICAL_SETS,
                f"knn_select_batched {what}: identical sets on {row['rows_identical_sets']} of rows")
        require(row["sorted_ascending"], f"knn_select_batched {what}: output not sorted")
    require(min(valid) == 1.0, f"{kind}_batched {what}: a row holds a farther neighbour than the bound allows")
    return row


def synthetic_graph(seed: int = 0):
    """A golden_town-sized pose graph (port GraphBuilder): an anchor, 94
    poses on two laps of a 35 m circle with noisy odometry edges
    (information 100), 12 lap-2 -> lap-1 loop edges (information 400,
    Huber), numpy noise from ``seed``."""
    from hdl_graph_slam_tpu_torch.graph import GraphBuilder

    rng = np.random.default_rng(seed)
    n, per_lap = 94, 47

    def pose(k):
        a = 2.0 * np.pi * k / per_lap
        T = np.eye(4)
        T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[:3, 3] = [35.0 * np.cos(a), 35.0 * np.sin(a), 0.0]
        return T

    def noise(t_sd, r_sd):
        w = rng.normal(0.0, r_sd, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + (np.sin(th) / max(th, 1e-12)) * K + ((1 - np.cos(th)) / max(th * th, 1e-24)) * K @ K
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.normal(0.0, t_sd, 3)
        return T

    g = GraphBuilder()
    anchor = g.add_se3_node(np.eye(4), fixed=True)
    ids, est = [], pose(0)
    for k in range(n):
        if k:
            rel = np.linalg.inv(pose(k - 1)) @ pose(k) @ noise(0.05, 0.005)
            est = est @ rel
        ids.append(g.add_se3_node(est))
        if k:
            g.add_se3_edge(ids[k], ids[k - 1], np.linalg.inv(rel), np.eye(6) * 100.0)
    g.add_se3_edge(anchor, ids[0], np.linalg.inv(pose(0)), np.diag([0.1, 0.1, 0.001, 1, 1, 1]))
    for k in rng.choice(np.arange(per_lap + 2, n), 12, replace=False):
        rel = np.linalg.inv(pose(k)) @ pose(k - per_lap) @ noise(0.02, 0.002)
        g.add_se3_edge(ids[k], ids[k - per_lap], rel, np.eye(6) * 400.0, kernel="Huber", kernel_delta=1.0)
    return g


def device_busy(prof, names=None) -> tuple:
    """(device busy seconds, wall seconds) of a torch.profiler run, or of the
    parts of it inside the user annotations called ``names``: the union of
    the device intervals, against the union of those ranges (or the whole
    trace)."""
    from torch.autograd import DeviceType

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    events = list(prof.events())
    # device work only: the profiler also mirrors each user annotation
    # (record_function) onto the device timeline as one span over its kernels
    dev = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("slam/")]
    if names is None:
        lo = min(e.time_range.start for e in events)
        hi = max(e.time_range.end for e in events)
        windows = [[lo, hi]]
    else:
        windows = union([(e.time_range.start, e.time_range.end) for e in events
                         if e.name in names and e.device_type == DeviceType.CPU])
    busy = 0.0
    dev_u = union(dev)
    for a, b in windows:
        for c, d in dev_u:
            busy += max(0.0, min(b, d) - max(a, c))
    wall = sum(b - a for a, b in windows)
    return busy * 1e-6, wall * 1e-6


def top_device(prof, n: int) -> list:
    """The n operations with the most device time in a profile."""
    def dev_us(k):
        return getattr(k, "self_device_time_total", None) or getattr(k, "self_cuda_time_total", 0.0)

    averages = sorted((k for k in prof.key_averages() if dev_us(k) > 0 and not k.key.startswith("slam/")),
                      key=dev_us, reverse=True)[:n]
    return [dict(name=k.key[:80], calls=k.count, total_ms=dev_us(k) * 1e-3) for k in averages]


class StageClock:
    """Host wall time of wrapped methods (the script's instrumentation: the
    package has none), kept in a utils.metrics.StageTimer. A wrapper marks
    its span for the profiler, optionally synchronises the card at its end,
    and optionally counts the host syncs made inside it (torch.cuda sync
    debug mode)."""

    def __init__(self):
        from hdl_graph_slam_tpu_torch.utils.metrics import StageTimer

        self.timer = StageTimer()
        self.syncs = []
        self.results = defaultdict(list)  # key -> return values kept by keep_result wrappers
        self._undo = []

    def wrap(self, owner, attr: str, key: str, sync: bool = False, count_syncs: bool = False,
             keep_result: bool = False):
        import torch

        orig = getattr(owner, attr)
        clock = self

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(f"slam/{key}"), clock.timer.span(key):
                if count_syncs:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        torch.cuda.set_sync_debug_mode("warn")
                        try:
                            out = orig(*args, **kwargs)
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                    clock.syncs.append(sum("synchroniz" in str(w.message) for w in caught))
                else:
                    out = orig(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                if keep_result:
                    clock.results[key].append(out)
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []


def slam_stages(clock: StageClock, count_syncs: bool) -> None:
    from hdl_graph_slam_tpu_torch.backend import information_matrix, loop_detector
    from hdl_graph_slam_tpu_torch.backend import slam as slam_mod
    from hdl_graph_slam_tpu_torch.frontend import FloorDetector, Prefilter, ScanMatchingOdometry, window

    clock.wrap(window.OdometryWindow, "run_with_clouds", "odometry_window", sync=True)
    clock.wrap(Prefilter, "__call__", "prefilter", sync=True)
    clock.wrap(ScanMatchingOdometry, "step", "odometry_frame", sync=True)
    clock.wrap(FloorDetector, "detect", "floor_detect", sync=True)
    clock.wrap(slam_mod.HdlGraphSlam, "optimize_cycle", "optimize_cycle", sync=True, count_syncs=count_syncs)
    clock.wrap(loop_detector.LoopDetector, "detect", "loop_detection")
    clock.wrap(information_matrix.InformationMatrixCalculator, "calc_information_matrices_batched",
               "information_matrices")
    clock.wrap(slam_mod, "graph_optimize", "graph_solve", keep_result=True)


def golden_course_phase() -> dict:
    """Cast golden_town's 601 scans in a process pool; the sensor poses
    (truth) and the config come from utils/course.py."""
    from hdl_graph_slam_tpu_torch.utils import course

    truth = course.golden_town_sensor_poses()
    workers = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    scans = golden_scans(len(truth), workers)
    emit(dict(phase="golden_course", frames=len(scans), workers=workers, seconds=time.perf_counter() - t0,
              raw_points_mean=float(np.mean([x.shape[0] for x in scans]))))
    return dict(scans=scans, truth=truth, cfg=course.golden_town_config())


def golden_keyframes(golden) -> tuple:
    """GOLDEN_B golden_town frames spread over the course (0 to 597) and the
    frames 3 after them, prefiltered on the card as the slam phase does:
    (frame indices, their clouds, the later frames' clouds)."""
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.frontend import Prefilter
    from hdl_graph_slam_tpu_torch.utils import course

    pf = Prefilter(golden["cfg"].prefilter, out_capacity=course.GOLDEN_CLOUD_CAPACITY, device="cuda")
    frames = np.linspace(0, len(golden["scans"]) - 4, GOLDEN_B).round().astype(int)

    def cloud(i):
        return pf(cloudlib.from_numpy(golden["scans"][i], capacity=course.GOLDEN_RAW_CAPACITY, device="cuda"))

    return frames, [cloud(i) for i in frames], [cloud(i + 3) for i in frames]


def kernel_batched_phase(knn, golden, keyframes) -> dict:
    """The batched kernels at the loop shapes against their plain twins."""
    import torch
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib

    frames, tgts, srcs = keyframes
    truth = golden["truth"]
    # information-matrix shape: keyframe i+3 moved into keyframe i's frame
    rel = torch.from_numpy(np.stack([np.linalg.inv(truth[i]) @ truth[i + 3] for i in frames])).float().to("cuda")
    t = torch.stack([c.valid_xyz() for c in tgts])
    smask = torch.stack([c.mask for c in srcs])
    q = torch.stack([c.xyz for c in srcs]) @ rel[:, :3, :3].transpose(-1, -2) + rel[:, None, :3, 3]
    q = torch.where(smask[..., None], q, cloudlib.PAD_COORD)
    tmask = torch.stack([c.mask for c in tgts])
    # ragged: problem b keeps only its first 4096 - 400 b rows valid
    keep = torch.arange(t.shape[1], device=t.device)[None, :] < (t.shape[1] - 400 * torch.arange(GOLDEN_B, device=t.device))[:, None]
    cases = {
        "keyframes": (q, t, smask, tmask),
        "ragged": (torch.where(keep[..., None], q, cloudlib.PAD_COORD), torch.where(keep[..., None], t, cloudlib.PAD_COORD),
                   smask & keep, tmask & keep),
    }
    out = {}
    for case, (qq, tt, qrows, trows) in cases.items():
        for kind in ("nn1", "knn_select"):
            qk, rows = (qq, qrows) if kind == "nn1" else (tt, trows)
            row = dict(phase="kernel_batched", **check_batched(knn, kind, qk, tt, rows, case))
            if kind == "nn1":
                fn, plain = (lambda: knn.nn1_batched(qk, tt)), (lambda: knn.nn1_batched_plain(qk, tt))
            else:
                fn = lambda: knn.knn_select_batched(qk, tt, K_NEIGHBOURS)
                plain = lambda: knn.knn_select_batched_plain(qk, tt, K_NEIGHBOURS)
            row["valid_pairs"] = int(sum(int(r.sum()) * int(tr.sum()) for r, tr in zip(rows, trows)))
            if case == "keyframes":
                # B = 1 is the unbatched entry point, bit for bit
                one = knn.nn1_batched(qk[:1], tt[:1]) if kind == "nn1" else knn.knn_select_batched(qk[:1], tt[:1], K_NEIGHBOURS)
                ref = knn.nn1(qk[0], tt[0]) if kind == "nn1" else knn.knn_select(qk[0], tt[0], K_NEIGHBOURS)
                row["b1_identical"] = bool(torch.equal(one[0][0], ref[0]) and torch.equal(one[1][0], ref[1]))
                require(row["b1_identical"], f"{kind}_batched B=1 differs from the unbatched entry point")
                row["kernel_ms"] = time_ms(fn)
                row["device_ms"] = time_ms(fn, device_only=True)
                row["host_ms"] = host_ms(fn)
                row["plain_ms"] = time_ms(plain, reps=2, batches=3)
                row["launch"] = knn.launch_info(kind, qk.shape[1], tt.shape[1], batch=qk.shape[0])
            emit(row)
            out[(kind, case)] = row

    # loop association: the candidates' points flattened against one target
    qa, ta = q.reshape(-1, 3).contiguous(), t[0].contiguous()
    row = dict(phase="kernel_batched", **check_nn1(knn, qa, ta, smask.reshape(-1), "loop_association"))
    row["kernel_ms"] = time_ms(lambda: knn.nn1(qa, ta))
    row["device_ms"] = time_ms(lambda: knn.nn1(qa, ta), device_only=True)
    row["launch"] = knn.launch_info("nn1", qa.shape[0], ta.shape[0])
    emit(row)
    return out


def graph_phase() -> None:
    """The port's optimize on the card against the same code on the CPU."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hdl_graph_slam_tpu_torch.graph import optimize

    g = synthetic_graph(0)
    # device operations per LM iteration: a 2-iteration solve minus a
    # 1-iteration one (these solves also warm both paths up before timing)
    ops = []
    for its in (1, 2):
        data = g.freeze(dtype=torch.float64, device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            optimize(data, max_iterations=its)
            torch.cuda.synchronize()
        ops.append(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA))
    optimize(g.freeze(dtype=torch.float64, device="cpu"), max_iterations=1)
    res = {}
    for dev in ("cuda", "cpu"):
        data = g.freeze(dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        out, st = optimize(data, max_iterations=60)
        poses = out.poses.cpu().numpy()
        res[dev] = (poses, st, time.perf_counter() - t0)
    (pc, sc, tc), (pp, sp, tp) = res["cuda"], res["cpu"]
    row = dict(phase="graph", poses=len(g.poses), edges=g.num_edges, dof=int(6 * pc.shape[0]),
               iterations_cuda=int(sc.iterations), iterations_cpu=int(sp.iterations),
               chi2_before=float(sc.chi2_robust_before), chi2_after_cuda=float(sc.chi2_robust_after),
               chi2_after_cpu=float(sp.chi2_robust_after), pose_max_abs_err=float(np.abs(pc - pp).max()),
               seconds_cuda=tc, seconds_cpu=tp, ms_per_iteration_cuda=1e3 * tc / max(int(sc.iterations), 1),
               ms_per_iteration_cpu=1e3 * tp / max(int(sp.iterations), 1), device_ops_per_iteration=ops[1] - ops[0],
               pose_atol=GRAPH_POSE_ATOL, chi2_rtol=GRAPH_CHI2_RTOL)
    emit(row)
    require(row["pose_max_abs_err"] <= GRAPH_POSE_ATOL, f"graph: card vs CPU poses differ by {row['pose_max_abs_err']}")
    require(abs(row["chi2_after_cuda"] - row["chi2_after_cpu"]) <= GRAPH_CHI2_RTOL * abs(row["chi2_after_cpu"]),
            "graph: card vs CPU chi2 differ")
    require(row["chi2_after_cuda"] < row["chi2_before"], "graph: the solve did not lower chi2")


def slam_profile(pipe, frames) -> None:
    """Device busy time and idle share of the slam path's stages, each
    traced on its own with torch.profiler: 48 frames of a fresh pipeline
    (odometry windows and their optimize cycles), one batched loop match of
    the finished run (its last keyframe against its candidates) and one
    graph solve of the finished graph."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hdl_graph_slam_tpu_torch.backend import slam as slam_mod
    from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline
    from hdl_graph_slam_tpu_torch.utils import course

    slam = pipe.slam
    out = dict(phase="slam_profile")

    clock = StageClock()
    slam_stages(clock, count_syncs=False)
    try:
        fresh = SlamPipeline(pipe.cfg, cloud_capacity=course.GOLDEN_CLOUD_CAPACITY, device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fresh.run_windowed(frames[:48], window=course.GOLDEN_WINDOW, raw_capacity=course.GOLDEN_RAW_CAPACITY)
            torch.cuda.synchronize()
    finally:
        clock.restore()
    busy, wall = device_busy(prof)
    out["first_48_frames"] = dict(device_busy_s=busy, wall_s=wall, device_idle_share=1.0 - busy / wall,
                                  top_device=top_device(prof, 10))
    for key in ("odometry_window", "optimize_cycle", "graph_solve"):
        b, w = device_busy(prof, {f"slam/{key}"})
        out["first_48_frames"][key] = dict(device_busy_s=b, wall_s=w, device_idle_share=(1.0 - b / w) if w else None)

    det = slam.loop_detector
    estimates = slam._current_estimates()
    last = slam.keyframes[-1]
    det.last_edge_accum_distance = 0.0  # lift the min_edge_interval gate for this one match
    cand = det.find_candidates(slam.keyframes, last, estimates)
    if cand:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            det._match(slam.keyframes, cand, last, estimates)
            torch.cuda.synchronize()
        busy, wall = device_busy(prof)
        out["loop_match"] = dict(candidates=len(cand), device_busy_s=busy, wall_s=wall,
                                 device_idle_share=1.0 - busy / wall)
    data = slam.graph.freeze(dtype=torch.float64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, st = slam_mod.graph_optimize(data, max_iterations=pipe.cfg.backend.g2o_solver_num_iterations)
        torch.cuda.synchronize()
    busy, wall = device_busy(prof)
    out["graph_solve"] = dict(iterations=int(st.iterations), dof=data.num_dof, device_busy_s=busy, wall_s=wall,
                              device_idle_share=1.0 - busy / wall)
    emit(out)


def exact_radius_counts(q, t, r: float, chunk: int = 1024) -> tuple:
    """Float64 counts of targets with |q - t|^2 below float32(r^2), the
    radius the kernel compares against, and per row whether a pair lies
    within 10 eps32 (|q_c|^2 + |t_c|^2) of it (centred as rows_valid), where
    float32 rounding may decide either way."""
    import torch

    qc, tc, qn, tn = _centred64(q, t)
    r2 = float(np.float32(r * r))
    counts, near = [], []
    for s in range(0, q.shape[0], chunk):
        sl = slice(s, s + chunk)
        d2 = ((qc[sl, None, :] - tc[None, :, :]) ** 2).sum(-1)
        counts.append((d2 < r2).sum(-1))
        near.append(((d2 - r2).abs() <= ROW_ULPS * EPS32 * (qn[sl, None] + tn[None, :])).any(-1))
    return torch.cat(counts), torch.cat(near)


def check_radius(knn, q, t, r: float, rows, what: str, exact_ties: bool = False) -> dict:
    """radius_count kernel vs its plain twin and float64 counts: every row
    of ``rows`` equal to the float64 count but rows with a pair within
    rounding of r^2; with ``exact_ties`` (integer coordinates, every d^2
    exact) every row, and the kernel equal to its plain twin bit for bit."""
    import torch

    c_k = knn.radius_count(q, t, r)
    c_p = knn.radius_count_plain(q, t, r)
    torch.cuda.synchronize()
    exact, near = exact_radius_counts(q, t, r)
    judged = rows if exact_ties else rows & ~near
    row = dict(kernel="radius_count", case=what, n=q.shape[0], m=t.shape[0], r=r,
               rows_near_r=int((rows & near).sum()), rows_judged=int(judged.sum()),
               rows_off_float64=int(((c_k.long() != exact) & judged).sum()),
               plain_rows_off_float64=int(((c_p.long() != exact) & judged).sum()),
               idx_identical=bool(torch.equal(c_k, c_p)), max_abs_err=int((c_k - c_p)[rows].abs().max()),
               mean_count=float(c_k[rows].double().mean()))
    require(row["rows_off_float64"] == 0, f"radius_count {what}: {row['rows_off_float64']} rows off the float64 count")
    require(row["plain_rows_off_float64"] == 0, f"radius_count_plain {what}: rows off the float64 count")
    if exact_ties:
        require(row["idx_identical"], f"radius_count {what}: differs from the plain twin on exact distances")
    return row


def floor_band(cloud, height: float = 1.8, clip: float = 1.0):
    """The floor detector's double plane clip of a cloud (tilt 0): the
    normal estimation's input, with its padded rows where they fall."""
    import torch
    from hdl_graph_slam_tpu_torch.ops import filters

    def plane(d):
        return torch.tensor([0.0, 0.0, 1.0, d], dtype=cloud.xyz.dtype, device=cloud.xyz.device)

    c = filters.plane_clip(cloud, plane(height + clip), negative=False)
    return filters.plane_clip(c, plane(height - clip), negative=True)


def outlier_masks(cloud_gpu, mean_k: int = 20, stddev: float = 1.0, radius: float = 0.5) -> dict:
    """The statistical and radius outlier filters on the card against the
    CPU on one cloud: the masks may differ only on rows within rounding of
    their gate (the mean distance within 1e-4 relative plus the two sides'
    largest mean-distance difference of the threshold; a pair within
    rounding of r^2)."""
    import torch
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.ops import filters, knn

    cpu = PointCloud(xyz=cloud_gpu.xyz.cpu(), mask=cloud_gpu.mask.cpu())
    out = {}

    def mean_d(c):
        xyz = c.valid_xyz()
        _, d2 = knn.knn(xyz, xyz, mean_k + 1)
        return torch.sqrt(torch.clamp(d2[:, 1:], min=0.0)).mean(-1).cpu().double()

    m_g, m_c = mean_d(cloud_gpu), mean_d(cpu)
    valid = cpu.mask
    g_mean = m_c[valid].mean()
    thr = g_mean + stddev * torch.sqrt(torch.clamp((m_c[valid] ** 2).mean() - g_mean ** 2, min=0.0))
    near = (m_c - thr).abs() <= 1e-4 * thr + (m_g - m_c)[valid].abs().max()
    for name, fn, near_rows in (
            ("statistical", lambda c: filters.statistical_outlier_removal(c, mean_k, stddev), near),
            ("radius", lambda c: filters.radius_outlier_removal(c, radius, 2),
             exact_radius_counts(cloud_gpu.valid_xyz(), cloud_gpu.valid_xyz(), radius)[1].cpu())):
        a, b = fn(cloud_gpu).mask.cpu(), fn(cpu).mask
        off = (a != b) & valid
        out[name] = dict(kept_gpu=int(a.sum()), kept_cpu=int(b.sum()), rows_differ=int(off.sum()),
                         rows_differ_off_gate=int((off & ~near_rows).sum()), rows_near_gate=int((near_rows & valid).sum()))
        require(out[name]["rows_differ_off_gate"] == 0,
                f"{name} outlier mask: card and CPU differ on {out[name]['rows_differ_off_gate']} rows off the gate")
    return out


def kernel_filters_phase(knn, keyframes, bench_clouds, rng) -> dict:
    """radius_count and knn_select at k = 10, 21 against their plain twins
    and float64; the outlier masks card against CPU on the two bench clouds
    (statistical: mean_k 20, 1 std; radius: the indoor preset's 0.5 m, 2
    neighbours). Returns the timed rows by kernel entry (radius_count,
    knn_select_k10, knn_select_k21)."""
    import torch

    dev = torch.device("cuda")
    bench_cloud = bench_clouds[0]
    kf = keyframes[1][0]
    band = floor_band(kf)
    gq, grows = kf.valid_xyz().contiguous(), kf.mask
    bq, brows = bench_cloud.valid_xyz().contiguous(), bench_cloud.mask

    def uniform(n, n_pad=0, half=60.0):
        x = rng.uniform(-half, half, (n, 3)).astype(np.float32)
        x[n - n_pad:] = 1.0e6
        return torch.from_numpy(x).to(dev)

    g = np.arange(16, dtype=np.float32)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lat = torch.from_numpy(lat[rng.permutation(np.r_[np.arange(len(lat)), rng.integers(0, len(lat), 1024)])]).to(dev)
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)  # noqa: E731
    dense = uniform(16384, 1600, half=10.0)
    radius_cases = {
        "golden_keyframe": (gq, gq, grows, RADIUS_M),
        "bench": (bq, bq, brows, RADIUS_M),
        "n16384_two_stages": (dense, dense, ones(16384) & (dense.abs() < 1e5).all(-1), RADIUS_M),
        "n1_m20": (uniform(1), uniform(20), ones(1), 60.0),
        "n31_m8192": (uniform(31), uniform(8192), ones(31), 10.0),
        "n8192_m20000_multi_stage": (uniform(8192), uniform(20000), ones(8192), 5.0),
        "all_but_25_padded": (uniform(2048), uniform(8192, 8192 - 25), ones(2048), 40.0),
    }
    timed = {}
    for case, (q, t, rows, r) in radius_cases.items():
        row = dict(phase="kernel_filters", **check_radius(knn, q, t, r, rows, case),
                   launch=knn.launch_info("radius_count", q.shape[0], t.shape[0]))
        if case == "golden_keyframe":
            row.update(time_rows(lambda: knn.radius_count(q, t, r), lambda: knn.radius_count_plain(q, t, r)))
            row["valid_pairs"] = int(rows.sum()) ** 2
            timed["radius_count"] = row
        emit(row)
    row = dict(phase="kernel_filters", **check_radius(knn, lat, lat, 1.0, ones(lat.shape[0]), "lattice_duplicates",
                                                      exact_ties=True))
    emit(row)

    knn_cases = {
        "floor_band": (band.valid_xyz().contiguous(), band.mask),
        "golden_keyframe": (gq, grows),
        "bench": (bq, brows),
        "uniform_padded": (uniform(8192, 819), ones(8192) & (torch.arange(8192, device=dev) < 8192 - 819)),
        "n8192_m20000_multi_stage": (uniform(20000), ones(20000)),
        "lattice_duplicates": (lat, ones(lat.shape[0])),
    }
    for k in (10, 21):
        for case, (t, rows) in knn_cases.items():
            row = dict(phase="kernel_filters", **check_knn(knn, t, t, rows, case, k=k, near_ties=True),
                       launch=knn.launch_info("knn_select", t.shape[0], t.shape[0], k=k))
            if case == "lattice_duplicates":
                require(row["idx_identical"], f"knn_select k={k} {case}: indices differ from the plain twin")
            if (k, case) in ((10, "floor_band"), (21, "golden_keyframe")):
                row.update(time_rows(lambda: knn.knn_select(t, t, k), lambda: knn.knn_select_plain(t, t, k)))
                row["valid_pairs"] = int(rows.sum()) ** 2
                timed[f"knn_select_k{k}"] = row
            emit(row)
        for case, (q, t) in {"n1_m20": (uniform(1), uniform(20)), "n31_m8192": (uniform(31), uniform(8192))}.items():
            if t.shape[0] >= k:
                emit(dict(phase="kernel_filters", **check_knn(knn, q, t, ones(q.shape[0]), case, k=k, near_ties=True)))
    emit(dict(phase="kernel_filters", case="outlier_masks", bench=[outlier_masks(c) for c in bench_clouds]))
    return timed


def time_rows(fn, plain) -> dict:
    """kernel_ms, device_ms, host_ms and plain_ms of a kernel entry point."""
    return dict(kernel_ms=time_ms(fn), device_ms=time_ms(fn, device_only=True), host_ms=host_ms(fn),
                plain_ms=time_ms(plain, reps=2, batches=3))


def floor_phase(keyframes) -> dict:
    """FloorDetector on the GOLDEN_B keyframe clouds on the card: the card's
    clipped cloud against the CPU's, RANSAC card against CPU on the same
    triplets, each detected floor against the truth."""
    import torch
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.frontend import FloorDetector
    from hdl_graph_slam_tpu_torch.ops import ransac
    from hdl_graph_slam_tpu_torch.utils import course

    cfg = course.golden_town_config("floor").floor
    det, det_cpu = FloorDetector(cfg, device="cuda"), FloorDetector(cfg, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for frame, c in zip(keyframes[0], keyframes[1]):
        band = det._prefilter(c)
        band_cpu = det_cpu._prefilter(PointCloud(xyz=c.xyz.cpu(), mask=c.mask.cpu()))
        count = int(band.count)
        tri = ransac.sample_triplets(gen, cfg.ransac_hypotheses, band.capacity, count)
        res = ransac.fit_plane_from_triplets(band, tri.cuda(), cfg.ransac_distance_thresh)
        ref = ransac.fit_plane_from_triplets(PointCloud(xyz=band.xyz.cpu(), mask=band.mask.cpu()), tri,
                                             cfg.ransac_distance_thresh)
        coeffs = det.detect(c)
        rows.append(dict(frame=int(frame), band_rows=count, band_rows_cpu=int(band_cpu.count),
                         inliers=int(res.num_inliers), inliers_cpu=int(ref.num_inliers),
                         coeff_max_abs_err=float((res.coeffs.cpu() - ref.coeffs).abs().max()),
                         detected=None if coeffs is None else [float(x) for x in coeffs]))
        r = rows[-1]
        require(abs(r["band_rows"] - r["band_rows_cpu"]) <= 0.01 * r["band_rows"],
                f"floor frame {frame}: clipped clouds of {r['band_rows']} and {r['band_rows_cpu']} rows")
        require(r["inliers"] == r["inliers_cpu"], f"floor frame {frame}: inliers {r['inliers']} vs {r['inliers_cpu']}")
        require(r["coeff_max_abs_err"] <= FLOOR_COEFF_ATOL, f"floor frame {frame}: coefficients differ")
        require(coeffs is not None, f"floor frame {frame}: no floor detected")
        tilt = float(np.degrees(np.arccos(min(1.0, abs(coeffs[2])))))
        r["tilt_deg"], r["height_err_m"] = tilt, float(abs(coeffs[3] - course.GOLDEN_SENSOR_HEIGHT))
        require(tilt <= FLOOR_TILT_DEG and r["height_err_m"] <= FLOOR_HEIGHT_ATOL_M,
                f"floor frame {frame}: tilt {tilt} deg, height error {r['height_err_m']} m")
    # the card's detect as the per-frame path calls it: host ms per call
    c = keyframes[1][0]
    row = dict(phase="floor", frames=rows, coeff_atol=FLOOR_COEFF_ATOL, tilt_max_deg=FLOOR_TILT_DEG,
               height_atol_m=FLOOR_HEIGHT_ATOL_M,
               detect_ms=time_ms(lambda: det.detect(c), reps=5, batches=3))
    emit(row)
    return row


LAUNCH_COUNTERS = ("nn1", "knn_select", "nn1_batched", "knn_select_batched", "radius_count")


def reset_launches(knn) -> None:
    for name in LAUNCH_COUNTERS:
        getattr(knn, name).launches = 0
    knn.knn_select.launches_k = dict.fromkeys(knn.KNN_SELECT_KS, 0)


def read_launches(knn) -> dict:
    """Launches per kernel entry since reset_launches: knn_select per k, its
    k = 20 (GICP) count under the plain name."""
    out = {name: getattr(knn, name).launches for name in LAUNCH_COUNTERS}
    out.update({f"knn_select_k{k}": v for k, v in knn.knn_select.launches_k.items() if k != K_NEIGHBOURS})
    out["knn_select"] = knn.knn_select.launches_k[K_NEIGHBOURS]
    return out


def golden_frames(golden, n=None) -> list:
    return [(float(i), x, None) for i, x in enumerate(golden["scans"][:n])]


def run_golden(cfg, frames, per_frame: bool = False, device_odometry: bool = False):
    """A fresh pipeline on the card over golden_town frames: run() (per
    frame) or run_windowed at the golden window and capacities."""
    import torch
    from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline
    from hdl_graph_slam_tpu_torch.utils import course

    pipe = SlamPipeline(cfg, cloud_capacity=course.GOLDEN_CLOUD_CAPACITY, device_odometry=device_odometry,
                        device="cuda")
    if per_frame:
        result = pipe.run(frames)
    else:
        result = pipe.run_windowed(frames, window=course.GOLDEN_WINDOW, raw_capacity=course.GOLDEN_RAW_CAPACITY)
    torch.cuda.synchronize()
    return pipe, result


def slam_phase(knn, golden, phase: str = "slam", cfg=None, per_frame: bool = False,
               required=("nn1", "knn_select", "nn1_batched", "knn_select_batched")) -> dict:
    """golden_town through SlamPipeline.run_windowed (or, ``per_frame``,
    run) on the card with ``cfg`` (the base config by default): the gates,
    the stage split and the launches of every kernel in ``required``."""
    import torch
    from hdl_graph_slam_tpu_torch.io import trajectory as traj_io

    scans, truth = golden["scans"], golden["truth"]
    cfg = cfg or golden["cfg"]
    frames = golden_frames(golden)
    clock = StageClock()
    slam_stages(clock, count_syncs=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(knn)
    t0 = time.perf_counter()
    try:
        pipe, result = run_golden(cfg, frames, per_frame=per_frame)
    finally:
        clock.restore()
    wall = time.perf_counter() - t0
    launches = read_launches(knn)

    est = result.trajectory
    kf_stamps = {st for st, _ in est}
    odom_kf = [(st, T) for st, T in result.odometry_trajectory if st in kf_stamps]
    ref = [(float(i), T) for i, T in enumerate(truth)]
    Rs = np.stack([T[:3, :3] for _, T in result.odometry_trajectory])
    n_kf = len(pipe.slam.keyframes)
    n_loops = len(pipe.slam.graph.edge_rows["se3_se3"]) - (n_kf - 1) - 1  # chain + anchor
    n_floor = len(pipe.slam.graph.edge_rows["se3_plane"])
    stats = pipe.slam.last_stats
    graph_iterations = sum(int(st.iterations) for _, st in clock.results["graph_solve"])
    timer = clock.timer
    row = dict(
        phase=phase, mode="run (per frame)" if per_frame else "run_windowed", frames=result.num_frames,
        keyframes=n_kf, loop_edges=n_loops, floor_edges=n_floor,
        ate_opt_m=traj_io.ate_rmse(est, ref, align=True), ate_odom_m=traj_io.ate_rmse(odom_kf, ref, align=True),
        det_err=float(np.abs(np.linalg.det(Rs) - 1.0).max()),
        orth_err=float(np.abs(Rs @ np.swapaxes(Rs, 1, 2) - np.eye(3)).max()),
        seconds=wall, fps=result.num_frames / wall,
        host_wall_s=dict(timer.totals), calls=dict(timer.counts),
        host_ms_per_call={k: 1e3 * timer.totals[k] / timer.counts[k] for k in timer.counts if timer.counts[k]},
        host_syncs_per_optimize_cycle=dict(mean=float(np.mean(clock.syncs)), max=int(max(clock.syncs)),
                                           total=int(sum(clock.syncs)), cycles=len(clock.syncs)),
        last_solve_iterations=int(stats.iterations) if stats is not None else None,
        graph_iterations=graph_iterations,
        graph_ms_per_iteration=1e3 * timer.totals["graph_solve"] / max(graph_iterations, 1),
        launches=launches, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    if cfg.floor.enabled:
        row["reference"] = dict(source="PERF_JAX_REFERENCE.md:625 (JAX package on TPU, golden_town floor)",
                                ate_opt_m=0.0341, ate_odom_m=0.0855, keyframes=93, loop_edges=12, floor_edges=93)
    else:
        row["reference"] = dict(source="PERF_JAX_REFERENCE.md:415-433 (JAX package on TPU)", ate_opt_m=0.0342,
                                ate_odom_m=0.0847, keyframes=93, loop_edges=12)
    emit(row)
    require(row["frames"] == len(scans), f"{phase} ran {row['frames']} of {len(scans)} frames")
    require(row["det_err"] < 1e-4 and row["orth_err"] < 1e-4,
            f"{phase}: rotation drift {row['det_err']}, {row['orth_err']}")
    require(n_loops >= 2, f"{phase}: only {n_loops} loop edges")
    require(row["ate_opt_m"] < row["ate_odom_m"],
            f"{phase}: optimized ATE {row['ate_opt_m']} >= odometry {row['ate_odom_m']}")
    if cfg.floor.enabled:
        require(n_floor >= 0.9 * n_kf, f"{phase}: {n_floor} floor edges for {n_kf} keyframes")
    require(all(launches[k] >= 1 for k in required), f"{phase} path did not go through every kernel: {launches}")
    return dict(row=row, pipe=pipe, frames=frames, launches=launches)


def host_profile(golden, n: int = 16) -> dict:
    """The per-frame path's host syncs per frame and device idle share over
    ``n`` frames of a fresh pipeline traced with torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline
    from hdl_graph_slam_tpu_torch.utils import course

    frames = golden_frames(golden, n)
    clock = StageClock()
    clock.wrap(SlamPipeline, "process_frame", "process_frame", sync=True, count_syncs=True)
    try:
        pipe = SlamPipeline(course.golden_town_outdoor_config(), cloud_capacity=course.GOLDEN_CLOUD_CAPACITY,
                            device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for stamp, xyz, _ in frames:
                pipe.process_frame(stamp, xyz)
            torch.cuda.synchronize()
    finally:
        clock.restore()
    busy, wall = device_busy(prof)
    return dict(frames=n, host_syncs_per_frame=dict(mean=float(np.mean(clock.syncs[1:])), max=int(max(clock.syncs)),
                                                    bootstrap=int(clock.syncs[0])),
                device_busy_s=busy, wall_s=wall, device_idle_share=1.0 - busy / wall,
                top_device=top_device(prof, 10))


def host_phase(knn, golden) -> dict:
    """golden_town_outdoor_config() through the per-frame run(); then its
    trace, then the STATISTICAL prefilter's path, run(device_odometry=True)
    against run_windowed over 48 frames."""
    from hdl_graph_slam_tpu_torch.utils import course

    out = slam_phase(knn, golden, phase="host", cfg=course.golden_town_outdoor_config(), per_frame=True,
                     required=("nn1", "knn_select", "nn1_batched", "knn_select_batched", "knn_select_k10",
                               "radius_count"))
    n = len(golden["scans"])
    require(out["launches"]["radius_count"] >= n, f"host: radius_count launched {out['launches']['radius_count']} "
                                                   f"times in {n} frames")
    emit(dict(phase="host_profile", **host_profile(golden)))

    cfg = course.golden_town_config("floor")
    cfg.prefilter.outlier_removal_method = "STATISTICAL"  # SlamConfig()'s default filter
    frames = golden_frames(golden, 48)
    reset_launches(knn)
    _, seq = run_golden(cfg, frames, per_frame=True, device_odometry=True)
    launches = read_launches(knn)
    reset_launches(knn)
    _, win = run_golden(cfg, frames)
    launches_windowed = read_launches(knn)
    err = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(seq.odometry_trajectory, win.odometry_trajectory))
    row = dict(phase="host_statistical", frames=len(frames), keyframes_run=seq.num_keyframes,
               keyframes_windowed=win.num_keyframes, odometry_max_abs_err=err, atol=ODOM_PARITY_ATOL,
               launches=launches, launches_windowed=launches_windowed)
    emit(row)
    require(seq.num_frames == win.num_frames == len(frames), "host_statistical: frame counts differ")
    require(seq.num_keyframes == win.num_keyframes, "host_statistical: keyframe counts differ")
    require(err <= ODOM_PARITY_ATOL, f"host_statistical: run vs run_windowed odometry differ by {err}")
    require(launches["knn_select_k21"] >= len(frames) and launches_windowed["knn_select_k21"] >= 1,
            f"host_statistical: knn_select k=21 launches {launches} (run), {launches_windowed} (run_windowed)")
    return dict(host=out["launches"], host_statistical=launches, host_statistical_windowed=launches_windowed)


def kernels_line(kres, bres, fres, launches, peak_flops) -> list:
    """One entry per kernel entry point measured in this run. ``launches``
    maps each path (main, slam, slam_floor, host, host_statistical: the
    STATISTICAL run(), host_statistical_windowed: its run_windowed twin) to its
    launch counts; an entry's ``launches`` is that of its own main path."""
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_FRAMES

    line = []
    n = N_KERNEL
    spec = {
        "nn1": dict(replaces="hdl_graph_slam_tpu/ops/pallas_nn.py:61 (nn1_pallas; pallas_call :95)",
                    out_bytes=n * 8),
        "knn_select": dict(replaces="hdl_graph_slam_tpu/ops/knn.py:130 (knn_approx, lax.approx_min_k)",
                           out_bytes=n * K_NEIGHBOURS * 8),
    }
    for name, sp in spec.items():
        r = kres[(name, "course")]
        ops_s = n * n * OPS_PER_PAIR / peak_flops
        bytes_s = (2 * n * 12 + sp["out_bytes"]) / HBM_BYTES_PER_S
        line.append(dict(
            name=name, route="cuda", source="hdl_graph_slam_tpu_torch/csrc/knn.cu", replaces=sp["replaces"],
            launches=launches["main"][name], launches_slam=launches["slam"][name],
            launches_per_frame=launches["main"][name] / (BENCH_FRAMES + 1),
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
            host_ms=r["host_ms"], plain_ms=r["plain_ms"],
            bound_ms=1e3 * max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=None, shape=f"{n}x{n}" + (f", k={K_NEIGHBOURS}" if name == "knn_select" else ""),
            resident_warps_per_sm=r["launch"]["resident_warps_per_sm"], grid_blocks=r["launch"]["grid_blocks"],
            dynamic_smem_bytes=r["launch"]["dynamic_smem_bytes"],
            registers_per_thread=r["launch"]["registers_per_thread"],
        ))
    for kind, replaces in (("nn1", "hdl_graph_slam_tpu/ops/pallas_nn.py:61 (nn1_pallas; pallas_call :95) under "
                                   "jax.vmap, backend/information_matrix.py:105-108"),
                           ("knn_select", "hdl_graph_slam_tpu/ops/knn.py:130 (knn_approx) under jax.vmap, "
                                          "backend/loop_detector.py:244,281")):
        r = bres[(kind, "keyframes")]
        b, nq, m = r["batch"], r["n"], r["m"]
        # the work this run's data needs: valid query x valid target pairs
        ops_s = r["valid_pairs"] * OPS_PER_PAIR / peak_flops
        out_bytes = b * nq * (8 if kind == "nn1" else 8 * K_NEIGHBOURS)
        bytes_s = (b * (nq + m) * 12 + out_bytes) / HBM_BYTES_PER_S
        line.append(dict(
            name=f"{kind}_batched", route="cuda", source="hdl_graph_slam_tpu_torch/csrc/knn.cu", replaces=replaces,
            launches=launches["slam"][f"{kind}_batched"],
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
            host_ms=r["host_ms"], plain_ms=r["plain_ms"],
            bound_ms=1e3 * max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=None, shape=f"B={b} x {nq}x{m}" + (f", k={K_NEIGHBOURS}" if kind == "knn_select" else ""),
            resident_warps_per_sm=r["launch"]["resident_warps_per_sm"], grid_blocks_per_problem=r["launch"]["grid_blocks"],
            dynamic_smem_bytes=r["launch"]["dynamic_smem_bytes"],
            registers_per_thread=r["launch"]["registers_per_thread"],
        ))
    # the filter and floor kernels: the work this run's inputs need (valid pairs)
    for name, path, replaces, ops, out_per_row in (
            ("radius_count", "host", "hdl_graph_slam_tpu/ops/knn.py:180 (radius_count, XLA)", RADIUS_OPS_PER_PAIR, 4),
            ("knn_select_k10", "slam_floor", "hdl_graph_slam_tpu/ops/knn.py:99 (knn, XLA top_k) at k=10, "
                                             "ops/normals.py:36", OPS_PER_PAIR, 80),
            ("knn_select_k21", "host_statistical", "hdl_graph_slam_tpu/ops/knn.py:99 (knn, XLA top_k) at k=21, "
                                                   "ops/filters.py:56", OPS_PER_PAIR, 168)):
        r = fres[name]
        ops_s = r["valid_pairs"] * ops / peak_flops
        bytes_s = (r["n"] * 12 + r["m"] * 12 + r["n"] * out_per_row) / HBM_BYTES_PER_S
        line.append(dict(
            name=name, route="cuda", source="hdl_graph_slam_tpu_torch/csrc/knn.cu", replaces=replaces,
            launches=launches[path][name], launches_by_path={p: v[name] for p, v in launches.items() if name in v},
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
            host_ms=r["host_ms"], plain_ms=r["plain_ms"],
            bound_ms=1e3 * max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=None, shape=f"{r['n']}x{r['m']} ({r['case']})", valid_pairs=r["valid_pairs"],
            resident_warps_per_sm=r["launch"]["resident_warps_per_sm"], grid_blocks=r["launch"]["grid_blocks"],
            dynamic_smem_bytes=r["launch"]["dynamic_smem_bytes"], stage_rows=r["launch"]["stage_rows"],
            registers_per_thread=r["launch"]["registers_per_thread"],
        ))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="trace 16 frames of the main path with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import hdl_graph_slam_tpu_torch  # noqa: F401  (sets the precision policy)
    from hdl_graph_slam_tpu_torch import kernels
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.frontend import Prefilter
    from hdl_graph_slam_tpu_torch.ops import knn
    from hdl_graph_slam_tpu_torch.utils import course
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_FRAMES, BENCH_RAW_CAPACITY, BENCH_STEP, make_course

    dev = torch.device("cuda")

    # -- 1. environment ---------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    env = dict(phase="env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
               python=sys.version.split()[0], sm_count=props.multi_processor_count, max_sm_clock_mhz=clock_mhz,
               allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
               allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
               float32_matmul_precision=torch.get_float32_matmul_precision())
    emit(env)
    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest", "TF32 must be off")
    peak_flops = props.multi_processor_count * FP32_LANES_PER_SM * clock_mhz * 1e6 * 2

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load("knn")
    build = dict(phase="build", seconds=time.perf_counter() - t0, nvcc_flags=kernels.NVCC_FLAGS,
                 ptxas=kernels.build_info["knn"]["ptxas"])
    emit(build)

    kres, launches = {}, {}
    # -- course (host ray casting) ----------------------------------------
    t0 = time.perf_counter()
    scans = make_course(BENCH_FRAMES, BENCH_STEP, seed=SEED)
    emit(dict(phase="course", frames=BENCH_FRAMES, seed=SEED, seconds=time.perf_counter() - t0,
              raw_points_mean=float(np.mean([s.shape[0] for s in scans]))))

    pf_cfg, _ = bench_configs()

    # -- 3. kernels ---------------------------------------------------------
    pf_gpu = Prefilter(pf_cfg, out_capacity=N_KERNEL, device="cuda")
    pf_cpu = Prefilter(pf_cfg, out_capacity=N_KERNEL, device="cpu")
    clouds = []
    for s in scans[:2]:
        c_gpu = pf_gpu(cloudlib.from_numpy(s, capacity=BENCH_RAW_CAPACITY, device="cuda"))
        c_cpu = pf_cpu(cloudlib.from_numpy(s, capacity=BENCH_RAW_CAPACITY, device="cpu"))
        require(torch.equal(c_gpu.mask.cpu(), c_cpu.mask), "GPU and CPU prefilter keep different voxels")
        m = c_cpu.mask
        err = float((c_gpu.xyz.cpu()[m] - c_cpu.xyz[m]).abs().max())
        require(err <= CENTROID_ATOL_M, f"GPU vs CPU voxel centroids differ by {err} m")
        clouds.append((c_gpu, int(m.sum()), err))
    emit(dict(phase="prefilter_check", valid_rows=[c[1] for c in clouds], centroid_max_abs_err_m=[c[2] for c in clouds],
              atol_m=CENTROID_ATOL_M))

    rng = np.random.default_rng(SEED)
    n_pad = N_KERNEL // 10

    def uniform_cloud():
        x = rng.uniform(-60.0, 60.0, (N_KERNEL, 3)).astype(np.float32)
        x[-n_pad:] = cloudlib.PAD_COORD
        return torch.from_numpy(x).to(dev)

    tgt0 = clouds[0][0].valid_xyz().contiguous()
    src1 = clouds[1][0].valid_xyz().contiguous()
    uq, ut = uniform_cloud(), uniform_cloud()
    cases = {
        "course": dict(nn1=(src1, tgt0, clouds[1][0].mask), knn=(tgt0, tgt0, clouds[0][0].mask)),
        "uniform": dict(nn1=(uq, ut, torch.arange(N_KERNEL, device=dev) < N_KERNEL - n_pad),
                        knn=(ut, ut, torch.arange(N_KERNEL, device=dev) < N_KERNEL - n_pad)),
    }
    for case, inp in cases.items():
        for name, check, fn, plain in (("nn1", check_nn1, lambda q, t: knn.nn1(q, t), knn.nn1_plain),
                                       ("knn_select", check_knn, lambda q, t: knn.knn_select(q, t, K_NEIGHBOURS),
                                        lambda q, t: knn.knn_select_plain(q, t, K_NEIGHBOURS))):
            q, t, valid = inp["knn" if name == "knn_select" else "nn1"]
            row = dict(phase="kernel", **check(knn, q, t, valid, case))
            row["kernel_ms"] = time_ms(lambda: fn(q, t))
            row["device_ms"] = time_ms(lambda: fn(q, t), device_only=True)
            row["host_ms"] = host_ms(lambda: fn(q, t))
            row["plain_ms"] = time_ms(lambda: plain(q, t), reps=5)
            row["launch"] = knn.launch_info(name, q.shape[0], t.shape[0])
            emit(row)
            kres[(name, case)] = row

    # -- 3b. kernel edges: shapes and data the main path does not reach -----
    def uniform(n, n_pad=0):
        x = rng.uniform(-60.0, 60.0, (n, 3)).astype(np.float32)
        x[n - n_pad:] = cloudlib.PAD_COORD
        return torch.from_numpy(x).to(dev)

    g = np.arange(16, dtype=np.float32)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lat = torch.from_numpy(lat[rng.permutation(np.r_[np.arange(len(lat)), rng.integers(0, len(lat), 1024)])]).to(dev)
    edges = {
        "n1_m20": (uniform(1), uniform(20)),
        "n31_m8192": (uniform(31), uniform(8192)),
        "n8192_m20000_multi_stage": (uniform(8192), uniform(20000)),
        "n4096_m20_m_eq_k": (uniform(4096), uniform(20)),
        "all_but_25_padded": (uniform(2048), uniform(8192, 8192 - 25)),
        "lattice_duplicates": (lat, lat),
    }
    for case, (q, t) in edges.items():
        rows = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
        for check in (check_nn1, check_knn):
            row = dict(phase="kernel_edges", **check(knn, q, t, rows, case),
                       launch=knn.launch_info("nn1" if check is check_nn1 else "knn_select", q.shape[0], t.shape[0]))
            emit(row)
            if case == "lattice_duplicates":  # exact ties: index for index
                require(row["idx_identical"], f"{row['kernel']} {case}: indices differ from the plain twin")

    # -- 4. main path -------------------------------------------------------
    win, first, xyz, mask, stamps = main_path(scans)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launches(knn)
    state0, odoms, status, dt = drive_window(win, first, xyz, mask, stamps)
    conv = status["converged"].cpu().numpy()
    launches["main"] = read_launches(knn)

    dist = BENCH_STEP * BENCH_FRAMES
    Rs = odoms[:, :3, :3].astype(np.float64)
    main_row = dict(
        phase="main", frames=BENCH_FRAMES, seconds=dt, fps=BENCH_FRAMES / dt,
        final_x=float(odoms[-1, 0, 3]), drive_m=dist, converged_fraction=float(conv.mean()),
        lm_iterations_per_frame=float(status["iterations"].double().mean()),
        keyframes=int(status["keyframe_switched"].sum()),
        det_err=float(np.abs(np.linalg.det(Rs) - 1.0).max()),
        orth_err=float(np.abs(Rs @ np.swapaxes(Rs, 1, 2) - np.eye(3)).max()),
        launches=launches["main"], peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(main_row)
    # bench.py:196-212
    require(bool(np.isfinite(odoms).all()), "non-finite pose")
    require(abs(main_row["final_x"] - dist) < 0.03 * dist, f"final x {main_row['final_x']} vs drive {dist}")
    require(main_row["converged_fraction"] > 0.9, f"only {main_row['converged_fraction']:.0%} of frames converged")
    require(main_row["det_err"] < 1e-4, f"det(R) drift {main_row['det_err']:.2e}")
    require(main_row["orth_err"] < 1e-4, f"orthogonality error {main_row['orth_err']:.2e}")
    require(launches["main"]["knn_select"] >= BENCH_FRAMES and launches["main"]["nn1"] >= BENCH_FRAMES,
            f"main path did not go through the kernels: {launches['main']}")

    if args.profile:
        emit(profile_frames(win, state0, xyz, mask, stamps, 16, dt / BENCH_FRAMES))

    # -- 5. golden_town course (host ray casting in a process pool) ----------
    golden = golden_course_phase()

    # -- 6. batched kernels at the loop shapes; the filter kernels; floor ----------
    keyframes = golden_keyframes(golden)
    bres = kernel_batched_phase(knn, golden, keyframes)
    fres = kernel_filters_phase(knn, keyframes, [c[0] for c in clouds], rng)
    floor_phase(keyframes)

    # -- 7. pose graph, card vs CPU ---------------------------------------------
    graph_phase()

    # -- 8. golden_town SLAM on the card ---------------------------------------------
    slam = slam_phase(knn, golden)
    launches["slam"] = slam["launches"]
    slam_profile(slam["pipe"], slam["frames"])

    # -- 9. golden_town floor through run_windowed ------------------------------------
    launches["slam_floor"] = slam_phase(knn, golden, phase="slam_floor", cfg=course.golden_town_config("floor"),
                                        required=("nn1", "knn_select", "nn1_batched", "knn_select_batched",
                                                  "knn_select_k10"))["launches"]

    # -- 10. the per-frame path: run() with the outdoor filters -------------------------
    launches.update(host_phase(knn, golden))

    # -- 11. kernels line ------------------------------------------------------
    emit({"kernels": kernels_line(kres, bres, fres, launches, peak_flops)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
