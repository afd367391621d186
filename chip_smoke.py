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
           plain PyTorch version on the card and both are timed with CUDA
           events. The GPU prefilter is held against the CPU one.
4. main    bench.py's windowed FAST_GICP odometry (its configs, its course
           with seed 0, 16384-row raw scans, 8192-row filtered clouds) through
           the port's OdometryWindow on cuda, with bench.py's gates; kernel
           launch counts are read around this run.
   With --profile, torch.profiler then traces 16 more frames: device busy
   time, kernels launched per frame, the top kernels by device time, and
   the device idle share twice: over the profiled wall time (which the
   profiler inflates) and over the unprofiled main run's wall time per
   frame.
5. The kernels line, the card's name and power limit, then the last line
   {"ok": true, "device": {...}}.

Without a GPU, or without the package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
# another set; every row must still agree up to ties, and nearly all exactly.
KNN_MIN_IDENTICAL_SETS = 0.999


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over ``batches`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return float(np.median(per))


def knn_rows_agree(q, t, idx_a, idx_b, rows):
    """Row-set agreement up to ties: (fraction of rows with identical sets,
    fraction whose sorted exact float64 distances agree within the expanded
    form's rounding, max abs difference of those distances)."""
    q = q.double().cpu().numpy()[rows]
    t = t.double().cpu().numpy()
    a = idx_a.cpu().numpy()[rows].astype(np.int64)
    b = idx_b.cpu().numpy()[rows].astype(np.int64)
    same = np.mean([set(x) == set(y) for x, y in zip(a, b)])
    da = np.sort(((q[:, None, :] - t[a]) ** 2).sum(-1), axis=1)
    db = np.sort(((q[:, None, :] - t[b]) ** 2).sum(-1), axis=1)
    valid_t = np.all(np.abs(t) < 1e5, axis=1)
    center = 0.5 * (t[valid_t].min(0) + t[valid_t].max(0))
    scale = float(((t[valid_t] - center) ** 2).sum(-1).max() + ((q - center) ** 2).sum(-1).max())
    tol = float(16 * np.finfo(np.float32).eps * scale)
    err = np.abs(da - db).max(axis=1)
    return float(same), float(np.mean(err <= tol)), float(err.max()), tol


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
    top = sorted((k for k in prof.key_averages() if dev_us(k) > 0), key=dev_us, reverse=True)[:12]
    return dict(phase="profile", frames=n, wall_s=wall, device_busy_s=busy * 1e-6,
                device_idle_share_profiled=1.0 - busy * 1e-6 / wall,
                device_idle_share_unprofiled=1.0 - busy * 1e-6 / n / main_s_per_frame,
                device_ops_per_frame=len(spans) / n,
                top_device=[dict(name=k.key[:80], calls=k.count, total_ms=dev_us(k) * 1e-3) for k in top])


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
    from hdl_graph_slam_tpu_torch.core.config import OdometryConfig, PrefilterConfig, RegistrationConfig
    from hdl_graph_slam_tpu_torch.frontend import OdometryWindow, Prefilter
    from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
    from hdl_graph_slam_tpu_torch.ops import knn
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

    # -- course (host ray casting) ----------------------------------------
    t0 = time.perf_counter()
    scans = make_course(BENCH_FRAMES, BENCH_STEP, seed=SEED)
    emit(dict(phase="course", frames=BENCH_FRAMES, seed=SEED, seconds=time.perf_counter() - t0,
              raw_points_mean=float(np.mean([s.shape[0] for s in scans]))))

    # bench.py:142-151
    pf_cfg = PrefilterConfig(downsample_resolution=0.2, outlier_removal_method="NONE")
    odo_cfg = OdometryConfig(keyframe_delta_trans=2.0, keyframe_delta_time=1e9,
                             registration=RegistrationConfig(reg_reassoc_displacement=0.1))

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
    kres = {}
    for case, inp in cases.items():
        q, t, valid = inp["nn1"]
        i_k, d_k = knn.nn1(q, t)
        i_p, d_p = knn.nn1_plain(q, t)
        torch.cuda.synchronize()
        agree = float((i_k == i_p).double().mean())
        rows = valid
        rel = ((d_k - d_p).abs() / d_p.abs().clamp(min=1e-6))[rows]
        row = dict(phase="kernel", kernel="nn1", case=case, n=q.shape[0], m=t.shape[0],
                   idx_agreement=agree, dist2_max_rel_err=float(rel.max()),
                   max_abs_err=float((d_k - d_p)[rows].abs().max()),
                   kernel_ms=time_ms(lambda: knn.nn1(q, t)), plain_ms=time_ms(lambda: knn.nn1_plain(q, t), reps=5))
        emit(row)
        require(agree > NN1_MIN_AGREEMENT, f"nn1 {case}: idx agreement {agree}")
        require(row["dist2_max_rel_err"] <= NN1_DIST_RTOL, f"nn1 {case}: dist2 rel err {row['dist2_max_rel_err']}")
        kres[("nn1", case)] = row

        q, t, valid = inp["knn"]
        i_k, d_k = knn.knn_select(q, t, K_NEIGHBOURS)
        i_p, d_p = knn.knn_select_plain(q, t, K_NEIGHBOURS)
        torch.cuda.synchronize()
        rows = valid.cpu().numpy()
        same, tie_ok, err, tol = knn_rows_agree(q, t, i_k, i_p, rows)
        row = dict(phase="kernel", kernel="knn_select", case=case, n=q.shape[0], m=t.shape[0], k=K_NEIGHBOURS,
                   rows_identical_sets=same, rows_agree_up_to_ties=tie_ok, max_abs_err=err, tie_tol=tol,
                   sorted_ascending=bool((d_k[:, 1:] >= d_k[:, :-1]).all()),
                   kernel_ms=time_ms(lambda: knn.knn_select(q, t, K_NEIGHBOURS)),
                   plain_ms=time_ms(lambda: knn.knn_select_plain(q, t, K_NEIGHBOURS), reps=5))
        emit(row)
        require(tie_ok == 1.0, f"knn_select {case}: {1 - tie_ok} of rows differ beyond ties")
        require(same >= KNN_MIN_IDENTICAL_SETS, f"knn_select {case}: identical sets on only {same} of rows")
        require(row["sorted_ascending"], f"knn_select {case}: output not sorted")
        kres[("knn_select", case)] = row

    # -- 4. main path -------------------------------------------------------
    win = OdometryWindow(odo_cfg, prefilter_cfg=pf_cfg, out_capacity=8192, device="cuda")
    xyz_np, mask_np = stack_scans(scans[1:], capacity=BENCH_RAW_CAPACITY)
    xyz = torch.from_numpy(xyz_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    stamps = torch.from_numpy((0.1 * np.arange(1, BENCH_FRAMES + 1)).astype(np.float32)).to(dev)
    first = cloudlib.from_numpy(scans[0], capacity=BENCH_RAW_CAPACITY, device="cuda")
    torch.cuda.synchronize()

    knn.nn1.launches = 0
    knn.knn_select.launches = 0
    state0 = win.init_state(0.0, first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, odoms, status = win.run(state0, xyz, mask, stamps)
    odoms = odoms.cpu().numpy()
    conv = status["converged"].cpu().numpy()
    dt = time.perf_counter() - t0
    launches = {"nn1": knn.nn1.launches, "knn_select": knn.knn_select.launches}

    dist = BENCH_STEP * BENCH_FRAMES
    Rs = odoms[:, :3, :3].astype(np.float64)
    main_row = dict(
        phase="main", frames=BENCH_FRAMES, seconds=dt, fps=BENCH_FRAMES / dt,
        final_x=float(odoms[-1, 0, 3]), drive_m=dist, converged_fraction=float(conv.mean()),
        lm_iterations_per_frame=float(status["iterations"].double().mean()),
        keyframes=int(status["keyframe_switched"].sum()),
        det_err=float(np.abs(np.linalg.det(Rs) - 1.0).max()),
        orth_err=float(np.abs(Rs @ np.swapaxes(Rs, 1, 2) - np.eye(3)).max()),
        launches=launches, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    emit(main_row)
    # bench.py:196-212
    require(bool(np.isfinite(odoms).all()), "non-finite pose")
    require(abs(main_row["final_x"] - dist) < 0.03 * dist, f"final x {main_row['final_x']} vs drive {dist}")
    require(main_row["converged_fraction"] > 0.9, f"only {main_row['converged_fraction']:.0%} of frames converged")
    require(main_row["det_err"] < 1e-4, f"det(R) drift {main_row['det_err']:.2e}")
    require(main_row["orth_err"] < 1e-4, f"orthogonality error {main_row['orth_err']:.2e}")
    require(launches["knn_select"] >= BENCH_FRAMES and launches["nn1"] >= BENCH_FRAMES,
            f"main path did not go through the kernels: {launches}")

    if args.profile:
        emit(profile_frames(win, state0, xyz, mask, stamps, 16, dt / BENCH_FRAMES))

    # -- 5. kernels line ------------------------------------------------------
    n = N_KERNEL
    pairs = n * n
    spec = {
        "nn1": dict(replaces="hdl_graph_slam_tpu/ops/pallas_nn.py:61 (nn1_pallas; pallas_call :95)",
                    out_bytes=n * 8),
        "knn_select": dict(replaces="hdl_graph_slam_tpu/ops/knn.py:130 (knn_approx, lax.approx_min_k)",
                           out_bytes=n * K_NEIGHBOURS * 8),
    }
    line = []
    for name, sp in spec.items():
        r = kres[(name, "course")]
        ops_s = pairs * OPS_PER_PAIR / peak_flops
        bytes_s = (2 * n * 12 + sp["out_bytes"]) / HBM_BYTES_PER_S
        line.append(dict(
            name=name, route="cuda", source="hdl_graph_slam_tpu_torch/csrc/knn.cu", replaces=sp["replaces"],
            launches=launches[name], launches_per_frame=launches[name] / (BENCH_FRAMES + 1),
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=1e3 * max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=None, shape=f"{n}x{n}" + (f", k={K_NEIGHBOURS}" if name == "knn_select" else ""),
        ))
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
