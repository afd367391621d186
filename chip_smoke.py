#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hdl_graph_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printed as one JSON line; any failure raises and exits non-zero
before the last line:

1. env     GPU name and power limit (nvidia-smi), torch and CUDA versions;
           TF32 must be off.
2. build   nvcc builds the kernels of hdl_graph_slam_tpu_torch/csrc/, one
           process per source, started together.
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
   ndt_kernels  the NDT kernels (csrc/ndt.cu) against their plain twins on
           bench frames 0 (target) and 1 (source, at a pose off the truth),
           the target at 2.0 m and at the imu preset's 10 m cells, DIRECT7
           and DIRECT1: the association identical but on rows with a point
           within FACE_ULPS eps32 of a cell face (judged in float64), g and
           H within 1e-4 of the largest |entry|, scores within 1e-5
           relative, 10 trial poses' scores likewise with the same argmin,
           one trial pose's too, a batch of 3 equal to the batch of 1 row
           for row, bit for bit, each wrapper called again and again after
           the batch of 3 bit for bit as before (the reductions' ticket
           counters reset); the association's key-search branch (the
           target without its dense grid) against its twin off faces, and
           again bit for bit; knn_select at k = 8 (KDTREE's cell candidates)
           through the float64 near-tie gate; preprocess_target's time.
           Timed as the kernel phase, with each kernel's bound from the
           bytes and operations this run's inputs need (ndt_work,
           ndt_bounds), and each wrapper call one device operation in a
           torch.profiler trace (device_ops_per_call; where every retaken
           trace comes back short, counted by CUDA graph capture instead,
           graph_ops_per_call, and both counts emitted as a device_ops row).
   kernel_filters  (on golden_town frames 0 and 1, cast in the process;
           run here, early, because later in a long process torch.profiler
           traces lost device events) radius_count against its plain twin
           and float64 counts
           (every row equal but rows holding a pair within the expanded
           form's rounding of r^2; on integer lattices every row, bit for
           bit) on a golden keyframe cloud (r = 0.8 m), golden_town frame 1
           through the outdoor (cli) and imu presets' prefilters at 16384
           rows, a bench cloud, a 16384-row uniform cloud, the kernel_edges
           shapes and 40000 lattice rows (every tile pair full, past the
           kernel's list); each called again bit for bit, and with every
           lane computing its tiles' boxes itself (the kernel's fallback),
           and the tile pairs it tested equal to those ops/knn.py
           radius_tile_plan names;
           knn_select at k = 10 and 21 through the kernel phase's check; the
           statistical and radius outlier masks, card against CPU. Timed as
           the kernel phase (radius_count at the golden keyframe and the two
           16384-row frames, each call one device operation, bound over the
           pairs tested, the valid pairs' figure beside it).
   ndt_kernels (case imu)  the ndt_kernels gates and times at the imu
           path's shapes: golden_town frames 0 and 1 through the imu
           preset's prefilter at 16384 rows, the target at 10 m cells with
           max_voxels 16384, DIRECT7.
   vgicp_kernels  (early too) the FAST_VGICP target of bench frame 0 at
           1.0 m voxels with its 256³ grid: preprocess_target twice on the
           card bit for bit, and against the same cloud's target on the CPU;
           the DIRECT1 association ndt_associate_kernel<1> over its voxels
           (ndt.associate_cells), through the grid and the key search,
           against the plain twin off cell faces (float64 face rule), again
           bit for bit, one device operation a call; timed beside its bound.
   gicp_kernels  (early too) the GICP kernel's four forms (csrc/gicp.cu
           gicp_step_kernel: associate, linearize, cost, and associate and
           linearize fused) on bench frames 0 (target) and 1 (source) at the
           three NDT_TWISTS poses, through GICP's nn1 search and 2.5 m gate
           and through VGICP's voxel lookup over vgicp_kernels' target: Mw
           within 1e-5 of the plain twin's largest |entry| and the same
           counts; H, b and the cost within 1e-4 of the float64 twin's (the
           plain float32 twin's distance beside it); the fused call bit for
           bit the association then the linearization; the linearization at
           a damped step's trial pose (the gated loop's carried H, b and
           cost) bit for bit a fresh call there; the cost form's cost bit
           for bit the full call's; every call again, and each problem's
           single call as its row of the batch of 3, bit for bit; each
           wrapper call one device operation of the kernel; the prepared
           calls the LM loop launches timed beside their bounds (gicp_work,
           gicp_bounds). The same gates at the loop detector's B = 8 x 4096
           run after kernel_batched.
4. main    bench.py's windowed FAST_GICP odometry (its configs, its course
           with seed 0, 16384-row raw scans, 8192-row filtered clouds) through
           the port's OdometryWindow on cuda, with bench.py's gates; kernel
           launch counts are read around this run (nn1, knn_select and the
           GICP kernel's fused and linearize forms at least once a frame, at
           most 1 + 2 x LM iterations GICP launches a frame); host syncs and
           device operations a frame over 16 more frames, as window_phase.
   With --profile, torch.profiler then traces 16 more frames: device busy
   time, kernels launched per frame, the top kernels by device time and the
   port's own kernels' device time per launch, and
   the device idle share twice: over the profiled wall time (which the
   profiler inflates) and over the unprofiled main run's wall time per
   frame.
   ndt_main  the same course through the OdometryWindow with NDT_OMP
           DIRECT7, 2.0 m cells, 0.5 m re-association
           (benchmarks/r3_method_window.py's NDT row), bench.py's gates; fps,
           Newton iterations, launches and host syncs a frame, device
           operations and idle share over 16 traced frames. ndt_kdtree: its
           first 32 frames with KDTREE (knn_select at k = 8), the final x
           within 0.1 m of ndt_main's at frame 32 instead of the 3%.
   vgicp_main  the same course through the window with FAST_VGICP at 1.0 m
           (benchmarks/r3_method_window.py:51), bench.py's gates, the
           association and knn_select launched at least once a frame, and
           the x at frame 64 within VGICP_WITNESS's tolerance of the JAX
           package's on the CPU (tools/method_witness.py). icp_main: ICP
           over the first 128 frames, nn1 once a frame at least, the x and
           converged share at frame 64 against the JAX run; not gated on
           the 3% (the reference's point-to-point ICP drifts ~10.6% here,
           PERF_JAX_REFERENCE.md:300). icp_reciprocal: 32 frames with
           reciprocal correspondences (nn1_batched's back query).
5. golden_course  benchmarks/golden_town.py's 601 ray-cast town scans, cast
           in a process pool (the script's, not the package's).
6. kernel_batched  the batched kernels (nn1_batched, knn_select_batched) at
           the loop shapes: B = 8 distinct 4096-row keyframe clouds of that
           course, and the same with ragged valid counts, against their plain
           twins with the float64 row check on every row; B = 1 must equal
           the unbatched entry point bit for bit. Also nn1 at the loop
           association shape (8 x 4096 queries flattened against one 4096-row
           target). Timed as the kernel phase. Then gicp_kernels' gates at
           the loop's B = 8 x 4096 (loop_methods' frames and guesses), the
           fused and linearize forms timed there.
   floor   FloorDetector on the 8 keyframe clouds: the card's clipped cloud
           against the CPU's, RANSAC card against CPU through
           fit_plane_from_triplets with the same triplets (the same inlier
           count, coefficients within 1e-5), each floor within 1 degree of
           vertical and 0.05 m of the 1.8 m sensor height; RANSAC's
           (4096, 3) x (3, 1024) fp32 product and its whole scoring timed
           beside their bounds (fit_plane_bounds).
   loop_methods  the loop detector's batched match with FAST_GICP (the
           launch default), FAST_VGICP and ICP: golden_town frame 300 and 8
           candidate frames around it,
           _match_batched against _match_sequential on the card (transforms
           within 1e-4 m, the same flags), a repeat bit for bit, the batch of
           one bit for bit the unbatched align; ms, host syncs and device
           operations a match.
7. graph   the port's dense LM pose-graph optimize on a golden-sized
           synthetic graph (94 poses, 2 laps, 12 loop edges) in float64 on
           the card against the same code on the CPU; ms per iteration on
           both and the device operations per iteration (profiled). Then
           linear_solver "pcg" and "schur" (graph_solvers) on a 20-pose
           chain with a floor plane and on the golden-sized ring with the
           floor plane as a landmark: card against CPU (1e-6 m) and against
           the dense solve (1e-5 m), a repeat bit for bit. Then the
           replayed solve (CUDA graphs, graph/solver.py) against the eager
           loop on the golden-sized ring (dense) and on it with the floor
           landmark (dense and Schur), 60 iterations: poses, planes, lam,
           iterations and the chi2s bit for bit; ms an iteration of each,
           in turns after a warm-up, the first (capturing) solve's seconds,
           the graphs captured and the host syncs a solve of each.
8. slam    golden_town "base" through SlamPipeline.run_windowed on the
           card: all 601 frames, keyframes, loop edges, ATE (optimized and
           odometry keyframes, Umeyama-aligned as golden_town.py:179-180),
           det/orth error, fps, the host wall of the odometry windows, the
           optimize cycles and, within them, loop detection, information
           matrices and the graph solve (the script wraps those methods), the
           host syncs per optimize cycle, kernel launches on the path and the
           peak device memory. Gates: det/orth < 1e-4 on every odometry pose,
           >= 2 loop edges, optimized ATE below the odometry keyframes' ATE.
           Then slam_profile: torch.profiler over one odometry stretch (16
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
   imu     the imu preset (NDT_OMP at 10 m cells, deskewing, the IMU
           frontend; core/config.py preset_imu) through SlamPipeline.run's
           per-frame path at the CLI's 16384 rows over golden_town's first
           100 frames, each after an IMU message built from the truth
           (utils/course.py golden_town_imu). Gates: every frame, det/orth <
           1e-4, the odometry ATE within a slack of the JAX package's on the
           same frames and messages (tools/cli_witness.py), every kernel of
           the path launched.
11. cli    the offline CLI as a user runs it: golden_town's 601 raw scans
           written as a KITTI sequence (float32 (N, 4) bins, times.txt with
           the stamps float(i), a truth poses file), then ``python -m
           hdl_graph_slam_tpu_torch.run --kitti ... --preset outdoor
           --cloud-capacity 16384`` (the preset's 0.1 m voxels overflow 4096
           rows, CLI_CLOUD_CAPACITY) with every output (trajectories, map,
           dump, graph JSON, trace) in a child process on the card (through
           runpy, as -m runs a module, so that it can hand its kernel launch
           counts back). Gates: 601 frames; optimized ATE below the odometry
           keyframes' ATE, both from the TUM files against the truth;
           >= 2 loop edges and floor edges >= 0.9 x keyframes (graph JSON);
           det/orth < 1e-4 on every dumped pose; a non-empty map of distinct
           0.05 m voxel centres; every kernel of the path launched.
12. persistence  that dump loaded on the card and on the CPU (the same
           keyframes, node ids, stamps and edges; poses within the dump's
           %.9g text), the map generated from it card against CPU, through
           the one-capacity against the per-snapshot path, and against the
           CLI's own map: voxels may differ only on both sides of a face that
           some point lies on within float32 rounding (judged in float64 from
           the same float32 pose and point); a re-dump's graph.g2o byte-
           identical; run_windowed(overlap_backend=True) against the
           synchronous run over 48 frames (odometry within 1e-6 m, final
           poses within 1e-2 m), the wall time of both.
12b. parallel  parallel/ on that dump's graph (185 keyframes, 14 loop
           edges, a floor edge a keyframe, no anchor: the outdoor preset does
           not fix the first node) reset to its odometry chain: (a) the dense
           LM (512 iterations) card and CPU; (b) hierarchical_optimize
           (blocks of 64, 2 rounds) card and CPU: card vs CPU 1e-6 m, ATE
           below the odometry's and <= 1.5 x dense + 0.05 m, chi2 not above
           the start's; (c) distributed_optimize on make_mesh() (1e-9 m from
           (a)) and on 4 entries of cuda:0 (1e-6 m, chi2 1e-9); (d)
           distributed_optimize_multihost in child processes, two gloo ranks
           on cuda:0 (bit-identical ranks, 1e-5 m, chi2 1e-6) and one NCCL
           rank (1e-9 m); (e) run_windowed over golden_town's first 64
           frames (floor) dense, submap_block_size 8 and distributed: the
           same keyframes, distributed 1e-6 m from dense, submap ATE <= 1.5
           x dense + 0.05 m and its chi2 below the odometry chain's (no
           route beats the odometry's ATE before the first loop closure);
           (f) sharded_candidate_align of loop_methods' 8 GICP candidates:
           one entry bit for bit the batched align, 4 entries of cuda:0
           within 1e-4 m. ms and ms per LM iteration in each row.
13. The kernels line (every kernel entry point, with the cli path's
   launches; the NDT kernels with ndt_main's and imu's, ndt_associate
   also with vgicp_main's and its K = 1 shape, knn_select k = 8 with
   ndt_kdtree's; nn1, knn_select and the batched kernels with the VGICP,
   ICP and loop paths; gicp_associate_linearize (the fused form, the
   associate-only form beside it) and gicp_linearize (the cost form beside
   it) with every path's launches, the VGICP gate and the loop's batch), the
   card's name and power limit, then the last line
   {"ok": true, "device": {...}}.

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
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Optional

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
# radius_count at the cli and imu paths' 16384 rows: golden_town frame
# RADIUS_FRAME through each preset's prefilter up to its voxel downsample
RADIUS_FRAME = 1
RADIUS_PRESETS = ("outdoor", "imu")
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
# NDT (registration/ndt.py, csrc/ndt.cu): the cells of benchmarks/
# r3_method_window.py's NDT row (2.0 m) and of the imu preset (10 m)
NDT_RESOLUTIONS = (2.0, 10.0)
NDT_TRIALS = 10  # ndt.align's num_line_search
# the ndt_kernels poses: the first is the source's pose, all three the batch
NDT_TWISTS = ((0.3, -0.1, 0.02, 0.002, -0.003, 0.01), (0.1, 0.05, 0.0, 0.0, 0.0, -0.02),
              (-0.2, 0.0, 0.05, 0.004, 0.0, 0.0))
# g and H, kernel vs plain on the same association: block-order float32
# partials summed in float64 against one float32 einsum sum, of the largest
# |entry| (the rotation block is ~r_max^2 times the translation block)
NDT_DERIV_TOL = 1e-4
NDT_SCORE_RTOL = 1e-5
# fp32 operations the functions need, per found (point, cell) pair and per
# valid point, in their least form (the bound's work; csrc/ndt.cu's pair
# grid repeats the per-point part for each pair): the derivatives' q, B q,
# q.a, exp and four moments (67) and the point's block algebra and transform
# (190); the score's q, B q, q.a and exp (28) and its transform (18)
NDT_DERIV_OPS_PER_PAIR, NDT_DERIV_OPS_PER_POINT = 67, 190
NDT_SCORE_OPS_PER_PAIR, NDT_SCORE_OPS_PER_POINT = 28, 18
# registration/ndt.py wrappers: the kernels line's name -> the wrapper that counts its launches
NDT_COUNTERS = {"associate": "associate_cells", "derivatives": "derivatives", "trial_scores": "trial_scores"}
# benchmarks/r3_method_window.py:46-54, the NDT row
NDT_MAIN_REG = dict(registration_method="NDT_OMP", reg_resolution=2.0, reg_nn_search_method="DIRECT7",
                    reg_reassoc_displacement=0.5)
NDT_KDTREE_FRAMES = 32  # the KDTREE path (knn_select k = 8): the first bench frames
# over 32 frames the first frames' transient (both modes start short of the
# drive) outweighs 3% of it, so KDTREE is held to DIRECT7's position at the
# same frame instead: tests/test_registration.py TestNdtKdtreeMode's 0.1 m
# between the two modes
NDT_KDTREE_VS_DIRECT7_M = 0.1
IMU_FRAMES = 100  # the imu phase: golden_town's first frames
IMU_CLOUD_CAPACITY = 16384  # the CLI's default --cloud-capacity
IMU_REQUIRED = ("ndt_associate", "ndt_derivatives", "ndt_trial_scores", "radius_count", "nn1_batched")
# tools/cli_witness.py imu_feed (--frames 100): the JAX package's
# odometry-keyframe ATE over the same frames and IMU messages on the CPU.
# The port on the CPU gave 8.3240 m there, its poses at most 0.012 m from
# JAX's: a rounding-level pose difference moves DIRECT7 face points to
# another cell, and the chained frames drift apart within the Newton loop's
# 0.01 step tolerance (tests/test_torch_ndt.py). The card may exceed JAX's
# ATE by 0.05 m, four times that largest pose difference.
IMU_JAX_ATE_ODOM_M = 8.325281271492258
IMU_ATE_SLACK_M = 0.05
# FAST_VGICP and ICP (registration/vgicp.py, icp.py): benchmarks/
# r3_method_window.py:51,53's rows, with bench_configs()'s prefilter
VGICP_MAIN_REG = dict(registration_method="FAST_VGICP", reg_resolution=1.0)
ICP_MAIN_REG = dict(registration_method="ICP")
ICP_RECIPROCAL_FRAMES = 32
# tools/method_witness.py --frames 64 (JAX_PLATFORMS=cpu): the JAX
# package's window on the CPU over the bench course's first 64 frames, the
# x of frame 64 and the share converged. The port on the CPU gave VGICP
# 5.138615608 (4.8e-7 from JAX's), its poses within 6.9e-4 of JAX's over
# the prefix, so the card is held to 2e-3 (the cut-cloud windows'
# tolerance, tests/test_torch_window.py). ICP: 4.739522457 (1.7e-4 from
# JAX's), poses within 9.1e-3 (ICP stops at steps below 0.01, and on this
# straight street its x swings by up to 1 m frame to frame, the chain
# compounding where each frame stops); the card is held to 0.05 m, about
# five times that, and to JAX's converged share within 0.05.
VGICP_WITNESS = dict(prefix=64, jax_x=5.13861608505249, x_atol=2e-3)
ICP_WITNESS = dict(prefix=64, jax_x=4.739689826965332, x_atol=0.05, jax_converged_fraction=1.0, converged_atol=0.05)
# --reciprocal-frames 32: JAX 3.306628942489624, the port on the CPU
# 3.302157402 (4.5e-3 apart), poses within 0.0496 of each other (the back
# query drops pairs at its nearest-neighbour ties, where a last bit decides);
# the card is held to 0.25 m, five times that
ICP_RECIPROCAL_WITNESS = dict(prefix=ICP_RECIPROCAL_FRAMES, jax_x=3.306628942489624, x_atol=0.25,
                              jax_converged_fraction=1.0, converged_atol=0.05)
# the port's kernels profile_frames reports by name (the odometry paths' kernels)
PORT_KERNEL_NAMES = ("nn1_kernel", "knn_select_kernel", "gicp_step_kernel", "ndt_associate_kernel")
# main: the frames traced for its host syncs and device operations a frame
MAIN_TRACED_FRAMES = 16
# slam_profile: golden_town frames traced through run_windowed, one window
# of GOLDEN_WINDOW and its optimize cycle (the profiler's own cost is most
# of the phase, and the run must stay inside its time limit on a slower
# host)
SLAM_PROFILE_FRAMES = 16
# ICP frames of ~4500 device operations each: 4 traced frames, not 16 (the
# profiler's own cost, ~2.5 s a frame, is the phase's largest part)
ICP_TRACED_FRAMES = 4
# icp_main's frames: its gates read frame 64 (ICP_WITNESS); fewer than the
# bench's 256 keep the run inside its time limit on a slower host
ICP_MAIN_FRAMES = 128
# vgicp_kernels, preprocess_target card vs CPU on one cloud: voxel sums in
# row order on both (float32, rounding only); every voxel covariance within
# test_torch_gicp.py's every-row bound on the point covariances (their
# closed-form eigenvectors amplify the float32 rounding of the k = 20 sums
# by 1/gap; the share within 1e-4 is reported beside it)
VGICP_MEAN_ATOL_M = 1e-5
VGICP_COV_ATOL = 1e-3
# GICP (registration/gicp.py, csrc/gicp.cu): the launch default's
# correspondence gate (RegistrationConfig.reg_max_correspondence_distance)
GICP_MAX_CORR_M = 2.5
# of the largest |entry|: Mw against the plain twin (the kernel rounds each
# product and sum as the plain twin's elementwise ops do, so 0 is expected;
# the bar is the CPU tests' against the JAX package); H, b and the cost
# against the plain twin in float64 on the same inputs (block-order float32
# partials summed in float64, as NDT_DERIV_TOL; near an optimum b is a small
# sum of large terms, and gating against the plain float32 twin would read
# that twin's own rounding of the moved points)
GICP_MW_TOL = 1e-5
GICP_LIN_TOL = 1e-4
# fp32 operations the functions need: per row of the association (R C,
# (R C) R^T + C_tgt, the adjugate and determinant, the reciprocal, the
# scaling by 1 / det and the gate: 152 + 3), per valid row of the
# linearization (transform 18, e 3, M e 18, cost 7, b 15, M S 27, S M S
# 24, the 21 H sums and 9 signs 30) and of the cost alone (transform, e,
# M e, cost)
GICP_ASSOC_OPS_PER_ROW, GICP_LIN_OPS_PER_ROW, GICP_COST_OPS_PER_ROW = 155, 142, 46
# registration/gicp.py wrappers: the launches' name -> the wrapper that counts
# them (each a form of gicp_step_kernel)
GICP_COUNTERS = {"gicp_associate_linearize": "associate_linearize", "gicp_associate": "associate",
                 "gicp_linearize": "linearize", "gicp_cost": "cost"}
# the GICP forms the gated LM loop launches (main, the golden_town runs) and
# the ungated one (vgicp_main, the cli's outdoor preset)
GICP_GATED, GICP_UNGATED = ("gicp_associate_linearize", "gicp_linearize"), ("gicp_associate_linearize", "gicp_cost")
# loop_methods: golden_town frame 300 and 8 frames around it (1.2 m apart)
LOOP_TARGET_FRAME = 300
LOOP_CANDIDATE_OFFSETS = (-12, -9, -6, -3, 3, 6, 9, 12)
LOOP_MATCH_ATOL_M = 1e-4
# the loop_methods phase's matchers: the launch default (the golden config's
# loop registration as it is), then VGICP and ICP
LOOP_METHODS = ("FAST_GICP", "FAST_VGICP", "ICP")
# graph: PCG and Schur against the dense solve (tests/test_graph.py)
GRAPH_SOLVER_VS_DENSE_M = 1e-5
# PCG on the golden-sized ring, not gated against the CPU and the dense
# solve (its CG does not converge there): LM iterations of its run
GRAPH_RING_PCG_ITERATIONS = 8


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase row also gets ``at_s``, the seconds since the
    script started."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - T0)
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


def main_path(scans, odo_cfg=None) -> tuple:
    """The main path as bench.py drives it, on cuda: an OdometryWindow that
    filters to N_KERNEL rows, the first scan's cloud for its initial state,
    and the other scans stacked at the raw capacity with 0.1 s stamps; with
    ``odo_cfg`` instead of bench.py's odometry config if given.
    Returns (win, first, xyz, mask, stamps)."""
    import torch
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.frontend import OdometryWindow
    from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_RAW_CAPACITY

    pf_cfg, bench_odo = bench_configs()
    win = OdometryWindow(odo_cfg or bench_odo, prefilter_cfg=pf_cfg, out_capacity=N_KERNEL, device="cuda")
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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        win.run(state0, xyz[:n], mask[:n], stamps[:n])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    def dev_us(k):
        return getattr(k, "self_device_time_total", None) or getattr(k, "self_cuda_time_total", 0.0)
    averages = [k for k in prof.key_averages() if dev_us(k) > 0]
    top = sorted(averages, key=dev_us, reverse=True)[:12]
    port = [k for k in averages if any(name in k.key for name in PORT_KERNEL_NAMES)]
    return dict(phase="profile", frames=n, wall_s=wall, device_busy_s=busy * 1e-6,
                device_busy_ms_per_frame=busy * 1e-3 / n,
                device_idle_share_profiled=1.0 - busy * 1e-6 / wall,
                device_idle_share_unprofiled=1.0 - busy * 1e-6 / n / main_s_per_frame,
                device_ops_per_frame=len(spans) / n,
                top_device=[dict(name=k.key[:80], calls=k.count, total_ms=dev_us(k) * 1e-3,
                                 mean_us=dev_us(k) / max(k.count, 1)) for k in top],
                port_kernels=[dict(name=k.key[:80], calls=k.count, total_ms=dev_us(k) * 1e-3,
                                   mean_us=dev_us(k) / max(k.count, 1)) for k in port])


def device_events(prof) -> list:
    """The device operations of a torch.profiler run (kernels, copies, sets)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def graph_ops_per_call(fn, calls: int = 10):
    """(operations per call of fn, {CUgraphNodeType: nodes}) counted a way
    torch.profiler does not share: ``calls`` calls captured into one CUDA
    graph on a side stream (after a warm-up call there, so that the
    kernels' workspaces of that stream exist), its nodes counted with the
    libcuda's cuGraphGetNodes. Every kernel, copy and set the calls enqueue
    is a node, and a host read or a launch on another stream fails the
    capture. None where this torch keeps no captured graph or the capture
    fails."""
    import ctypes

    import torch

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except (TypeError, RuntimeError):  # an older torch; no CUDA
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(side):
            fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
        cu = ctypes.CDLL("libcuda.so.1")
        count = ctypes.c_size_t(0)
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
            return None
        nodes = (ctypes.c_void_p * max(count.value, 1))()
        if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
            return None
        types = {}
        for k in range(count.value):
            kind = ctypes.c_int(-1)
            cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[k]), ctypes.byref(kind))
            types[kind.value] = types.get(kind.value, 0) + 1
        return count.value / calls, types
    except Exception:  # noqa: BLE001  (a failed capture is no count)
        return None
    finally:
        graph.reset()
        torch.cuda.synchronize()


def device_ops_per_call(fn, calls: int = 10, pad_s: float = 0.05, tries: int = 8) -> tuple:
    """(device operations per call of fn, their names): torch.profiler over
    ``calls`` calls after a warm-up call (profile_frames' count). The window
    is padded with ``pad_s`` seconds of idle host on both sides, and a trace
    that holds fewer device events than calls is taken again, up to
    ``tries`` times, its pads doubled each time (at most 0.8 s): late in a
    long process, traces of a few microseconds were seen to come back
    without some or all of the device events of the calls they held (a
    call that launches nothing is not a case to time). When every trace
    comes back short, the calls are counted again by CUDA graph capture
    (graph_ops_per_call), and that count is returned where it is a whole
    number of kernel nodes a call; the names stay the traces'. Both counts
    are emitted as a ``device_ops`` row, the record of what the profiler
    lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        pad = min(pad_s * 2 ** attempt, 0.8)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = device_events(prof)
        if len(events) >= calls:
            break
    per, names = len(events) / calls, sorted({e.name[:80] for e in events})
    if len(events) < calls:
        graph = graph_ops_per_call(fn, calls)
        emit(dict(phase="device_ops", traces=tries, profiler_ops_per_call=per, names=names,
                  graph_ops_per_call=None if graph is None else graph[0],
                  graph_node_types=None if graph is None else {str(k): v for k, v in graph[1].items()}))
        if graph is not None and graph[0] >= 1 and graph[0] == int(graph[0]) and set(graph[1]) == {0}:
            per = graph[0]
    return per, names


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


_BENCH = None


def _bench_scan(i: int) -> np.ndarray:
    """Ray-cast bench course frame i (a process-pool worker): make_course's
    scan i."""
    global _BENCH
    if _BENCH is None:
        sys.path.insert(0, HERE)
        from hdl_graph_slam_tpu_torch.utils import course, lidar_sim

        _BENCH = (*course.bench_course_scene(SEED), course.bench_course_poses(course.BENCH_FRAMES, course.BENCH_STEP,
                                                                              SEED), lidar_sim)
    town, model, poses, lidar_sim = _BENCH
    return lidar_sim.scan(town, poses[i], model, seed=100000 * SEED + i)


def bench_scans(n: int, workers: int) -> list:
    """make_course(n)'s n + 1 scans (n <= BENCH_FRAMES), cast in ``workers``
    spawned processes."""
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_bench_scan, range(n + 1), chunksize=8))


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


def synthetic_graph(seed: int = 0, floor: bool = False):
    """A golden_town-sized pose graph (port GraphBuilder): an anchor, 94
    poses on two laps of a 35 m circle with noisy odometry edges
    (information 100), 12 lap-2 -> lap-1 loop edges (information 400,
    Huber), numpy noise from ``seed``; with ``floor``, also the floor
    plane 1.8 m below the poses (z = -1.8) as a landmark seen from every
    pose through se3_plane edges (information 10, noise 0.01), as
    HdlGraphSlam adds them (hdl_graph_slam_nodelet.cpp:490-498)."""
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
    if floor:
        plane = g.add_plane_node([0.0, 0.0, 1.0, 1.8])
        for k in range(n):
            n_local = pose(k)[:3, :3].T @ np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.01, 3)
            n_local /= np.linalg.norm(n_local)
            g.add_se3_plane_edge(ids[k], plane, np.concatenate([n_local, [1.8 + rng.normal(0.0, 0.01)]]),
                                 np.eye(3) * 10.0)
    return g


def chain_graph(seed: int = 11):
    """tests/test_graph.py TestPcgSolver's graph (port GraphBuilder): 20
    poses 1 m apart, the first fixed, noisy odometry edges (information
    50) and one loop edge (information 100), with the floor plane of
    synthetic_graph(floor=True) seen from every pose. Jacobi-preconditioned
    CG resolves it within its 250 iterations; the golden-sized ring of
    synthetic_graph, whose bending modes leave its damped H near 1e-6 at
    the bottom of the spectrum, it does not."""
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.graph import GraphBuilder
    import torch

    rng = np.random.default_rng(seed)
    g = GraphBuilder()
    ids = [g.add_se3_node(np.eye(4), fixed=True)]
    est = np.eye(4)
    for k in range(1, 20):
        rel = np.eye(4)
        rel[0, 3] = 1.0
        twist = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)])
        rel_noisy = rel @ se3.se3_exp(torch.from_numpy(twist)).numpy()
        est = est @ rel_noisy
        ids.append(g.add_se3_node(est))
        g.add_se3_edge(ids[k], ids[k - 1], np.linalg.inv(rel_noisy), np.eye(6) * 50.0)
    loop = np.eye(4)
    loop[0, 3] = 19.0
    g.add_se3_edge(ids[-1], ids[0], np.linalg.inv(loop), np.eye(6) * 100.0)
    plane = g.add_plane_node([0.0, 0.0, 1.0, 1.8])
    for i in ids:
        n_local = np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.01, 3)
        g.add_se3_plane_edge(i, plane, np.concatenate([n_local / np.linalg.norm(n_local), [1.8]]), np.eye(3) * 10.0)
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


def count_host_syncs(fn) -> tuple:
    """(fn's result, the host syncs it made: torch.cuda's sync debug warnings)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


class StageClock:
    """Host wall time of wrapped methods (the script's instrumentation, apart
    from the program's own tracer, which stays off): totals and calls a key.
    A wrapper marks its span for the profiler, optionally synchronises the
    card at its end, and optionally counts the host syncs made inside it
    (torch.cuda sync debug mode)."""

    def __init__(self):
        self.totals = defaultdict(float)  # key -> seconds
        self.counts = defaultdict(int)  # key -> calls
        self.syncs = []
        self.results = defaultdict(list)  # key -> return values kept by keep_result wrappers
        self._undo = []

    def wrap(self, owner, attr: str, key: str, sync: bool = False, count_syncs: bool = False,
             keep_result: bool = False):
        import torch

        orig = getattr(owner, attr)
        clock = self

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"slam/{key}"):
                if count_syncs:
                    out, syncs = count_host_syncs(lambda: orig(*args, **kwargs))
                    clock.syncs.append(syncs)
                else:
                    out = orig(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                if keep_result:
                    clock.results[key].append(out)
            clock.totals[key] += time.perf_counter() - t0
            clock.counts[key] += 1
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


def golden_cloud(scan, device: str = "cuda"):
    """A raw golden_town scan prefiltered as the slam phase does: the base
    config's prefilter at GOLDEN_CLOUD_CAPACITY rows."""
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.frontend import Prefilter
    from hdl_graph_slam_tpu_torch.utils import course

    pf = Prefilter(course.golden_town_config().prefilter, out_capacity=course.GOLDEN_CLOUD_CAPACITY, device=device)
    return pf(cloudlib.from_numpy(scan, capacity=course.GOLDEN_RAW_CAPACITY, device=device))


def golden_keyframes(golden) -> tuple:
    """GOLDEN_B golden_town frames spread over the course (0 to 597) and the
    frames 3 after them, prefiltered on the card as the slam phase does:
    (frame indices, their clouds, the later frames' clouds)."""
    frames = np.linspace(0, len(golden["scans"]) - 4, GOLDEN_B).round().astype(int)
    return (frames, [golden_cloud(golden["scans"][i]) for i in frames],
            [golden_cloud(golden["scans"][i + 3]) for i in frames])


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
    from torch.profiler import ProfilerActivity, profile
    from hdl_graph_slam_tpu_torch.graph import optimize

    g = synthetic_graph(0)
    # device operations per LM iteration: a 2-iteration solve minus a
    # 1-iteration one (these solves also warm both paths up before timing),
    # both replaying the graphs a first solve captured
    optimize(g.freeze(dtype=torch.float64, device="cuda"), max_iterations=1)
    ops = []
    for its in (1, 2):
        data = g.freeze(dtype=torch.float64, device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            optimize(data, max_iterations=its)
            torch.cuda.synchronize()
        ops.append(len(device_events(prof)))
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
    graph_solvers()
    graph_replay()


def graph_solvers() -> None:
    """linear_solver "pcg" and "schur" in float64, each on the card and the
    CPU, on chain_graph() and on synthetic_graph(0, floor=True) (a
    golden-sized ring with the floor plane a landmark and its se3_plane
    edges). Gates: the card against the CPU (poses within GRAPH_POSE_ATOL)
    and against the card's dense solve (GRAPH_SOLVER_VS_DENSE_M), a repeat
    on the card bit for bit (PCG's products scatter-add through
    index_put_'s accumulation), chi2 lowered. On the ring PCG's 250 Jacobi
    CG iterations do not resolve the bending modes, so there it is gated on
    the repeat and chi2 alone, its distances to the CPU and the dense solve
    reported. ms per LM iteration and host syncs a solve."""
    import torch
    from hdl_graph_slam_tpu_torch.graph import linearize, optimize

    for name, g in (("chain", chain_graph()), ("golden_floor", synthetic_graph(0, floor=True))):
        dense, _ = optimize(g.freeze(dtype=torch.float64, device="cuda"), max_iterations=60)
        dense_poses = dense.poses.cpu().numpy()
        # the spectrum of the free-dof H at the start (CPU, float64): what CG's iterations face
        data = g.freeze(dtype=torch.float64, device="cpu")
        H, _, _, _ = linearize.build_system(data)
        free_f = linearize.free_dof_mask(data).double()
        eig = torch.linalg.eigvalsh(H * free_f[:, None] * free_f[None, :] + torch.diag(1.0 - free_f))
        spectrum = dict(h_min_eig=float(eig.min()), h_max_eig=float(eig.max()))
        for solver in ("pcg", "schur"):
            optimize(g.freeze(dtype=torch.float64, device="cuda"), max_iterations=1, linear_solver=solver)  # warm-up
            gated = not (name == "golden_floor" and solver == "pcg")
            its = 60 if gated else GRAPH_RING_PCG_ITERATIONS

            def solve(dev):
                data = g.freeze(dtype=torch.float64, device=dev)
                t0 = time.perf_counter()
                out, st = optimize(data, max_iterations=its, linear_solver=solver)
                return out.poses.cpu().numpy(), out.planes.cpu().numpy(), st, time.perf_counter() - t0

            pc, lc, sc, tc = solve("cuda")
            (pc2, lc2, _, _), syncs = count_host_syncs(lambda: solve("cuda"))  # the repeat, its host syncs
            pp, lp, sp, tp = solve("cpu")
            row = dict(phase="graph", graph=name, solver=solver, poses=len(g.poses), planes=len(g.planes),
                       edges=g.num_edges, iterations_cuda=int(sc.iterations), iterations_cpu=int(sp.iterations),
                       chi2_before=float(sc.chi2_robust_before), chi2_after_cuda=float(sc.chi2_robust_after),
                       chi2_after_cpu=float(sp.chi2_robust_after), pose_max_abs_err=float(np.abs(pc - pp).max()),
                       plane_max_abs_err=float(np.abs(lc - lp).max()),
                       vs_dense_max_abs_err=float(np.abs(pc - dense_poses).max()),
                       repeat_identical=bool(np.array_equal(pc, pc2) and np.array_equal(lc, lc2)),
                       seconds_cuda=tc, seconds_cpu=tp, ms_per_iteration_cuda=1e3 * tc / max(int(sc.iterations), 1),
                       host_syncs_per_solve=syncs, gated_against_cpu_and_dense=gated, **spectrum,
                       pose_atol=GRAPH_POSE_ATOL,
                       vs_dense_atol=GRAPH_SOLVER_VS_DENSE_M)
            emit(row)
            what = f"graph {name} {solver}"
            if gated:
                require(row["pose_max_abs_err"] <= GRAPH_POSE_ATOL, f"{what}: card vs CPU poses: {row}")
                require(row["vs_dense_max_abs_err"] <= GRAPH_SOLVER_VS_DENSE_M, f"{what}: vs the dense solve: {row}")
            require(row["repeat_identical"], f"{what}: a repeat on the card differs")
            require(row["chi2_after_cuda"] < row["chi2_before"], f"{what}: the solve did not lower chi2")


def graph_replay(iterations: int = 60, rounds: int = 2) -> None:
    """The replayed pose-graph solve against the eager loop on the card:
    each graph and solver solved first through optimize's replayed path
    (its graphs captured), then by turns eager, replayed, replayed, eager
    (``rounds`` times), every solve from the same frozen graph. Gates: each
    replayed solve equal to the eager one bit for bit (poses, planes, lam,
    iterations, the four chi2s), every pass of a replayed solve replayed."""
    import torch
    from hdl_graph_slam_tpu_torch.graph import solver
    from hdl_graph_slam_tpu_torch.graph.linearize import Linearizer

    class EagerLinearizer(Linearizer):
        capturable = False  # the same sums, launched pass by pass

    for name, g, linear_solver in (("golden", synthetic_graph(0), "dense"),
                                   ("golden_floor", synthetic_graph(0, floor=True), "dense"),
                                   ("golden_floor", synthetic_graph(0, floor=True), "schur")):
        data = g.freeze(dtype=torch.float64, device="cuda")

        def solve(lin):
            torch.cuda.synchronize()
            replayed, t0 = solver.GRAPHS.replayed, time.perf_counter()
            out, st = solver.optimize(data, max_iterations=iterations, linear_solver=linear_solver, linearizer=lin)
            got = (out.poses.cpu().numpy(), out.planes.cpu().numpy(), [float(x) for x in st])
            return got, time.perf_counter() - t0, solver.GRAPHS.replayed - replayed

        captures = solver.GRAPHS.captures
        first, first_s, _ = solve(None)
        captures = solver.GRAPHS.captures - captures
        eager, _, _ = solve(EagerLinearizer())  # warm-up

        def same(got):
            return all(np.array_equal(a, b) for a, b in zip(got[:2], eager[:2])) and got[2] == eager[2]

        times = {"replayed": [], "eager": []}
        identical, replayed_passes = [same(first)], []
        for _ in range(rounds):
            for lin in (EagerLinearizer(), None, None, EagerLinearizer()):
                got, sec, passes = solve(lin)
                times["eager" if lin else "replayed"].append(sec)
                if lin is None:
                    replayed_passes.append(passes)
                identical.append(same(got))
        its = int(eager[2][0])
        _, syncs_replayed = count_host_syncs(lambda: solve(None))
        _, syncs_eager = count_host_syncs(lambda: solve(EagerLinearizer()))
        ms = {k: [1e3 * t / max(its, 1) for t in v] for k, v in times.items()}
        row = dict(phase="graph", graph=name, solver=linear_solver, replay_vs_eager=True, dof=data.num_dof,
                   iterations=its, replayed_identical=all(identical), replayed_passes=replayed_passes,
                   ms_per_iteration_replayed=float(np.median(ms["replayed"])),
                   ms_per_iteration_eager=float(np.median(ms["eager"])), ms_replayed=ms["replayed"],
                   ms_eager=ms["eager"], first_solve_s=first_s, captures=captures,
                   host_syncs_per_solve_replayed=syncs_replayed, host_syncs_per_solve_eager=syncs_eager)
        emit(row)
        require(row["replayed_identical"], f"graph {name} {linear_solver}: the replayed solve differs from the eager")
        require(all(p >= its for p in replayed_passes), f"graph {name} {linear_solver}: passes ran eager: {row}")


def slam_profile(pipe, frames) -> None:
    """Device busy time and idle share of the slam path's stages, each
    traced on its own with torch.profiler: SLAM_PROFILE_FRAMES frames of a fresh pipeline
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
            fresh.run_windowed(frames[:SLAM_PROFILE_FRAMES], window=course.GOLDEN_WINDOW,
                               raw_capacity=course.GOLDEN_RAW_CAPACITY)
            torch.cuda.synchronize()
    finally:
        clock.restore()
    busy, wall = device_busy(prof)
    out["first_frames"] = dict(frames=SLAM_PROFILE_FRAMES, device_busy_s=busy, wall_s=wall,
                               device_idle_share=1.0 - busy / wall, top_device=top_device(prof, 10))
    for key in ("odometry_window", "optimize_cycle", "graph_solve"):
        b, w = device_busy(prof, {f"slam/{key}"})
        out["first_frames"][key] = dict(device_busy_s=b, wall_s=w, device_idle_share=(1.0 - b / w) if w else None)

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
    exact) every row, and the kernel equal to its plain twin bit for bit.
    The kernel called again gives the same bits, and the tile pairs it
    tested (radius_count_tiles) are those ops/knn.py radius_tile_plan
    names, in full and against one point. With every lane computing its
    tiles' boxes itself (``own_boxes``, the path a lane takes when a tile's
    stamp does not come) the kernel tests the same tile pairs and gives the
    same bits."""
    import torch

    c_k = knn.radius_count(q, t, r)
    c_p = knn.radius_count_plain(q, t, r)
    tiles = knn.radius_count_tiles(q, t, r)
    own = knn.radius_count_tiles(q, t, r, own_boxes=True)
    plan = knn.radius_tile_plan(q, t, r)
    again = knn.radius_count(q, t, r)
    torch.cuda.synchronize()
    exact, near = exact_radius_counts(q, t, r)
    judged = rows if exact_ties else rows & ~near
    planned = dict(full=int((plan == 2).sum()), point=int((plan == 1).sum()))
    row = dict(kernel="radius_count", case=what, n=q.shape[0], m=t.shape[0], r=r, valid=int(rows.sum()),
               rows_near_r=int((rows & near).sum()), rows_judged=int(judged.sum()),
               rows_off_float64=int(((c_k.long() != exact) & judged).sum()),
               plain_rows_off_float64=int(((c_p.long() != exact) & judged).sum()),
               idx_identical=bool(torch.equal(c_k, c_p)), max_abs_err=int((c_k - c_p)[rows].abs().max()),
               mean_count=float(c_k[rows].double().mean()), repeat_identical=bool(torch.equal(again, c_k)),
               stats_call_identical=bool(torch.equal(tiles["counts"], c_k)),
               own_boxes_identical=bool(torch.equal(own["counts"], c_k)) and (own["full"], own["point"]) == (
                   tiles["full"], tiles["point"]),
               tile_pairs=tiles["tile_pairs"], tiles_full=tiles["full"], tiles_point=tiles["point"],
               wait_expired=tiles["wait_expired"],
               tiles_planned=planned, tested_share=(tiles["full"] + tiles["point"]) / tiles["tile_pairs"],
               full_share=tiles["full"] / tiles["tile_pairs"])
    require(row["rows_off_float64"] == 0, f"radius_count {what}: {row['rows_off_float64']} rows off the float64 count")
    require(row["plain_rows_off_float64"] == 0, f"radius_count_plain {what}: rows off the float64 count")
    require(row["repeat_identical"] and row["stats_call_identical"], f"radius_count {what}: calls differ: {row}")
    require(row["own_boxes_identical"], f"radius_count {what}: the lanes' own boxes give other counts or tile pairs")
    require((row["tiles_full"], row["tiles_point"]) == (planned["full"], planned["point"]),
            f"radius_count {what}: tested tile pairs {row['tiles_full']}, {row['tiles_point']} vs the rule's {planned}")
    if exact_ties:
        require(row["idx_identical"], f"radius_count {what}: differs from the plain twin on exact distances")
    return row


def radius_bounds(row: dict, peak_flops: float) -> dict:
    """radius_count's bound on this run's inputs: the operations of the pairs
    the kernel tested (each full tile pair's 32 x 32, each point test's 32)
    against reading both clouds once and writing the counts (``bound_ms``).
    The same over every valid pair (``valid_pairs_bound_ms``) counts pairs
    that tile skipping shows the function need not test, so it is no bound
    on the kernel: it stands beside the other for comparison."""
    bytes_s = (row["n"] * 12 + row["m"] * 12 + row["n"] * 4) / HBM_BYTES_PER_S

    def bound(pairs):
        ops_s = pairs * RADIUS_OPS_PER_PAIR / peak_flops
        return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"

    valid = row["valid"] ** 2 if row["n"] == row["m"] else row["valid"] * row["m"]
    tested = row["tiles_full"] * 32 * 32 + row["tiles_point"] * 32
    (b, by), (vb, vby) = bound(tested), bound(valid)
    return dict(tested_pairs=tested, bound_ms=b, bound_by=by, valid_pairs=valid, valid_pairs_bound_ms=vb,
                valid_pairs_bound_by=vby)


def radius_frame(scan, preset: str, capacity: int = 16384, device: str = "cuda") -> tuple:
    """What the ``preset``'s RADIUS filter hands radius_count for one raw
    scan at ``capacity`` rows: the preset's prefilter up to its voxel
    downsample (no IMU, the identity base transform), padded rows at
    PAD_COORD. Returns (xyz, valid rows, the preset's radius)."""
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.core.config import PRESETS
    from hdl_graph_slam_tpu_torch.frontend import Prefilter

    cfg = PRESETS[preset]().prefilter
    require(cfg.outlier_removal_method == "RADIUS", f"preset {preset} has no radius filter")
    radius, cfg.outlier_removal_method = cfg.radius_radius, "NONE"
    c = Prefilter(cfg, out_capacity=capacity, device=device)(cloudlib.from_numpy(scan, device=device))
    return c.valid_xyz().contiguous(), c.mask, radius


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


def kernel_filters_phase(knn, scans, bench_clouds, rng, peak_flops: float) -> dict:
    """radius_count and knn_select at k = 10, 21 against their plain twins
    and float64; the outlier masks card against CPU on the two bench clouds
    (statistical: mean_k 20, 1 std; radius: the indoor preset's 0.5 m, 2
    neighbours). ``scans`` are golden_town's first raw scans: frame 0 is
    the golden keyframe (the host path's 4096 rows, golden_cloud), frame
    RADIUS_FRAME the cli and imu paths' 16384 rows (radius_frame).
    radius_count is timed there, with its bounds, and each call must be one
    device operation. Returns the timed rows by kernel entry (radius_count,
    radius_count_16384: {preset: row}, knn_select_k10, knn_select_k21)."""
    import torch

    dev = torch.device("cuda")
    bench_cloud = bench_clouds[0]
    kf = golden_cloud(scans[0])
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
    frames = {f"{p}_frame_16384": radius_frame(scans[RADIUS_FRAME], p) for p in RADIUS_PRESETS}
    radius_cases = {
        "golden_keyframe": (gq, gq, grows, RADIUS_M),
        **{case: (x, x, rows, r) for case, (x, rows, r) in frames.items()},
        "bench": (bq, bq, brows, RADIUS_M),
        "n16384_two_stages": (dense, dense, ones(16384) & (dense.abs() < 1e5).all(-1), RADIUS_M),
        "n1_m20": (uniform(1), uniform(20), ones(1), 60.0),
        "n31_m8192": (uniform(31), uniform(8192), ones(31), 10.0),
        "n8192_m20000_multi_stage": (uniform(8192), uniform(20000), ones(8192), 5.0),
        "all_but_25_padded": (uniform(2048), uniform(8192, 8192 - 25), ones(2048), 40.0),
    }
    timed = {"radius_count_16384": {}}
    for case, (q, t, rows, r) in radius_cases.items():
        row = dict(phase="kernel_filters", **check_radius(knn, q, t, r, rows, case),
                   launch=knn.launch_info("radius_count", q.shape[0], t.shape[0]))
        if case == "golden_keyframe" or case in frames:
            ops, names = device_ops_per_call(lambda: knn.radius_count(q, t, r))
            row.update(time_rows(lambda: knn.radius_count(q, t, r), lambda: knn.radius_count_plain(q, t, r)),
                       **radius_bounds(row, peak_flops), device_ops_per_call=[ops, names])
            require(ops == 1.0 and len(names) == 1 and "radius_count_kernel" in names[0],
                    f"radius_count {case}: a call is not one launch of its kernel: {ops}, {names}")
            if case == "golden_keyframe":
                timed["radius_count"] = row
            else:
                timed["radius_count_16384"][case.split("_")[0]] = row
        emit(row)
    row = dict(phase="kernel_filters", **check_radius(knn, lat, lat, 1.0, ones(lat.shape[0]), "lattice_duplicates",
                                                      exact_ties=True))
    emit(row)
    # 40000 rows on the 4^3 integer lattice (every d^2 exact): every one of
    # a query tile's 1250 target tiles is full, more than the kernel's list
    # holds (1024), so its warps count the rest themselves
    cube = np.random.default_rng(40000).integers(0, 4, (40000, 3)).astype(np.float32)
    cube = torch.from_numpy(cube).to(dev)
    row = dict(phase="kernel_filters", **check_radius(knn, cube, cube, 1.5, ones(cube.shape[0]),
                                                      "n40000_lattice_list_overflow", exact_ties=True),
               launch=knn.launch_info("radius_count", cube.shape[0], cube.shape[0]))
    require(row["tiles_full"] == row["tile_pairs"], f"radius_count n40000_lattice_list_overflow: {row['tiles_full']} "
            f"of {row['tile_pairs']} tile pairs counted in full")
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


# ops/ransac.py fit_plane_from_triplets, per (point, hypothesis): n.p + d
# (3 FMAs, 6 flops), abs, compare, and with the mask, count (4)
FIT_PLANE_OPS_PER_PAIR = 10


def fit_plane_bounds(n: int, k: int, peak_flops: float) -> dict:
    """(bound ms, "bytes" or "operations") of ops/ransac.py's (n, 3) x (3, k)
    fp32 product, which writes its (n, k) field, and of the whole
    fit_plane_from_triplets, which needs only the points, the mask and the k
    int64 triplets read once and the (n,) inlier mask and the plane written
    (FIT_PLANE_OPS_PER_PAIR per pair)."""
    def bound(nbytes, ops):
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / peak_flops
        return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s else "bytes")

    return dict(product=bound(4 * (3 * n + 3 * k + n * k), 6 * n * k),
                function=bound(12 * n + n + 24 * k + n + 4 * 4, FIT_PLANE_OPS_PER_PAIR * n * k))


def floor_phase(keyframes, peak_flops: float) -> dict:
    """FloorDetector on the GOLDEN_B keyframe clouds on the card: the card's
    clipped cloud against the CPU's, RANSAC card against CPU on the same
    triplets, each detected floor against the truth; the detect's time, and
    RANSAC's (N, 3) x (3, K) product and fit_plane_from_triplets at the
    detector's N x K with their bounds (fit_plane_bounds)."""
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
    # the last keyframe's band and triplets at the detector's N x K
    n, k = band.capacity, cfg.ransac_hypotheses
    normals = torch.from_numpy(np.random.default_rng(SEED).normal(size=(k, 3)).astype(np.float32)).cuda()
    nT = torch.nn.functional.normalize(normals, dim=1).T.contiguous()
    tri_gpu = tri.cuda()
    bounds = fit_plane_bounds(n, k, peak_flops)
    row["fit_plane"] = dict(
        shape=f"{n} x 3 x {k} fp32",
        product=dict(kernel_ms=time_ms(lambda: band.xyz @ nT), device_ms=time_ms(lambda: band.xyz @ nT,
                                                                               device_only=True),
                     bound_ms=bounds["product"][0], bound_by=bounds["product"][1]),
        function=dict(kernel_ms=time_ms(lambda: ransac.fit_plane_from_triplets(band, tri_gpu)),
                      device_ms=time_ms(lambda: ransac.fit_plane_from_triplets(band, tri_gpu), device_only=True),
                      bound_ms=bounds["function"][0], bound_by=bounds["function"][1]))
    emit(row)
    return row


LAUNCH_COUNTERS = ("nn1", "knn_select", "nn1_batched", "knn_select_batched", "radius_count")


def _ndt():
    from hdl_graph_slam_tpu_torch.registration import ndt

    return ndt


def _gicp():
    from hdl_graph_slam_tpu_torch.registration import gicp

    return gicp


def reset_launches(knn) -> None:
    for name in LAUNCH_COUNTERS:
        getattr(knn, name).launches = 0
    knn.knn_select.launches_k = dict.fromkeys(knn.KNN_SELECT_KS, 0)
    for attr in NDT_COUNTERS.values():
        getattr(_ndt(), attr).launches = 0
    for attr in GICP_COUNTERS.values():
        getattr(_gicp(), attr).launches = 0


def format_launches(counts: dict, per_k: dict) -> dict:
    """Launches per kernel entry: ``counts`` per counter of LAUNCH_COUNTERS,
    ``ndt_<counter>`` of NDT_COUNTERS and each of GICP_COUNTERS, ``per_k``
    knn_select's per k; the k = 20 (GICP) count goes under the plain name."""
    out = {name: counts[name] for name in LAUNCH_COUNTERS}
    out.update({f"ndt_{name}": counts.get(f"ndt_{name}", 0) for name in NDT_COUNTERS})
    out.update({name: counts.get(name, 0) for name in GICP_COUNTERS})
    out.update({f"knn_select_k{k}": v for k, v in per_k.items() if int(k) != K_NEIGHBOURS})
    out["knn_select"] = {int(k): v for k, v in per_k.items()}[K_NEIGHBOURS]
    return out


def launch_counts(knn) -> dict:
    """The raw counters format_launches reads."""
    counts = {name: getattr(knn, name).launches for name in LAUNCH_COUNTERS}
    counts.update({f"ndt_{name}": getattr(_ndt(), attr).launches for name, attr in NDT_COUNTERS.items()})
    counts.update({name: getattr(_gicp(), attr).launches for name, attr in GICP_COUNTERS.items()})
    return counts


def read_launches(knn) -> dict:
    """Launches per kernel entry since reset_launches."""
    return format_launches(launch_counts(knn), knn.knn_select.launches_k)


def golden_frames(golden, n=None) -> list:
    return [(float(i), x, None) for i, x in enumerate(golden["scans"][:n])]


def run_golden(cfg, frames, per_frame: bool = False, device_odometry: bool = False, overlap_backend: bool = False):
    """A fresh pipeline on the card over golden_town frames: run() (per
    frame) or run_windowed at the golden window and capacities (with its
    optimize cycles on a worker thread if ``overlap_backend``)."""
    import torch
    from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline
    from hdl_graph_slam_tpu_torch.utils import course

    pipe = SlamPipeline(cfg, cloud_capacity=course.GOLDEN_CLOUD_CAPACITY, device_odometry=device_odometry,
                        device="cuda")
    if per_frame:
        result = pipe.run(frames)
    else:
        result = pipe.run_windowed(frames, window=course.GOLDEN_WINDOW, raw_capacity=course.GOLDEN_RAW_CAPACITY,
                                   overlap_backend=overlap_backend)
    torch.cuda.synchronize()
    return pipe, result


def slam_phase(knn, golden, phase: str = "slam", cfg=None, per_frame: bool = False,
               required=("nn1", "knn_select", "nn1_batched", "knn_select_batched") + GICP_GATED) -> dict:
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
    row = dict(
        phase=phase, mode="run (per frame)" if per_frame else "run_windowed", frames=result.num_frames,
        keyframes=n_kf, loop_edges=n_loops, floor_edges=n_floor,
        ate_opt_m=traj_io.ate_rmse(est, ref, align=True), ate_odom_m=traj_io.ate_rmse(odom_kf, ref, align=True),
        det_err=float(np.abs(np.linalg.det(Rs) - 1.0).max()),
        orth_err=float(np.abs(Rs @ np.swapaxes(Rs, 1, 2) - np.eye(3)).max()),
        seconds=wall, fps=result.num_frames / wall,
        host_wall_s=dict(clock.totals), calls=dict(clock.counts),
        host_ms_per_call={k: 1e3 * clock.totals[k] / clock.counts[k] for k in clock.counts if clock.counts[k]},
        host_syncs_per_optimize_cycle=dict(mean=float(np.mean(clock.syncs)), max=int(max(clock.syncs)),
                                           total=int(sum(clock.syncs)), cycles=len(clock.syncs)),
        last_solve_iterations=int(stats.iterations) if stats is not None else None,
        graph_iterations=graph_iterations,
        graph_ms_per_iteration=1e3 * clock.totals["graph_solve"] / max(graph_iterations, 1),
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


# -- NDT: its kernels, the bench course through the NDT window, the imu preset ---------------


def ndt_work(tgt, xyz, mask, T, idx, found, method: str) -> dict:
    """What this run's data asks of the NDT kernels, for their bounds: rows
    n, valid rows, K, the association's grid reads (valid rows' neighbour
    keys inside the dense grid), the found pairs of valid rows and the
    distinct cells those name."""
    import torch
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.ops import voxel

    keys = voxel.neighbor_query_keys(tgt.voxels, se3.transform_points(T, xyz), mask,
                                     voxel.neighbor_offsets(method, device=xyz.device))
    G = voxel.grid_dim(tgt.grid)
    i, j, k = voxel._split_key(keys)
    in_grid = (keys != voxel._LOCAL_INVALID) & (i < G) & (j < G) & (k < G)
    pairs = found & mask[..., None]
    return dict(n=int(mask.shape[-1]), valid=int(mask.sum()), K=int(idx.shape[-1]), grid_reads=int(in_grid.sum()),
                found_pairs=int(pairs.sum()), cells_read=int(torch.unique(idx[pairs]).numel()))


def ndt_bounds(kernel: str, w: dict, peak_flops: float, trials: int = 1) -> tuple:
    """(bound ms, "bytes" or "operations") of an NDT kernel on this run's
    inputs (ndt_work's counts ``w``). Each byte the function needs is read
    once: the mask of every row (1), the points of the valid rows (12), each
    pose (64); for the association the grid cell of each neighbour key
    inside the grid (4); for the others the found flags of the valid rows
    (1 per pair), the cell index of each found pair (4) and the 48-byte row
    of each cell those name. Each output byte is written once: the
    association's (n, K) indices and flags (5 per pair), g, H and the score
    (43 floats), the trial scores (4 each). Operations per found pair and
    valid point (NDT_*_OPS)."""
    pts = w["n"] + 12 * w["valid"]
    if kernel == "ndt_associate":
        nbytes, ops = pts + 64 + 4 * w["grid_reads"] + 5 * w["n"] * w["K"], 0
    else:
        reads = pts + w["valid"] * w["K"] + 4 * w["found_pairs"] + 48 * w["cells_read"]
        if kernel == "ndt_derivatives":
            nbytes = reads + 64 + 43 * 4
            ops = w["found_pairs"] * NDT_DERIV_OPS_PER_PAIR + w["valid"] * NDT_DERIV_OPS_PER_POINT
        else:
            nbytes = reads + trials * (64 + 4)
            ops = trials * (w["found_pairs"] * NDT_SCORE_OPS_PER_PAIR + w["valid"] * NDT_SCORE_OPS_PER_POINT)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / peak_flops
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s else "bytes")


def ndt_trial_poses(T, g, H, trials: int = NDT_TRIALS):
    """(B, trials, 4, 4) line-search poses as ndt.align makes them: halving
    steps from 0.1 along the Newton direction of (g, H) at the poses T."""
    import torch
    from hdl_graph_slam_tpu_torch.core import se3

    d = _ndt()._newton_direction(H, g, kdtree=False)
    ddir = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    halves = torch.tensor([0.5**i for i in range(trials)], device=T.device)
    return se3.compose(se3.se3_exp(0.1 * halves[None, :, None] * ddir[:, None]), T[:, None]).contiguous()


def check_ndt(tgt, src, res: float, method: str, case: str, peak_flops: float, timed: bool) -> dict:
    """The three NDT kernels against their plain twins on one target and
    source cloud, at a pose off the truth: the association identical but on
    rows with a point within FACE_ULPS eps32 of a cell face (judged in
    float64); g and H within NDT_DERIV_TOL of the largest |entry|, the score
    within NDT_SCORE_RTOL; the NDT_TRIALS trial scores along the Newton
    direction, and the one trial at the pose, within NDT_SCORE_RTOL and the
    same argmin; a batch of 3 (the pose and two others) equal row for row,
    bit for bit, to the batch of 1; each wrapper called again, and again
    after the batch of 3, bit for bit as its first call (the reductions'
    ticket counters reset). With ``timed``, each wrapper call must be one
    device operation (torch.profiler), and each kernel and its twin are
    timed and its bound computed (ndt_work, ndt_bounds); returns those rows
    by kernel."""
    import torch
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.ops import voxel

    ndt = _ndt()
    dev = torch.device("cuda")
    n = src.capacity
    xyz, mask = src.xyz[None].contiguous(), src.mask[None].contiguous()
    Tb = se3.se3_exp(torch.tensor(NDT_TWISTS, device=dev))  # (3, 4, 4)
    T = Tb[:1].contiguous()
    _, near = near_faces(src.xyz.cpu().numpy(), T[0].cpu().numpy(), res)
    face = torch.from_numpy(near.any(1)).to(dev) & src.mask
    ik, fk = ndt.associate(tgt, xyz, mask, T, method)
    ip, fp = ndt.associate_plain(tgt, xyz, mask, T, method)
    gk, Hk, sk = ndt.derivatives(tgt, xyz, mask, T, ik, fk)
    gp, Hp, sp = ndt.derivatives_plain(tgt, xyz, mask, T, ik, fk)
    Ts = ndt_trial_poses(T, gk, Hk)
    tk = ndt.trial_scores(tgt, xyz, mask, Ts, ik, fk)
    tp = ndt.trial_scores_plain(tgt, xyz, mask, Ts, ik, fk)
    t1k = ndt.trial_scores(tgt, xyz, mask, T[:, None], ik, fk)
    t1p = ndt.trial_scores_plain(tgt, xyz, mask, T[:, None], ik, fk)
    again = ndt.derivatives(tgt, xyz, mask, T, ik, fk), ndt.trial_scores(tgt, xyz, mask, Ts, ik, fk)
    xb, mb = xyz.expand(3, -1, -1).contiguous(), mask.expand(3, -1).contiguous()
    ib, fb = ndt.associate(tgt, xb, mb, Tb, method)
    gb, Hb, sb = ndt.derivatives(tgt, xb, mb, Tb, ib, fb)
    tb = ndt.trial_scores(tgt, xb, mb, Ts.expand(3, -1, -1, -1).contiguous(), ib, fb)
    after = (ndt.associate(tgt, xyz, mask, T, method), ndt.derivatives(tgt, xyz, mask, T, ik, fk),
             ndt.trial_scores(tgt, xyz, mask, Ts, ik, fk))
    torch.cuda.synchronize()

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    differ = ((ik != ip) | (fk != fp)).any(-1)[0]
    w = ndt_work(tgt, xyz, mask, T, ik, fk, method)
    cells = int(tgt.voxels.mask.sum())
    row = dict(
        phase="ndt_kernels", case=case, resolution=res, method=method, n=n, valid=w["valid"], cells=cells,
        grid=voxel.grid_dim(tgt.grid), found_pairs=w["found_pairs"], cells_read=w["cells_read"],
        face_rows=int(face.sum()), rows_differ=int(differ.sum()), rows_differ_off_face=int((differ & ~face).sum()),
        g_err=float((gk - gp).abs().max() / gp.abs().max()),
        H_err=float((Hk - Hp).abs().max() / Hp.abs().max()),
        score_rel_err=float(((sk - sp).abs() / sp.abs()).max()),
        trial_rel_err=float(((tk - tp).abs() / tp.abs()).max()),
        trial1_rel_err=float(((t1k - t1p).abs() / t1p.abs()).max()),
        trial_argmin=[int(tk.argmin()), int(tp.argmin())],
        batch_rows_identical=bool(torch.equal(ib[:1], ik) and torch.equal(fb[:1], fk)
                                  and torch.equal(gb[:1], gk) and torch.equal(Hb[:1], Hk)
                                  and torch.equal(sb[:1], sk) and torch.equal(tb[:1], tk)),
        repeat_identical=same(again[0], (gk, Hk, sk)) and torch.equal(again[1], tk),
        after_batch_identical=same(after[0], (ik, fk)) and same(after[1], (gk, Hk, sk)) and torch.equal(after[2], tk),
    )
    if timed:
        row["device_ops_per_call"] = {name: device_ops_per_call(fn) for name, fn in (
            ("ndt_associate", lambda: ndt.associate(tgt, xyz, mask, T, method)),
            ("ndt_derivatives", lambda: ndt.derivatives(tgt, xyz, mask, T, ik, fk)),
            ("ndt_trial_scores", lambda: ndt.trial_scores(tgt, xyz, mask, Ts, ik, fk)),
            ("ndt_trial_scores_L1", lambda: ndt.trial_scores(tgt, xyz, mask, T[:, None], ik, fk)))}
    emit(row)
    what = f"{case} {res} {method}"
    require(row["rows_differ_off_face"] == 0, f"ndt associate {what}: rows differ off faces: {row}")
    require(row["g_err"] <= NDT_DERIV_TOL and row["H_err"] <= NDT_DERIV_TOL, f"ndt derivatives {what}: {row}")
    require(max(row["score_rel_err"], row["trial_rel_err"], row["trial1_rel_err"]) <= NDT_SCORE_RTOL,
            f"ndt scores {what}: {row}")
    require(row["trial_argmin"][0] == row["trial_argmin"][1], f"ndt trial argmin {what}: {row}")
    require(row["batch_rows_identical"], f"ndt batch of 3 vs 1 {what}: {row}")
    require(row["repeat_identical"] and row["after_batch_identical"], f"ndt repeated calls differ {what}: {row}")
    if not timed:
        return {}
    kernel_of = dict(ndt_associate="ndt_associate_kernel", ndt_derivatives="ndt_derivatives_kernel",
                     ndt_trial_scores="ndt_score_kernel", ndt_trial_scores_L1="ndt_score_kernel")
    require(all(ops == 1.0 and len(names) == 1 and kernel_of[name] in names[0]
                for name, (ops, names) in row["device_ops_per_call"].items()),
            f"ndt {what}: a wrapper call is not one launch of its kernel: {row['device_ops_per_call']}")
    errs = dict(ndt_associate=float((ik != ip)[~face[None]].abs().sum()),
                ndt_derivatives=float(max((gk - gp).abs().max(), (Hk - Hp).abs().max())),
                ndt_trial_scores=float((tk - tp).abs().max()))
    calls = dict(
        ndt_associate=(lambda: ndt.associate(tgt, xyz, mask, T, method),
                       lambda: ndt.associate_plain(tgt, xyz, mask, T, method)),
        ndt_derivatives=(lambda: ndt.derivatives(tgt, xyz, mask, T, ik, fk),
                         lambda: ndt.derivatives_plain(tgt, xyz, mask, T, ik, fk)),
        ndt_trial_scores=(lambda: ndt.trial_scores(tgt, xyz, mask, Ts, ik, fk),
                          lambda: ndt.trial_scores_plain(tgt, xyz, mask, Ts, ik, fk)))
    out = {}
    for name, (fn, plain) in calls.items():
        bound, by = ndt_bounds(name, w, peak_flops, trials=NDT_TRIALS)
        out[name] = dict(phase="ndt_kernels", kernel=name, case=case, resolution=res, method=method, cells=cells,
                         max_abs_err=errs[name], bound_ms=bound, bound_by=by, **w, **time_rows(fn, plain))
        emit(out[name])
    return out


def check_ndt_search(tgt, src, res: float, method: str, case: str) -> dict:
    """The association's key-search branch (the target without its dense
    grid, as preprocess_target(grid_size=0) leaves it) against its plain
    twin at check_ndt's pose: rows identical off cell faces (float64 face
    rule), a repeated call bit for bit."""
    import dataclasses

    import torch
    from hdl_graph_slam_tpu_torch.core import se3

    ndt = _ndt()
    keyed = dataclasses.replace(tgt, grid=None)
    xyz, mask = src.xyz[None].contiguous(), src.mask[None].contiguous()
    T = se3.se3_exp(torch.tensor(NDT_TWISTS[:1], device=xyz.device))
    ik, fk = ndt.associate(keyed, xyz, mask, T, method)
    ip, fp = ndt.associate_plain(keyed, xyz, mask, T, method)
    again = ndt.associate(keyed, xyz, mask, T, method)
    torch.cuda.synchronize()
    _, near = near_faces(src.xyz.cpu().numpy(), T[0].cpu().numpy(), res)
    face = torch.from_numpy(near.any(1)).to(xyz.device) & src.mask
    differ = ((ik != ip) | (fk != fp)).any(-1)[0]
    row = dict(phase="ndt_kernels", case=f"{case}_key_search", resolution=res, method=method,
               found_pairs=int((fk & mask[..., None]).sum()), face_rows=int(face.sum()),
               rows_differ=int(differ.sum()), rows_differ_off_face=int((differ & ~face).sum()),
               repeat_identical=bool(torch.equal(again[0], ik) and torch.equal(again[1], fk)))
    emit(row)
    require(row["rows_differ_off_face"] == 0 and row["repeat_identical"], f"ndt key-search association: {row}")
    return row


def ndt_kernels_phase(knn, clouds, peak_flops: float) -> dict:
    """check_ndt and check_ndt_search on bench frames 0 (target) and 1
    (source), the target at the NDT_RESOLUTIONS cells (max_voxels
    N_KERNEL), DIRECT7 and DIRECT1, timed at ndt_main's cells; knn_select at k = 8 (KDTREE's cell
    candidates) through check_knn's float64 near-tie gate;
    preprocess_target's time. Returns the timed rows by kernel."""
    import torch
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.ops import voxel

    ndt = _ndt()
    tgt_cloud, src = clouds[0][0], clouds[1][0]
    T = se3.se3_exp(torch.tensor(NDT_TWISTS[0], device="cuda"))  # check_ndt's pose
    timed = {}
    for res in NDT_RESOLUTIONS:
        G = voxel.dense_grid_size_for(res)
        tgt = ndt.preprocess_target(tgt_cloud, res, max_voxels=N_KERNEL, grid_size=G)
        emit(dict(phase="ndt_kernels", case="preprocess_target", resolution=res, grid=G,
                  cells=int(tgt.voxels.mask.sum()),
                  ms=time_ms(lambda: ndt.preprocess_target(tgt_cloud, res, max_voxels=N_KERNEL, grid_size=G),
                             reps=5, batches=3)))
        main_cells = res == NDT_MAIN_REG["reg_resolution"]
        for method in ("DIRECT7", "DIRECT1"):
            t = check_ndt(tgt, src, res, method, "bench", peak_flops, timed=method == "DIRECT7")
            check_ndt_search(tgt, src, res, method, "bench")
            if main_cells:
                timed.update(t)
        # KDTREE's cell candidates: the 8 nearest cell means of each moved point
        moved = torch.where(src.mask[:, None], se3.transform_points(T, src.xyz), 1.0e6).contiguous()
        means = torch.where(tgt.voxels.mask[:, None], tgt.voxels.means, 1.0e6).contiguous()
        row = dict(phase="ndt_kernels", resolution=res, **check_knn(knn, moved, means, src.mask, "ndt_kdtree", k=8,
                                                                    near_ties=True),
                   launch=knn.launch_info("knn_select", src.capacity, means.shape[0], k=8))
        if main_cells:
            row.update(time_rows(lambda: knn.knn_select(moved, means, 8), lambda: knn.knn_select_plain(moved, means, 8)))
            row["valid_pairs"] = int(src.mask.sum()) * int(tgt.voxels.mask.sum())
            timed["knn_select_k8"] = row
        emit(row)
    return timed


def vgicp_kernels_phase(clouds, peak_flops: float) -> dict:
    """The VGICP target and its association on bench frames 0 (target) and
    1 (source, at check_ndt's pose), vgicp_main's 1.0 m voxels and 256³
    grid: preprocess_target on the card twice, bit for bit, and against the
    same cloud's target on the CPU (keys, mask, origin and grid identical,
    means within VGICP_MEAN_ATOL_M, covariances within VGICP_COV_ATOL);
    the DIRECT1 association (ndt.associate_cells, ndt_associate_kernel<1>)
    through the dense grid and through the key search, each against its
    plain twin with rows identical off cell faces (float64 face rule) and
    called again bit for bit, the dense-grid call one device operation of
    that kernel; both timed, the dense-grid call beside its bound. Returns
    (the timed dense-grid row, the target)."""
    import types

    import torch
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.ops import voxel
    from hdl_graph_slam_tpu_torch.registration import vgicp

    ndt = _ndt()
    res = VGICP_MAIN_REG["reg_resolution"]
    G = voxel.dense_grid_size_for(res)
    tgt_cloud, src = clouds[0][0], clouds[1][0]

    def make(c):
        return vgicp.preprocess_target(c, res, max_voxels=N_KERNEL, grid_size=G)

    tgt, again = make(tgt_cloud), make(tgt_cloud)
    tgt_cpu = make(PointCloud(xyz=tgt_cloud.xyz.cpu(), mask=tgt_cloud.mask.cpu()))
    torch.cuda.synchronize()
    fields = ("keys", "means", "covs", "mask", "origin", "grid")
    m = tgt_cpu.mask
    cov_rows = (tgt.covs.cpu()[m] - tgt_cpu.covs[m]).abs().flatten(1).amax(1)
    row = dict(phase="vgicp_kernels", case="preprocess_target", resolution=res, grid=G, voxels=int(m.sum()),
               repeat_identical=all(torch.equal(getattr(tgt, f), getattr(again, f)) for f in fields),
               structure_identical=all(torch.equal(getattr(tgt, f).cpu(), getattr(tgt_cpu, f))
                                       for f in ("keys", "mask", "origin", "grid")),
               mean_max_abs_err_m=float((tgt.means.cpu()[m] - tgt_cpu.means[m]).abs().max()),
               cov_max_abs_err=float(cov_rows.max()), cov_share_within_1e4=float((cov_rows <= 1e-4).double().mean()),
               ms=time_ms(lambda: make(tgt_cloud), reps=5, batches=3))
    emit(row)
    require(row["repeat_identical"], f"vgicp preprocess_target: a repeat differs: {row}")
    require(row["structure_identical"] and row["mean_max_abs_err_m"] <= VGICP_MEAN_ATOL_M
            and row["cov_max_abs_err"] <= VGICP_COV_ATOL, f"vgicp preprocess_target: card vs CPU: {row}")

    xyz, mask = src.xyz[None].contiguous(), src.mask[None].contiguous()
    T = se3.se3_exp(torch.tensor(NDT_TWISTS[:1], device="cuda"))
    _, near = near_faces(src.xyz.cpu().numpy(), T[0].cpu().numpy(), res)
    face = torch.from_numpy(near.any(1)).to("cuda") & src.mask
    timed = None
    for case, grid in (("dense_grid", tgt.grid), ("key_search", None)):
        def fn(grid=grid):
            return ndt.associate_cells(tgt, grid, xyz, mask, T, "DIRECT1")

        def plain(grid=grid):
            return ndt.associate_cells_plain(tgt, grid, xyz, mask, T, "DIRECT1")

        (ik, fk), (ip, fp), rep = fn(), plain(), fn()
        torch.cuda.synchronize()
        differ = ((ik != ip) | (fk != fp)).any(-1)[0]
        w = ndt_work(types.SimpleNamespace(voxels=tgt, grid=tgt.grid), xyz, mask, T, ik, fk, "DIRECT1")
        r = dict(phase="vgicp_kernels", kernel="ndt_associate", case=case, resolution=res, method="DIRECT1",
                 voxels=int(m.sum()), face_rows=int(face.sum()), rows_differ=int(differ.sum()),
                 rows_differ_off_face=int((differ & ~face).sum()), max_abs_err=float((differ & ~face).sum()),
                 repeat_identical=bool(torch.equal(rep[0], ik) and torch.equal(rep[1], fk)), **w)
        if case == "dense_grid":
            r["device_ops_per_call"] = device_ops_per_call(fn)
            r["bound_ms"], r["bound_by"] = ndt_bounds("ndt_associate", w, peak_flops)
        r.update(time_rows(fn, plain))
        emit(r)
        require(r["rows_differ_off_face"] == 0 and r["repeat_identical"], f"vgicp association {case}: {r}")
        if case == "dense_grid":
            ops, names = r["device_ops_per_call"]
            require(ops == 1.0 and len(names) == 1 and "ndt_associate_kernel" in names[0],
                    f"vgicp association: a call is not one launch of ndt_associate_kernel: {r['device_ops_per_call']}")
            timed = r
    return timed, tgt


# -- GICP: the association and linearization kernels (csrc/gicp.cu) -----------------------


def gicp_work(corr, B: int) -> dict:
    """What this run's data asks of the GICP kernels, for their bounds: rows
    (B n), valid rows, the distinct target rows the rows name (per problem,
    summed) and those valid rows name."""
    import torch

    idx = corr.idx.reshape(B, -1).long()
    valid = (corr.Mw.reshape(B, -1, 9) != 0).any(-1)
    named = sum(int(torch.unique(i).numel()) for i in idx)
    named_valid = sum(int(torch.unique(i[v]).numel()) for i, v in zip(idx, valid))
    return dict(batch=B, rows=int(idx.numel()), valid=int(valid.sum()), named=named, named_valid=named_valid)


def gicp_bounds(kernel: str, w: dict, peak_flops: float, found_gate: bool = False) -> tuple:
    """(bound ms, "bytes" or "operations") of a GICP kernel on this run's
    inputs (gicp_work's counts ``w``), each input byte read once and each
    output byte written once. The association reads each pose (64), per
    row the source covariance, index and gate inputs (36 + 4 + d2 and mask
    5, or the found flag 1) and per named target row its covariance and
    mask (37, or 36), and writes each row's Mw (36) and each count (4). The
    linearization and the cost read each pose, each row's Mw (36: it is the
    gate), each valid row's point and index (16) and each target point a
    valid row names (12), and write (43 or 1) floats a problem. The fused
    form moves the association's bytes and the linearization's points and
    rows, without reading Mw back. Operations per row (association) and per
    valid row (GICP_*_OPS)."""
    assoc_bytes = (64 + 4) * w["batch"] + w["rows"] * (36 + 4 + (1 if found_gate else 5) + 36) \
        + w["named"] * (36 if found_gate else 37)
    if kernel == "gicp_associate":
        nbytes, ops = assoc_bytes, w["rows"] * GICP_ASSOC_OPS_PER_ROW
    elif kernel == "gicp_associate_linearize":
        # the association's bytes, then each valid row's point and the target
        # point it names, and the (B, 43) rows; Mw is written, never read back
        nbytes = assoc_bytes + 4 * 43 * w["batch"] + 12 * w["valid"] + 12 * w["named_valid"]
        ops = w["rows"] * GICP_ASSOC_OPS_PER_ROW + w["valid"] * GICP_LIN_OPS_PER_ROW
    else:
        cost_only = kernel == "gicp_cost"
        nbytes = (64 + 4 * (1 if cost_only else 43)) * w["batch"] + 36 * w["rows"] + 16 * w["valid"] \
            + 12 * w["named_valid"]
        ops = w["valid"] * (GICP_COST_OPS_PER_ROW if cost_only else GICP_LIN_OPS_PER_ROW)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / peak_flops
    return 1e3 * max(bytes_s, ops_s), ("operations" if ops_s >= bytes_s else "bytes")


def rel_to_max(a, b) -> float:
    """max |a - b| over max |b| (0 where both are 0)."""
    d, m = float((a.double() - b.double()).abs().max()), float(b.double().abs().max())
    return d / m if m else d


def gicp_trial_poses(T, H, b):
    """Trial poses of a damped LM step from (H, b) at T (B, 4, 4): d =
    -(H + lam I)^-1 b with lam 1e-3 of H's largest diagonal entry (enough
    for a problem of few valid rows on two planes), T_new = exp(d) T."""
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.ops.small_solve import solve_spd

    A = H.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(1e-3 * H.diagonal(dim1=-2, dim2=-1).abs().amax(-1, keepdim=True))
    return se3.compose(se3.se3_exp(-solve_spd(A, b)), T).contiguous()


def check_gicp(case: str, T, src, tgt_covs, tgt_xyz, idx, gate) -> dict:
    """The GICP kernel's forms on the card for B problems at the poses T
    (B, 4, 4) under one search's idx and gate (a gicp.DistanceGate, or
    found flags), each (B, n): Mw within GICP_MW_TOL of the plain twin's
    largest |entry| and num equal; H, b and cost, and the cost form's cost,
    within GICP_LIN_TOL of their largest |entry| in the plain twin run in
    float64 on the same inputs (the plain float32 twin's distance reported
    beside it: near an optimum b is a small sum of large terms, and the
    float32 rounding of the moved points sets that twin's error); the fused
    call (associate_linearize) bit for bit associate then linearize; the
    prepared call's fused form bit for bit the wrapper's, and its
    linearization at the trial poses of a damped step (what the gated loop
    carries to the next step) bit for bit a fresh linearize there, its cost
    form the same cost; the cost form's cost bit for bit the full call's;
    every call again bit for bit; and each problem's single call (a (4, 4)
    pose, its own rows) bit for bit its row of the batch. Returns (the row,
    the batched correspondences)."""
    import torch

    g = _gicp()
    dist = isinstance(gate, g.DistanceGate)
    flags = gate.d2 if dist else gate

    def gate_of(b):
        return g.DistanceGate(gate.d2[b], gate.tgt_mask, gate.max_corr_dist) if dist else gate[b]

    def calls(T, src, idx, gate):
        corr, lin = g.associate_linearize(T, src, tgt_covs, tgt_xyz, idx, gate)
        return corr, lin[:3], g.cost(T, corr, src, tgt_xyz)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    corr, lin, cst = calls(T, src, idx, gate)
    sep = g.associate(T, src, tgt_covs, idx, gate)
    sep_lin = g.linearize(T, sep, src, tgt_xyz)[:3]
    corr_p = g.associate_plain(T, src, tgt_covs, idx, gate)
    lin_p = g.linearize_plain(T, corr, src, tgt_xyz)[:3]
    # the plain twin in float64 on the same inputs: how far each float32 side is from it
    lin_64 = g.linearize_plain(T.double(), g.GicpCorr(corr.idx, corr.Mw.double(), corr.num),
                               g.GicpCloud(src.xyz.double(), src.mask, src.covs.double()), tgt_xyz.double())[:3]
    # the loop's path: the prepared fused call, a damped step, the trial linearized in full
    prep = g.Prepared(src, tgt_covs, tgt_xyz, gate.tgt_mask if dist else None, gate.max_corr_dist if dist else 0.0)
    pc, pl = prep.associate_linearize(T, idx, flags)
    pc, pl = g.GicpCorr(pc.idx, pc.Mw.clone(), pc.num.clone()), [x.clone() for x in pl[:3]]
    T_new = gicp_trial_poses(T, pl[0], pl[1])
    trial = [x.clone() for x in prep.linearize(T_new, pc)[:3]]
    trial_cost = prep.cost(T_new, pc).clone()
    fresh = g.linearize(T_new, corr, src, tgt_xyz)[:3]
    again = calls(T, src, idx, gate)
    singles = [calls(T[b], g.GicpCloud(src.xyz[b], src.mask[b], src.covs[b]), idx[b], gate_of(b))
               for b in range(T.shape[0])]
    torch.cuda.synchronize()
    row = dict(phase="gicp_kernels", case=case, gate="distance" if dist else "found", batch=int(T.shape[0]),
               n=int(idx.shape[1]), valid=corr.num.tolist(), valid_plain=corr_p.num.tolist(),
               Mw_err=rel_to_max(corr.Mw, corr_p.Mw), Mw_identical=bool(torch.equal(corr.Mw, corr_p.Mw)),
               H_err=rel_to_max(lin[0], lin_64[0]), b_err=rel_to_max(lin[1], lin_64[1]),
               cost_err=rel_to_max(lin[2], lin_64[2]), cost_only_err=rel_to_max(cst, lin_64[2]),
               plain_f64_err=[rel_to_max(a, r) for a, r in zip(lin_p, lin_64)],
               kernel_vs_plain_err=[rel_to_max(a, r) for a, r in zip(lin, lin_p)],
               fused_identical=same(corr, sep) and same(lin, sep_lin),
               prepared_identical=same(pc, corr) and same(pl, lin),
               trial_identical=same(trial, fresh) and bool(torch.equal(trial_cost, trial[2])),
               cost_only_identical=bool(torch.equal(cst, lin[2])),
               repeat_identical=same(again[0], corr) and same(again[1], lin) and torch.equal(again[2], cst),
               single_identical=all(same(c, [x[b] for x in corr]) and same(li, [x[b] for x in lin])
                                    and torch.equal(co, cst[b]) for b, (c, li, co) in enumerate(singles)))
    row["max_abs_err"] = float(max((lin[0] - lin_p[0]).abs().max(), (lin[1] - lin_p[1]).abs().max()))
    emit(row)
    what = f"gicp {case}"
    require(row["valid"] == row["valid_plain"] and row["Mw_err"] <= GICP_MW_TOL, f"{what} association: {row}")
    require(max(row["H_err"], row["b_err"], row["cost_err"], row["cost_only_err"]) <= GICP_LIN_TOL,
            f"{what} linearization: {row}")
    require(row["fused_identical"], f"{what}: the fused call differs from associate then linearize: {row}")
    require(row["prepared_identical"], f"{what}: the prepared fused call differs from the wrapper's: {row}")
    require(row["trial_identical"], f"{what}: the trial's linearization differs from a fresh one: {row}")
    require(row["cost_only_identical"], f"{what}: the cost form's cost differs from the full call's: {row}")
    require(row["repeat_identical"], f"{what}: a repeated call differs: {row}")
    require(row["single_identical"], f"{what}: a problem's single call differs from its row of the batch: {row}")
    return row, corr


def gicp_timed(name: str, case: str, fn, plain, wrapper, w: dict, peak_flops: float, found_gate: bool = False) -> dict:
    """A timed row of one GICP form: the prepared call ``fn`` (the LM
    loop's launch) against its plain twin, the public ``wrapper``'s host
    time beside it, the bound from the run's rows (gicp_bounds)."""
    import torch

    def tensors(x):
        return [t for o in (x if isinstance(x, tuple) else (x,)) for t in (o if isinstance(o, tuple) else (o,))
                if t.is_floating_point()]

    bound, by = gicp_bounds(name, w, peak_flops, found_gate=found_gate)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(tensors(fn()), tensors(plain())))
    torch.cuda.synchronize()
    row = dict(phase="gicp_kernels", kernel=name, case=case, gate="found" if found_gate else "distance",
               max_abs_err=err, bound_ms=bound, bound_by=by, **w, **time_rows(fn, plain),
               wrapper_host_ms=host_ms(wrapper))
    emit(row)
    return row


def gicp_kernels_phase(clouds, vtgt, peak_flops: float) -> dict:
    """The GICP kernel's forms against their plain twins and each other
    (check_gicp) on bench frames 0 (target, gicp.preprocess) and 1 (the
    source) at the three NDT_TWISTS poses, through GICP's nn1 search and
    distance gate (GICP_MAX_CORR_M) and through VGICP's voxel lookup over
    ``vtgt`` (vgicp_kernels' target) and its found flags. At the first
    pose, each wrapper call (both gates, the fused form, linearize, cost)
    must be one device operation of gicp_step_kernel (device_ops_per_call),
    and each form's prepared call (the LM loop's launch) is timed beside
    its bound (gicp_work, gicp_bounds) and its wrapper's host time. Returns
    the timed rows by name."""
    import torch
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.registration import ndt

    g = _gicp()
    tgt, one = g.preprocess(clouds[0][0]), g.preprocess(clouds[1][0])
    T = se3.se3_exp(torch.tensor(NDT_TWISTS, device=one.xyz.device)).contiguous()
    B = T.shape[0]
    src = g.GicpCloud(*[x[None].expand(B, *x.shape).contiguous() for x in (one.xyz, one.mask, one.covs)])
    idx, d2 = g._correspond(T, src, tgt)
    _, corr = check_gicp("bench", T, src, tgt.covs, tgt.xyz, idx, g.DistanceGate(d2, tgt.mask, GICP_MAX_CORR_M))
    vidx, found = ndt.associate_cells(vtgt, vtgt.grid, src.xyz, src.mask, T, "DIRECT1")
    _, vcorr = check_gicp("bench_vgicp", T, src, vtgt.covs, vtgt.means, vidx[..., 0].contiguous(),
                          found[..., 0].contiguous())

    # the first pose as the main path calls the wrappers: one problem, a (4, 4) pose
    T0, i0, d0, f0, vi0 = T[0], idx[0], d2[0], found[0, :, 0].contiguous(), vidx[0, :, 0].contiguous()
    c0 = g.GicpCorr(corr.idx[0], corr.Mw[0], corr.num[0])
    gate0 = g.DistanceGate(d0, tgt.mask, GICP_MAX_CORR_M)
    wrappers = dict(
        gicp_associate_linearize=lambda: g.associate_linearize(T0, one, tgt.covs, tgt.xyz, i0, gate0),
        gicp_associate_linearize_vgicp=lambda: g.associate_linearize(T0, one, vtgt.covs, vtgt.means, vi0, f0),
        gicp_associate=lambda: g.associate(T0, one, tgt.covs, i0, gate0),
        gicp_associate_vgicp=lambda: g.associate(T0, one, vtgt.covs, vi0, f0),
        gicp_linearize=lambda: g.linearize(T0, c0, one, tgt.xyz),
        gicp_cost=lambda: g.cost(T0, c0, one, tgt.xyz))
    ops = {name: device_ops_per_call(fn) for name, fn in wrappers.items()}
    emit(dict(phase="gicp_kernels", case="device_ops_per_call", device_ops_per_call=ops))
    require(all(n == 1.0 and len(names) == 1 and "gicp_step_kernel" in names[0] for n, names in ops.values()),
            f"gicp: a wrapper call is not one launch of gicp_step_kernel: {ops}")
    p = g.Prepared(one, tgt.covs, tgt.xyz, tgt.mask, GICP_MAX_CORR_M)
    pv = g.Prepared(one, vtgt.covs, vtgt.means)
    vc0 = g.GicpCorr(vi0, vcorr.Mw[0], vcorr.num[0])
    w, wv = gicp_work(c0, 1), gicp_work(vc0, 1)
    out = dict(
        gicp_associate_linearize=gicp_timed(
            "gicp_associate_linearize", "bench", lambda: p.associate_linearize(T0, i0, d0),
            lambda: g.associate_linearize_plain(T0, one, tgt.covs, tgt.xyz, i0, gate0),
            wrappers["gicp_associate_linearize"], w, peak_flops),
        gicp_associate_linearize_vgicp=gicp_timed(
            "gicp_associate_linearize", "bench_vgicp", lambda: pv.associate_linearize(T0, vi0, f0),
            lambda: g.associate_linearize_plain(T0, one, vtgt.covs, vtgt.means, vi0, f0),
            wrappers["gicp_associate_linearize_vgicp"], wv, peak_flops, found_gate=True),
        gicp_associate=gicp_timed(
            "gicp_associate", "bench", lambda: p.associate(T0, i0, d0),
            lambda: g.associate_plain(T0, one, tgt.covs, i0, gate0), wrappers["gicp_associate"], w, peak_flops),
        gicp_associate_vgicp=gicp_timed(
            "gicp_associate", "bench_vgicp", lambda: pv.associate(T0, vi0, f0),
            lambda: g.associate_plain(T0, one, vtgt.covs, vi0, f0), wrappers["gicp_associate_vgicp"], wv, peak_flops,
            found_gate=True),
        gicp_linearize=gicp_timed(
            "gicp_linearize", "bench", lambda: p.linearize(T0, c0), lambda: g.linearize_plain(T0, c0, one, tgt.xyz),
            wrappers["gicp_linearize"], w, peak_flops),
        gicp_cost=gicp_timed(
            "gicp_cost", "bench", lambda: p.cost(T0, c0), lambda: g.cost_plain(T0, c0, one, tgt.xyz),
            wrappers["gicp_cost"], w, peak_flops))
    return out


def gicp_batched_phase(golden, peak_flops: float) -> dict:
    """check_gicp at the loop detector's shape: golden_town frame
    LOOP_TARGET_FRAME as the target and its LOOP_CANDIDATE_OFFSETS frames
    as B = GOLDEN_B sources (the golden prefilter's 4096 rows,
    gicp.preprocess with a leading batch), at loop_methods' truth guesses;
    the fused and linearize forms' prepared calls timed at that shape.
    Returns the timed rows by name."""
    import torch

    g = _gicp()
    truth = golden["truth"]
    frames = [LOOP_TARGET_FRAME + o for o in LOOP_CANDIDATE_OFFSETS]
    tgt = g.preprocess(golden_cloud(golden["scans"][LOOP_TARGET_FRAME]))
    clouds = [golden_cloud(golden["scans"][i]) for i in frames]
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud

    src = g.preprocess(PointCloud(xyz=torch.stack([c.xyz for c in clouds]), mask=torch.stack([c.mask for c in clouds])))
    guesses = []
    for i in frames:
        m = np.linalg.inv(truth[LOOP_TARGET_FRAME]) @ truth[i]
        m[2, 3] = 0.0
        guesses.append(m)
    T = torch.from_numpy(np.stack(guesses)).float().to(src.xyz.device)
    idx, d2 = g._correspond(T, src, tgt)
    gate = g.DistanceGate(d2, tgt.mask, GICP_MAX_CORR_M)
    row, corr = check_gicp("loop_batch", T, src, tgt.covs, tgt.xyz, idx, gate)
    p = g.Prepared(src, tgt.covs, tgt.xyz, tgt.mask, GICP_MAX_CORR_M)
    w = gicp_work(corr, T.shape[0])
    return dict(
        gicp_associate_linearize=gicp_timed(
            "gicp_associate_linearize", "loop_batch", lambda: p.associate_linearize(T, idx, d2),
            lambda: g.associate_linearize_plain(T, src, tgt.covs, tgt.xyz, idx, gate),
            lambda: g.associate_linearize(T, src, tgt.covs, tgt.xyz, idx, gate), w, peak_flops),
        gicp_linearize=gicp_timed(
            "gicp_linearize", "loop_batch", lambda: p.linearize(T, corr), lambda: g.linearize_plain(T, corr, src, tgt.xyz),
            lambda: g.linearize(T, corr, src, tgt.xyz), w, peak_flops))


def loop_methods_phase(golden) -> dict:
    """The loop detector's batched match with each of LOOP_METHODS on the
    card: golden_town frame LOOP_TARGET_FRAME as the new keyframe and the
    LOOP_CANDIDATE_OFFSETS frames around it as GOLDEN_B candidates (the
    golden prefilter at its 4096 rows), guesses from the truth z-flattened
    as loop_detector.hpp:139-146 makes them, the golden config's loop
    registration with the method swapped. Gates: _match_batched against
    _match_sequential, transforms within LOOP_MATCH_ATOL_M and the same
    converged flags; the batch of one bit for bit the unbatched align of
    that candidate. Times one batched match and counts its host syncs and
    device operations. Returns the launches of the batched matches."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile
    from hdl_graph_slam_tpu_torch.backend.loop_detector import LoopDetector
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.ops import knn
    from hdl_graph_slam_tpu_torch.registration import factory
    from hdl_graph_slam_tpu_torch.utils import course

    truth = golden["truth"]
    frames = [LOOP_TARGET_FRAME + o for o in LOOP_CANDIDATE_OFFSETS]
    target = golden_cloud(golden["scans"][LOOP_TARGET_FRAME])
    sources = [golden_cloud(golden["scans"][i]) for i in frames]
    guesses = []
    for i in frames:
        g = np.linalg.inv(truth[LOOP_TARGET_FRAME]) @ truth[i]
        g[2, 3] = 0.0
        guesses.append(g)
    out = {}
    for method in LOOP_METHODS:
        cfg = course.golden_town_config().loop
        cfg.registration = dataclasses.replace(cfg.registration, registration_method=method, reg_resolution=1.0)
        det = LoopDetector(cfg)
        reset_launches(knn)
        sb = det._match_batched(sources, target, guesses)
        launches = read_launches(knn)
        ss = det._match_sequential(sources, target, guesses)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = det._match_batched(sources, target, guesses)  # the repeat, timed
        ms = 1e3 * (time.perf_counter() - t0)
        # the batch of one against the unbatched align of candidate 0
        c = cfg.registration
        tgt_state = factory.make_target(c, target, det._registration.max_voxels)
        one = PointCloud(xyz=sources[0].xyz[None], mask=sources[0].mask[None])
        g0 = torch.from_numpy(guesses[0]).float().cuda()
        rb = factory.align(c, tgt_state, factory.prepare_source(c, one), g0[None])
        ru = factory.align(c, tgt_state, factory.prepare_source(c, sources[0]), g0)
        b1_identical = all(torch.equal(x[0], y) for x, y in zip(rb, ru))

        def traced():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                det._match_batched(sources, target, guesses)
                torch.cuda.synchronize()
            return prof

        prof, syncs = count_host_syncs(traced)
        err = float(max(np.abs(a - b)[:3, 3].max() for a, b in zip(sb[1], ss[1])))
        row = dict(phase="loop_methods", method=method, target_frame=LOOP_TARGET_FRAME, candidate_frames=frames,
                   converged_batched=[bool(x) for x in sb[2]], converged_sequential=[bool(x) for x in ss[2]],
                   fitness=[float(x) for x in sb[0]], transform_max_abs_err_m=err,
                   rotation_max_abs_err=float(max(np.abs(a - b)[:3, :3].max() for a, b in zip(sb[1], ss[1]))),
                   repeat_identical=all(np.array_equal(a, b) for a, b in zip(sb[1], again[1])),
                   b1_identical=b1_identical, iterations_b1=int(rb.iterations[0]), ms_per_match=ms,
                   host_syncs_per_match=syncs, device_ops_per_match=len(device_events(prof)), launches=launches,
                   atol_m=LOOP_MATCH_ATOL_M)
        emit(row)
        require(err <= LOOP_MATCH_ATOL_M, f"loop_methods {method}: batched vs sequential transforms differ by {err}")
        require(row["converged_batched"] == row["converged_sequential"] and any(row["converged_batched"]),
                f"loop_methods {method}: converged flags {row['converged_batched']} vs {row['converged_sequential']}")
        require(row["repeat_identical"], f"loop_methods {method}: a repeated batched match differs")
        require(b1_identical, f"loop_methods {method}: the batch of one differs from the unbatched align")
        out[method] = launches
    return out


def ndt_imu_case(scans, device: str = "cuda") -> tuple:
    """The imu path's NDT kernel shapes: two raw scans through the imu
    preset's prefilter at IMU_CLOUD_CAPACITY rows (no deskewing), the first
    as the target the preset's ScanMatchingOdometry builds (factory.
    make_target: 10 m cells, max_voxels IMU_CLOUD_CAPACITY, the dense
    grid). Returns (target, source cloud, resolution, method)."""
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.core.config import PRESETS
    from hdl_graph_slam_tpu_torch.frontend import Prefilter
    from hdl_graph_slam_tpu_torch.registration import factory

    cfg = PRESETS["imu"]()
    reg = cfg.odometry.registration
    pf = Prefilter(cfg.prefilter, out_capacity=IMU_CLOUD_CAPACITY, device=device)
    tgt_cloud, src = (pf(cloudlib.from_numpy(s, device=device)) for s in scans[:2])
    return factory.make_target(reg, tgt_cloud, IMU_CLOUD_CAPACITY), src, reg.reg_resolution, reg.reg_nn_search_method


def ndt_imu_kernels_phase(scans, peak_flops: float) -> dict:
    """check_ndt, timed, and check_ndt_search on golden_town frames 0
    (target) and 1 (source), ``scans``, at the imu path's shapes
    (ndt_imu_case). Returns the timed rows by kernel."""
    tgt, src, res, method = ndt_imu_case(scans)
    check_ndt_search(tgt, src, res, method, "imu")
    return check_ndt(tgt, src, res, method, "imu", peak_flops, timed=True)


def odometry_config(reg: dict):
    """bench_configs()'s odometry with the registration ``reg``."""
    from hdl_graph_slam_tpu_torch.core.config import OdometryConfig, RegistrationConfig

    return OdometryConfig(keyframe_delta_trans=2.0, keyframe_delta_time=1e9, registration=RegistrationConfig(**reg))


def window_phase(knn, scans, phase: str, reg: dict, frames: int, required: tuple, reference=None,
                 per_frame: tuple = (), witness: Optional[dict] = None, drift_gate: bool = True,
                 traced: int = 16) -> tuple:
    """The bench course's first ``frames`` frames through an OdometryWindow
    with the registration ``reg`` on the card, as main drives GICP: the
    rotation gates (det/orth < 1e-4, finite poses) and, with
    ``drift_gate``, bench.py's (final x within 3% of the drive, > 90%
    converged); given the ``reference`` poses of another run over the same
    frames, the final x within NDT_KDTREE_VS_DIRECT7_M of its x there
    instead of the 3%; given a ``witness`` (tools/method_witness.py's JAX
    run: its prefix, x, x_atol and, if any, converged share and its
    tolerance), the x and converged share at that prefix. Every kernel in
    ``required`` launched, those in ``per_frame`` at least once a frame.
    fps, LM (Newton) iterations, keyframes and launches; then ``traced``
    traced frames (device operations and idle share) and the host syncs of
    as many frames. Returns (launches, poses)."""
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_STEP

    win, first, xyz, mask, stamps = main_path(scans[:frames + 1], odometry_config(reg))
    reset_launches(knn)
    state0, odoms, status, dt = drive_window(win, first, xyz, mask, stamps)
    launches = read_launches(knn)
    conv = status["converged"].cpu().numpy()
    dist = BENCH_STEP * frames
    Rs = odoms[:, :3, :3].astype(np.float64)
    row = dict(
        phase=phase, frames=frames, registration=reg, seconds=dt, fps=frames / dt, final_x=float(odoms[-1, 0, 3]),
        drive_m=dist, drift_fraction=abs(float(odoms[-1, 0, 3]) - dist) / dist, converged_fraction=float(conv.mean()),
        reference_x=None if reference is None else float(reference[frames - 1, 0, 3]),
        iterations_per_frame=float(status["iterations"].double().mean()),
        keyframes=int(status["keyframe_switched"].sum()),
        det_err=float(np.abs(np.linalg.det(Rs) - 1.0).max()),
        orth_err=float(np.abs(Rs @ np.swapaxes(Rs, 1, 2) - np.eye(3)).max()),
        launches=launches, launches_per_frame={k: v / frames for k, v in launches.items() if v},
    )
    if witness is not None:
        k = witness["prefix"]
        row["witness"] = dict(witness, x=float(odoms[k - 1, 0, 3]), converged_fraction=float(conv[:k].mean()))
    n = min(traced, frames)
    _, syncs = count_host_syncs(lambda: win.run(state0, xyz[:n], mask[:n], stamps[:n])[1].cpu())
    row["host_syncs_per_frame"] = syncs / n
    prof = profile_frames(win, state0, xyz, mask, stamps, n, dt / frames)
    row.update({k: prof[k] for k in ("device_ops_per_frame", "device_busy_ms_per_frame", "device_idle_share_unprofiled",
                                     "top_device", "port_kernels")})
    emit(row)
    require(bool(np.isfinite(odoms).all()), f"{phase}: non-finite pose")
    if reference is not None:
        ref_x = float(reference[frames - 1, 0, 3])
        require(abs(row["final_x"] - ref_x) < NDT_KDTREE_VS_DIRECT7_M,
                f"{phase}: final x {row['final_x']} vs {ref_x} of the reference run")
    elif drift_gate:
        require(row["drift_fraction"] < 0.03, f"{phase}: final x {row['final_x']} vs drive {dist}")
    if drift_gate:
        require(row["converged_fraction"] > 0.9, f"{phase}: only {row['converged_fraction']:.0%} of frames converged")
    if witness is not None:
        w = row["witness"]
        require(abs(w["x"] - witness["jax_x"]) <= witness["x_atol"],
                f"{phase}: x {w['x']} at frame {witness['prefix']} vs the JAX package's {witness['jax_x']}")
        if "jax_converged_fraction" in witness:
            require(abs(w["converged_fraction"] - witness["jax_converged_fraction"]) <= witness["converged_atol"],
                    f"{phase}: converged share {w['converged_fraction']} at frame {witness['prefix']} vs the JAX "
                    f"package's {witness['jax_converged_fraction']}")
    require(row["det_err"] < 1e-4 and row["orth_err"] < 1e-4, f"{phase}: rotation drift {row['det_err']}, "
                                                               f"{row['orth_err']}")
    require(all(launches[k] >= 1 for k in required), f"{phase} path did not go through every kernel: {launches}")
    require(all(launches[k] >= frames for k in per_frame), f"{phase}: a kernel of {per_frame} launched less than "
                                                            f"once a frame: {launches}")
    if any(launches[k] for k in GICP_COUNTERS):
        require_gicp_launches(phase, launches, frames, row["iterations_per_frame"])
    return launches, odoms


def require_gicp_launches(phase: str, launches: dict, frames: int, iterations_per_frame: float) -> None:
    """The LM loop launches each GICP form once per pose and correspondence
    set: gated, 1 + refreshes fused calls and a linearization a step;
    ungated, a fused call and a cost trial a step (the first fused call
    _lm_init's). Either is at most 1 + 2 x iterations a frame (the loop
    that repeated _lm_init's calls and associated apart from linearizing
    ran 7.1 at 2.05 iterations)."""
    per_frame = sum(launches[k] for k in GICP_COUNTERS) / frames
    require(per_frame <= 1.0 + 2.0 * iterations_per_frame,
            f"{phase}: {per_frame} GICP launches a frame at {iterations_per_frame} LM iterations")


def imu_phase(knn, golden) -> dict:
    """The imu preset end to end: SlamPipeline(PRESETS["imu"](),
    cloud_capacity=IMU_CLOUD_CAPACITY) on the card over golden_town's first
    IMU_FRAMES frames, each after its IMU message built from the truth
    (utils/course.py golden_town_imu). Gates: every frame processed,
    det/orth < 1e-4 on every odometry pose, the odometry keyframes' ATE
    within IMU_ATE_SLACK_M of the JAX package's on the same frames and
    messages (IMU_JAX_ATE_ODOM_M, tools/cli_witness.py imu_feed), every
    kernel of IMU_REQUIRED launched."""
    import torch
    from hdl_graph_slam_tpu_torch.core.config import PRESETS
    from hdl_graph_slam_tpu_torch.io import trajectory as traj_io
    from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline
    from hdl_graph_slam_tpu_torch.utils.course import golden_town_imu

    scans, truth = golden["scans"][:IMU_FRAMES], golden["truth"][:IMU_FRAMES]
    clock = StageClock()
    slam_stages(clock, count_syncs=False)
    reset_launches(knn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        pipe = SlamPipeline(PRESETS["imu"](), cloud_capacity=IMU_CLOUD_CAPACITY, device="cuda")
        for i, ((stamp, q, acc, w), xyz) in enumerate(zip(golden_town_imu(truth), scans)):
            pipe.add_imu(stamp, orientation_wxyz=q, acceleration=acc, angular_velocity=w)
            pipe.process_frame(float(i), xyz)
        pipe.finish()
        torch.cuda.synchronize()
    finally:
        clock.restore()
    wall = time.perf_counter() - t0
    launches = read_launches(knn)
    est, odom = pipe.slam.trajectory(), pipe.odometry_trajectory
    ref = [(float(i), T) for i, T in enumerate(truth)]
    kf = {s for s, _ in est}
    Rs = np.stack([T[:3, :3] for _, T in odom])
    row = dict(
        phase="imu", preset="imu", frames=len(odom), cloud_capacity=IMU_CLOUD_CAPACITY, keyframes=len(est),
        ate_opt_m=traj_io.ate_rmse(est, ref, align=True),
        ate_odom_m=traj_io.ate_rmse([(s, T) for s, T in odom if s in kf], ref, align=True),
        reference=dict(source="tools/cli_witness.py imu_feed (JAX package on the CPU)", ate_odom_m=IMU_JAX_ATE_ODOM_M,
                       slack_m=IMU_ATE_SLACK_M),
        det_err=float(np.abs(np.linalg.det(Rs) - 1.0).max()),
        orth_err=float(np.abs(Rs @ np.swapaxes(Rs, 1, 2) - np.eye(3)).max()),
        seconds=wall, fps=len(odom) / wall, host_wall_s=dict(clock.totals), calls=dict(clock.counts),
        launches=launches,
    )
    emit(row)
    require(row["frames"] == IMU_FRAMES, f"imu ran {row['frames']} of {IMU_FRAMES} frames")
    require(row["det_err"] < 1e-4 and row["orth_err"] < 1e-4, f"imu: rotation drift {row['det_err']}, {row['orth_err']}")
    require(row["ate_odom_m"] <= IMU_JAX_ATE_ODOM_M + IMU_ATE_SLACK_M,
            f"imu: odometry ATE {row['ate_odom_m']} above the JAX package's {IMU_JAX_ATE_ODOM_M} + {IMU_ATE_SLACK_M}")
    require(all(launches[k] >= 1 for k in IMU_REQUIRED), f"imu path did not go through every kernel: {launches}")
    return launches


# -- the offline CLI and its dump -------------------------------------------------------

CLI_PRESET = "outdoor"  # launch/hdl_graph_slam_400.launch
# the preset's 0.1 m voxels keep ~9-10k of golden_town's ~10.4k returns a
# scan; at 4096 rows the lowest voxel keys win (a half-space of the scan, the
# repo-wide overflow rule) and the odometry stands still, so the CLI runs at
# its default capacity
CLI_CLOUD_CAPACITY = 16384
MAP_MAX_POINTS = 1 << 21  # MapCloudGenerator.generate's default voxel cap
CLI_TIMEOUT_S = 600
MAP_RESOLUTION = 0.05  # the CLI's --map-resolution default
CLI_REQUIRED = ("nn1", "knn_select", "nn1_batched", "knn_select_batched", "radius_count",
                "knn_select_k10") + GICP_UNGATED
# The child process runs the CLI module as ``python -m`` does (runpy,
# run_name __main__, sys.argv set) and then writes its kernel launch counts
# to the file named by its first argument, which it removes from sys.argv.
CLI_CHILD = (
    "import json, runpy, sys\n"
    "launches_path = sys.argv.pop(1)\n"
    "import chip_smoke\n"
    "from hdl_graph_slam_tpu_torch.ops import knn\n"
    "try:\n"
    "    runpy.run_module('hdl_graph_slam_tpu_torch.run', run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    with open(launches_path, 'w') as f:\n"
    "        json.dump(dict(counts=chip_smoke.launch_counts(knn), per_k=knn.knn_select.launches_k), f)\n"
)
# a dump's poses are %.9g text: coordinates below 1000 m round by < 5e-7 m,
# rotations rebuilt from 9-digit quaternions by < 1e-8
POSE_TEXT_ATOL = 1e-6
# map voxels, card vs CPU and one-capacity vs per-snapshot path: a point's
# float32 transform (3 products, 3 sums) and division by the resolution round
# by <= 4 eps32 of the terms' magnitudes; a point whose float64 cell
# coordinate lies within FACE_ULPS eps32 of them of an integer is on a face,
# and only the voxels on both sides of such faces may differ
FACE_ULPS = 8
# a re-dump rebuilds each rotation from its 9-digit quaternion and writes
# the quaternion of that rotation, normalised: a component may move by one
# in its last printed digit (the JAX package does the same); every other
# token must be the same text
QUAT_REDUMP_ATOL = 1e-9
QUAT_TOKENS = {"VERTEX_SE3:QUAT": slice(5, 9), "EDGE_SE3:QUAT": slice(6, 10)}
OVERLAP_FRAMES = 48
OVERLAP_ODOM_ATOL = 1e-6  # tests/test_pipeline.py:627
OVERLAP_POSE_ATOL = 1e-2  # tests/test_pipeline.py:631


def write_kitti_sequence(scans, truth, directory: str) -> tuple:
    """The course as a KITTI odometry sequence: velodyne/%06d.bin float32
    (N, 4) with reflectance 0, times.txt with the course's stamps float(i),
    and the truth as a KITTI poses file. Returns (sequence dir, poses file)."""
    seq = os.path.join(directory, "sequence")
    os.makedirs(os.path.join(seq, "velodyne"))
    for i, xyz in enumerate(scans):
        rows = np.zeros((len(xyz), 4), dtype=np.float32)
        rows[:, :3] = xyz
        rows.tofile(os.path.join(seq, "velodyne", "%06d.bin" % i))
    np.savetxt(os.path.join(seq, "times.txt"), np.arange(len(scans), dtype=np.float64))
    poses = os.path.join(directory, "poses.txt")
    np.savetxt(poses, np.stack(truth)[:, :3, :].reshape(-1, 12), fmt="%.17g")
    return seq, poses


def voxel_cells(xyz: np.ndarray, res: float) -> tuple:
    """Voxel centres -> (integer cells (n, 3), largest distance of a centre
    from its cell's float64 centre in float32 ulps of the coordinate)."""
    x = np.asarray(xyz, dtype=np.float64)
    res32 = float(np.float32(res))
    cells = np.floor(x / res32).astype(np.int64)
    ulp = np.spacing(np.abs(np.asarray(xyz, dtype=np.float32))).astype(np.float64)
    off = np.abs(x - (cells + 0.5) * res32) / np.maximum(ulp, np.finfo(np.float32).tiny)
    return cells, float(off.max()) if len(x) else 0.0


def cell_keys(cells: np.ndarray) -> np.ndarray:
    c = cells + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def near_faces(xyz: np.ndarray, pose: np.ndarray, res: float) -> tuple:
    """float64 cell coordinates u of float32 points under a float32 pose,
    and per axis whether u lies within FACE_ULPS eps32 (of the magnitudes
    of the transform's and the division's terms) of an integer: there the
    float32 cell of the card and of the CPU may differ by rounding alone."""
    p = np.asarray(xyz, dtype=np.float32).astype(np.float64)
    pose = np.asarray(pose, dtype=np.float32).astype(np.float64)
    R, t = pose[:3, :3], pose[:3, 3]
    res32 = float(np.float32(res))
    u = (p @ R.T + t) / res32
    terms = (np.abs(p) @ np.abs(R).T + np.abs(t)) / res32 + np.abs(u)
    return u, np.abs(u - np.round(u)) <= FACE_ULPS * EPS32 * terms


def face_voxels(snapshots, res: float) -> tuple:
    """The voxels a map of ``snapshots`` may hold or not by float32
    rounding alone: for every point within FACE_ULPS eps32 of a voxel face
    (judged in float64 from the same float32 pose and point the map uses),
    the voxels on both sides of each such face. Returns (their keys, the
    number of such points, the number of points)."""
    keys, near_points, total = [], 0, 0
    for snap in snapshots:
        u, near = near_faces(snap.cloud.to_numpy(), snap.pose, res)
        rows = near.any(axis=1)
        near_points += int(rows.sum())
        total += len(u)
        u, near = u[rows], near[rows]
        lo = np.where(near, np.round(u) - 1, np.floor(u)).astype(np.int64)
        hi = np.where(near, np.round(u), np.floor(u)).astype(np.int64)
        for bits in range(8):
            pick = np.array([(bits >> a) & 1 for a in range(3)], dtype=bool)
            keys.append(cell_keys(np.where(pick, hi, lo)))
    return (np.unique(np.concatenate(keys)) if keys else np.zeros(0, np.int64)), near_points, total


def compare_maps(a: np.ndarray, b: np.ndarray, ambiguous: np.ndarray, res: float) -> dict:
    """Two maps' voxel sets: how many voxels differ, and how many of those
    no face point explains. A map holding MAP_MAX_POINTS voxels kept the
    lowest keys of its occupied set, so above the lower of the two maps'
    largest keys only the cut differs; those keys are left out."""
    ka, kb = np.sort(cell_keys(voxel_cells(a, res)[0])), np.sort(cell_keys(voxel_cells(b, res)[0]))
    diff = np.setxor1d(ka, kb)
    capped = MAP_MAX_POINTS in (len(ka), len(kb))
    if capped:
        diff = diff[diff <= min(ka[-1], kb[-1])]
    return dict(voxels=[int(len(ka)), int(len(kb))], capped=capped, differ=int(len(diff)),
                unexplained=int(len(np.setdiff1d(diff, ambiguous))))


def compare_g2o(a: str, b: str) -> dict:
    """Two g2o files token by token: the lines that differ, the quaternion
    components that differ and by how much (parsed), and the other tokens
    that differ (none in a faithful re-dump)."""
    from decimal import Decimal

    with open(a) as f:
        la = f.read().splitlines()
    with open(b) as f:
        lb = f.read().splitlines()
    quat, quat_err, other = 0, 0.0, int(len(la) != len(lb))
    for x, y in zip(la, lb):
        if x == y:
            continue
        tx, ty = x.split(), y.split()
        q = QUAT_TOKENS.get(tx[0]) if len(tx) == len(ty) and tx[0] == ty[0] else None
        for i, (u, v) in enumerate(zip(tx, ty)):
            if u == v:
                continue
            if q is not None and q.start <= i < q.stop:
                quat += 1
                quat_err = max(quat_err, float(abs(Decimal(u) - Decimal(v))))  # exact in decimal
            else:
                other += 1
    return dict(lines=len(la), lines_differ=sum(x != y for x, y in zip(la, lb)), quaternion_values_differ=quat,
                quaternion_max_abs_err=quat_err, other_tokens_differ=other)


def cli_phase(golden) -> dict:
    """The offline CLI as a user runs it: golden_town's 601 raw scans as a
    KITTI sequence, ``python -m hdl_graph_slam_tpu_torch.run`` in a child
    process on the card with the outdoor preset at 4096-row clouds and every
    output, then the outputs checked: the stats line, both ATEs from the TUM
    files against the truth, loop and floor edges from the graph JSON,
    rotation integrity from the dump, the map on 0.05 m voxel centres."""
    import shutil
    from hdl_graph_slam_tpu_torch.io import kitti, pcd, trajectory as traj_io

    workdir = os.path.join(HERE, "_cache", "chip_smoke_cli")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    seq, poses_path = write_kitti_sequence(golden["scans"], golden["truth"], workdir)
    write_s = time.perf_counter() - t0
    out = {k: os.path.join(workdir, k) for k in ("traj.txt", "odom.txt", "map.pcd", "dump", "graph.json",
                                                "trace.json", "launches.json")}
    cmd = [sys.executable, "-c", CLI_CHILD, out["launches.json"], "--kitti", seq, "--preset", CLI_PRESET,
           "--cloud-capacity", str(CLI_CLOUD_CAPACITY), "--out-traj", out["traj.txt"],
           "--out-odom-traj", out["odom.txt"], "--out-map", out["map.pcd"], "--dump", out["dump"],
           "--out-graph-json", out["graph.json"], "--trace", out["trace.json"]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [HERE, os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli: exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    stats = json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])
    with open(out["launches.json"]) as f:
        launches = format_launches(**json.load(f))

    ref = kitti.read_poses(poses_path)
    truth = [(float(i), ref[i]) for i in range(ref.shape[0])]
    est, odom = traj_io.load_tum(out["traj.txt"]), traj_io.load_tum(out["odom.txt"])
    kf_stamps = {s for s, _ in est}
    odom_kf = [(s, T) for s, T in odom if s in kf_stamps]
    with open(out["graph.json"]) as f:
        graph = json.load(f)
    order = {node["id"]: i for i, node in enumerate(graph["nodes"])}
    se3 = graph["edges"].get("se3_se3", [])
    loops = sum(1 for e in se3 if e["vi"] in order and e["vj"] in order and abs(order[e["vi"]] - order[e["vj"]]) > 1)
    mats = []
    for name in sorted(os.listdir(out["dump"])):
        if name.isdigit():
            with open(os.path.join(out["dump"], name, "data")) as f:
                lines = f.read().splitlines()
            for tag in ("estimate", "odom"):
                j = lines.index(tag)
                mats.append(np.array([[float(v) for v in lines[j + k].split()] for k in (1, 2, 3)])[:, :3])
    Rs = np.stack(mats)
    map_xyz, _ = pcd.load_pcd(out["map.pcd"])
    cells, centre_ulps = voxel_cells(map_xyz, MAP_RESOLUTION)
    with open(out["trace.json"]) as f:
        trace = json.load(f)["spans"]  # the tracer's summary: spans, counters, dropped
    row = dict(
        phase="cli", preset=CLI_PRESET, command="python -m hdl_graph_slam_tpu_torch.run " + " ".join(cmd[4:]),
        frames=stats["frames"], keyframes=stats["keyframes"], edges=stats["edges"], loop_edges=loops,
        floor_edges=len(graph["edges"].get("se3_plane", [])),
        ate_opt_m=traj_io.ate_rmse(est, truth, align=True), ate_odom_m=traj_io.ate_rmse(odom_kf, truth, align=True),
        det_err=float(np.abs(np.linalg.det(Rs) - 1.0).max()),
        orth_err=float(np.abs(Rs @ np.swapaxes(Rs, 1, 2) - np.eye(3)).max()),
        fps=stats["fps"], wall_s=stats["wall_s"], process_seconds=seconds, write_kitti_s=write_s,
        map_points=int(len(map_xyz)), map_unique_voxels=int(len(np.unique(cell_keys(cells)))),
        map_centre_max_ulps=centre_ulps, save_map_s=trace["save_map"]["total_s"], dump_s=trace["dump"]["total_s"],
        stage_wall_s={k: v["total_s"] for k, v in trace.items()}, launches=launches,
    )
    emit(row)
    require(row["frames"] == len(golden["scans"]), f"cli ran {row['frames']} of {len(golden['scans'])} frames")
    require(len(est) == row["keyframes"] and len(odom) == row["frames"], "cli: the TUM files miss poses")
    require(row["ate_opt_m"] < row["ate_odom_m"], f"cli: optimized ATE {row['ate_opt_m']} >= odometry "
                                                   f"{row['ate_odom_m']}")
    require(loops >= 2, f"cli: only {loops} loop edges")
    require(row["floor_edges"] >= 0.9 * row["keyframes"], f"cli: {row['floor_edges']} floor edges for "
                                                           f"{row['keyframes']} keyframes")
    require(row["det_err"] < 1e-4 and row["orth_err"] < 1e-4, f"cli: rotation drift {row['det_err']}, {row['orth_err']}")
    require(row["map_points"] > 0 and row["map_unique_voxels"] == row["map_points"], "cli: empty map or duplicates")
    require(centre_ulps <= 2.0, f"cli: map points {centre_ulps} ulps off their voxel centres")
    require(all(launches[k] >= 1 for k in CLI_REQUIRED), f"cli path did not go through every kernel: {launches}")
    return dict(workdir=workdir, out=out, launches=launches, row=row)


def persistence_phase(golden, cli) -> dict:
    """The CLI's dump loaded on the card and on the CPU; maps card vs CPU and
    one-capacity vs per-snapshot path under the voxel-face rule; a re-dump's
    graph.g2o byte-identical; run_windowed(overlap_backend=True) against the
    synchronous run over the first OVERLAP_FRAMES golden frames. Returns the
    loaded backends, {"cuda": ..., "cpu": ...}."""
    import filecmp
    import shutil
    import torch
    from hdl_graph_slam_tpu_torch.backend import HdlGraphSlam, KeyFrameSnapshot
    from hdl_graph_slam_tpu_torch.backend.map_cloud import MapCloudGenerator
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.core.config import PRESETS
    from hdl_graph_slam_tpu_torch.io import pcd

    dump = cli["out"]["dump"]
    slams, load_s = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        slams[dev] = HdlGraphSlam(PRESETS[CLI_PRESET](), device=dev)
        slams[dev].load(dump)
        load_s[dev] = time.perf_counter() - t0
    g, c = slams["cuda"], slams["cpu"]
    require(len(g.keyframes) == len(c.keyframes) == cli["row"]["keyframes"], "persistence: keyframe counts differ")
    require([k.node_id for k in g.keyframes] == [k.node_id for k in c.keyframes], "persistence: node ids differ")
    require([k.stamp for k in g.keyframes] == [k.stamp for k in c.keyframes], "persistence: stamps differ")
    require(g.graph.num_edges == c.graph.num_edges == cli["row"]["edges"], "persistence: edge counts differ")
    pose_err = 0.0
    for i, kf in enumerate(g.keyframes):
        with open(os.path.join(dump, "%06d" % i, "data")) as f:
            lines = f.read().splitlines()
        j = lines.index("estimate")
        text = np.array([[float(v) for v in lines[j + k].split()] for k in (1, 2, 3, 4)])
        pose_err = max(pose_err, float(np.abs(g.graph.poses[kf.node_id] - text).max()),
                       float(np.abs(c.graph.poses[kf.node_id] - text).max()))

    t0 = time.perf_counter()
    map_gpu = g.generate_map(MAP_RESOLUTION)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    map_cpu = c.generate_map(MAP_RESOLUTION)
    cpu_s = time.perf_counter() - t0
    caps = sorted({s.cloud.capacity for s in g.snapshots})
    one = [KeyFrameSnapshot(pose=s.pose, cloud=cloudlib.from_numpy(s.cloud.to_numpy(), capacity=caps[-1],
                                                                    device="cuda")) for s in g.snapshots]
    wide = KeyFrameSnapshot(pose=one[0].pose, cloud=cloudlib.from_numpy(one[0].cloud.to_numpy(), capacity=2 * caps[-1],
                                                                         device="cuda"))
    t0 = time.perf_counter()
    map_fast = MapCloudGenerator().generate(one, MAP_RESOLUTION)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    map_mixed = MapCloudGenerator().generate([wide] + one[1:], MAP_RESOLUTION)
    mixed_s = time.perf_counter() - t0
    ambiguous, near_points, points = face_voxels(c.snapshots, MAP_RESOLUTION)
    card_cpu = compare_maps(map_gpu, map_cpu, ambiguous, MAP_RESOLUTION)
    paths = compare_maps(map_fast, map_mixed, ambiguous, MAP_RESOLUTION)
    saved = compare_maps(map_gpu, pcd.load_pcd(cli["out"]["map.pcd"])[0], ambiguous, MAP_RESOLUTION)

    redump = os.path.join(cli["workdir"], "redump")
    t0 = time.perf_counter()
    g.dump(redump)
    redump_s = time.perf_counter() - t0
    g2o = compare_g2o(os.path.join(dump, "graph.g2o"), os.path.join(redump, "graph.g2o"))
    same_kernels = filecmp.cmp(os.path.join(dump, "graph.g2o.kernels"), os.path.join(redump, "graph.g2o.kernels"),
                               shallow=False)

    frames = golden_frames(golden, OVERLAP_FRAMES)
    t0 = time.perf_counter()
    _, sync = run_golden(golden["cfg"], frames)
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ovl = run_golden(golden["cfg"], frames, overlap_backend=True)
    ovl_s = time.perf_counter() - t0
    _, again = run_golden(golden["cfg"], frames)

    def odom_diff(a, b):
        return max(float(np.abs(x - y).max()) for (_, x), (_, y) in zip(a.odometry_trajectory, b.odometry_trajectory))

    odom_err, repeat_err = odom_diff(sync, ovl), odom_diff(sync, again)
    pose_err_ovl = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(sync.trajectory, ovl.trajectory))
    row = dict(
        phase="persistence", keyframes=len(g.keyframes), edges=g.graph.num_edges, load_s=load_s,
        pose_text_max_abs_err=pose_err, pose_text_atol=POSE_TEXT_ATOL,
        snapshot_capacities=caps, generate_map_path="one capacity" if len(caps) == 1 else "mixed capacities",
        map_points=dict(cuda=int(len(map_gpu)), cpu=int(len(map_cpu)), fast=int(len(map_fast)),
                        mixed=int(len(map_mixed))),
        map_s=dict(cuda=gpu_s, cpu=cpu_s, fast_cuda=fast_s, mixed_cuda=mixed_s),
        face_points=near_points, points=points, face_ulps=FACE_ULPS, ambiguous_voxels=int(len(ambiguous)),
        card_vs_cpu=card_cpu, fast_vs_mixed=paths, loaded_vs_cli_map=saved,
        redump_g2o=g2o, redump_kernels_identical=same_kernels, quaternion_atol=QUAT_REDUMP_ATOL,
        redump_s=redump_s,
        overlap=dict(frames=len(frames), keyframes=[sync.num_keyframes, ovl.num_keyframes], sync_s=sync_s,
                     overlap_s=ovl_s, odometry_max_abs_err=odom_err, trajectory_max_abs_err=pose_err_ovl,
                     synchronous_repeat_odometry_max_abs_err=repeat_err,
                     odometry_atol=OVERLAP_ODOM_ATOL, trajectory_atol=OVERLAP_POSE_ATOL),
    )
    emit(row)
    require(pose_err <= POSE_TEXT_ATOL, f"persistence: loaded poses differ from the dump's text by {pose_err}")
    for name, cmp in (("card vs CPU", card_cpu), ("fast vs mixed", paths), ("loaded vs the CLI's", saved)):
        require(cmp["unexplained"] == 0, f"persistence: maps {name} differ off voxel faces: {cmp}")
    require(g2o["other_tokens_differ"] == 0 and g2o["quaternion_max_abs_err"] <= QUAT_REDUMP_ATOL and same_kernels,
            f"persistence: the re-dumped graph.g2o differs from the CLI's: {g2o}")
    require(sync.num_frames == ovl.num_frames == len(frames) and sync.num_keyframes == ovl.num_keyframes,
            "persistence: overlapped run differs in frames or keyframes")
    require(odom_err <= OVERLAP_ODOM_ATOL, f"persistence: overlapped odometry differs by {odom_err}")
    require(pose_err_ovl <= OVERLAP_POSE_ATOL, f"persistence: overlapped trajectory differs by {pose_err_ovl}")
    shutil.rmtree(cli["workdir"], ignore_errors=True)
    return slams


# -- parallel/: the submap hierarchy, the sharded LM, processes, sharded loop matching ---

PARALLEL_ITERATIONS = 512  # the outdoor preset's g2o_solver_num_iterations
PARALLEL_BLOCK = 64  # blocks of 64/64/57, then 32/64/64/25 over the CLI graph's 185 poses
# the hierarchy against the dense solve, tests/test_parallel.py's form
HIER_ATE_FACTOR, HIER_ATE_SLACK_M = 1.5, 0.05
MESH_ONE_ATOL_M = 1e-9  # make_mesh()'s one entry: the dense solve, bit for bit expected
MESH_ATOL_M, MESH_CHI2_RTOL = 1e-6, 1e-9  # a 4-entry mesh of cuda:0: the shards' sums reassociated
# two gloo ranks against the dense solve: tests/test_multiprocess.py's tolerances
RANKS_ATOL_M, RANKS_CHI2_RTOL = 1e-5, 1e-6
NCCL_ATOL_M = 1e-9  # one NCCL rank: its all-reduce of one rank is a copy
RANKS_TIMEOUT_S = 180
PARALLEL_FRAMES = 64  # the backend route: golden_town's first frames, floor config
PARALLEL_SUBMAP_BLOCK = 8
PARALLEL_SHARDS = 4  # mesh entries of cuda:0 for the sharded LM and the sharded align
# The child process of a rank: chip_smoke.multihost_rank(workdir, world, rank, device, backend, iterations)
MULTIHOST_CHILD = "import sys\nimport chip_smoke\nchip_smoke.multihost_rank(*sys.argv[1:])\n"


def odometry_chain(slam):
    """A copy of ``slam``'s graph as the backend holds it before its first
    solve: every keyframe node at its odometry pose (odom2map is the
    identity then) and the anchor node, under fix_first_node_adaptive, at
    the first keyframe's (hdl_graph_slam_nodelet.cpp:579-582)."""
    import copy

    g = copy.deepcopy(slam.graph)
    for kf in slam.keyframes:
        g.poses[kf.node_id] = np.array(kf.odom, dtype=np.float64)
    if (slam.anchor_node_id is not None and slam.anchor_edge_first_kf is not None
            and slam.cfg.backend.fix_first_node_adaptive):
        g.poses[slam.anchor_node_id] = g.poses[slam.anchor_edge_first_kf].copy()
    return g


def keyframe_ate(graph, keyframes, truth) -> float:
    """ATE (m, Umeyama-aligned) of ``graph``'s keyframe poses against the
    truth poses indexed by frame (stamp i is frame i), as the cli phase
    computes it from the TUM files."""
    from hdl_graph_slam_tpu_torch.io import trajectory as traj_io

    return traj_io.ate_rmse([(kf.stamp, graph.poses[kf.node_id]) for kf in keyframes],
                            [(float(i), T) for i, T in enumerate(truth)], align=True)


def multihost_rank(workdir: str, world: str, rank: str, device: str, backend: str, iterations: str) -> None:
    """One rank (a child process of run_ranks): join the group through the
    file store in ``workdir``, load ``workdir``/graph.npz on ``device``,
    run distributed_optimize_multihost once for one iteration (warm-up)
    and once for ``iterations``, and write the result to rank<rank>.npz."""
    import torch
    import torch.distributed as tdist
    from hdl_graph_slam_tpu_torch import state
    from hdl_graph_slam_tpu_torch.parallel import multihost

    world, rank, iterations = int(world), int(rank), int(iterations)
    if device == "cpu":
        torch.set_num_threads(1)
    used = multihost.initialize("file://" + os.path.join(workdir, "store"), world, rank, device=device,
                                backend=backend)
    try:
        with np.load(os.path.join(workdir, "graph.npz")) as f:
            data = state.graph_data_from_numpy(dict(f), device=device)
        sync = torch.cuda.synchronize if data.poses.is_cuda else (lambda: None)
        multihost.distributed_optimize_multihost(data, max_iterations=1)
        sync()
        t0 = time.perf_counter()
        out, st = multihost.distributed_optimize_multihost(data, max_iterations=iterations)
        poses = out.poses.cpu().numpy()
        seconds = time.perf_counter() - t0
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), poses=poses, planes=out.planes.cpu().numpy(),
                 iterations=int(st.iterations), chi2_robust_before=float(st.chi2_robust_before),
                 chi2_robust_after=float(st.chi2_robust_after), seconds=seconds, backend=used,
                 group_backend=str(tdist.get_backend()), device=str(data.poses.device))
    finally:
        tdist.destroy_process_group()


def run_ranks(arrays: dict, workdir: str, world: int, device: str, backend: str, iterations: int,
              timeout_s: float) -> list:
    """distributed_optimize_multihost in ``world`` child processes on the
    graph ``arrays`` (state.graph_data_to_numpy's form), every rank on
    ``device`` with ``backend``, joined through a file store in
    ``workdir``. A rank that fails stops them all; ranks still running
    after ``timeout_s`` are killed; either raises. Returns each rank's
    result (multihost_rank's arrays) in rank order."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    np.savez(os.path.join(workdir, "graph.npz"), **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [HERE, os.environ.get("PYTHONPATH")])))
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen([sys.executable, "-c", MULTIHOST_CHILD, workdir, str(world), str(r), device,
                                           backend, str(iterations)], cwd=HERE, env=env, stdout=logs[r],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                log = f.read()[-3000:]
            raise RuntimeError(f"multihost rank {r} of {world} ({device}, {backend}) exited {p.returncode}"
                               f"{' (killed at the timeout)' if p.returncode < 0 else ''}:\n{log}")
    out = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


def _timed_solve(fn):
    """(result, seconds) of ``fn()``, the card synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def parallel_phase(golden, loaded) -> None:
    """parallel/ on the card. The CLI dump's graph (``loaded``: the
    persistence phase's backends on card and CPU; the outdoor preset adds
    no anchor node, so x, y and yaw are free) reset to its odometry chain, solved (a) by the dense LM, (b) by the submap hierarchy, card
    and CPU, (c) by the edge-sharded LM on make_mesh() and on a 4-entry mesh
    of cuda:0, (d) by two gloo ranks on cuda:0 and one NCCL rank in child
    processes; (e) the backend's three routes through run_windowed over
    golden_town's first PARALLEL_FRAMES frames; (f) the loop_methods
    candidates' GICP align sharded over the two meshes."""
    import torch
    from hdl_graph_slam_tpu_torch import state
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.graph import optimize
    from hdl_graph_slam_tpu_torch.graph.linearize import chi2_only
    from hdl_graph_slam_tpu_torch.io import trajectory as traj_io
    from hdl_graph_slam_tpu_torch.parallel import (distributed_optimize, hierarchical_optimize, make_mesh, partition,
                                                   sharded_candidate_align)
    from hdl_graph_slam_tpu_torch.registration import factory
    from hdl_graph_slam_tpu_torch.utils import course

    slam, truth = loaded["cuda"], golden["truth"]
    kfs = slam.keyframes
    chain = odometry_chain(slam)
    n_poses = len(chain.poses)
    base = dict(phase="parallel", poses=n_poses, keyframes=len(kfs), edges=chain.num_edges,
                floor_edges=len(chain.edge_rows["se3_plane"]), iterations=PARALLEL_ITERATIONS)
    ate_odom = keyframe_ate(chain, kfs, truth)
    chi2_start = float(chi2_only(chain.freeze(device="cuda"))[1])

    # (a) the dense LM, card and CPU: the reference
    dense = {}
    for dev in ("cuda", "cpu"):
        (out, st), sec = _timed_solve(lambda: optimize(chain.freeze(device=dev), max_iterations=PARALLEL_ITERATIONS))
        dense[dev] = dict(out=out, poses=out.poses.cpu().numpy(), stats=st, seconds=sec)
    dc, dp = dense["cuda"], dense["cpu"]
    g_dense = odometry_chain(slam)
    g_dense.update_estimates(dc["out"])
    ate_dense = keyframe_ate(g_dense, kfs, truth)
    it_dense = int(dc["stats"].iterations)
    row = dict(base, case="a_dense", ate_odom_m=ate_odom, ate_m=ate_dense, chi2_start=chi2_start,
               chi2_after=float(dc["stats"].chi2_robust_after), lm_iterations=it_dense,
               lm_iterations_cpu=int(dp["stats"].iterations), ms=1e3 * dc["seconds"], ms_cpu=1e3 * dp["seconds"],
               ms_per_iteration=1e3 * dc["seconds"] / max(it_dense, 1),
               ms_per_iteration_cpu=1e3 * dp["seconds"] / max(int(dp["stats"].iterations), 1),
               card_vs_cpu_m=float(np.abs(dc["poses"] - dp["poses"]).max()), atol_m=GRAPH_POSE_ATOL)
    emit(row)
    require(row["card_vs_cpu_m"] <= GRAPH_POSE_ATOL, f"parallel a: dense card vs CPU differ by {row['card_vs_cpu_m']}")

    # (b) the submap hierarchy, card and CPU, every LM solve counted
    hier = {}
    solves = []
    orig = partition.graph_optimize

    def counted(*a, **k):
        out = orig(*a, **k)
        solves.append(int(out[1].iterations))
        return out

    partition.graph_optimize = counted
    try:
        for dev in ("cuda", "cpu"):
            g = odometry_chain(slam)
            solves.clear()
            _, sec = _timed_solve(lambda: hierarchical_optimize(g, block_size=PARALLEL_BLOCK, rounds=2,
                                                                intra_iterations=PARALLEL_ITERATIONS,
                                                                inter_iterations=PARALLEL_ITERATIONS, device=dev))
            hier[dev] = dict(graph=g, seconds=sec, solves=list(solves))
    finally:
        partition.graph_optimize = orig
    hc, hp = hier["cuda"], hier["cpu"]
    ate_hier = keyframe_ate(hc["graph"], kfs, truth)
    chi2_hier = float(chi2_only(hc["graph"].freeze(device="cuda"))[1])
    it_hier = sum(hc["solves"])
    row = dict(base, case="b_hierarchical", block_size=PARALLEL_BLOCK, rounds=2,
               blocks=[[len(b.pose_ids) for b in partition.partition_poses(n_poses, PARALLEL_BLOCK, o)]
                       for o in (0, PARALLEL_BLOCK // 2)],
               ate_odom_m=ate_odom, ate_dense_m=ate_dense, ate_m=ate_hier, chi2_start=chi2_start, chi2_after=chi2_hier,
               lm_solves=len(hc["solves"]), lm_iterations=it_hier, lm_iterations_per_solve=hc["solves"],
               lm_iterations_cpu=sum(hp["solves"]), ms=1e3 * hc["seconds"], ms_cpu=1e3 * hp["seconds"],
               ms_per_iteration=1e3 * hc["seconds"] / max(it_hier, 1),
               ms_vs_dense=hc["seconds"] / dc["seconds"],
               card_vs_cpu_m=max(float(np.abs(a - b).max()) for a, b in zip(hc["graph"].poses, hp["graph"].poses)),
               vs_dense_m=max(float(np.abs(hc["graph"].poses[i] - g_dense.poses[i]).max()) for i in range(n_poses)),
               atol_m=GRAPH_POSE_ATOL, ate_bound_m=HIER_ATE_FACTOR * ate_dense + HIER_ATE_SLACK_M)
    emit(row)
    require(row["card_vs_cpu_m"] <= GRAPH_POSE_ATOL, f"parallel b: card vs CPU differ by {row['card_vs_cpu_m']}")
    require(ate_hier < ate_odom, f"parallel b: hierarchical ATE {ate_hier} >= odometry {ate_odom}")
    require(ate_hier <= row["ate_bound_m"], f"parallel b: hierarchical ATE {ate_hier} > {row['ate_bound_m']}")
    require(chi2_hier <= chi2_start, f"parallel b: chi2 {chi2_hier} above the start's {chi2_start}")

    # (c) the edge-sharded LM on make_mesh() and on PARALLEL_SHARDS entries of cuda:0
    ref_chi2 = float(dc["stats"].chi2_robust_after)
    for name, mesh, atol in (("c_mesh_local", make_mesh(), MESH_ONE_ATOL_M),
                             ("c_mesh_4x_cuda0", make_mesh(PARALLEL_SHARDS, "cuda:0"), MESH_ATOL_M)):
        (out, st), sec = _timed_solve(lambda: distributed_optimize(mesh, chain.freeze(device="cuda"),
                                                                   max_iterations=PARALLEL_ITERATIONS))
        its = int(st.iterations)
        err = float(np.abs(out.poses.cpu().numpy() - dc["poses"]).max())
        row = dict(base, case=name, mesh=[str(d) for d in mesh.devices], lm_iterations=its,
                   lm_iterations_dense=it_dense, ms=1e3 * sec, ms_per_iteration=1e3 * sec / max(its, 1),
                   ms_per_iteration_dense=1e3 * dc["seconds"] / max(it_dense, 1), vs_dense_m=err,
                   bit_identical=bool(err == 0.0), chi2_after=float(st.chi2_robust_after), chi2_dense=ref_chi2,
                   chi2_rel_err=abs(float(st.chi2_robust_after) - ref_chi2) / abs(ref_chi2), atol_m=atol,
                   chi2_rtol=MESH_CHI2_RTOL)
        emit(row)
        require(err <= atol, f"parallel {name}: {err} m from the dense solve")
        require(row["chi2_rel_err"] <= MESH_CHI2_RTOL, f"parallel {name}: chi2 {row['chi2_rel_err']} from dense")

    # (d) ranks in child processes: two gloo ranks on cuda:0, one NCCL rank
    arrays = state.graph_data_to_numpy(chain.freeze(device="cpu"))
    work = os.path.join(HERE, "_cache", "chip_smoke_ranks")
    with ThreadPoolExecutor(2) as ex:
        t0 = time.perf_counter()
        gloo = ex.submit(run_ranks, arrays, os.path.join(work, "gloo"), 2, "cuda:0", "gloo", PARALLEL_ITERATIONS,
                         RANKS_TIMEOUT_S)
        nccl = ex.submit(run_ranks, arrays, os.path.join(work, "nccl"), 1, "cuda:0", "nccl", PARALLEL_ITERATIONS,
                         RANKS_TIMEOUT_S)
        ranks = dict(gloo=gloo.result(), nccl=nccl.result())
        wall = time.perf_counter() - t0
    for name, res in ranks.items():
        err = max(float(np.abs(r["poses"] - dc["poses"]).max()) for r in res)
        chi2 = float(res[0]["chi2_robust_after"])
        its = int(res[0]["iterations"])
        row = dict(base, case=f"d_ranks_{name}", world=len(res), device="cuda:0",
                   backends=[str(r["group_backend"]) for r in res], devices=[str(r["device"]) for r in res],
                   ranks_bit_identical=all(np.array_equal(r["poses"], res[0]["poses"])
                                           and float(r["chi2_robust_after"]) == chi2 for r in res),
                   lm_iterations=its, ms=[1e3 * float(r["seconds"]) for r in res],
                   ms_per_iteration=1e3 * float(res[0]["seconds"]) / max(its, 1), wall_s_both_groups=wall,
                   vs_dense_m=err, chi2_after=chi2, chi2_rel_err=abs(chi2 - ref_chi2) / abs(ref_chi2),
                   atol_m=RANKS_ATOL_M if name == "gloo" else NCCL_ATOL_M, chi2_rtol=RANKS_CHI2_RTOL)
        emit(row)
        require(row["backends"] == [name] * len(res), f"parallel d: ranks ran {row['backends']}, not {name}")
        require(row["ranks_bit_identical"], f"parallel d {name}: the ranks differ")
        require(err <= row["atol_m"], f"parallel d {name}: {err} m from the dense solve")
        require(row["chi2_rel_err"] <= RANKS_CHI2_RTOL, f"parallel d {name}: chi2 {row['chi2_rel_err']} from dense")

    # (e) the backend's routes over golden_town's first frames
    frames = golden_frames(golden, PARALLEL_FRAMES)
    ref = [(float(i), T) for i, T in enumerate(truth)]
    routes = {}
    for name, field, value in (("dense", None, None), ("submap", "submap_block_size", PARALLEL_SUBMAP_BLOCK),
                               ("distributed", "distributed", True)):
        cfg = course.golden_town_config("floor")
        if field:
            setattr(cfg.backend, field, value)
        t0 = time.perf_counter()
        pipe, result = run_golden(cfg, frames)
        sec = time.perf_counter() - t0
        est = result.trajectory
        stamps = {t for t, _ in est}
        odom_kf = [(t, T) for t, T in result.odometry_trajectory if t in stamps]
        routes[name] = dict(stamps=[t for t, _ in est], poses=np.stack([T for _, T in est]), seconds=sec,
                            ate=traj_io.ate_rmse(est, ref, align=True), ate_odom=traj_io.ate_rmse(odom_kf, ref, align=True),
                            mesh=None if pipe.slam._mesh is None else [str(d) for d in pipe.slam._mesh.devices],
                            chi2=float(chi2_only(pipe.slam.graph.freeze(device="cuda"))[1]),
                            chi2_odometry=float(chi2_only(odometry_chain(pipe.slam).freeze(device="cuda"))[1]))
    rd, rs, rx = routes["dense"], routes["submap"], routes["distributed"]
    same_kf = rd["stamps"] == rs["stamps"] == rx["stamps"]
    row = dict(base, case="e_backend_routes", frames=len(frames), config="golden_town floor",
               keyframes=len(rd["stamps"]), submap_block_size=PARALLEL_SUBMAP_BLOCK,
               same_keyframes=same_kf, ate_odom_m=rd["ate_odom"],
               ate_m={k: v["ate"] for k, v in routes.items()}, seconds={k: v["seconds"] for k, v in routes.items()},
               below_odometry_ate={k: v["ate"] < v["ate_odom"] for k, v in routes.items()},
               chi2={k: v["chi2"] for k, v in routes.items()}, chi2_odometry_chain=rs["chi2_odometry"],
               distributed_mesh=rx["mesh"],
               distributed_vs_dense_m=float(np.abs(rx["poses"] - rd["poses"]).max()) if same_kf else None,
               submap_vs_dense_m=float(np.abs(rs["poses"] - rd["poses"]).max()) if same_kf else None,
               atol_m=MESH_ATOL_M, ate_bound_m=HIER_ATE_FACTOR * rd["ate"] + HIER_ATE_SLACK_M)
    emit(row)
    require(same_kf, "parallel e: the routes admitted different keyframes")
    require(row["distributed_vs_dense_m"] <= MESH_ATOL_M,
            f"parallel e: distributed {row['distributed_vs_dense_m']} m from dense")
    # before the first loop closure (~frame 300) no route's ATE beats the
    # odometry's (dense 0.016356 against 0.015954 m over 120 frames on the
    # H100): the submap route is held to the dense route's ATE and to a chi2
    # below its own graph's at the odometry chain
    require(rs["ate"] <= row["ate_bound_m"], f"parallel e: submap ATE {rs['ate']} > {row['ate_bound_m']}")
    require(rs["chi2"] < rs["chi2_odometry"],
            f"parallel e: submap chi2 {rs['chi2']} not below the odometry chain's {rs['chi2_odometry']}")

    # (f) the loop_methods candidates' GICP align, sharded
    frames_f = [LOOP_TARGET_FRAME + o for o in LOOP_CANDIDATE_OFFSETS]
    c = course.golden_town_config().loop.registration
    target = golden_cloud(golden["scans"][LOOP_TARGET_FRAME])
    sources = [golden_cloud(golden["scans"][i]) for i in frames_f]
    guesses = []
    for i in frames_f:
        gss = np.linalg.inv(truth[LOOP_TARGET_FRAME]) @ truth[i]
        gss[2, 3] = 0.0
        guesses.append(gss)
    tgt_state = factory.make_target(c, target)
    src = factory.prepare_source(c, PointCloud(xyz=torch.stack([s.xyz for s in sources]),
                                               mask=torch.stack([s.mask for s in sources])))
    g_t = torch.from_numpy(np.stack(guesses)).float().cuda()
    align = lambda t, s, gg: factory.align(c, t, s, gg)  # noqa: E731
    whole, sec_whole = _timed_solve(lambda: align(tgt_state, src, g_t))
    res = {}
    for name, mesh in (("mesh_local", make_mesh()), ("mesh_4x_cuda0", make_mesh(PARALLEL_SHARDS, "cuda:0"))):
        out, sec = _timed_solve(lambda: sharded_candidate_align(mesh, tgt_state, src, g_t, align))
        res[name] = dict(identical=all(torch.equal(a, b) for a, b in zip(out, whole)), ms=1e3 * sec,
                         transform_max_abs_err_m=float((out.transformation - whole.transformation)[:, :3, 3].abs().max()),
                         rotation_max_abs_err=float((out.transformation - whole.transformation)[:, :3, :3].abs().max()),
                         converged=[bool(x) for x in out.converged.cpu()])
    row = dict(phase="parallel", case="f_sharded_align", method=c.registration_method, candidates=frames_f,
               target_frame=LOOP_TARGET_FRAME, ms_batched=1e3 * sec_whole,
               converged=[bool(x) for x in whole.converged.cpu()], **res, atol_m=LOOP_MATCH_ATOL_M)
    emit(row)
    require(res["mesh_local"]["identical"], "parallel f: the one-entry mesh differs from the batched align")
    require(res["mesh_4x_cuda0"]["transform_max_abs_err_m"] <= LOOP_MATCH_ATOL_M,
            f"parallel f: the 4-entry mesh is {res['mesh_4x_cuda0']['transform_max_abs_err_m']} m from the batch")
    require(any(row["converged"]), "parallel f: no candidate converged")


def kernels_line(kres, bres, fres, nres, nimu, gres, launches, peak_flops) -> list:
    """One entry per kernel entry point measured in this run. ``launches``
    maps each path (main, slam, slam_floor, host, host_statistical: the
    STATISTICAL run(), host_statistical_windowed: its run_windowed twin, cli:
    the CLI's child process) to its launch counts; an entry's ``launches`` is
    that of its own main path, ``launches_cli`` the CLI's. radius_count
    carries the host path's shape and, under ``shape_16384``, the cli and
    imu paths'. The NDT kernels carry ndt_main's shapes (``nres``) and,
    under ``imu_shape``, the imu path's (``nimu``)."""
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
            launches=launches["main"][name], launches_slam=launches["slam"][name], launches_cli=launches["cli"][name],
            launches_per_frame=launches["main"][name] / (BENCH_FRAMES + 1),
            # this slice's paths: the VGICP and ICP windows, the reciprocal
            # ICP window and the loop detector's FAST_VGICP and ICP matches
            launches_by_method={p: launches[p][name] for p in ("vgicp_main", "icp_main", "icp_reciprocal",
                                                              "loop_FAST_VGICP", "loop_ICP")},
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
            launches=launches["slam"][f"{kind}_batched"], launches_cli=launches["cli"][f"{kind}_batched"],
            launches_by_method={p: launches[p][f"{kind}_batched"] for p in ("icp_reciprocal", "loop_FAST_VGICP",
                                                                            "loop_ICP")},
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
            host_ms=r["host_ms"], plain_ms=r["plain_ms"],
            bound_ms=1e3 * max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=None, shape=f"B={b} x {nq}x{m}" + (f", k={K_NEIGHBOURS}" if kind == "knn_select" else ""),
            resident_warps_per_sm=r["launch"]["resident_warps_per_sm"], grid_blocks_per_problem=r["launch"]["grid_blocks"],
            dynamic_smem_bytes=r["launch"]["dynamic_smem_bytes"],
            registers_per_thread=r["launch"]["registers_per_thread"],
        ))
    # radius_count: the host path's 4096 rows, and under shape_16384 the cli
    # and imu paths' rows; bound over the pairs tested, beside the valid pairs'
    def radius_entry(r, path):
        return dict(shape=f"{r['n']}x{r['m']} ({r['case']}, {r['valid']} valid, r={r['r']})",
                    launches=launches[path]["radius_count"], max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
                    kernel_ms=r["kernel_ms"], device_ms=r["device_ms"], host_ms=r["host_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"], tested_pairs=r["tested_pairs"],
                    valid_pairs=r["valid_pairs"], valid_pairs_bound_ms=r["valid_pairs_bound_ms"],
                    valid_pairs_bound_by=r["valid_pairs_bound_by"], tile_pairs=r["tile_pairs"],
                    tiles_full=r["tiles_full"],
                    tiles_point=r["tiles_point"], tested_share=r["tested_share"], library_ms=None,
                    grid_blocks=r["launch"]["grid_blocks"], threads_per_block=r["launch"]["threads_per_block"],
                    blocks_per_sm=r["launch"]["blocks_per_sm"], registers_per_thread=r["launch"]["registers_per_thread"])

    line.append(dict(
        name="radius_count", route="cuda", source="hdl_graph_slam_tpu_torch/csrc/knn.cu",
        replaces="hdl_graph_slam_tpu/ops/knn.py:180 (radius_count, XLA)", launches_cli=launches["cli"]["radius_count"],
        launches_by_path={p: v["radius_count"] for p, v in launches.items() if "radius_count" in v},
        **radius_entry(fres["radius_count"], "host"),
        shape_16384={{"outdoor": "cli"}.get(p, p): radius_entry(r, {"outdoor": "cli"}.get(p, p))
                     for p, r in fres["radius_count_16384"].items()},
    ))
    # the filter and floor kernels: the work this run's inputs need (valid pairs)
    for name, path, replaces, ops, out_per_row in (
            ("knn_select_k10", "slam_floor", "hdl_graph_slam_tpu/ops/knn.py:99 (knn, XLA top_k) at k=10, "
                                             "ops/normals.py:36", OPS_PER_PAIR, 80),
            ("knn_select_k21", "host_statistical", "hdl_graph_slam_tpu/ops/knn.py:99 (knn, XLA top_k) at k=21, "
                                                   "ops/filters.py:56", OPS_PER_PAIR, 168)):
        r = fres[name]
        ops_s = r["valid_pairs"] * ops / peak_flops
        bytes_s = (r["n"] * 12 + r["m"] * 12 + r["n"] * out_per_row) / HBM_BYTES_PER_S
        line.append(dict(
            name=name, route="cuda", source="hdl_graph_slam_tpu_torch/csrc/knn.cu", replaces=replaces,
            launches=launches[path][name], launches_cli=launches["cli"][name],
            launches_by_path={p: v[name] for p, v in launches.items() if name in v},
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
            host_ms=r["host_ms"], plain_ms=r["plain_ms"],
            bound_ms=1e3 * max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=None, shape=f"{r['n']}x{r['m']} ({r['case']})", valid_pairs=r["valid_pairs"],
            resident_warps_per_sm=r["launch"]["resident_warps_per_sm"], grid_blocks=r["launch"]["grid_blocks"],
            dynamic_smem_bytes=r["launch"]["dynamic_smem_bytes"], stage_rows=r["launch"]["stage_rows"],
            registers_per_thread=r["launch"]["registers_per_thread"],
        ))
    # the NDT kernels (csrc/ndt.cu) on the ndt_main path, knn_select k = 8 on ndt_kdtree's
    for name, replaces in (
            ("ndt_associate", "hdl_graph_slam_tpu/registration/ndt.py:101 (_gather_cells, XLA) with "
                              "ops/voxel.py:433 neighbor_query_keys and :190 lookup_dense"),
            ("ndt_derivatives", "hdl_graph_slam_tpu/registration/ndt.py:155 (score_derivatives over "
                                "_gather_mean_icov :91, XLA)"),
            ("ndt_trial_scores", "hdl_graph_slam_tpu/registration/ndt.py:137 (_score under the line search's "
                                 "jax.vmap :399, XLA)")):
        def shape(r):
            return (f"n={r['n']} ({r['valid']} valid), K={r['K']}, {r['cells']} cells at {r['resolution']} m"
                    + (f", L={NDT_TRIALS}" if name == "ndt_trial_scores" else ""))

        r, q = nres[name], nimu[name]
        extra = {}
        if name == "ndt_associate":
            # K = 1 over the VGICP voxels: vgicp_main's launches and shapes
            v = nres["vgicp_associate"]
            extra = dict(launches_vgicp_main=launches["vgicp_main"][name],
                         launches_loop_vgicp=launches["loop_FAST_VGICP"][name],
                         vgicp_shape=dict(shape=f"n={v['n']} ({v['valid']} valid), K=1, {v['voxels']} voxels at "
                                                f"{v['resolution']} m", found_pairs=v["found_pairs"],
                                          grid_reads=v["grid_reads"], max_abs_err=v["max_abs_err"],
                                          ms=v["kernel_ms"], kernel_ms=v["kernel_ms"], device_ms=v["device_ms"],
                                          host_ms=v["host_ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                                          bound_by=v["bound_by"], library_ms=None),
                         replaces_vgicp="hdl_graph_slam_tpu/registration/vgicp.py:94 (_correspond, XLA) with "
                                        "ops/voxel.py:190 lookup_dense / :110 searchsorted32")
        line.append(dict(
            name=name, route="cuda", source="hdl_graph_slam_tpu_torch/csrc/ndt.cu", replaces=replaces, **extra,
            launches=launches["ndt_main"][name], launches_imu=launches["imu"][name],
            launches_per_frame=launches["ndt_main"][name] / BENCH_FRAMES,
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
            host_ms=r["host_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape=shape(r), found_pairs=r["found_pairs"], cells_read=r["cells_read"],
            # the imu path's shapes (ndt_imu_kernels_phase)
            imu_shape=dict(shape=shape(q), found_pairs=q["found_pairs"], cells_read=q["cells_read"],
                           max_abs_err=q["max_abs_err"], ms=q["kernel_ms"], kernel_ms=q["kernel_ms"],
                           device_ms=q["device_ms"], host_ms=q["host_ms"], plain_ms=q["plain_ms"],
                           bound_ms=q["bound_ms"], bound_by=q["bound_by"], library_ms=None),
        ))
    # the GICP kernel (csrc/gicp.cu gicp_step_kernel) at the main path's shape (bench frames, one
    # problem), as the LM loop launches it: the fused form with the associate-only form and the VGICP
    # gate beside it, the linearize form with the cost form; the loop's B = 8 under batch_shape
    def times(r):
        return dict(max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
                    host_ms=r["host_ms"], wrapper_host_ms=r["wrapper_host_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)

    def shape(r):
        return f"B={r['batch']} x n={r['rows'] // r['batch']} ({r['valid']} valid rows)"

    def beside(r):
        return dict(shape=shape(r), **times(r))

    lb = gres["loop_batch"]
    for name, parts, replaces, extra in (
            ("gicp_associate_linearize", ("gicp_associate_linearize", "gicp_associate"),
             "hdl_graph_slam_tpu/registration/gicp.py:116 (_associate after its 1-NN search) then :131 "
             "(_linearize_at), registration/vgicp.py:112 then :124 (XLA)",
             dict(vgicp_gate=beside(gres["gicp_associate_linearize_vgicp"]),
                  associate_only=beside(gres["gicp_associate"]),
                  associate_only_vgicp_gate=beside(gres["gicp_associate_vgicp"]),
                  batch_shape=beside(lb["gicp_associate_linearize"]))),
            ("gicp_linearize", ("gicp_linearize", "gicp_cost"),
             "hdl_graph_slam_tpu/registration/gicp.py:131 (_linearize_at) and :147 (_cost_at), "
             "registration/vgicp.py:124 and :138 (XLA)",
             dict(cost_only=beside(gres["gicp_cost"]), batch_shape=beside(lb["gicp_linearize"])))):
        r = gres[name]
        line.append(dict(
            name=name, route="cuda", source="hdl_graph_slam_tpu_torch/csrc/gicp.cu", kernel="gicp_step_kernel",
            replaces=replaces, launches=sum(launches["main"][p] for p in parts),
            launches_per_frame=sum(launches["main"][p] for p in parts) / BENCH_FRAMES,
            launches_by_path={path: {p: v[p] for p in parts} for path, v in launches.items()},
            shape=shape(r), valid_rows=r["valid"], named_rows=r["named"], **times(r), **extra))
    r = nres["knn_select_k8"]
    ops_s = r["valid_pairs"] * OPS_PER_PAIR / peak_flops
    bytes_s = (r["n"] * 12 + r["m"] * 12 + r["n"] * 64) / HBM_BYTES_PER_S
    line.append(dict(
        name="knn_select_k8", route="cuda", source="hdl_graph_slam_tpu_torch/csrc/knn.cu",
        replaces="hdl_graph_slam_tpu/ops/knn.py:130 (knn_approx) at k=8, registration/ndt.py:131 (KDTREE)",
        launches=launches["ndt_kdtree"]["knn_select_k8"], launches_by_path={p: v["knn_select_k8"] for p, v in
                                                                            launches.items() if "knn_select_k8" in v},
        max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], kernel_ms=r["kernel_ms"], device_ms=r["device_ms"],
        host_ms=r["host_ms"], plain_ms=r["plain_ms"],
        bound_ms=1e3 * max(ops_s, bytes_s), bound_by="operations" if ops_s >= bytes_s else "bytes",
        library_ms=None, shape=f"{r['n']}x{r['m']} (moved bench points x cell means), k=8", valid_pairs=r["valid_pairs"],
        resident_warps_per_sm=r["launch"]["resident_warps_per_sm"], grid_blocks=r["launch"]["grid_blocks"],
        dynamic_smem_bytes=r["launch"]["dynamic_smem_bytes"], registers_per_thread=r["launch"]["registers_per_thread"],
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
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_FRAMES, BENCH_RAW_CAPACITY, BENCH_STEP

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
    with ThreadPoolExecutor(len(kernels.SOURCES)) as ex:  # one nvcc per source, started together
        list(ex.map(kernels.build, kernels.SOURCES))
    for name in kernels.SOURCES:
        kernels.load(name)
    build = dict(phase="build", seconds=time.perf_counter() - t0, nvcc_flags=kernels.NVCC_FLAGS,
                 sources={name: dict(seconds=kernels.build_info[name]["seconds"], ptxas=kernels.build_info[name]["ptxas"])
                          for name in kernels.SOURCES})
    emit(build)

    kres, launches = {}, {}
    # -- course (host ray casting) ----------------------------------------
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    scans = bench_scans(BENCH_FRAMES, workers)
    emit(dict(phase="course", frames=BENCH_FRAMES, seed=SEED, workers=workers, seconds=time.perf_counter() - t0,
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

    # -- 3c. the NDT kernels against their plain twins --------------------------
    nres = ndt_kernels_phase(knn, clouds, peak_flops)

    # -- 3d. on golden_town frames 0 and 1, cast here: the filter kernels, then
    # the NDT kernels at the imu path's shapes. Their one-operation gates run
    # early in the process: later, torch.profiler traces lost some or all of
    # the device events of the calls they held (PERF.md §6).
    first_scans = [_golden_scan(i) for i in range(2)]
    fres = kernel_filters_phase(knn, first_scans, [c[0] for c in clouds], rng, peak_flops)
    nimu = ndt_imu_kernels_phase(first_scans, peak_flops)
    # -- 3e. the VGICP target and its DIRECT1 association, early as well
    nres["vgicp_associate"], vtgt = vgicp_kernels_phase(clouds, peak_flops)
    # -- 3f. the GICP association and linearization kernels, early as well
    gres = gicp_kernels_phase(clouds, vtgt, peak_flops)
    del vtgt  # its 256^3 grid would count in main's peak memory

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
    # host syncs and device operations a frame over MAIN_TRACED_FRAMES frames, as window_phase
    _, syncs = count_host_syncs(lambda: win.run(state0, xyz[:MAIN_TRACED_FRAMES], mask[:MAIN_TRACED_FRAMES],
                                                stamps[:MAIN_TRACED_FRAMES])[1].cpu())
    main_row["host_syncs_per_frame"] = syncs / MAIN_TRACED_FRAMES
    prof = profile_frames(win, state0, xyz, mask, stamps, MAIN_TRACED_FRAMES, dt / BENCH_FRAMES)
    main_row.update({k: prof[k] for k in ("device_ops_per_frame", "device_busy_ms_per_frame",
                                          "device_idle_share_unprofiled", "top_device", "port_kernels")})
    emit(main_row)
    # bench.py:196-212
    require(bool(np.isfinite(odoms).all()), "non-finite pose")
    require(abs(main_row["final_x"] - dist) < 0.03 * dist, f"final x {main_row['final_x']} vs drive {dist}")
    require(main_row["converged_fraction"] > 0.9, f"only {main_row['converged_fraction']:.0%} of frames converged")
    require(main_row["det_err"] < 1e-4, f"det(R) drift {main_row['det_err']:.2e}")
    require(main_row["orth_err"] < 1e-4, f"orthogonality error {main_row['orth_err']:.2e}")
    require(all(launches["main"][k] >= BENCH_FRAMES for k in ("knn_select", "nn1") + GICP_GATED),
            f"main path did not go through the kernels: {launches['main']}")
    require_gicp_launches("main", launches["main"], BENCH_FRAMES, main_row["lm_iterations_per_frame"])

    if args.profile:
        emit(profile_frames(win, state0, xyz, mask, stamps, 16, dt / BENCH_FRAMES))

    # -- 4b. the bench course through the NDT window (DIRECT7), then KDTREE ------
    launches["ndt_main"], ndt_odoms = window_phase(knn, scans, "ndt_main", NDT_MAIN_REG, BENCH_FRAMES,
                                                   ("ndt_associate", "ndt_derivatives", "ndt_trial_scores"))
    launches["ndt_kdtree"], _ = window_phase(
        knn, scans, "ndt_kdtree", dict(NDT_MAIN_REG, reg_nn_search_method="KDTREE"), NDT_KDTREE_FRAMES,
        ("knn_select_k8", "ndt_derivatives", "ndt_trial_scores"), reference=ndt_odoms)

    # -- 4c. the same course with FAST_VGICP and with ICP, held to the JAX package's run
    launches["vgicp_main"], _ = window_phase(
        knn, scans, "vgicp_main", VGICP_MAIN_REG, BENCH_FRAMES, ("ndt_associate", "knn_select") + GICP_UNGATED,
        per_frame=("ndt_associate", "knn_select") + GICP_UNGATED,
        witness=VGICP_WITNESS)
    launches["icp_main"], _ = window_phase(knn, scans, "icp_main", ICP_MAIN_REG, ICP_MAIN_FRAMES, ("nn1",),
                                           per_frame=("nn1",), witness=ICP_WITNESS, drift_gate=False,
                                           traced=ICP_TRACED_FRAMES)
    launches["icp_reciprocal"], _ = window_phase(
        knn, scans, "icp_reciprocal", dict(ICP_MAIN_REG, reg_use_reciprocal_correspondences=True),
        ICP_RECIPROCAL_FRAMES, ("nn1", "nn1_batched"), per_frame=("nn1", "nn1_batched"),
        witness=ICP_RECIPROCAL_WITNESS, drift_gate=False, traced=ICP_TRACED_FRAMES)

    # -- 5. golden_town course (host ray casting in a process pool) ----------
    golden = golden_course_phase()

    # -- 6. batched kernels at the loop shapes; floor ----------
    keyframes = golden_keyframes(golden)
    bres = kernel_batched_phase(knn, golden, keyframes)
    gres["loop_batch"] = gicp_batched_phase(golden, peak_flops)
    floor_phase(keyframes, peak_flops)
    launches.update({f"loop_{m}": v for m, v in loop_methods_phase(golden).items()})

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

    # -- 10b. the imu preset (NDT odometry) per frame with IMU messages -----------------
    launches["imu"] = imu_phase(knn, golden)

    # -- 11. the offline CLI on golden_town, then 12. its dump ----------------------------
    cli = cli_phase(golden)
    launches["cli"] = cli["launches"]
    loaded = persistence_phase(golden, cli)

    # -- 12b. parallel/ on the CLI's graph from its odometry chain, and the backend's routes
    parallel_phase(golden, loaded)

    # -- 13. kernels line ------------------------------------------------------
    emit(dict(phase="done"))
    emit({"kernels": kernels_line(kres, bres, fres, nres, nimu, gres, launches, peak_flops)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
