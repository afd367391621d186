#!/usr/bin/env python3
"""The JAX package as the witness of the port's FAST_VGICP and ICP windows
on the bench course, both on the CPU.

    JAX_PLATFORMS=cpu python3 tools/method_witness.py [--frames 64] [--methods FAST_VGICP ICP ICP_RECIPROCAL]

The first ``--frames`` frames of bench.py's course (seed 0; utils/course.py
make_course, frame 0 bootstrapping the keyframe) go through an
OdometryWindow of each package with bench.py's prefilter (0.2 m voxels
into 8192 rows, raw scans at 16384 rows) and benchmarks/r3_method_window.py's
odometry row for the method: FAST_VGICP at 1.0 m voxels, ICP with the
defaults; ICP_RECIPROCAL is ICP with reciprocal correspondences over the
first ``--reciprocal-frames`` frames. These are chip_smoke.py's
``vgicp_main`` and ``icp_main`` prefixes.

Each method prints one JSON line: the JAX window's and the port's (CPU)
final x, converged share and LM iterations a frame at the prefix, the
largest difference between their poses frame for frame and between their
final x, and the seconds each side took. chip_smoke.py gates the card's x
at that prefix on the JAX final x printed here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT_CAPACITY = 8192
# benchmarks/r3_method_window.py:51-53
METHOD_REG = {
    "FAST_VGICP": dict(registration_method="FAST_VGICP", reg_resolution=1.0),
    "ICP": dict(registration_method="ICP"),
    "ICP_RECIPROCAL": dict(registration_method="ICP", reg_use_reciprocal_correspondences=True),
}


def run_window(package: str, reg: dict, scans) -> tuple:
    """(poses (K, 4, 4), converged (K,), iterations (K,), seconds) of one
    package's window over scans[1:], bootstrapped from scans[0]."""
    from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_RAW_CAPACITY

    xyz, mask = stack_scans(scans[1:], capacity=BENCH_RAW_CAPACITY)
    stamps = (0.1 * np.arange(1, len(scans))).astype(np.float32)
    if package == "hdl_graph_slam_tpu":
        import jax

        jax.config.update("jax_enable_x64", True)
        from hdl_graph_slam_tpu.core import cloud as cloudlib
        from hdl_graph_slam_tpu.core.config import OdometryConfig, PrefilterConfig, RegistrationConfig
        from hdl_graph_slam_tpu.frontend.window import OdometryWindow

        kw = {}
    else:
        import torch

        from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
        from hdl_graph_slam_tpu_torch.core.config import OdometryConfig, PrefilterConfig, RegistrationConfig
        from hdl_graph_slam_tpu_torch.frontend.window import OdometryWindow

        torch.set_num_threads(4)
        kw = dict(device="cpu")
    win = OdometryWindow(OdometryConfig(keyframe_delta_trans=2.0, keyframe_delta_time=1e9,
                                        registration=RegistrationConfig(**reg)),
                         prefilter_cfg=PrefilterConfig(downsample_resolution=0.2, outlier_removal_method="NONE"),
                         out_capacity=OUT_CAPACITY, **kw)
    t0 = time.perf_counter()
    state = win.init_state(0.0, cloudlib.from_numpy(scans[0], capacity=BENCH_RAW_CAPACITY, **kw))
    _, odoms, status = win.run(state, xyz, mask, stamps)
    return (np.asarray(odoms, np.float64), np.asarray(status["converged"]), np.asarray(status["iterations"]),
            time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64, help="bench course frames after the bootstrap frame")
    ap.add_argument("--reciprocal-frames", type=int, default=32, help="frames of the ICP_RECIPROCAL run")
    ap.add_argument("--methods", nargs="+", default=list(METHOD_REG), choices=list(METHOD_REG))
    args = ap.parse_args(argv)

    from hdl_graph_slam_tpu_torch.utils.course import BENCH_STEP, make_course

    scans = make_course(args.frames, BENCH_STEP, seed=0)
    for method in args.methods:
        frames = args.reciprocal_frames if method == "ICP_RECIPROCAL" else args.frames
        out = dict(method=method, frames=frames, registration=METHOD_REG[method], drive_m=BENCH_STEP * frames)
        runs = {}
        for package in ("hdl_graph_slam_tpu", "hdl_graph_slam_tpu_torch"):
            poses, conv, its, secs = runs[package] = run_window(package, METHOD_REG[method], scans[:frames + 1])
            out[package] = dict(final_x=float(poses[-1, 0, 3]), converged_fraction=float(conv.mean()),
                                iterations_per_frame=float(its.mean()), seconds=secs)
        pj, pp = runs["hdl_graph_slam_tpu"][0], runs["hdl_graph_slam_tpu_torch"][0]
        out["max_pose_diff"] = float(np.abs(pp - pj).max())
        out["final_x_diff"] = abs(float(pp[-1, 0, 3] - pj[-1, 0, 3]))
        out["converged_flags_differ"] = int((runs["hdl_graph_slam_tpu"][1] != runs["hdl_graph_slam_tpu_torch"][1]).sum())
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
