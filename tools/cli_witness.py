#!/usr/bin/env python3
"""The JAX package as the witness of the port's CLI presets on golden_town,
both on the CPU.

    JAX_PLATFORMS=cpu python3 tools/cli_witness.py [--frames 100] [--workers 4]

The first ``--frames`` golden_town scans (benchmarks/golden_town.py's course,
cast as chip_smoke.py casts them) are written as a KITTI sequence under the
git-ignored ``_cache/cli_witness/``. Then, for each package:

- ``outdoor``: ``python -m <package>.run --kitti ... --preset outdoor
  --cloud-capacity 16384`` (chip_smoke.py's ``cli`` phase, cut to the prefix);
- ``imu``: the same with ``--preset imu`` (NDT_OMP odometry at 10 m cells;
  a KITTI sequence carries no IMU);
- ``imu_feed``: ``SlamPipeline(PRESETS["imu"](), cloud_capacity=16384).run``
  over the same frames with ``add_imu`` fed before each frame from the
  truth (utils/course.py golden_town_imu): chip_smoke.py's ``imu`` phase.

Each prints one JSON line: frames, keyframes and the ATE (Umeyama-aligned)
of the optimized and of the odometry keyframes against the truth, for the
JAX package and the port, and the largest difference between their poses,
frame for frame (optimized keyframes and odometry). The CLIs run as child
processes (the port's with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CLOUD_CAPACITY = 16384  # the CLIs' default


def ate_pair(est, odom, truth) -> dict:
    from hdl_graph_slam_tpu_torch.io import trajectory as traj_io

    kf = {s for s, _ in est}
    return dict(ate_opt_m=float(traj_io.ate_rmse(est, truth, align=True)),
                ate_odom_m=float(traj_io.ate_rmse([(s, T) for s, T in odom if s in kf], truth, align=True)),
                keyframes=len(est), frames=len(odom))


def max_diff(a, b) -> float:
    """Largest entry difference of two trajectories with the same stamps."""
    if [s for s, _ in a] != [s for s, _ in b]:
        return float("inf")
    return float(np.abs(np.stack([T for _, T in a]) - np.stack([np.asarray(T) for _, T in b])).max())


def run_cli(package: str, seq: str, preset: str, out_dir: str, frames: int) -> tuple:
    """One CLI run in a child process; (optimized, odometry) TUM trajectories."""
    from hdl_graph_slam_tpu_torch.io import trajectory as traj_io

    traj, odom = os.path.join(out_dir, f"{package}_{preset}_traj.txt"), os.path.join(out_dir, f"{package}_{preset}_odom.txt")
    cmd = [sys.executable, "-m", f"{package}.run", "--kitti", seq, "--preset", preset, "--cloud-capacity",
           str(CLOUD_CAPACITY), "--max-frames", str(frames), "--out-traj", traj, "--out-odom-traj", odom]
    if package.endswith("_torch"):
        cmd += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return traj_io.load_tum(traj), traj_io.load_tum(odom)


def run_imu_feed(package: str, scans, truth) -> tuple:
    """SlamPipeline with the imu preset and truth-built IMU messages, in
    process; (optimized, odometry) trajectories."""
    from hdl_graph_slam_tpu_torch.utils.course import golden_town_imu

    if package == "hdl_graph_slam_tpu":
        import jax

        jax.config.update("jax_enable_x64", True)
        from hdl_graph_slam_tpu.core.config import PRESETS
        from hdl_graph_slam_tpu.pipeline import SlamPipeline

        pipe = SlamPipeline(PRESETS["imu"](), cloud_capacity=CLOUD_CAPACITY)
    else:
        from hdl_graph_slam_tpu_torch.core.config import PRESETS
        from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline

        pipe = SlamPipeline(PRESETS["imu"](), cloud_capacity=CLOUD_CAPACITY, device="cpu")
    for i, ((stamp, q, acc, w), xyz) in enumerate(zip(golden_town_imu(truth[:len(scans)]), scans)):
        pipe.add_imu(stamp, orientation_wxyz=q, acceleration=acc, angular_velocity=w)
        pipe.process_frame(float(i), xyz)
    pipe.finish()
    return pipe.slam.trajectory(), [(s, np.asarray(T)) for s, T in pipe.odometry_trajectory]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100, help="golden_town frames from the start")
    ap.add_argument("--workers", type=int, default=4, help="processes casting the scans")
    ap.add_argument("--modes", nargs="+", default=["outdoor", "imu", "imu_feed"],
                    choices=["outdoor", "imu", "imu_feed"])
    args = ap.parse_args(argv)

    import chip_smoke
    from hdl_graph_slam_tpu_torch.utils import course

    truth_all = course.golden_town_sensor_poses()
    scans = chip_smoke.golden_scans(args.frames, args.workers)
    truth = [(float(i), T) for i, T in enumerate(truth_all[:args.frames])]
    work = os.path.join(REPO, "_cache", "cli_witness")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    seq, _ = chip_smoke.write_kitti_sequence(scans, truth_all[:args.frames], work)
    for mode in args.modes:
        out = dict(mode=mode, frames=args.frames, cloud_capacity=CLOUD_CAPACITY)
        trajs = {}
        for package in ("hdl_graph_slam_tpu", "hdl_graph_slam_tpu_torch"):
            t0 = time.perf_counter()
            if mode == "imu_feed":
                trajs[package] = run_imu_feed(package, scans, truth_all)
            else:
                trajs[package] = run_cli(package, seq, mode, work, args.frames)
            out[package] = dict(ate_pair(*trajs[package], truth), seconds=time.perf_counter() - t0)
        (est_j, odom_j), (est_p, odom_p) = trajs["hdl_graph_slam_tpu"], trajs["hdl_graph_slam_tpu_torch"]
        out["max_pose_diff_opt"] = max_diff(est_p, est_j)
        out["max_pose_diff_odom"] = max_diff(odom_p, odom_j)
        print(json.dumps(out), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
