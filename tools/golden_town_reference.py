#!/usr/bin/env python3
"""golden_town through the JAX package's SlamPipeline.run_windowed, once, on
the CPU: keyframes, loop and floor edges, and the ATE of the optimized and
the odometry keyframes. The reference for the port's golden_town phases in
chip_smoke.py under configurations benchmarks/golden_town.py does not have.

    JAX_PLATFORMS=cpu python3 tools/golden_town_reference.py {base,floor,outdoor} [--workers 4]

base and floor are benchmarks/golden_town.py's make_cfg modes; outdoor is
floor with the outdoor (hdl_400) preset's prefilter outlier filter, RADIUS
0.8 m with at least 2 neighbours (core/config.py preset_outdoor). The port's
hdl_graph_slam_tpu_torch/utils/course.py builds the same three
configurations (tests/test_torch_frontend.py holds them equal). One pass,
no warm-up: the seconds printed include JAX's compiles.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CLOUD_CAPACITY, RAW_CAPACITY, WINDOW, SENSOR_HEIGHT = 4096, 16384, 16, 1.8


def sensor_poses():
    from hdl_graph_slam_tpu.utils import lidar_sim as L

    out = []
    for pose in L.town_course(blocks=2, loops=2, step=1.2):
        sensor = pose.copy()
        sensor[2, 3] += SENSOR_HEIGHT
        out.append(sensor)
    return out


_SCENE = None


def cast(i: int):
    """Frame i of the course, as benchmarks/golden_town.py casts it (a
    process-pool worker)."""
    global _SCENE
    from hdl_graph_slam_tpu.utils import lidar_sim as L

    if _SCENE is None:
        model = L.LidarModel(rings=32, azimuth_steps=512, max_range=60.0, range_noise=0.02, dropout=0.05)
        _SCENE = L.make_town(seed=1, blocks=3), model, sensor_poses()
    town, model, poses = _SCENE
    return L.scan(town, poses[i], model, seed=i)


def make_cfg(mode: str):
    """benchmarks/golden_town.py make_cfg(mode) for base and floor; outdoor
    adds the RADIUS filter to floor."""
    from hdl_graph_slam_tpu.core.config import RegistrationConfig, SlamConfig

    reg = RegistrationConfig(registration_method="FAST_GICP", reg_reassoc_displacement=0.1)
    cfg = SlamConfig()
    cfg.prefilter.downsample_resolution = 0.5
    cfg.prefilter.outlier_removal_method = "NONE"
    cfg.prefilter.distance_far_thresh = 60.0
    cfg.odometry.registration = reg
    cfg.odometry.keyframe_delta_trans = 4.0
    cfg.odometry.keyframe_delta_time = 1e9
    cfg.backend.keyframe_delta_trans = 4.0
    cfg.backend.fix_first_node = True
    cfg.backend.fix_first_node_stddev = "10 10 1000 1 1 1"
    cfg.backend.g2o_solver_num_iterations = 60
    cfg.backend.graph_update_interval = 10.0
    cfg.loop.registration = reg
    cfg.loop.distance_thresh = 15.0
    cfg.loop.accum_distance_thresh = 25.0
    cfg.loop.min_edge_interval = 15.0
    cfg.loop.fitness_score_thresh = 2.5
    cfg.floor.enabled = mode in ("floor", "outdoor")
    if cfg.floor.enabled:
        cfg.floor.sensor_height = SENSOR_HEIGHT
        cfg.floor.height_clip_range = 1.0
        cfg.floor.floor_pts_thresh = 256
    if mode == "outdoor":
        cfg.prefilter.outlier_removal_method = "RADIUS"
        cfg.prefilter.radius_radius = 0.8
        cfg.prefilter.radius_min_neighbors = 2
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("base", "floor", "outdoor"))
    ap.add_argument("--workers", type=int, default=4, help="processes casting the 601 scans")
    args = ap.parse_args(argv)

    truth = sensor_poses()
    with ProcessPoolExecutor(args.workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        scans = list(ex.map(cast, range(len(truth)), chunksize=8))

    import jax

    jax.config.update("jax_enable_x64", True)
    from hdl_graph_slam_tpu.io import trajectory as traj_io
    from hdl_graph_slam_tpu.pipeline import SlamPipeline

    t0 = time.perf_counter()
    pipe = SlamPipeline(make_cfg(args.mode), cloud_capacity=CLOUD_CAPACITY)
    res = pipe.run_windowed([(float(i), x, None) for i, x in enumerate(scans)], window=WINDOW,
                            raw_capacity=RAW_CAPACITY)
    kf = {s for s, _ in res.trajectory}
    ref = [(float(i), T) for i, T in enumerate(truth)]
    rows = pipe.slam.graph.edge_rows
    print(json.dumps(dict(
        mode=args.mode, package="hdl_graph_slam_tpu (JAX)", backend=jax.default_backend(),
        seconds=time.perf_counter() - t0, frames=res.num_frames, keyframes=res.num_keyframes,
        loop_edges=len(rows["se3_se3"]) - (res.num_keyframes - 1) - 1, floor_edges=len(rows["se3_plane"]),
        ate_opt_m=float(traj_io.ate_rmse(res.trajectory, ref, align=True)),
        ate_odom_m=float(traj_io.ate_rmse([(s, T) for s, T in res.odometry_trajectory if s in kf], ref,
                                          align=True)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
