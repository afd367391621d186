"""CLI runner: offline SLAM over a rosbag or KITTI sequence on the card
(port of hdl_graph_slam_tpu/run.py).

Replaces the reference's `roslaunch hdl_graph_slam_*.launch` +
bag_player.py workflow (README.md:113-184):

    python -m hdl_graph_slam_tpu_torch.run --bag hdl_501.bag --preset indoor \
        --out-traj traj.txt --out-map map.pcd --dump dump_dir

    python -m hdl_graph_slam_tpu_torch.run --kitti sequences/00 --preset kitti \
        --out-traj 00.txt --ref-poses poses/00.txt

Everything runs on ``--device`` (default cuda; without a GPU the run raises,
it never falls back to the CPU). ``--device cpu`` runs the plain PyTorch
path. The same arguments, outputs and stdout lines as the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import json
import sys

from .core.config import PRESETS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="hdl_graph_slam offline runner (PyTorch/CUDA)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--bag", help="rosbag 2.0 file with PointCloud2 scans")
    src.add_argument("--kitti", help="KITTI odometry sequence dir (with velodyne/)")
    ap.add_argument("--points-topic", default="/velodyne_points")
    ap.add_argument("--gps-topic", default="/gps/geopoint")
    ap.add_argument("--navsat-topic", default="/gps/navsat")
    ap.add_argument("--nmea-topic", default="/gpsimu_driver/nmea_sentence")
    ap.add_argument("--imu-topic", default="/gpsimu_driver/imu_data")
    ap.add_argument(
        "--preset", default="base",
        choices=sorted(PRESETS),
        help="launch-preset analog (hdl_graph_slam{,_501,_400,_kitti,_imu}.launch)",
    )
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-traj", help="write optimized trajectory (TUM format)")
    ap.add_argument("--out-odom-traj", help="write raw odometry trajectory (TUM)")
    ap.add_argument("--out-map", help="write map point cloud (PCD)")
    ap.add_argument("--map-resolution", type=float, default=0.05)
    ap.add_argument("--dump", help="dump full graph + keyframes to directory")
    ap.add_argument("--load", help="load a previous dump before processing")
    ap.add_argument("--out-graph-json", help="write graph visualization JSON")
    ap.add_argument("--ref-poses", help="KITTI ground-truth poses for ATE/RPE")
    ap.add_argument("--trace", help="trace the run and write its summary JSON here: per span name its calls, "
                                    "total and self time; the program's counters (host syncs by site, LM "
                                    "iterations, loop candidates, ...)")
    ap.add_argument("--device-odometry", action="store_true", help="per-frame odometry with the pose kept on the device")
    ap.add_argument("--window", type=int, default=0,
                    help="offline throughput mode: process N frames per device window (frontend/window.py)")
    ap.add_argument("--cloud-capacity", type=int, default=16384, help="padded cloud capacity (power of two; match your sensor's post-filter density)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    from .io import trajectory as traj_io
    from .pipeline import SlamPipeline, frames_from_kitti, frames_from_rosbag
    from .utils.metrics import GLOBAL_TIMER

    if args.trace:
        GLOBAL_TIMER.enable()  # the spans of this run only
    cfg = PRESETS[args.preset]()
    pipe = SlamPipeline(cfg, cloud_capacity=args.cloud_capacity, device_odometry=args.device_odometry,
                        device=args.device)
    if args.load:
        pipe.slam.load(args.load)

    if args.bag:
        frames = frames_from_rosbag(args.bag, points_topic=args.points_topic)
        # feed GPS/IMU/NMEA side channels in a pre-pass (offline: order-safe)
        from .io import rosbag as rb

        side_topics = [args.gps_topic, args.navsat_topic, args.nmea_topic, args.imu_topic]
        for m in rb.BagReader(args.bag).messages(topics=side_topics):
            if m.topic == args.nmea_topic:
                stamp, sentence = rb.parse_nmea_sentence(m.raw)
                pipe.add_nmea(stamp or m.stamp, sentence)
            elif m.topic == args.navsat_topic:
                stamp, lat, lon, alt = rb.parse_navsatfix(m.raw)
                pipe.add_gps(stamp or m.stamp, lat, lon, alt)
            elif m.topic == args.gps_topic:
                stamp, lat, lon, alt = rb.parse_geopoint(m.raw)
                pipe.add_gps(stamp or m.stamp, lat, lon, alt)
            elif m.topic == args.imu_topic:
                stamp, _f, q, w, a = rb.parse_imu(m.raw)
                pipe.add_imu(stamp or m.stamp, q, a, angular_velocity=w)
    else:
        frames = frames_from_kitti(args.kitti)

    if args.max_frames:
        import itertools

        frames = itertools.islice(frames, args.max_frames)

    if args.window > 0:
        result = pipe.run_windowed(frames, window=args.window)
    else:
        result = pipe.run(frames)
    print(
        json.dumps(
            {
                "frames": result.num_frames,
                "keyframes": result.num_keyframes,
                "wall_s": round(result.wall_time_s, 2),
                "fps": round(result.frames_per_second, 2),
                "edges": pipe.slam.graph.num_edges,
            }
        )
    )

    if args.out_traj:
        traj_io.save_tum(args.out_traj, result.trajectory)
    if args.out_odom_traj:
        traj_io.save_tum(args.out_odom_traj, result.odometry_trajectory)
    if args.out_map:
        with GLOBAL_TIMER.span("save_map"):
            pipe.slam.save_map(args.out_map, resolution=args.map_resolution)
    if args.dump:
        with GLOBAL_TIMER.span("dump"):
            pipe.slam.dump(args.dump)
    if args.out_graph_json:
        from .utils.markers import save_graph_json

        save_graph_json(pipe.slam, args.out_graph_json)
    if args.ref_poses:
        from .io.kitti import read_poses

        ref = read_poses(args.ref_poses)
        ref_traj = [(i * 0.1, ref[i]) for i in range(ref.shape[0])]
        est = [(s, T) for s, T in result.trajectory]
        ate = traj_io.ate_rmse(est, ref_traj)
        rpe_t, rpe_r = traj_io.rpe_rmse(est, ref_traj)
        print(json.dumps({"ate_rmse_m": ate, "rpe_trans_m": rpe_t, "rpe_rot_rad": rpe_r}))
    if args.trace:
        GLOBAL_TIMER.disable()
        GLOBAL_TIMER.dump_summary(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
