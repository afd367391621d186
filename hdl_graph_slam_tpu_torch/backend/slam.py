"""Backend orchestrator: keyframe admission, multi-sensor graph construction,
periodic optimization, map assembly (port of hdl_graph_slam_tpu/backend/slam.py).

Equivalent of HdlGraphSlamNodelet (apps/hdl_graph_slam_nodelet.cpp), with the
ROS queues/timers replaced by explicit method calls from the pipeline driver:
- add_frame()        <- cloud_callback + KeyframeUpdater gate (:149-178)
- add_gps/imu/floor  <- the sensor callbacks (:252-282, 360-366, 457-467)
- optimize_cycle()   <- optimization_timer_callback (:546-612)
- generate_map()     <- map_points_publish_timer_callback (:517-540)
- save_map/dump/load <- the three services (:818-1013)

The graph is host-side numpy (graph.types.GraphBuilder); each optimize cycle
freezes it to float64 tensors on the device, runs the dense LM there and
copies the estimates back once. ``backend.distributed`` shards the edges
over a mesh of the local devices, or over the processes of an initialized
``torch.distributed`` group; ``backend.submap_block_size`` > 0 solves
graphs of more poses through the submap hierarchy (parallel/). Keyframe
clouds stay on the device, and the map is built there. A dump has the
reference's layout and loads in either package.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ..core.cloud import PointCloud
from ..core.config import SlamConfig, wire_derived
from ..core.device import resolve_device
from ..graph import GraphBuilder, optimize as graph_optimize
from ..io import geodesy
from ..parallel import distributed_optimize, hierarchical_optimize, make_mesh
from ..parallel.multihost import distributed_optimize_multihost
from ..utils.metrics import GLOBAL_TIMER
from .information_matrix import InformationMatrixCalculator
from .keyframe import KeyFrame, KeyFrameSnapshot, KeyframeUpdater
from .loop_detector import LoopDetector
from .map_cloud import MapCloudGenerator


@dataclasses.dataclass
class GpsMeasurement:
    stamp: float
    lat: float
    lon: float
    alt: float  # NaN when unavailable (NMEA path)


@dataclasses.dataclass
class ImuMeasurement:
    stamp: float
    orientation: np.ndarray  # quaternion (w,x,y,z) in base frame
    acceleration: np.ndarray  # (3,) in base frame


@dataclasses.dataclass
class FloorMeasurement:
    stamp: float
    coeffs: np.ndarray  # (4,)


class HdlGraphSlam:
    """The backend on ``device`` (None = cuda): keyframe clouds, loop
    matching and the pose-graph solve run there; the graph is float64."""

    def __init__(self, cfg: Optional[SlamConfig] = None, device=None):
        self.cfg = wire_derived(cfg or SlamConfig())
        self.device = resolve_device(device)
        b = self.cfg.backend
        self._mesh = None  # the local mesh of backend.distributed, made at its first use
        self.graph = GraphBuilder()
        self.keyframe_updater = KeyframeUpdater(b.keyframe_delta_trans, b.keyframe_delta_angle)
        self.loop_detector = LoopDetector(self.cfg.loop)
        self.inf_calculator = InformationMatrixCalculator(self.cfg.information)
        self.map_generator = MapCloudGenerator()

        self.keyframes: List[KeyFrame] = []
        self.new_keyframes: List[KeyFrame] = []
        self.keyframe_queue: List[KeyFrame] = []
        self.keyframe_hash = {}  # stamp -> KeyFrame
        self.gps_queue: List[GpsMeasurement] = []
        self.imu_queue: List[ImuMeasurement] = []
        self.floor_queue: List[FloorMeasurement] = []

        self.trans_odom2map = np.eye(4)
        # one lock covers queue mutation and one the optimize cycle, as the
        # reference's per-queue mutexes + main_thread_mutex
        # (hdl_graph_slam_nodelet.cpp:1056-1090)
        self.queue_lock = threading.Lock()
        self.main_lock = threading.Lock()
        self.zero_utm: Optional[np.ndarray] = None
        self.anchor_node_id: Optional[int] = None
        self.anchor_edge_first_kf: Optional[int] = None
        self.floor_plane_node_id: Optional[int] = None
        self.snapshots: List[KeyFrameSnapshot] = []
        self.last_stats = None
        self.cycles = 0  # optimize cycles run: the next cycle's index

    # -- ingestion -----------------------------------------------------------

    def add_frame(self, stamp: float, odom: np.ndarray, cloud: PointCloud) -> bool:
        """cloud_callback (:149-178): gate by KeyframeUpdater, enqueue.

        The odometry rotation is projected back onto SO(3) (polar
        projection) before it becomes a graph measurement: the SE(3) edge
        residual log(M^-1 · rel) on a non-orthogonal rotation reports
        phantom chi2 that the optimizer "repairs" by bending the trajectory
        (the round-4 bf16-matmul post-mortem in PERF.md — a det(R)=1.1 odom
        chain corrupted estimates by 10-30 m and silenced the loop
        detector). The projection is exact for healthy inputs and a few
        microseconds per keyframe."""
        odom = np.asarray(odom, dtype=np.float64).copy()
        U, _s, Vt = np.linalg.svd(odom[:3, :3])
        R = U @ Vt
        if np.linalg.det(R) < 0.0:  # keep it a rotation, not a reflection
            R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
        odom[:3, :3] = R
        if not self.keyframe_updater.update(odom):
            return False
        kf = KeyFrame(
            stamp=stamp,
            odom=odom,
            accum_distance=self.keyframe_updater.get_accum_distance(),
            cloud=PointCloud(xyz=cloud.xyz.to(self.device), mask=cloud.mask.to(self.device)),
        )
        with self.queue_lock:
            self.keyframe_queue.append(kf)
        return True

    def add_gps(self, m: GpsMeasurement) -> None:
        m.stamp += self.cfg.backend.gps_time_offset
        with self.queue_lock:
            self.gps_queue.append(m)

    def add_imu(self, m: ImuMeasurement) -> None:
        m.stamp += self.cfg.backend.imu_time_offset
        with self.queue_lock:
            self.imu_queue.append(m)

    def add_floor(self, m: FloorMeasurement) -> None:
        with self.queue_lock:
            self.floor_queue.append(m)

    # -- queue flushing ------------------------------------------------------

    def _flush_keyframe_queue(self) -> bool:
        """(:184-249): admit up to max_keyframes_per_update keyframes, add
        pose nodes (odom2map * odom) and consecutive odometry edges with
        adaptive information; anchor the first node if configured. Holds the
        queue lock for the whole flush like the reference (:185)."""
        with self.queue_lock:
            return self._flush_keyframe_queue_locked()

    def _flush_keyframe_queue_locked(self) -> bool:
        if not self.keyframe_queue:
            return False
        b = self.cfg.backend
        odom2map = self.trans_odom2map
        num = min(len(self.keyframe_queue), b.max_keyframes_per_update)
        GLOBAL_TIMER.count("keyframes_admitted", num)
        pending = []  # (kf, prev, relative_pose) odometry edges of this flush
        for i in range(num):
            kf = self.keyframe_queue[i]
            self.new_keyframes.append(kf)
            odom = odom2map @ kf.odom
            kf.node_id = self.graph.add_se3_node(odom)
            self.keyframe_hash[kf.stamp] = kf

            if not self.keyframes and len(self.new_keyframes) == 1:
                if b.fix_first_node:
                    inf = np.eye(6)
                    stddevs = [float(s) for s in b.fix_first_node_stddev.split()]
                    for d in range(6):
                        inf[d, d] = 1.0 / stddevs[d]  # reference divides by stddev
                    self.anchor_node_id = self.graph.add_se3_node(np.eye(4), fixed=True)
                    self.anchor_edge_first_kf = kf.node_id
                    self._anchor_edge_idx = self.graph.add_se3_edge(
                        self.anchor_node_id, kf.node_id, np.eye(4), inf
                    )
            if i == 0 and not self.keyframes:
                continue
            prev = self.keyframes[-1] if i == 0 else self.keyframe_queue[i - 1]
            relative_pose = np.linalg.inv(kf.odom) @ prev.odom
            pending.append((kf, prev, relative_pose))
        # adaptive information matrices for the whole flush in ONE device
        # program (one fitness dispatch + one sync instead of one per edge)
        infos = self.inf_calculator.calc_information_matrices_batched(
            [(kf.cloud, prev.cloud, rp) for kf, prev, rp in pending]
        )
        for (kf, prev, relative_pose), information in zip(pending, infos):
            self.graph.add_se3_edge(
                kf.node_id,
                prev.node_id,
                relative_pose,
                information,
                kernel=b.odometry_edge_robust_kernel,
                kernel_delta=b.odometry_edge_robust_kernel_size,
            )
        del self.keyframe_queue[:num]
        return True

    def _flush_gps_queue(self) -> bool:
        """(:290-358): closest-in-time <= 0.2 s association, UTM - zero_utm,
        XY or XYZ prior edge with info I/stddev."""
        with self.queue_lock:
            return self._flush_gps_queue_locked()

    def _flush_gps_queue_locked(self) -> bool:
        if not self.keyframes or not self.gps_queue:
            return False
        b = self.cfg.backend
        updated = False
        last_stamp = self.gps_queue[-1].stamp
        for kf in self.keyframes:
            if kf.stamp > last_stamp:
                break
            if kf.utm_coord is not None:
                continue
            closest = min(self.gps_queue, key=lambda g: abs(g.stamp - kf.stamp))
            if abs(closest.stamp - kf.stamp) > 0.2:
                continue
            e, n, _zone = geodesy.wgs84_to_utm(closest.lat, closest.lon)
            xyz = np.array([e, n, closest.alt])
            if self.zero_utm is None:
                self.zero_utm = xyz.copy()
            xyz = xyz - self.zero_utm
            kf.utm_coord = xyz
            if np.isnan(xyz[2]):
                info = np.eye(2) / b.gps_edge_stddev_xy
                self.graph.add_se3_prior_xy_edge(
                    kf.node_id, xyz[:2], info, kernel=b.gps_edge_robust_kernel, kernel_delta=b.gps_edge_robust_kernel_size
                )
            else:
                info = np.eye(3)
                info[:2, :2] /= b.gps_edge_stddev_xy
                info[2, 2] /= b.gps_edge_stddev_z
                self.graph.add_se3_prior_xyz_edge(
                    kf.node_id, xyz, info, kernel=b.gps_edge_robust_kernel, kernel_delta=b.gps_edge_robust_kernel_size
                )
            updated = True
        last_kf_stamp = self.keyframes[-1].stamp
        self.gps_queue = [g for g in self.gps_queue if g.stamp > last_kf_stamp]
        return updated

    def _flush_imu_queue(self) -> bool:
        """(:370-451): orientation quat prior + gravity-vector prior."""
        with self.queue_lock:
            return self._flush_imu_queue_locked()

    def _flush_imu_queue_locked(self) -> bool:
        if not self.keyframes or not self.imu_queue:
            return False
        b = self.cfg.backend
        if not (b.enable_imu_orientation or b.enable_imu_acceleration):
            return False
        updated = False
        last_stamp = self.imu_queue[-1].stamp
        for kf in self.keyframes:
            if kf.stamp > last_stamp:
                break
            if kf.acceleration is not None:
                continue
            closest = min(self.imu_queue, key=lambda m: abs(m.stamp - kf.stamp))
            if abs(closest.stamp - kf.stamp) > 0.2:
                continue
            kf.acceleration = np.asarray(closest.acceleration, dtype=np.float64)
            q = np.asarray(closest.orientation, dtype=np.float64)
            if q[0] < 0:
                q = -q
            kf.orientation = q
            if b.enable_imu_orientation:
                info = np.eye(3) / b.imu_orientation_edge_stddev
                self.graph.add_se3_prior_quat_edge(
                    kf.node_id, q, info,
                    kernel=b.imu_orientation_edge_robust_kernel,
                    kernel_delta=b.imu_orientation_edge_robust_kernel_size,
                )
            if b.enable_imu_acceleration:
                info = np.eye(3) / b.imu_acceleration_edge_stddev
                self.graph.add_se3_prior_vec_edge(
                    kf.node_id, [0.0, 0.0, -1.0], kf.acceleration, info,
                    kernel=b.imu_acceleration_edge_robust_kernel,
                    kernel_delta=b.imu_acceleration_edge_robust_kernel_size,
                )
            updated = True
        last_kf_stamp = self.keyframes[-1].stamp
        self.imu_queue = [m for m in self.imu_queue if m.stamp > last_kf_stamp]
        return updated

    def _flush_floor_queue(self) -> bool:
        """(:470-511): exact-stamp association to keyframes, shared fixed
        floor plane node, SE3->plane edges."""
        with self.queue_lock:
            return self._flush_floor_queue_locked()

    def _flush_floor_queue_locked(self) -> bool:
        if not self.keyframes:
            return False
        b = self.cfg.backend
        updated = False
        latest = self.keyframes[-1].stamp
        remaining = []
        for m in self.floor_queue:
            if m.stamp > latest:
                remaining.append(m)
                continue
            kf = self.keyframe_hash.get(m.stamp)
            if kf is None:
                continue
            if self.floor_plane_node_id is None:
                self.floor_plane_node_id = self.graph.add_plane_node([0.0, 0.0, 1.0, 0.0], fixed=True)
            info = np.eye(3) / b.floor_edge_stddev
            self.graph.add_se3_plane_edge(
                kf.node_id, self.floor_plane_node_id, m.coeffs, info,
                kernel=b.floor_edge_robust_kernel, kernel_delta=b.floor_edge_robust_kernel_size,
            )
            kf.floor_coeffs = np.asarray(m.coeffs)
            updated = True
        self.floor_queue = remaining
        return updated

    # -- optimization cycle --------------------------------------------------

    def optimize_cycle(self) -> bool:
        """optimization_timer_callback (:546-612). Returns True if the
        estimates were updated. Thread-safe vs the ingestion methods."""
        with self.main_lock:
            cycle, self.cycles = self.cycles, self.cycles + 1
            with GLOBAL_TIMER.span("optimize_cycle", rid=cycle):
                return self._optimize_cycle_locked()

    def flush(self) -> bool:
        """End-of-stream flush: drain every queue and optimize until nothing
        is pending, then settle once more so loop closures found over the
        last admitted batch are optimized too.

        The reference has no such API — its max_keyframes_per_update is a
        per-cycle admission cap (hdl_graph_slam_nodelet.cpp:197), and offline
        runs simply keep the 3 s timer firing after the bag ends. This is the
        deterministic equivalent for the offline pipeline, and unlike a
        config override it leaves cfg untouched."""
        updated = False
        while True:
            updated = self.optimize_cycle() or updated
            with self.queue_lock:
                pending = bool(self.keyframe_queue)
            if not pending:
                break
        updated = self.optimize_cycle() or updated
        return updated

    def _optimize_cycle_locked(self) -> bool:
        b = self.cfg.backend
        with GLOBAL_TIMER.span("flush_queues"):
            keyframe_updated = self._flush_keyframe_queue()
            flushed = self._flush_floor_queue() | self._flush_gps_queue() | self._flush_imu_queue()
        if not keyframe_updated and not flushed:
            # reference also short-circuits when nothing new (:561-564)
            if not self.new_keyframes:
                return False

        with GLOBAL_TIMER.span("loop_detect"):
            estimates = self._current_estimates()
            loops = self.loop_detector.detect(self.keyframes, self.new_keyframes, estimates)
            GLOBAL_TIMER.count("loops_added", len(loops))
            for loop in loops:
                relpose = loop.relative_pose
                if np.isfinite(loop.fitness) and self.cfg.loop.fitness_score_max_range == float("inf"):
                    # the batched matcher already computed this fitness (same
                    # clouds, same pose, max_range=inf)
                    information = self.inf_calculator.information_from_fitness(loop.fitness)
                else:
                    information = self.inf_calculator.calc_information_matrix(loop.key1.cloud, loop.key2.cloud,
                                                                               relpose)
                self.graph.add_se3_edge(
                    loop.key1.node_id,
                    loop.key2.node_id,
                    relpose,
                    information,
                    kernel=b.loop_closure_edge_robust_kernel,
                    kernel_delta=b.loop_closure_edge_robust_kernel_size,
                )

        self.keyframes.extend(self.new_keyframes)
        self.new_keyframes = []

        # anchor re-targeting (:579-582)
        if self.anchor_node_id is not None and b.fix_first_node_adaptive and self.anchor_edge_first_kf is not None:
            self.graph.poses[self.anchor_node_id] = self.graph.poses[self.anchor_edge_first_kf].copy()

        # optimize (graph_slam.cpp:292-321; skip if < 10 edges), float64 on
        # the device as the JAX package under x64
        if self.graph.num_edges >= 10:
            iters = b.g2o_solver_num_iterations
            if b.submap_block_size > 0 and len(self.graph.poses) > b.submap_block_size:
                # per-host keyframe blocks refined independently, condensed
                # base graph solved globally (parallel/partition.py); both
                # boundary phases per cycle (its rounds alternate the block
                # offsets so boundary poses see their priors)
                with GLOBAL_TIMER.span("graph_optimize"):
                    hierarchical_optimize(self.graph, block_size=b.submap_block_size, intra_iterations=iters,
                                          inter_iterations=iters, rounds=2, device=self.device)
            else:
                with GLOBAL_TIMER.span("graph_freeze"):
                    data = self.graph.freeze(dtype=torch.float64, device=self.device)
                with GLOBAL_TIMER.span("graph_optimize"):
                    if b.distributed and tdist.is_initialized() and tdist.get_world_size() > 1:
                        data, stats = distributed_optimize_multihost(data, max_iterations=iters)
                    elif b.distributed:
                        if self._mesh is None:
                            self._mesh = make_mesh(device=self.device)
                        data, stats = distributed_optimize(self._mesh, data, max_iterations=iters)
                    else:
                        data, stats = graph_optimize(data, max_iterations=iters)
                with GLOBAL_TIMER.span("update_estimates"):
                    self.graph.update_estimates(data)
                self.last_stats = stats

        if self.keyframes:
            last = self.keyframes[-1]
            est = self.graph.poses[last.node_id]
            self.trans_odom2map = est @ np.linalg.inv(last.odom)

        with GLOBAL_TIMER.span("snapshots"):
            self.snapshots = [
                KeyFrameSnapshot(pose=self.graph.poses[kf.node_id], cloud=kf.cloud) for kf in self.keyframes
            ]
        return True

    def _current_estimates(self) -> np.ndarray:
        if self.graph.poses:
            return np.stack(self.graph.poses)
        return np.zeros((0, 4, 4))

    # -- outputs -------------------------------------------------------------

    def generate_map(self, resolution: Optional[float] = None) -> Optional[np.ndarray]:
        res = self.cfg.backend.map_cloud_resolution if resolution is None else resolution
        return self.map_generator.generate(self.snapshots, resolution=res)

    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        return [(kf.stamp, self.graph.poses[kf.node_id]) for kf in self.keyframes]

    # -- persistence services (dump/load/save_map,
    #    hdl_graph_slam_nodelet.cpp:818-1013) --------------------------------

    def save_map(self, path: str, resolution: Optional[float] = None, utm: bool = False) -> bool:
        """save_map_service (:982-1013): assemble + write PCD (+ .utm).

        ``utm=True`` mirrors SaveMap.srv's ``utm`` flag: output points are
        offset by zero_utm so the map lands in the absolute UTM frame
        (hdl_graph_slam_nodelet.cpp:995-999). No-op when no GPS fix has
        established a datum, like the reference's ``zero_utm &&`` guard.
        """
        from ..io import pcd as pcdio

        pts = self.generate_map(resolution=resolution)
        if pts is None:
            return False
        if utm and self.zero_utm is not None:
            pts = pts + self.zero_utm.astype(pts.dtype)
        if self.zero_utm is not None:
            with open(path + ".utm", "w") as f:
                f.write("%.6f %.6f %.6f\n" % tuple(self.zero_utm))
        pcdio.save_pcd(path, pts)
        return True

    def dump(self, directory: str) -> bool:
        """dump_service (:932-974): graph.g2o + per-keyframe dirs +
        zero_utm + special_nodes.csv, matching the reference layout
        (keyframe.cpp:21-58)."""
        import os

        from ..graph.io import save_g2o
        from ..io import pcd as pcdio

        def row(values) -> str:
            return " ".join("%.9g" % v for v in values)

        os.makedirs(directory, exist_ok=True)
        save_g2o(self.graph, os.path.join(directory, "graph.g2o"))
        for i, kf in enumerate(self.keyframes):
            kdir = os.path.join(directory, "%06d" % i)
            os.makedirs(kdir, exist_ok=True)
            with open(os.path.join(kdir, "data"), "w") as f:
                secs = int(kf.stamp)
                nsecs = int(round((kf.stamp - secs) * 1e9))
                f.write(f"stamp {secs} {nsecs}\n")
                f.write("estimate\n")
                for r in self.graph.poses[kf.node_id]:
                    f.write(row(r) + "\n")
                f.write("odom\n")
                for r in kf.odom:
                    f.write(row(r) + "\n")
                f.write(f"accum_distance {kf.accum_distance:.9g}\n")
                for name in ("floor_coeffs", "utm_coord", "acceleration", "orientation"):
                    value = getattr(kf, name)
                    if value is not None:
                        f.write(f"{name} {row(value)}\n")
                f.write(f"id {kf.node_id}\n")
            pcdio.save_pcd(os.path.join(kdir, "cloud.pcd"), kf.cloud.to_numpy())
        if self.zero_utm is not None:
            with open(os.path.join(directory, "zero_utm"), "w") as f:
                f.write("%.6f %.6f %.6f\n" % tuple(self.zero_utm))
        with open(os.path.join(directory, "special_nodes.csv"), "w") as f:
            f.write(f"anchor_node {-1 if self.anchor_node_id is None else self.anchor_node_id}\n")
            f.write(f"anchor_edge {-1}\n")
            f.write(f"floor_node {-1 if self.floor_plane_node_id is None else self.floor_plane_node_id}\n")
        return True

    def load(self, directory: str) -> bool:
        """load_service (:818-923): rebuild graph + keyframes from a dump;
        the clouds go to this instance's device."""
        import os

        from ..core import cloud as cloudlib
        from ..graph.io import load_g2o
        from ..io import pcd as pcdio

        self.graph = load_g2o(os.path.join(directory, "graph.g2o"))
        self.keyframes = []
        self.keyframe_hash = {}
        i = 0
        while True:
            kdir = os.path.join(directory, "%06d" % i)
            if not os.path.isdir(kdir):
                break
            fields = {}
            matrices = {}
            with open(os.path.join(kdir, "data")) as f:
                lines = f.read().splitlines()
            j = 0
            while j < len(lines):
                parts = lines[j].split()
                if not parts:
                    j += 1
                elif parts[0] in ("estimate", "odom"):
                    matrices[parts[0]] = np.asarray([[float(v) for v in lines[j + k + 1].split()] for k in range(4)])
                    j += 5
                else:
                    fields[parts[0]] = parts[1:]
                    j += 1
            xyz, inten = pcdio.load_pcd(os.path.join(kdir, "cloud.pcd"))
            secs, nsecs = int(fields["stamp"][0]), int(fields["stamp"][1])
            kf = KeyFrame(
                stamp=secs + nsecs * 1e-9,
                odom=matrices["odom"],
                accum_distance=float(fields["accum_distance"][0]),
                cloud=cloudlib.from_numpy(xyz, intensity=inten, device=self.device),
                node_id=int(fields["id"][0]),
            )
            for name in ("floor_coeffs", "utm_coord", "acceleration", "orientation"):
                if name in fields:
                    setattr(kf, name, np.array([float(v) for v in fields[name]]))
            self.keyframes.append(kf)
            self.keyframe_hash[kf.stamp] = kf
            i += 1
        zpath = os.path.join(directory, "zero_utm")
        if os.path.exists(zpath):
            with open(zpath) as f:
                self.zero_utm = np.array([float(v) for v in f.read().split()])
        spath = os.path.join(directory, "special_nodes.csv")
        if os.path.exists(spath):
            with open(spath) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 2 or int(parts[1]) < 0:
                        continue
                    if parts[0] == "anchor_node":
                        self.anchor_node_id = int(parts[1])
                        if self.keyframes:
                            self.anchor_edge_first_kf = self.keyframes[0].node_id
                    elif parts[0] == "floor_node":
                        self.floor_plane_node_id = int(parts[1])
        if self.keyframes:
            self.keyframe_updater.is_first = False
            self.keyframe_updater.accum_distance = self.keyframes[-1].accum_distance
            self.keyframe_updater.prev_keypose = self.keyframes[-1].odom.copy()
        self.snapshots = [
            KeyFrameSnapshot(pose=self.graph.poses[kf.node_id], cloud=kf.cloud) for kf in self.keyframes
        ]
        return True
