"""Offline pipeline driver: frames -> prefilter -> odometry -> floor ->
backend -> trajectory/map (port of hdl_graph_slam_tpu/pipeline.py).

Replaces the reference's ROS launch graph + bag_player.py flow control
(SURVEY.md §3.6). Two modes, whose backend fires its optimize cycle on the
reference's cadence (graph_update_interval of stream time):
- ``run``/``process_frame``: each frame through the prefilter, the
  per-frame odometry (ScanMatchingOdometry, or DeviceOdometry with
  ``device_odometry=True``) with the IMU or robot-odometry init guess, and
  floor detection;
- ``run_windowed``: K frames of prefilter + odometry per window on the
  device (frontend/window.py), floor detection on the keyframes; with
  ``overlap_backend=True`` each optimize cycle runs on a worker thread.

AsyncBackend runs optimize cycles on a wall-clock timer thread, the
reference's timer-decoupled backend. A worker thread makes the instance's
device its current device (the current CUDA device and stream are per
thread in PyTorch) and uses that device's default stream, as the main
thread does; launches from both threads are serialised by the GIL, so the
overlap gains host time only. ``frames_from_rosbag``/``frames_from_kitti``
read recorded drives.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .backend import FloorMeasurement, GpsMeasurement, HdlGraphSlam, ImuMeasurement
from .core import cloud as cloudlib
from .core.config import SlamConfig, wire_derived
from .core.device import resolve_device
from .frontend import DeviceOdometry, FloorDetector, OdometryWindow, Prefilter, ScanMatchingOdometry, stack_scans
from .frontend.imu_prediction import ImuPredictor
from .utils.metrics import GLOBAL_TIMER


def _on_device(device: torch.device):
    """A function wrapper that runs ``fn`` with ``device`` as the calling
    thread's current CUDA device (a no-op off CUDA). Built on the thread that
    owns the pipeline, which resolves a bare ``cuda`` to its current index."""
    if device.type != "cuda":
        return lambda fn: fn()
    index = device.index if device.index is not None else torch.cuda.current_device()

    def run(fn):
        with torch.cuda.device(index):
            return fn()

    return run


@dataclasses.dataclass
class PipelineResult:
    trajectory: list  # [(stamp, 4x4)]
    odometry_trajectory: list
    num_frames: int
    num_keyframes: int
    wall_time_s: float
    frames_per_second: float


class SlamPipeline:
    """End-to-end offline SLAM over an iterator of sensor frames, on
    ``device`` (None = cuda)."""

    def __init__(self, cfg: Optional[SlamConfig] = None, cloud_capacity: int = 16384,
                 device_odometry: bool = False, device=None):
        self.cfg = wire_derived(cfg or SlamConfig())
        self.device = resolve_device(device)
        self.cloud_capacity = cloud_capacity
        self.prefilter = Prefilter(self.cfg.prefilter, out_capacity=cloud_capacity, device=self.device)
        if device_odometry:
            self.odometry = DeviceOdometry(self.cfg.odometry, device=self.device)
        else:
            self.odometry = ScanMatchingOdometry(self.cfg.odometry, device=self.device)
        self.floor = FloorDetector(self.cfg.floor, device=self.device) if self.cfg.floor.enabled else None
        self.slam = HdlGraphSlam(self.cfg, device=self.device)
        self._last_optimize_stream_time: Optional[float] = None
        self.odometry_trajectory = []
        self.imu_predictor = ImuPredictor() if self.cfg.odometry.enable_imu_frontend else None
        self._last_ang_vel = None  # for prefilter deskewing
        # external robot-odometry init guess (scan_matching_odometry_nodelet.
        # cpp:193-207): time-stamped poses in the robot_odom frame; per frame
        # the delta between the previous frame time and the current stamp
        # seeds the scan matcher (msf_source="odometry")
        self._robot_odom: list = []  # [(stamp, 4x4 pose)]
        self._prev_frame_time: Optional[float] = None

    def _detect_floor(self, stamp: float, cloud) -> None:
        coeffs = self.floor.detect(cloud)
        if coeffs is not None:
            self.slam.add_floor(FloorMeasurement(stamp=stamp, coeffs=coeffs))

    def process_frame(self, stamp: float, xyz: np.ndarray, intensity: Optional[np.ndarray] = None) -> np.ndarray:
        """One frame through prefilter, odometry, floor detection and the
        backend; returns the odometry pose (4x4 float64)."""
        if xyz is None or np.size(xyz) == 0:
            # the reference skips empty clouds (prefiltering_nodelet.cpp:111-113)
            return self.odometry_trajectory[-1][1] if self.odometry_trajectory else np.eye(4)
        with GLOBAL_TIMER.span("frame", rid=len(self.odometry_trajectory)):
            with GLOBAL_TIMER.span("ingest"):
                cloud = cloudlib.from_numpy(xyz, intensity=intensity, device=self.device)
            filtered = self.prefilter(cloud, ang_vel=self._last_ang_vel if self.cfg.prefilter.deskewing else None)
            msf_delta, msf_source = None, "imu"
            if self.imu_predictor is not None:
                msf_delta = self.imu_predictor.predict_delta(stamp)
            elif self.cfg.odometry.enable_robot_odometry_init_guess:
                # the reference's if/else-if order: the IMU frontend wins when
                # enabled (scan_matching_odometry_nodelet.cpp:182-207)
                msf_delta = self._robot_odom_delta(self._prev_frame_time, stamp)
                msf_source = "odometry"
            with GLOBAL_TIMER.span("odometry"):
                odom = self.odometry.step(stamp, filtered, msf_delta=msf_delta, msf_source=msf_source)
                if isinstance(odom, torch.Tensor):  # DeviceOdometry's pose stays on the device
                    GLOBAL_TIMER.count("host_sync.device_odometry_pose")
                    odom = odom.cpu().numpy()
                odom = np.asarray(odom, dtype=np.float64)
            self._prev_frame_time = stamp
            self.odometry_trajectory.append((stamp, odom))
            self.slam.add_frame(stamp, odom, filtered)
            if self.floor is not None:
                self._detect_floor(stamp, filtered)
        # the backend cycle is a request of its own (its spans are optimize_cycle's)
        if self._last_optimize_stream_time is None:
            self._last_optimize_stream_time = stamp
        elif stamp - self._last_optimize_stream_time >= self.cfg.backend.graph_update_interval:
            self.slam.optimize_cycle()
            self._last_optimize_stream_time = stamp
        return odom

    def add_gps(self, stamp: float, lat: float, lon: float, alt: float = float("nan")) -> None:
        self.slam.add_gps(GpsMeasurement(stamp=stamp, lat=lat, lon=lon, alt=alt))

    def add_imu(self, stamp: float, orientation_wxyz, acceleration, angular_velocity=None) -> None:
        self.slam.add_imu(
            ImuMeasurement(stamp=stamp, orientation=np.asarray(orientation_wxyz), acceleration=np.asarray(acceleration))
        )
        if angular_velocity is not None:
            self._last_ang_vel = np.asarray(angular_velocity, dtype=np.float64)
            if self.imu_predictor is not None:
                self.imu_predictor.add_imu(stamp, angular_velocity, acceleration)

    def add_robot_odometry(self, stamp: float, pose: np.ndarray) -> None:
        """Feed an external wheel/robot odometry pose (4x4, robot_odom frame)
        for the scan-matching init guess (the reference's tf lookup source,
        scan_matching_odometry_nodelet.cpp:193-207)."""
        self._robot_odom.append((float(stamp), np.asarray(pose, dtype=np.float64)))
        # a bounded history (a few seconds at sensor rate)
        if len(self._robot_odom) > 1024:
            del self._robot_odom[: len(self._robot_odom) - 1024]

    def _robot_odom_delta(self, t0: Optional[float], t1: float) -> Optional[np.ndarray]:
        """Delta of the robot-odometry pose between t0 and t1 (nearest
        samples; the reference falls back to the latest tf when the exact
        stamp is unavailable, scan_matching_odometry_nodelet.cpp:196-198).
        None on the first frame or with no samples (identity guess)."""
        if t0 is None or not self._robot_odom:
            return None
        p0 = min(self._robot_odom, key=lambda s: abs(s[0] - t0))[1]
        p1 = min(self._robot_odom, key=lambda s: abs(s[0] - t1))[1]
        return np.linalg.inv(p0) @ p1

    def add_nmea(self, stamp: float, sentence: str) -> None:
        from .io import nmea

        out = nmea.parse(sentence)
        if out.status == "A":
            self.add_gps(stamp, out.latitude, out.longitude)

    def finish(self) -> None:
        """Flush all queues and run a final optimization (config untouched)."""
        self.slam.flush()

    def run(self, frames: Iterable[Tuple[float, np.ndarray, Optional[np.ndarray]]]) -> PipelineResult:
        """Every frame through ``process_frame``, then ``finish``."""
        t0 = time.perf_counter()
        n = 0
        for item in frames:
            self.process_frame(item[0], item[1], item[2] if len(item) > 2 else None)
            n += 1
        self.finish()
        wall = time.perf_counter() - t0
        return PipelineResult(
            trajectory=self.slam.trajectory(),
            odometry_trajectory=self.odometry_trajectory,
            num_frames=n,
            num_keyframes=len(self.slam.keyframes),
            wall_time_s=wall,
            frames_per_second=n / wall if wall > 0 else 0.0,
        )

    def run_windowed(
        self,
        frames: Iterable[Tuple[float, np.ndarray, Optional[np.ndarray]]],
        window: int = 64,
        raw_capacity: Optional[int] = None,
        overlap_backend: bool = False,
    ) -> PipelineResult:
        """Offline throughput mode: prefilter + odometry for ``window``
        frames per window on the device (frontend/window.py), then the
        backend consumes the per-frame results; the same results as the JAX
        package's run_windowed. Keyframe clouds are slices of the window's
        own prefiltered output and stay on the device; the window's
        odometry poses come to the host once per window. Floor detection
        runs on the bootstrap frame and on every keyframe the backend admits
        (floor measurements are keyframe-associated,
        hdl_graph_slam_nodelet.cpp:470-511); IMU and robot-odometry init
        guesses are not injected inside a window. Deskewing is threaded as
        in the JAX package: each frame carries the latest IMU angular
        velocity seen at enqueue time (add_imu from the frames
        generator).

        ``overlap_backend=True`` runs each due optimize cycle on a worker
        thread so the next window is launched meanwhile — the reference's
        timer-decoupled nodelet architecture (hdl_graph_slam_nodelet.cpp:
        137-139) applied to offline replay. The HdlGraphSlam locks make this
        safe; the odometry is the synchronous run's, but when a cycle runs
        relative to the windows depends on wall time, so keep the default
        (synchronous, deterministic) for parity runs."""
        cap = raw_capacity or self.cloud_capacity * 2
        win = OdometryWindow(self.cfg.odometry, prefilter_cfg=self.cfg.prefilter, out_capacity=self.cloud_capacity,
                             device=self.device)
        deskew = self.cfg.prefilter.deskewing
        t0 = time.perf_counter()
        n = 0
        state = None
        pending: list = []  # [(stamp, raw xyz, ang_vel or None)]

        def _ang_vels(items):
            out = np.zeros((len(items), 3), dtype=np.float64)
            for i, (_, _, w) in enumerate(items):
                if w is not None:
                    out[i] = w
            return out

        def flush_window():
            nonlocal state, n
            if not pending:
                return
            base = 0
            if state is None:
                # the first frame bootstraps the keyframe (:166-174)
                with GLOBAL_TIMER.span("frame", rid=n):
                    stamp0 = pending[0][0]
                    with GLOBAL_TIMER.span("ingest"):
                        first = cloudlib.from_numpy(pending[0][1], capacity=cap, device=self.device)
                    w0 = pending[0][2]
                    state = win.init_state(stamp0, first, ang_vel=w0)
                    self.odometry_trajectory.append((stamp0, np.eye(4)))
                    cloud0 = self.prefilter(first, ang_vel=w0)
                    self.slam.add_frame(stamp0, np.eye(4), cloud0)
                    if self.floor is not None:
                        self._detect_floor(stamp0, cloud0)
                n += 1
                base = 1
                if len(pending) == 1:
                    pending.clear()
                    return
            stamps = np.asarray([s for s, _, _ in pending[base:]], dtype=np.float32)
            xyz, mask = stack_scans([x for _, x, _ in pending[base:]], capacity=cap)
            state, odoms, _status, fxyz, fmask = win.run_with_clouds(
                state, xyz, mask, stamps, ang_vel=_ang_vels(pending[base:])
            )
            GLOBAL_TIMER.count("host_sync.window_poses")
            odoms = odoms.cpu().numpy().astype(np.float64)  # one copy per window
            for i in range(len(stamps)):
                stamp = float(stamps[i])
                odom = odoms[i]
                self.odometry_trajectory.append((stamp, odom))
                n += 1
                if not self.slam.keyframe_updater.would_update(odom):
                    continue
                # the keyframe's backend work, a span of its frame's request
                with GLOBAL_TIMER.span("frame", rid=n - 1):
                    cloud = cloudlib.PointCloud(xyz=fxyz[i], mask=fmask[i])
                    self.slam.add_frame(stamp, odom, cloud)
                    if self.floor is not None:
                        self._detect_floor(stamp, cloud)
            pending.clear()

        executor = None
        pending_cycle = None
        if overlap_backend:
            from concurrent.futures import ThreadPoolExecutor

            executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="backend")
            on_device = _on_device(self.device)

        def run_cycle():
            nonlocal pending_cycle
            if executor is None:
                self.slam.optimize_cycle()
                return
            if pending_cycle is not None:
                pending_cycle.result()  # surface the worker's exception
            pending_cycle = executor.submit(on_device, self.slam.optimize_cycle)

        try:
            for item in frames:
                w = self._last_ang_vel if deskew else None
                pending.append((float(item[0]), item[1], w))
                if len(pending) >= window:
                    flush_window()
                    if (
                        self._last_optimize_stream_time is None
                        or item[0] - self._last_optimize_stream_time >= self.cfg.backend.graph_update_interval
                    ):
                        run_cycle()
                        self._last_optimize_stream_time = item[0]
            flush_window()
            if pending_cycle is not None:
                pending_cycle.result()
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
        self.finish()
        wall = time.perf_counter() - t0
        return PipelineResult(
            trajectory=self.slam.trajectory(),
            odometry_trajectory=self.odometry_trajectory,
            num_frames=n,
            num_keyframes=len(self.slam.keyframes),
            wall_time_s=wall,
            frames_per_second=n / wall if wall > 0 else 0.0,
        )


def frames_from_rosbag(path: str, points_topic: str = "/velodyne_points") -> Iterator:
    """Yield (stamp, xyz, intensity) from a bag (bag_player.py replacement)."""
    from .io import rosbag as rb

    reader = rb.BagReader(path)
    for m in reader.messages(topics=[points_topic]):
        stamp, _frame, xyz, inten = rb.parse_pointcloud2(m.raw)
        yield (stamp if stamp > 0 else m.stamp), xyz, inten


def frames_from_kitti(sequence_dir: str) -> Iterator:
    """Yield (stamp, xyz, reflectance) from a KITTI odometry sequence."""
    from .io.kitti import KittiOdometrySequence

    for stamp, xyz, refl in KittiOdometrySequence(sequence_dir):
        yield stamp, xyz, refl


class AsyncBackend:
    """Background optimization thread.

    The reference decouples the sensor-rate frontend from the backend with a
    3 s wall timer on the nodelet thread pool (optimization_timer_callback,
    hdl_graph_slam_nodelet.cpp:137-139). This thread reproduces that: it
    wakes every ``interval`` wall seconds and runs one optimize cycle on the
    backend's device while the frontend keeps feeding queues (the
    HdlGraphSlam locks make this safe). Use as a context manager around a
    real-time run; ``stop`` re-raises the worker's first error.
    """

    def __init__(self, slam: HdlGraphSlam, interval: Optional[float] = None):
        import threading

        self.slam = slam
        self.interval = interval if interval is not None else slam.cfg.backend.graph_update_interval
        self._on_device = _on_device(slam.device)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.cycles = 0
        self.errors: list = []

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self._on_device(self.slam.optimize_cycle)
                self.cycles += 1
            except Exception as e:  # surfaced on stop; never kills ingestion
                self.errors.append(e)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self):
        self._stop.set()
        self._thread.join()
        if self.errors:
            raise self.errors[0]
