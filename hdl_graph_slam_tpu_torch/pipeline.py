"""Offline pipeline driver: frames -> prefilter + odometry windows -> backend
-> trajectory (port of hdl_graph_slam_tpu/pipeline.py).

Replaces the reference's ROS launch graph + bag_player.py flow control
(SURVEY.md §3.6). This slice ports the windowed throughput mode
(``run_windowed``, synchronous backend): K frames of prefilter + FAST_GICP
odometry per window on the device (frontend/window.py), then the backend
consumes the per-frame results and fires its optimize cycle on the
reference's cadence (graph_update_interval of stream time).

Not ported in this slice, each raising NotImplementedError: the per-frame
host path (``run``/``process_frame`` with ScanMatchingOdometry) and the IMU
frontend are ROADMAP Queue 1 item 10, as is floor detection
(``floor.enabled``); ``overlap_backend=True`` and AsyncBackend are item 13.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Tuple

import numpy as np

from .backend import GpsMeasurement, HdlGraphSlam, ImuMeasurement
from .core import cloud as cloudlib
from .core.config import SlamConfig, wire_derived
from .core.device import resolve_device
from .frontend import OdometryWindow, Prefilter
from .frontend.window import stack_scans


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

    def __init__(self, cfg: Optional[SlamConfig] = None, cloud_capacity: int = 16384, device=None):
        self.cfg = wire_derived(cfg or SlamConfig())
        if self.cfg.floor.enabled:
            raise NotImplementedError("floor.enabled: floor detection is ROADMAP Queue 1 item 10 of the port")
        if self.cfg.odometry.enable_imu_frontend:
            raise NotImplementedError("odometry.enable_imu_frontend: the IMU frontend is ROADMAP Queue 1 item 10 "
                                      "of the port")
        self.device = resolve_device(device)
        self.cloud_capacity = cloud_capacity
        self.prefilter = Prefilter(self.cfg.prefilter, out_capacity=cloud_capacity, device=self.device)
        self.slam = HdlGraphSlam(self.cfg, device=self.device)
        self._last_optimize_stream_time: Optional[float] = None
        self.odometry_trajectory = []
        self._last_ang_vel = None  # for prefilter deskewing

    @property
    def odometry(self):
        """The per-frame host odometry (the JAX package builds it eagerly;
        here it would be built on first use)."""
        raise NotImplementedError("ScanMatchingOdometry (the per-frame host path) is ROADMAP Queue 1 item 10 "
                                  "of the port; use run_windowed")

    def process_frame(self, stamp: float, xyz: np.ndarray, intensity: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError("process_frame (per-frame host odometry) is ROADMAP Queue 1 item 10 of the port; "
                                  "use run_windowed")

    def run(self, frames) -> PipelineResult:
        raise NotImplementedError("run (per-frame host odometry) is ROADMAP Queue 1 item 10 of the port; "
                                  "use run_windowed")

    def add_gps(self, stamp: float, lat: float, lon: float, alt: float = float("nan")) -> None:
        self.slam.add_gps(GpsMeasurement(stamp=stamp, lat=lat, lon=lon, alt=alt))

    def add_imu(self, stamp: float, orientation_wxyz, acceleration, angular_velocity=None) -> None:
        self.slam.add_imu(
            ImuMeasurement(stamp=stamp, orientation=np.asarray(orientation_wxyz), acceleration=np.asarray(acceleration))
        )
        if angular_velocity is not None:
            self._last_ang_vel = np.asarray(angular_velocity, dtype=np.float64)

    def finish(self) -> None:
        """Flush all queues and run a final optimization (config untouched)."""
        self.slam.flush()

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
        odometry poses come to the host once per window. Deskewing is
        threaded as in the JAX package: each frame carries the latest IMU
        angular velocity seen at enqueue time (add_imu from the frames
        generator)."""
        if overlap_backend:
            raise NotImplementedError("overlap_backend=True (the backend on a worker thread) is ROADMAP Queue 1 "
                                      "item 13 of the port")
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
                stamp0 = pending[0][0]
                first = cloudlib.from_numpy(pending[0][1], capacity=cap, device=self.device)
                w0 = pending[0][2]
                state = win.init_state(stamp0, first, ang_vel=w0)
                self.odometry_trajectory.append((stamp0, np.eye(4)))
                self.slam.add_frame(stamp0, np.eye(4), self.prefilter(first, ang_vel=w0))
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
            odoms = odoms.cpu().numpy().astype(np.float64)  # one copy per window
            for i in range(len(stamps)):
                stamp = float(stamps[i])
                odom = odoms[i]
                self.odometry_trajectory.append((stamp, odom))
                n += 1
                if not self.slam.keyframe_updater.would_update(odom):
                    continue
                self.slam.add_frame(stamp, odom, cloudlib.PointCloud(xyz=fxyz[i], mask=fmask[i]))
            pending.clear()

        for item in frames:
            w = self._last_ang_vel if deskew else None
            pending.append((float(item[0]), item[1], w))
            if len(pending) >= window:
                flush_window()
                if (
                    self._last_optimize_stream_time is None
                    or item[0] - self._last_optimize_stream_time >= self.cfg.backend.graph_update_interval
                ):
                    self.slam.optimize_cycle()
                    self._last_optimize_stream_time = item[0]
        flush_window()
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


class AsyncBackend:
    """The background optimization thread (hdl_graph_slam_nodelet.cpp:137-139)."""

    def __init__(self, slam: HdlGraphSlam, interval: Optional[float] = None):
        raise NotImplementedError("AsyncBackend is ROADMAP Queue 1 item 13 of the port")
