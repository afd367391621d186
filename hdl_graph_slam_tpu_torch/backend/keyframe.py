"""KeyFrame record + admission gate (port of hdl_graph_slam_tpu/backend/keyframe.py).

Equivalents of hdl_graph_slam::KeyFrame / KeyFrameSnapshot
(include/hdl_graph_slam/keyframe.hpp:38-69) and KeyframeUpdater
(keyframe_updater.hpp:34-63). Host-side numpy, as in the JAX package; a
keyframe's cloud stays on the device (a slice of the odometry window's
prefiltered output).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.cloud import PointCloud


@dataclasses.dataclass
class KeyFrame:
    stamp: float
    odom: np.ndarray  # (4,4) odometry pose at admission
    accum_distance: float
    cloud: PointCloud
    node_id: int = -1  # pose-vertex index in the graph (g2o node ptr analog)
    floor_coeffs: Optional[np.ndarray] = None
    utm_coord: Optional[np.ndarray] = None
    acceleration: Optional[np.ndarray] = None
    orientation: Optional[np.ndarray] = None  # quaternion (w,x,y,z)


@dataclasses.dataclass
class KeyFrameSnapshot:
    """(optimized pose, cloud) pair for lock-free map generation
    (keyframe.hpp:60-69)."""

    pose: np.ndarray
    cloud: PointCloud


class KeyframeUpdater:
    """Register a frame iff it moved >= keyframe_delta_trans or rotated >=
    keyframe_delta_angle from the previous keyframe; tracks accumulated
    travel distance (keyframe_updater.hpp:34-63)."""

    def __init__(self, keyframe_delta_trans: float = 2.0, keyframe_delta_angle: float = 2.0):
        self.keyframe_delta_trans = keyframe_delta_trans
        self.keyframe_delta_angle = keyframe_delta_angle
        self.is_first = True
        self.accum_distance = 0.0
        self.prev_keypose = np.eye(4)

    def update(self, pose: np.ndarray) -> bool:
        if self.is_first:
            self.is_first = False
            self.prev_keypose = pose.copy()
            return True
        delta = np.linalg.inv(self.prev_keypose) @ pose
        dx = float(np.linalg.norm(delta[:3, 3]))
        # AngleAxis angle (full rotation angle, keyframe_updater.hpp:46)
        tr = np.clip((np.trace(delta[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        da = float(np.arccos(tr))
        if dx < self.keyframe_delta_trans and da < self.keyframe_delta_angle:
            return False
        self.accum_distance += dx
        self.prev_keypose = pose.copy()
        return True

    def would_update(self, pose: np.ndarray) -> bool:
        """Pure admission check (no state mutation) — lets callers defer the
        expensive per-frame work (prefilter, floor detection) to frames that
        will actually become keyframes (pipeline.run_windowed)."""
        if self.is_first:
            return True
        delta = np.linalg.inv(self.prev_keypose) @ pose
        dx = float(np.linalg.norm(delta[:3, 3]))
        tr = np.clip((np.trace(delta[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        da = float(np.arccos(tr))
        return dx >= self.keyframe_delta_trans or da >= self.keyframe_delta_angle

    def get_accum_distance(self) -> float:
        return self.accum_distance
