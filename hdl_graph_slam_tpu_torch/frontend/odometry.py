"""Frame-to-keyframe scan-matching odometry, one frame per call
(port of hdl_graph_slam_tpu/frontend/odometry.py).

ScanMatchingOdometryNodelet::matching (apps/scan_matching_odometry_nodelet
.cpp:165-262):
- the first frame bootstraps the keyframe;
- the init guess is prev_trans times an external delta (the msf/odometry
  hook);
- frames whose registration did not converge are ignored, the pose
  propagated as keyframe_pose * prev_trans;
- transform thresholding (max_acceptable_trans / max_acceptable_angle with
  the reference's acos(q.w) angle measure);
- keyframe switching on delta trans/angle/time re-targets the registration.

The host drives the frame sequence; alignment runs on the device, and its
result comes to the host in one copy per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.cloud import PointCloud
from ..core.config import OdometryConfig
from ..core.device import resolve_device
from ..ops import voxel
from ..registration.factory import Registration
from ..utils.metrics import GLOBAL_TIMER


class OdometryStatus(NamedTuple):
    """ScanMatchingStatus (msg/ScanMatchingStatus.msg). One entry of
    prediction_labels/prediction_errors per active init-guess source ("imu"
    for the MSF/EKF hook, "odometry" for a robot-odometry delta), error =
    T_final^-1 * predicted_delta (scan_matching_odometry_nodelet.cpp:325-333)."""

    has_converged: bool
    matching_error: float
    inlier_fraction: float
    relative_pose: np.ndarray
    prediction_labels: tuple
    prediction_errors: tuple

    @property
    def prediction_error(self) -> Optional[np.ndarray]:
        """The first prediction error."""
        return self.prediction_errors[0] if self.prediction_errors else None


class ScanMatchingOdometry:
    """Per-frame odometry on ``device`` (None = cuda)."""

    def __init__(self, cfg: Optional[OdometryConfig] = None, device=None, max_voxels: int = 16384):
        self.cfg = cfg or OdometryConfig()
        self.device = resolve_device(device)
        self.registration = Registration(self.cfg.registration, max_voxels=max_voxels)
        self.keyframe: Optional[PointCloud] = None
        self.keyframe_pose = np.eye(4)
        self.keyframe_stamp: float = 0.0
        self.prev_time: float = 0.0
        self.prev_trans = np.eye(4)
        self.last_status: Optional[OdometryStatus] = None

    def _downsample(self, cloud: PointCloud) -> PointCloud:
        cfg = self.cfg
        if cfg.downsample_method == "VOXELGRID":
            return voxel.voxel_downsample(cloud, cfg.downsample_resolution, max_voxels=cloud.capacity)
        return cloud

    def step(self, stamp: float, cloud: PointCloud, msf_delta: Optional[np.ndarray] = None,
             msf_source: str = "imu") -> np.ndarray:
        """Process one frame; returns the odometry pose (4x4 float64 numpy).
        ``msf_source`` labels the init-guess provider in the status ("imu"
        or "odometry", scan_matching_odometry_nodelet.cpp:185,203)."""
        with GLOBAL_TIMER.span("odometry_step"):
            cfg = self.cfg
            cloud = PointCloud(xyz=cloud.xyz.to(self.device), mask=cloud.mask.to(self.device))
            if self.keyframe is None:
                self.prev_time = 0.0
                self.prev_trans = np.eye(4)
                self.keyframe_pose = np.eye(4)
                self.keyframe_stamp = stamp
                self.keyframe = self._downsample(cloud)
                self.registration.set_target(self.keyframe)
                return np.eye(4)

            filtered = self._downsample(cloud)
            guess = self.prev_trans @ (msf_delta if msf_delta is not None else np.eye(4))
            result = self.registration.align(filtered, guess=torch.as_tensor(guess, dtype=filtered.xyz.dtype))
            # one copy: the transformation, the flag, the error, the inliers and
            # the keyframe's point count
            scalars = (result.converged, result.error, result.num_inliers, self.keyframe.count)
            GLOBAL_TIMER.count("host_sync.odometry_result")
            host = torch.cat([result.transformation.reshape(-1).to(torch.float64),
                              torch.stack([x.to(torch.float64) for x in scalars])]).cpu().numpy()
            trans = host[:16].reshape(4, 4)
            converged = bool(host[16])
            self._publish_status(trans, converged, float(host[17]), int(host[18]), int(host[19]), msf_delta, msf_source)

            if not converged:
                return self.keyframe_pose @ self.prev_trans

            odom = self.keyframe_pose @ trans

            if cfg.transform_thresholding:
                delta = np.linalg.inv(self.prev_trans) @ trans
                dx = np.linalg.norm(delta[:3, 3])
                da = float(np.arccos(np.clip(_quat_w(delta[:3, :3]), -1.0, 1.0)))
                if dx > cfg.max_acceptable_trans or da > cfg.max_acceptable_angle:
                    return self.keyframe_pose @ self.prev_trans

            self.prev_time = stamp
            self.prev_trans = trans

            delta_trans = float(np.linalg.norm(trans[:3, 3]))
            delta_angle = float(np.arccos(np.clip(_quat_w(trans[:3, :3]), -1.0, 1.0)))
            delta_time = stamp - self.keyframe_stamp
            if (
                delta_trans > cfg.keyframe_delta_trans
                or delta_angle > cfg.keyframe_delta_angle
                or delta_time > cfg.keyframe_delta_time
            ):
                with GLOBAL_TIMER.span("keyframe_switch"):
                    self.keyframe = filtered
                    self.registration.set_target(self.keyframe)
                    self.keyframe_pose = odom
                    self.keyframe_stamp = stamp
                    self.prev_time = stamp
                    self.prev_trans = np.eye(4)

            return odom

    def _publish_status(self, trans, converged, error, num_inliers, keyframe_count, msf_delta, msf_source):
        """ScanMatchingStatus fields (scan_matching_odometry_nodelet.cpp:
        298-335): fitness, inlier fraction, labelled prediction errors
        T^-1 * msf_delta per active guess source (:325-333)."""
        labels, errors = (), ()
        if msf_delta is not None:
            labels = (msf_source,)
            errors = (np.linalg.inv(trans) @ np.asarray(msf_delta, dtype=np.float64),)
        self.last_status = OdometryStatus(
            has_converged=converged,
            matching_error=error,
            inlier_fraction=num_inliers / max(1, keyframe_count),
            relative_pose=trans,
            prediction_labels=labels,
            prediction_errors=errors,
        )


def _quat_w(R: np.ndarray) -> float:
    """w of the rotation's quaternion (the reference's angle measure)."""
    return 0.5 * np.sqrt(max(0.0, 1.0 + np.trace(R)))
