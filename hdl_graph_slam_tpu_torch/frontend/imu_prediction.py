"""IMU-based motion prediction for scan-matching init guesses
(port of hdl_graph_slam_tpu/frontend/imu_prediction.py; host numpy).

The role of the reference's optional ethzasl msf_updates EKF frontend
(launch/hdl_graph_slam_imu.launch:21-31): the delta between consecutive EKF
poses seeds registration->align (scan_matching_odometry_nodelet.cpp:182-192,
msf_delta). A simple strapdown propagator: gyro integration for orientation,
gravity-compensated double integration of acceleration for translation,
reset at every frame.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_GRAVITY = 9.80665


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues formula with the Taylor branch of core/se3.py::so3_exp
    below theta² = 1e-8: (3,) -> (3, 3)."""
    theta2 = float(w @ w)
    if theta2 < 1e-8:
        a, b = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0
    else:
        theta = np.sqrt(theta2)
        a, b = np.sin(theta) / theta, (1.0 - np.cos(theta)) / theta2
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    return np.eye(3) + a * W + b * (W @ W)


class ImuPredictor:
    def __init__(self, gravity: float = _GRAVITY):
        self.gravity = gravity
        self._samples: List[Tuple[float, np.ndarray, np.ndarray]] = []  # (t, gyro, accel)
        self._last_frame_time: Optional[float] = None
        self._velocity = np.zeros(3)

    def add_imu(self, stamp: float, angular_velocity, linear_acceleration) -> None:
        self._samples.append(
            (stamp, np.asarray(angular_velocity, dtype=np.float64), np.asarray(linear_acceleration, dtype=np.float64))
        )

    def predict_delta(self, frame_stamp: float) -> np.ndarray:
        """SE(3) delta from the previous frame to ``frame_stamp`` in the
        previous frame's body frame; identity when there is no data."""
        if self._last_frame_time is None:
            self._last_frame_time = frame_stamp
            self._samples = [s for s in self._samples if s[0] >= frame_stamp]
            return np.eye(4)

        t0, t1 = self._last_frame_time, frame_stamp
        window = [s for s in self._samples if t0 <= s[0] <= t1]
        self._samples = [s for s in self._samples if s[0] > t1]
        self._last_frame_time = t1
        if not window or t1 <= t0:
            return np.eye(4)

        R = np.eye(3)
        p = np.zeros(3)
        v = self._velocity.copy()
        prev_t = t0
        for stamp, gyro, accel in window:
            dt = max(0.0, stamp - prev_t)
            prev_t = stamp
            if dt == 0.0:
                continue
            # gravity compensation in the integrated frame: the body z axis
            # is taken as gravity-aligned at t0 (valid between 0.1 s frames)
            a_w = R @ accel - np.array([0.0, 0.0, self.gravity])
            p = p + v * dt + 0.5 * a_w * dt * dt
            v = v + a_w * dt
            R = R @ so3_exp(gyro * dt)
        # leak velocity to damp double-integration drift across frames
        self._velocity = 0.5 * v
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = p
        return T

    def reset(self) -> None:
        self._samples.clear()
        self._last_frame_time = None
        self._velocity = np.zeros(3)
