"""KITTI odometry dataset reader (a copy of hdl_graph_slam_tpu/io/kitti.py).

The reference supports KITTI through launch/hdl_graph_slam_kitti.launch fed
by the kitti2bag converter; this reader ingests the native dataset layout
directly (velodyne .bin scans + times.txt + optional ground-truth poses),
removing the bag round-trip.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


def read_velodyne_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI velodyne scan: float32 x,y,z,reflectance."""
    data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return data[:, :3].copy(), data[:, 3].copy()


def read_times(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def read_poses(path: str) -> np.ndarray:
    """KITTI ground-truth poses: each row is a 3x4 row-major matrix."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 12)
    n = rows.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :4] = rows.reshape(n, 3, 4)
    return poses


class KittiOdometrySequence:
    """sequences/NN with velodyne/*.bin + times.txt (+ ../poses/NN.txt)."""

    def __init__(self, sequence_dir: str, poses_file: Optional[str] = None):
        self.sequence_dir = sequence_dir
        self.velodyne_dir = os.path.join(sequence_dir, "velodyne")
        times_path = os.path.join(sequence_dir, "times.txt")
        self.times = read_times(times_path) if os.path.exists(times_path) else None
        self.poses = read_poses(poses_file) if poses_file and os.path.exists(poses_file) else None
        self.frames: List[str] = sorted(
            f for f in os.listdir(self.velodyne_dir) if f.endswith(".bin")
        ) if os.path.isdir(self.velodyne_dir) else []

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        for i, name in enumerate(self.frames):
            xyz, refl = read_velodyne_bin(os.path.join(self.velodyne_dir, name))
            stamp = float(self.times[i]) if self.times is not None else i * 0.1
            yield stamp, xyz, refl
