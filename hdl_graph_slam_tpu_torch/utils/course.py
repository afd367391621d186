"""The benchmark drive of ``bench.py`` (make_course), reproduced scan for scan.

A straight street drive through a lidar_sim town: 32x512-beam scans with
first-hit occlusion, range noise and dropout (~10-12k returns per frame),
from n_frames+1 sensor poses at ``step`` m/frame; scans[0] bootstraps the
keyframe. The sensor carries per-frame attitude jitter (roll/pitch ~
N(0, 0.4 deg)) and height jitter (z ~ N(0, 1 cm)). The random draws happen in
the same order as bench.py's, so the scans are identical.
"""

from __future__ import annotations

import numpy as np

from . import lidar_sim as L

BENCH_STEP = 0.08  # m/frame (0.8 m/s at 10 Hz)
BENCH_FRAMES = 256  # frames measured (frame 0 bootstraps the keyframe)
BENCH_RAW_CAPACITY = 16384


def make_course(n_frames: int = BENCH_FRAMES, step: float = BENCH_STEP, seed: int = 0):
    """List of n_frames+1 raw scans, (M_i, 3) float32 in the sensor frame."""
    town = L.make_town(seed=seed + 1, blocks=3)
    model = L.LidarModel(rings=32, azimuth_steps=512, max_range=60.0, range_noise=0.02, dropout=0.05)
    rng = np.random.default_rng(777 + seed)
    scans = []
    for i in range(n_frames + 1):
        roll, pitch = rng.normal(0.0, np.deg2rad(0.4), 2)
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[0, 3] = -5.0 + step * i  # along the y=-5 street of the block grid
        T[1, 3] = -5.0
        T[2, 3] = 1.8 + rng.normal(0.0, 0.01)
        scans.append(L.scan(town, T, model, seed=100000 * seed + i))
    return scans
