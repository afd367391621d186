"""The traffic generator: a fixed town, a closed drive through it and the
configured sensor's scans along it, cast on the card.

``build`` reads the mix's ``course`` (town blocks, route blocks, laps, step,
corner frames, frames cast, frame period) and the configuration's ``sensor``
(beams, elevations, azimuth steps, range, noise, dropout, mounting height).
The town (buildings and street furniture, NumPy, as ``lidar_sim.make_town``)
comes from the mix's fixed ``town_seed``; the run's seed draws the scans'
range noise and dropout on the card. So every seed's drive sees the same
geometry and does the same work, with other inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import lidar_sim as L
from .cast import cast_scans


@dataclass
class Course:
    scans: List[np.ndarray]  # (M_i, 3) float32, sensor frame
    sensor_poses: List[np.ndarray]  # (4, 4) float64, world
    period_s: float


def lidar_model(sensor: dict) -> L.LidarModel:
    return L.LidarModel(rings=sensor["rings"], azimuth_steps=sensor["azimuth_steps"],
                        elev_min_deg=sensor["elev_min_deg"], elev_max_deg=sensor["elev_max_deg"],
                        max_range=sensor["max_range_m"], min_range=sensor["min_range_m"],
                        range_noise=sensor["range_noise_m"], dropout=sensor["dropout"])


def sensor_poses(course: dict, height_m: float) -> List[np.ndarray]:
    """The first ``frames`` poses of the drive, the sensor ``height_m`` above the road."""
    out = []
    for pose in L.town_course(blocks=course["route_blocks"], loops=course["laps"], step=course["step_m"],
                              turn_steps=course["turn_frames"])[:course["frames"]]:
        s = pose.copy()
        s[2, 3] += height_m
        out.append(s)
    return out


def build(sensor: dict, course: dict, seed: int, device, noise: bool = True) -> Course:
    town = L.make_town(seed=course["town_seed"], blocks=course["town_blocks"])
    poses = sensor_poses(course, sensor["height_m"])
    scans = cast_scans(town, poses, lidar_model(sensor), seed, device, noise=noise)
    return Course(scans=scans, sensor_poses=poses, period_s=course["period_s"])
