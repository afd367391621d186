"""NumPy ray-cast LiDAR simulator: the benchmark's copy of the port's
``utils/lidar_sim.py``, kept here so that the yardstick does not change when
the program does.

Scene primitives are axis-aligned boxes, vertical capped cylinders and a
bounded ground plane z = 0; ``_raycast`` gives each ray's first hit, ``scan``
one revolution with range noise and dropout. ``make_town`` and
``make_room`` build the scenes and ``town_course`` the closed drive around
city blocks. ``course.cast`` re-implements ``_raycast`` in PyTorch for the
card and is tested against this file with noise off.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Scene:
    """Analytic world: ground plane + boxes + vertical cylinders."""

    boxes_min: np.ndarray  # (B, 3)
    boxes_max: np.ndarray  # (B, 3)
    cylinders: np.ndarray  # (C, 4): cx, cy, radius, height (z in [0, h])
    ground_extent: float = 100.0  # ground plane is |x|,|y| <= extent at z=0

    @staticmethod
    def build(boxes: List[Tuple[Tuple[float, float, float], Tuple[float, float, float]]],
              cylinders: List[Tuple[float, float, float, float]],
              ground_extent: float = 100.0) -> "Scene":
        bmin = np.asarray([b[0] for b in boxes], dtype=np.float64).reshape(-1, 3)
        bmax = np.asarray([b[1] for b in boxes], dtype=np.float64).reshape(-1, 3)
        cyl = np.asarray(cylinders, dtype=np.float64).reshape(-1, 4)
        return Scene(boxes_min=bmin, boxes_max=bmax, cylinders=cyl, ground_extent=ground_extent)


@dataclasses.dataclass
class LidarModel:
    """Spinning multi-beam LiDAR (VLP-32-shaped by default).

    rings x azimuth_steps beams per revolution; elevation angles span
    [elev_min, elev_max] (degrees). range_noise is 1-sigma Gaussian on the
    measured range (m); dropout is the per-beam probability of returning
    nothing (dust / absorptive surfaces / max-range returns).
    """

    rings: int = 32
    azimuth_steps: int = 720
    elev_min_deg: float = -25.0
    elev_max_deg: float = 15.0
    max_range: float = 80.0
    min_range: float = 0.5
    range_noise: float = 0.02
    dropout: float = 0.05

    def directions(self) -> np.ndarray:
        """Unit beam directions in the sensor frame, (rings*azimuth, 3)."""
        elev = np.deg2rad(np.linspace(self.elev_min_deg, self.elev_max_deg, self.rings))
        azim = np.linspace(0.0, 2.0 * np.pi, self.azimuth_steps, endpoint=False)
        ce, se = np.cos(elev), np.sin(elev)
        ca, sa = np.cos(azim), np.sin(azim)
        # (rings, azim, 3) -> flat
        d = np.stack(
            [np.outer(ce, ca), np.outer(ce, sa), np.broadcast_to(se[:, None], (self.rings, self.azimuth_steps))],
            axis=-1,
        )
        return d.reshape(-1, 3)


def _raycast(scene: Scene, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """First-hit distance along each ray; +inf where nothing is hit.

    origin: (3,) world; dirs: (R, 3) unit world directions. Returns (R,).
    """
    R = dirs.shape[0]
    t_best = np.full(R, np.inf)
    eps = 1e-9

    # --- ground plane z=0, bounded extent ---
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = -origin[2] / np.where(np.abs(dz) < eps, np.nan, dz)
    hit_xy = origin[None, :2] + t_g[:, None] * dirs[:, :2]
    ok = (t_g > 0) & np.isfinite(t_g) & (np.max(np.abs(hit_xy), axis=1) <= scene.ground_extent)
    t_best = np.where(ok, np.minimum(t_best, t_g), t_best)

    # --- boxes: slab method, broadcast (R, B, 3) ---
    if scene.boxes_min.shape[0]:
        inv_d = 1.0 / np.where(np.abs(dirs) < eps, eps, dirs)
        t1 = (scene.boxes_min[None, :, :] - origin[None, None, :]) * inv_d[:, None, :]
        t2 = (scene.boxes_max[None, :, :] - origin[None, None, :]) * inv_d[:, None, :]
        tnear = np.max(np.minimum(t1, t2), axis=2)  # (R, B)
        tfar = np.min(np.maximum(t1, t2), axis=2)
        okb = (tfar >= tnear) & (tfar > eps) & (tnear > eps)
        tb = np.where(okb, tnear, np.inf)
        t_best = np.minimum(t_best, tb.min(axis=1))

    # --- vertical cylinders: |xy(t) - c|^2 = r^2, z(t) in [0, h] ---
    if scene.cylinders.shape[0]:
        c = scene.cylinders[:, :2]  # (C, 2)
        r = scene.cylinders[:, 2]
        h = scene.cylinders[:, 3]
        oxy = origin[None, :2] - c  # (C, 2)
        dxy = dirs[:, None, :2]  # (R, 1, 2)
        a = np.sum(dxy * dxy, axis=2)  # (R, 1) broadcastable... actually (R,1)
        b = 2.0 * np.sum(dxy * oxy[None, :, :], axis=2)  # (R, C)
        cc = np.sum(oxy * oxy, axis=1)[None, :] - (r * r)[None, :]  # (1->R, C)
        disc = b * b - 4.0 * a * cc
        with np.errstate(invalid="ignore", divide="ignore"):
            sq = np.sqrt(np.where(disc >= 0, disc, np.nan))
            tc = (-b - sq) / (2.0 * np.where(a < eps, np.nan, a))
        z_hit = origin[2] + tc * dirs[:, 2:3]
        okc = np.isfinite(tc) & (tc > eps) & (z_hit >= 0.0) & (z_hit <= h[None, :])
        tc = np.where(okc, tc, np.inf)
        t_best = np.minimum(t_best, tc.min(axis=1))

    return t_best


def scan(
    scene: Scene,
    sensor_pose: np.ndarray,
    model: Optional[LidarModel] = None,
    seed: int = 0,
) -> np.ndarray:
    """One revolution from ``sensor_pose`` (4x4, sensor frame in world).

    Returns hit points in the SENSOR frame, (M, 3) float32 — what the sensor
    node would publish on /velodyne_points. Occluded beams are absent; ranges
    carry Gaussian noise; a ``dropout`` fraction of beams is discarded.
    """
    model = model or LidarModel()
    rng = np.random.default_rng(seed)
    dirs_s = model.directions()
    Rw = sensor_pose[:3, :3]
    origin = sensor_pose[:3, 3]
    dirs_w = dirs_s @ Rw.T
    t = _raycast(scene, origin, dirs_w)
    t = t + rng.normal(0.0, model.range_noise, t.shape)
    keep = (t >= model.min_range) & (t <= model.max_range)
    if model.dropout > 0:
        keep &= rng.random(t.shape) >= model.dropout
    return (dirs_s[keep] * t[keep, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# Scene generators
# ---------------------------------------------------------------------------


def make_room(seed: int = 0, size: float = 16.0, wall_h: float = 4.0) -> Scene:
    """Indoor scene (hdl_501-style): a walled room with pillars and crates.

    Interior clutter creates real occlusion shadows — a scan from one corner
    does NOT see the geometry behind the crates, so revisits after a loop
    genuinely re-observe previously hidden structure.
    """
    rng = np.random.default_rng(seed)
    s = size / 2.0
    th = 0.3  # wall thickness
    boxes = [
        ((-s - th, -s - th, 0.0), (s + th, -s, wall_h)),
        ((-s - th, s, 0.0), (s + th, s + th, wall_h)),
        ((-s - th, -s, 0.0), (-s, s, wall_h)),
        ((s, -s, 0.0), (s + th, s, wall_h)),
    ]
    # crates: scattered away from the square driving path (|x| or |y| near
    # size/4 ring); keep a clear 1.2 m corridor around the path
    n_crates = 10
    placed = 0
    while placed < n_crates:
        cx, cy = rng.uniform(-s + 1.5, s - 1.5, 2)
        w, d = rng.uniform(0.6, 1.6, 2)
        h = rng.uniform(0.5, 2.2)
        # the golden square path is roughly the ring at radius ~2-5 m
        r = np.hypot(cx, cy)
        if 1.0 < r < 6.5:
            continue
        boxes.append(((cx - w / 2, cy - d / 2, 0.0), (cx + w / 2, cy + d / 2, h)))
        placed += 1
    cyl = [(float(rng.uniform(-s + 2, s - 2)), float(rng.uniform(-s + 2, s - 2)), 0.15, wall_h)
           for _ in range(6)]
    cyl = [c for c in cyl if not (1.0 < np.hypot(c[0], c[1]) < 6.5)]
    return Scene.build(boxes, cyl, ground_extent=s + th)


def make_town(seed: int = 0, blocks: int = 3, block: float = 22.0, street: float = 10.0) -> Scene:
    """Outdoor scene (KITTI-shaped): a grid of city blocks with buildings of
    varying footprint/height along the streets, plus lamp posts and trees.

    A vehicle driving the street grid sees building facades with strong
    occlusion: each block shadows everything behind it, so loop closures at
    corners re-observe facades seen from a different side.
    """
    rng = np.random.default_rng(seed)
    pitch = block + street
    boxes = []
    cyl = []
    for bx in range(blocks):
        for by in range(blocks):
            # block origin (SW corner of the buildable area)
            ox = bx * pitch
            oy = by * pitch
            # 2-4 buildings per block with random setbacks
            for _ in range(int(rng.integers(2, 5))):
                w = rng.uniform(5.0, block * 0.6)
                d = rng.uniform(5.0, block * 0.6)
                x0 = ox + rng.uniform(0.0, block - w)
                y0 = oy + rng.uniform(0.0, block - d)
                h = rng.uniform(4.0, 18.0)
                boxes.append(((x0, y0, 0.0), (x0 + w, y0 + d, h)))
            # street furniture on the south/west street edges of the block
            for _ in range(3):
                px = ox + rng.uniform(0, block)
                py = oy - rng.uniform(1.0, street - 1.0)
                cyl.append((float(px), float(py), float(rng.uniform(0.1, 0.35)), float(rng.uniform(3.0, 7.0))))
    extent = blocks * pitch + street
    return Scene.build(boxes, cyl, ground_extent=extent)


def town_course(blocks: int = 2, block: float = 22.0, street: float = 10.0,
                step: float = 1.2, loops: int = 2, turn_steps: int = 30) -> List[np.ndarray]:
    """Vehicle poses (4x4, z=0 ground frame) driving around the perimeter of
    the SW ``blocks x blocks`` sub-grid of a town from :func:`make_town`,
    ``loops`` times — every corner after the first lap is a loop-closure
    opportunity with partial (occluded) overlap.

    The street centerline for block grid cell (i, j) runs at x/y =
    i*pitch - street/2. Heading follows the path; corners are constant-
    radius arcs over ``turn_steps`` frames. The default 30 steps = 3 deg
    per frame = 30 deg/s at a 10 Hz sensor — a normal city corner; faster
    yaw rates move far facades several meters between frames and defeat
    ANY zero-velocity-guess scan matcher (PCL included), so they test the
    course, not the odometry.
    """
    pitch = block + street
    half = street / 2.0
    side = blocks * pitch - street  # perimeter leg length
    lo = -half

    poses: List[np.ndarray] = []
    T = np.eye(4)
    T[0, 3], T[1, 3] = lo, lo
    poses.append(T.copy())
    ang = (np.pi / 2) / turn_steps
    # arc length per turn frame at ~1/3 cruise speed (cars slow for corners)
    arc_step = min(step, 3.0 * ang) / 2.5
    for _ in range(loops):
        for _leg in range(4):
            n_fwd = int(round(side / step))
            for _ in range(n_fwd):
                d = np.eye(4)
                d[0, 3] = step
                T = T @ d
                poses.append(T.copy())
            for _ in range(turn_steps):
                c, s = np.cos(ang), np.sin(ang)
                turn = np.eye(4)
                turn[:2, :2] = [[c, -s], [s, c]]
                turn[0, 3] = arc_step
                T = T @ turn
                poses.append(T.copy())
    return poses
