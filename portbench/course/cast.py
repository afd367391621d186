"""The ray caster of ``lidar_sim`` in PyTorch, for the card.

``raycast`` computes ``lidar_sim._raycast`` (first hit on the bounded
ground, the boxes by the slab test, the vertical cylinders) for one sensor
origin and a block of world directions, in float64 like the NumPy version.
``cast_scans`` turns sensor poses into scans as ``lidar_sim.scan`` does, the
range noise and the dropout drawn from a generator on the device, and
hands them back as host float32 arrays in the sensor frame, ring-major, as
a sensor driver would publish them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import lidar_sim as L

_EPS = 1e-9


class SceneTensors:
    """A lidar_sim Scene's primitives as float64 tensors on ``device``."""

    def __init__(self, scene: L.Scene, device):
        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)

        self.bmin, self.bmax = t(scene.boxes_min).reshape(-1, 3), t(scene.boxes_max).reshape(-1, 3)
        self.cyl = t(scene.cylinders).reshape(-1, 4)
        self.extent = float(scene.ground_extent)


def raycast(scene: SceneTensors, origin: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """First-hit distance along each ray, +inf where nothing is hit.
    origin (3,), dirs (R, 3) unit world directions, float64 -> (R,)."""
    inf = torch.tensor(float("inf"), dtype=dirs.dtype, device=dirs.device)
    dz = dirs[:, 2]
    t_g = -origin[2] / torch.where(dz.abs() < _EPS, torch.nan, dz)
    hit = origin[None, :2] + t_g[:, None] * dirs[:, :2]
    ok = (t_g > 0) & torch.isfinite(t_g) & (hit.abs().amax(1) <= scene.extent)
    best = torch.where(ok, t_g, inf)

    if scene.bmin.shape[0]:
        inv = 1.0 / torch.where(dirs.abs() < _EPS, _EPS, dirs)
        t1 = (scene.bmin[None] - origin[None, None]) * inv[:, None, :]
        t2 = (scene.bmax[None] - origin[None, None]) * inv[:, None, :]
        tnear = torch.minimum(t1, t2).amax(2)
        tfar = torch.maximum(t1, t2).amin(2)
        okb = (tfar >= tnear) & (tfar > _EPS) & (tnear > _EPS)
        best = torch.minimum(best, torch.where(okb, tnear, inf).amin(1))

    if scene.cyl.shape[0]:
        oxy = origin[None, :2] - scene.cyl[:, :2]  # (C, 2)
        dxy = dirs[:, None, :2]  # (R, 1, 2)
        a = (dxy * dxy).sum(2)  # (R, 1)
        b = 2.0 * (dxy * oxy[None]).sum(2)  # (R, C)
        cc = (oxy * oxy).sum(1)[None] - (scene.cyl[:, 2] ** 2)[None]
        disc = b * b - 4.0 * a * cc
        sq = torch.sqrt(torch.where(disc >= 0, disc, torch.nan))
        tc = (-b - sq) / (2.0 * torch.where(a < _EPS, torch.nan, a))
        z = origin[2] + tc * dirs[:, 2:3]
        okc = torch.isfinite(tc) & (tc > _EPS) & (z >= 0.0) & (z <= scene.cyl[:, 3][None])
        best = torch.minimum(best, torch.where(okc, tc, inf).amin(1))
    return best


def cast_scans(scene: L.Scene, sensor_poses, model: L.LidarModel, seed: int, device,
               noise: bool = True) -> List[np.ndarray]:
    """One revolution from each 4x4 sensor pose: hit points (M_i, 3)
    float32 in the sensor frame, occluded and dropped beams absent. With
    ``noise`` the ranges carry N(0, range_noise) and a ``dropout`` share of
    beams is discarded, drawn from a device generator seeded ``seed``."""
    st = SceneTensors(scene, device)
    dirs_s = torch.as_tensor(model.directions(), dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    pts, counts = [], []
    for pose in sensor_poses:
        T = torch.as_tensor(np.asarray(pose, dtype=np.float64), device=device)
        t = raycast(st, T[:3, 3], dirs_s @ T[:3, :3].T)
        if noise:
            t = t + model.range_noise * torch.randn(t.shape, generator=gen, dtype=t.dtype, device=device)
        keep = (t >= model.min_range) & (t <= model.max_range)
        if noise and model.dropout > 0:
            keep &= torch.rand(t.shape, generator=gen, dtype=t.dtype, device=device) >= model.dropout
        p = (dirs_s[keep] * t[keep, None]).to(torch.float32)
        pts.append(p)
        counts.append(p.shape[0])
    host = torch.cat(pts).cpu().numpy()
    return np.split(host, np.cumsum(counts)[:-1])
