"""Point-cloud conditioning filters (port of hdl_graph_slam_tpu/ops/filters.py).

This slice carries the distance band-pass (apps/prefiltering_nodelet.cpp:164-180)
and IMU deskewing (prefiltering_nodelet.cpp:182-243). Filters *mask* points
rather than compacting them, so shapes stay static.
"""

from __future__ import annotations

import torch

from ..core.cloud import PAD_COORD, PointCloud


def _remask(cloud: PointCloud, keep: torch.Tensor) -> PointCloud:
    mask = cloud.mask & keep
    xyz = torch.where(mask[:, None], cloud.xyz, PAD_COORD)
    inten = None if cloud.intensity is None else torch.where(mask, cloud.intensity, 0.0)
    return PointCloud(xyz=xyz, mask=mask, intensity=inten)


def distance_filter(cloud: PointCloud, near_thresh: float, far_thresh: float) -> PointCloud:
    """Keep points with near < ||p|| < far (strict, like the reference)."""
    d = torch.linalg.norm(cloud.xyz, dim=-1)
    return _remask(cloud, (d > near_thresh) & (d < far_thresh))


def deskew(cloud: PointCloud, ang_vel: torch.Tensor, scan_period: float) -> PointCloud:
    """IMU deskewing: point i at relative time t_i = scan_period * i / count is
    unrotated by the small-angle quaternion (1, w t/2) of the angular velocity,
    as the reference linearizes it."""
    n = cloud.xyz.shape[0]
    dtype = cloud.xyz.dtype
    # the reference divides by the valid count, not the padded capacity
    count = torch.clamp(cloud.mask.sum(), min=1).to(dtype)
    t = scan_period * torch.arange(n, dtype=dtype, device=cloud.xyz.device) / count
    half = 0.5 * t[:, None] * ang_vel[None, :]
    q = torch.cat([torch.ones_like(t)[:, None], half], dim=-1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # conjugate rotation applied to each point: v' = q^-1 * v * q
    qw, qv = q[:, 0:1], -q[:, 1:]
    v = cloud.xyz
    tcross = 2.0 * torch.linalg.cross(qv, v)
    xyz = v + qw * tcross + torch.linalg.cross(qv, tcross)
    xyz = torch.where(cloud.mask[:, None], xyz, PAD_COORD)
    return PointCloud(xyz=xyz, mask=cloud.mask, intensity=cloud.intensity)
