"""Point-cloud conditioning filters (port of hdl_graph_slam_tpu/ops/filters.py).

The PCL filters the reference's prefiltering and floor-detection stages
drive:
- distance band-pass (apps/prefiltering_nodelet.cpp:164-180);
- statistical outlier removal (prefiltering_nodelet.cpp:76-82,
  pcl::StatisticalOutlierRemoval: mean k-NN distance against the global
  mean + std gate), on ``knn.knn``;
- radius outlier removal (prefiltering_nodelet.cpp:84-90,
  pcl::RadiusOutlierRemoval: neighbours within a radius), on
  ``knn.radius_count``;
- half-space plane clip (apps/floor_detection_nodelet.cpp:189-204,
  pcl::PlaneClipper3D + ExtractIndices);
- IMU deskewing (prefiltering_nodelet.cpp:182-243).

Filters *mask* points rather than compacting them, so shapes stay static.
"""

from __future__ import annotations

import torch

from ..core.cloud import PAD_COORD, PointCloud
from . import knn


def _remask(cloud: PointCloud, keep: torch.Tensor) -> PointCloud:
    mask = cloud.mask & keep
    xyz = torch.where(mask[:, None], cloud.xyz, PAD_COORD)
    inten = None if cloud.intensity is None else torch.where(mask, cloud.intensity, 0.0)
    return PointCloud(xyz=xyz, mask=mask, intensity=inten)


def distance_filter(cloud: PointCloud, near_thresh: float, far_thresh: float) -> PointCloud:
    """Keep points with near < ||p|| < far (strict, like the reference)."""
    d = torch.linalg.norm(cloud.xyz, dim=-1)
    return _remask(cloud, (d > near_thresh) & (d < far_thresh))


def statistical_outlier_removal(cloud: PointCloud, mean_k: int, stddev_mul_thresh: float) -> PointCloud:
    """pcl::StatisticalOutlierRemoval: each point's mean distance to its
    ``mean_k`` nearest neighbours; keep points at or below global mean +
    stddev_mul_thresh * global std. PCL's searchers return the query point
    itself first, so mean_k + 1 neighbours are found and the first dropped."""
    xyz = cloud.valid_xyz()
    _, d2 = knn.knn(xyz, xyz, mean_k + 1)
    mean_d = torch.sqrt(torch.clamp(d2[:, 1:], min=0.0)).mean(-1)
    valid = cloud.mask
    n = torch.clamp(valid.sum(), min=1)
    g_mean = torch.where(valid, mean_d, 0.0).sum() / n
    g_sq = torch.where(valid, mean_d * mean_d, 0.0).sum() / n
    # PCL's sqrt(sq_sum / n - mean^2)
    g_std = torch.sqrt(torch.clamp(g_sq - g_mean * g_mean, min=0.0))
    return _remask(cloud, mean_d <= g_mean + stddev_mul_thresh * g_std)


def radius_outlier_removal(cloud: PointCloud, radius: float, min_neighbors: int) -> PointCloud:
    """pcl::RadiusOutlierRemoval: keep points with at least
    ``min_neighbors`` other points strictly within ``radius`` (the count
    includes the point itself, which is subtracted)."""
    xyz = cloud.valid_xyz()
    return _remask(cloud, knn.radius_count(xyz, xyz, radius) - 1 >= min_neighbors)


def plane_clip(cloud: PointCloud, plane_coeffs: torch.Tensor, negative: bool) -> PointCloud:
    """pcl::PlaneClipper3D + ExtractIndices: the clipper selects points with
    n.p + d > 0; ExtractIndices keeps them when ``negative`` is False and
    drops them when it is True."""
    inside = cloud.xyz @ plane_coeffs[:3] + plane_coeffs[3] > 0
    return _remask(cloud, inside ^ negative)


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
