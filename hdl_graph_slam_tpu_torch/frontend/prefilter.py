"""Prefiltering stage: raw scan -> conditioned cloud
(port of hdl_graph_slam_tpu/frontend/prefilter.py).

PrefilteringNodelet (apps/prefiltering_nodelet.cpp:106-243): optional IMU
deskewing, base_link transform, distance band-pass, voxel downsample,
outlier removal (STATISTICAL or RADIUS).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import cloud as cloudlib
from ..core.cloud import PointCloud
from ..core.config import PrefilterConfig
from ..core.device import resolve_device
from ..ops import filters, voxel
from ..utils.metrics import GLOBAL_TIMER


def make_prefilter_fn(cfg: PrefilterConfig, out_capacity: int):
    """The prefilter chain for ``cfg`` as a function of
    (cloud, base_to_sensor, ang_vel)."""
    # Static routing: after the distance filter every point lies within
    # distance_far_thresh of the base origin, so if 2*far/res (+slack) fits
    # the 1024-cell local grid the downsample uses int32 keys with identical
    # output.
    use_local_keys = cfg.use_distance_filter and voxel.local_grid_fits(
        2.0 * cfg.distance_far_thresh, cfg.downsample_resolution
    )

    def run(cloud: PointCloud, base_to_sensor: torch.Tensor, ang_vel: torch.Tensor) -> PointCloud:
        with GLOBAL_TIMER.span("prefilter"):
            if cfg.deskewing:
                cloud = filters.deskew(cloud, ang_vel, cfg.scan_period)
            cloud = cloudlib.transform(cloud, base_to_sensor)
            if cfg.use_distance_filter:
                cloud = filters.distance_filter(cloud, cfg.distance_near_thresh, cfg.distance_far_thresh)
            if cfg.downsample_method in ("VOXELGRID", "APPROX_VOXELGRID"):
                # ApproximateVoxelGrid is served by the exact centroid grid
                downsample = voxel.voxel_downsample_local if use_local_keys else voxel.voxel_downsample
                cloud = downsample(cloud, cfg.downsample_resolution, max_voxels=out_capacity)
            else:
                cloud = cloudlib.compact(cloud, capacity=out_capacity)
            if cfg.outlier_removal_method == "STATISTICAL":
                cloud = filters.statistical_outlier_removal(cloud, cfg.statistical_mean_k, cfg.statistical_stddev)
            elif cfg.outlier_removal_method == "RADIUS":
                cloud = filters.radius_outlier_removal(cloud, cfg.radius_radius, cfg.radius_min_neighbors)
            return cloud

    return run


class Prefilter:
    """Holds the config and runs the chain on ``device`` (None = cuda)."""

    def __init__(self, cfg: Optional[PrefilterConfig] = None, out_capacity: int = 16384, device=None):
        self.cfg = cfg or PrefilterConfig()
        self.out_capacity = out_capacity
        self.device = resolve_device(device)
        self._run = make_prefilter_fn(self.cfg, out_capacity)

    def __call__(
        self,
        cloud: PointCloud,
        base_to_sensor: Optional[torch.Tensor] = None,
        ang_vel: Optional[torch.Tensor] = None,
    ) -> PointCloud:
        dtype = cloud.xyz.dtype
        if base_to_sensor is None:
            base_to_sensor = torch.eye(4, dtype=dtype)
        if ang_vel is None:
            ang_vel = torch.zeros(3, dtype=dtype)
        cloud = PointCloud(
            xyz=cloud.xyz.to(self.device), mask=cloud.mask.to(self.device),
            intensity=None if cloud.intensity is None else cloud.intensity.to(self.device),
        )
        args = [torch.as_tensor(a, dtype=dtype) for a in (base_to_sensor, ang_vel)]
        GLOBAL_TIMER.count_copies("prefilter_args", self.device, sum(a.device.type == "cpu" for a in args))
        return self._run(cloud, *[a.to(self.device) for a in args])
