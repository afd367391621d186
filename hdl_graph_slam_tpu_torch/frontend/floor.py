"""Floor plane detection per frame (port of hdl_graph_slam_tpu/frontend/floor.py).

FloorDetectionNodelet::detect (apps/floor_detection_nodelet.cpp:110-180):
tilt compensation, a double height clip around -sensor_height, optional
normal filtering (k = 10 PCA normals against the vertical), batched RANSAC,
the point-count, inlier-count and verticality gates, an upward normal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import cloud as cloudlib
from ..core.cloud import PointCloud
from ..core.config import FloorDetectionConfig
from ..core.device import resolve_device
from ..ops import filters, normals, ransac


class FloorDetector:
    """Runs on ``device`` (None = cuda). RANSAC draws come from a generator
    on that device seeded 0, advanced by every detect."""

    def __init__(self, cfg: Optional[FloorDetectionConfig] = None, device=None):
        self.cfg = cfg or FloorDetectionConfig()
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        tilt = np.deg2rad(self.cfg.tilt_deg)
        self.tilt_matrix = np.eye(4)
        self.tilt_matrix[:3, :3] = [[np.cos(tilt), 0.0, np.sin(tilt)], [0.0, 1.0, 0.0],
                                    [-np.sin(tilt), 0.0, np.cos(tilt)]]

    def _prefilter(self, cloud: PointCloud) -> PointCloud:
        """Tilt, keep z in [-h - range, -h + range] (the floor sits below the
        sensor), filter by normals, untilt, compact."""
        cfg = self.cfg
        dtype = cloud.xyz.dtype

        def tensor(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        c = cloudlib.transform(cloud, tensor(self.tilt_matrix))
        c = filters.plane_clip(c, tensor([0.0, 0.0, 1.0, cfg.sensor_height + cfg.height_clip_range]), negative=False)
        c = filters.plane_clip(c, tensor([0.0, 0.0, 1.0, cfg.sensor_height - cfg.height_clip_range]), negative=True)
        if cfg.use_normal_filtering:
            c = self._normal_filter(c)
        c = cloudlib.transform(c, tensor(np.linalg.inv(self.tilt_matrix)))
        return cloudlib.compact(c)

    def _normal_filter(self, cloud: PointCloud) -> PointCloud:
        cfg = self.cfg
        viewpoint = torch.tensor([0.0, 0.0, cfg.sensor_height], dtype=cloud.xyz.dtype, device=self.device)
        n = normals.estimate_normals(cloud, k=10, viewpoint=viewpoint)
        keep = n[:, 2].abs() > float(np.cos(np.deg2rad(cfg.normal_filter_thresh)))
        mask = cloud.mask & keep
        return PointCloud(xyz=torch.where(mask[:, None], cloud.xyz, cloudlib.PAD_COORD), mask=mask,
                          intensity=cloud.intensity)

    def detect(self, cloud: PointCloud) -> Optional[np.ndarray]:
        """Floor coefficients (4,) float64 with n.p + d = 0 and an upward
        normal, or None when no floor passes the gates. Two host copies: the
        clipped point count, then the inlier count with the coefficients."""
        cfg = self.cfg
        cloud = PointCloud(xyz=cloud.xyz.to(self.device), mask=cloud.mask.to(self.device))
        c = self._prefilter(cloud)
        count = int(c.count)
        if count < cfg.floor_pts_thresh:
            return None
        # the valid points occupy rows [0, count) of the compacted cloud
        tri = ransac.sample_triplets(self._generator, cfg.ransac_hypotheses, c.capacity, count)
        res = ransac.fit_plane_from_triplets(c, tri, cfg.ransac_distance_thresh)
        out = torch.cat([res.num_inliers.to(torch.float64)[None], res.coeffs.to(torch.float64)]).cpu().numpy()
        if out[0] < cfg.floor_pts_thresh:
            return None
        coeffs = out[1:]
        # verticality gate against the tilt-compensated vertical
        reference = np.linalg.inv(self.tilt_matrix) @ np.array([0.0, 0.0, 1.0, 0.0])
        if abs(float(coeffs[:3] @ reference[:3])) < np.cos(np.deg2rad(cfg.floor_normal_thresh)):
            return None
        return -coeffs if coeffs[2] < 0.0 else coeffs
