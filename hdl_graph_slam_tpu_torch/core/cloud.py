"""Fixed-shape padded point-cloud tensors (port of hdl_graph_slam_tpu/core/cloud.py).

A cloud is a (capacity, 3) float32 tensor plus a validity mask. Padding rows
sit at the sentinel PAD_COORD so distance-based kernels ignore them, and every
op also carries the mask for exact counting.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .device import resolve_device

# Padding points live far outside any plausible LiDAR return so that
# nearest-neighbor style kernels never select them even without masking.
PAD_COORD = 1.0e6

# Capacity buckets (points per cloud after each stage).
DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A padded point cloud. ``xyz[i]`` is valid iff ``mask[i]``."""

    xyz: torch.Tensor  # (N, 3) float32
    mask: torch.Tensor  # (N,) bool
    intensity: Optional[torch.Tensor] = None  # (N,) float32 or None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    def valid_xyz(self) -> torch.Tensor:
        """xyz with padding rows forced to the sentinel coordinate (with or
        without a leading batch)."""
        return torch.where(self.mask[..., None], self.xyz, PAD_COORD)

    def to_numpy(self) -> np.ndarray:
        """The valid points as a dense (count, 3) numpy array."""
        return self.xyz[self.mask].cpu().numpy()


def bucket_capacity(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def from_numpy(
    points: np.ndarray,
    capacity: Optional[int] = None,
    intensity: Optional[np.ndarray] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    dtype=np.float32,
    device=None,
) -> PointCloud:
    """Pad a (n, 3) array into a bucketed PointCloud on ``device`` (None = cuda)."""
    dev = resolve_device(device)
    points = np.asarray(points, dtype=dtype).reshape(-1, 3)
    n = points.shape[0]
    cap = capacity if capacity is not None else bucket_capacity(n, buckets)
    if n > cap:
        # uniform strided subsample, NOT head truncation: spinning-lidar
        # points arrive ring-major, so taking the first `cap` rows would
        # systematically drop the upper rings (all vertical structure).
        sel = np.linspace(0, n - 1, cap).round().astype(np.int64)
        points = points[sel]
        if intensity is not None:
            intensity = np.asarray(intensity).reshape(-1)[sel]
        n = cap
    xyz = np.full((cap, 3), PAD_COORD, dtype=dtype)
    xyz[:n] = points[:n]
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    inten = None
    if intensity is not None:
        inten = np.zeros((cap,), dtype=dtype)
        inten[:n] = np.asarray(intensity, dtype=dtype).reshape(-1)[:n]
        inten = torch.from_numpy(inten).to(dev)
    return PointCloud(xyz=torch.from_numpy(xyz).to(dev), mask=torch.from_numpy(mask).to(dev), intensity=inten)


def transform(cloud: PointCloud, T: torch.Tensor) -> PointCloud:
    """Rigidly transform a cloud (padding stays at the sentinel)."""
    xyz = cloud.xyz @ T[:3, :3].T + T[:3, 3]
    xyz = torch.where(cloud.mask[:, None], xyz, PAD_COORD)
    return PointCloud(xyz=xyz, mask=cloud.mask, intensity=cloud.intensity)


def compact(cloud: PointCloud, capacity: Optional[int] = None) -> PointCloud:
    """Move valid points to the front (stable), keeping static shapes."""
    cap = capacity or cloud.capacity
    order = torch.sort((~cloud.mask).to(torch.int8), stable=True).indices[:cap]
    mask = cloud.mask[order]
    xyz = torch.where(mask[:, None], cloud.xyz[order], PAD_COORD)
    inten = None if cloud.intensity is None else torch.where(mask, cloud.intensity[order], 0.0)
    return PointCloud(xyz=xyz, mask=mask, intensity=inten)
