"""Map cloud assembly (port of hdl_graph_slam_tpu/backend/map_cloud.py).

Equivalent of MapCloudGenerator (src/hdl_graph_slam/map_cloud_generator.cpp:
13-51): transform every keyframe snapshot's cloud by its optimized pose,
concatenate, and (resolution > 0) downsample by occupied-voxel centres —
the pcl::octree getOccupiedVoxelCenters behaviour.

The map is built on the device of the snapshots' clouds from plain PyTorch
ops (a batched transform, an int64 sort, a segment pass). When all snapshot
clouds share one capacity (the prefilter emits fixed-capacity clouds), the
whole map is one batched (K, N, 3) pose transform, one occupied-voxel-centre
pass and one copy to the host. Pose products are true fp32 (TF32 is off,
package __init__).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import cloud as cloudlib
from ..core.cloud import PAD_COORD, PointCloud
from ..ops import voxel
from .keyframe import KeyFrameSnapshot


def _next_pow2(n: int) -> int:
    cap = 1
    while cap < n:
        cap *= 2
    return cap


def _assemble(xyz: torch.Tensor, mask: torch.Tensor, poses: torch.Tensor, resolution: float,
              max_voxels: int) -> PointCloud:
    """(K, N, 3) clouds + (K, 4, 4) poses -> map points (padded + mask)."""
    moved = torch.einsum("kij,knj->kni", poses[:, :3, :3], xyz) + poses[:, None, :3, 3]
    moved = torch.where(mask[:, :, None], moved, PAD_COORD)
    flat = PointCloud(xyz=moved.reshape(-1, 3), mask=mask.reshape(-1))
    if resolution <= 0.0:
        return flat
    return voxel.occupied_voxel_centers(flat, resolution, max_voxels=max_voxels)


class MapCloudGenerator:
    def generate(
        self,
        snapshots: List[KeyFrameSnapshot],
        resolution: float = 0.05,
        max_points: int = 1 << 21,
    ) -> Optional[np.ndarray]:
        """Returns the assembled map as (n, 3) numpy, or None if empty.

        The output voxel table is capped at next_pow2(min(points,
        max_points)); if the map has more occupied voxels than that, the
        lowest-key voxels win deterministically (repo-wide overflow rule) —
        raise max_points for city-scale maps at fine resolutions."""
        if not snapshots:
            return None
        dev = snapshots[0].cloud.xyz.device
        if len({snap.cloud.capacity for snap in snapshots}) == 1:
            # one batch for the whole map, padded to a power of two of
            # keyframes with masked copies of the first cloud
            k = len(snapshots)
            kpad = _next_pow2(k)
            clouds = [s.cloud for s in snapshots]
            xyz = torch.stack([c.xyz for c in clouds] + [clouds[0].xyz] * (kpad - k))
            mask = torch.stack([c.mask for c in clouds] + [torch.zeros_like(clouds[0].mask)] * (kpad - k))
            poses = torch.from_numpy(np.stack([s.pose for s in snapshots] + [np.eye(4)] * (kpad - k)))
            poses = poses.to(device=dev, dtype=xyz.dtype)
            cap = _next_pow2(min(kpad * clouds[0].capacity, max_points))
            out = _assemble(xyz, mask, poses, resolution, max_voxels=cap)
            host = torch.cat([out.xyz, out.mask[:, None].to(out.xyz.dtype)], dim=1).cpu().numpy()
            pts = host[host[:, 3] > 0.0, :3]
            return pts if pts.shape[0] else None

        # mixed capacities (e.g. loaded dumps): one transform per snapshot.
        # Overflow policy matches the one-capacity path: all points are
        # voxelized into a table capped at next_pow2(min(points,
        # max_points)), so the same clouds give the same map on either path.
        parts = []
        for snap in snapshots:
            pose = torch.as_tensor(snap.pose, dtype=snap.cloud.xyz.dtype, device=dev)
            parts.append(cloudlib.transform(snap.cloud, pose).to_numpy())
        merged = np.concatenate(parts, axis=0)
        if merged.shape[0] == 0:
            return None
        if resolution <= 0.0:
            return merged  # full resolution (map_cloud_generator.cpp:37)
        cap = _next_pow2(min(merged.shape[0], max_points))
        cloud = cloudlib.from_numpy(merged, capacity=_next_pow2(merged.shape[0]), device=dev)
        return voxel.occupied_voxel_centers(cloud, resolution, max_voxels=cap).to_numpy()
