"""Voxel-grid centroid downsampling, sort-based and static-shaped
(port of the hdl_graph_slam_tpu/ops/voxel.py functions the prefilter uses).

pcl::VoxelGrid semantics (apps/prefiltering_nodelet.cpp:56-60): voxel
membership is an integer key per point; a stable sort groups points by voxel,
segment boundaries give each point a dense segment id, and per-voxel sums
are reduced into a caller-chosen capacity. Output centroids come in ascending
key order; when more voxels are occupied than the capacity, the lowest keys
win.

PyTorch differences from the JAX reference, handled here:
- ``jax.ops.segment_sum`` drops ids >= num_segments; ``index_add_`` raises on
  them, so overflow ids are redirected into one discarded extra row.
- On the GPU ``index_add_`` sums with atomics, in an order that differs from
  the CPU's sequential one: centroids agree to float32 rounding, not bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.cloud import PAD_COORD, PointCloud

# 21 bits per axis, centered: coordinates must satisfy |floor(x/res)| < 2^20.
_AXIS_BITS = 21
_AXIS_OFFSET = 1 << 20
_INVALID_KEY = torch.iinfo(torch.int64).max

# Local (min-corner-anchored) int32 keys: 10 bits per axis, a 1024^3 grid.
_LOCAL_BITS = 10
_LOCAL_RANGE = 1 << _LOCAL_BITS
_LOCAL_INVALID = torch.iinfo(torch.int32).max


def local_cells(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    """Integer cell coordinates floor(x/res) as int32 (PCL cell assignment)."""
    return torch.floor(xyz / resolution).to(torch.int32)


def local_origin(xyz: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """Minimum occupied cell corner of a cloud — the local-grid anchor."""
    big = torch.iinfo(torch.int32).max // 2
    ijk = local_cells(xyz, resolution)
    return torch.where(mask[:, None], ijk, big).amin(dim=0)


def pack_local_keys(ijk: torch.Tensor, origin: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pack cell coords relative to ``origin`` into int32 keys; cells outside
    the 1024^3 local grid (or with valid=False) get the sentinel key."""
    rel = ijk - origin
    in_range = ((rel >= 0) & (rel < _LOCAL_RANGE)).all(dim=-1)
    key = (rel[..., 0] << (2 * _LOCAL_BITS)) | (rel[..., 1] << _LOCAL_BITS) | rel[..., 2]
    return torch.where(valid & in_range, key, _LOCAL_INVALID)


def voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, resolution: float) -> torch.Tensor:
    """Map points to int64 voxel keys; invalid points get the sentinel key."""
    ijk = torch.floor(xyz / resolution).to(torch.int64) + _AXIS_OFFSET
    ijk = torch.clamp(ijk, 0, (1 << _AXIS_BITS) - 1)
    key = (ijk[..., 0] << (2 * _AXIS_BITS)) | (ijk[..., 1] << _AXIS_BITS) | ijk[..., 2]
    return torch.where(mask, key, _INVALID_KEY)


def local_grid_fits(extent: float, resolution: float) -> bool:
    """Does a cloud spanning at most ``extent`` meters per axis fit the 1024^3
    int32 local grid at ``resolution``? (+2 cells of slack for floor().)"""
    return extent / float(resolution) + 2.0 < float(_LOCAL_RANGE)


def _segment_ids_from_sorted_keys(keys_sorted: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense segment ids for a sorted key array + is-segment-start flags."""
    starts = torch.ones_like(keys_sorted, dtype=torch.bool)
    starts[1:] = keys_sorted[1:] != keys_sorted[:-1]
    seg_ids = torch.cumsum(starts.to(torch.int32), dim=0, dtype=torch.int32) - 1
    return seg_ids, starts


def _segment_keys(keys_s: torch.Tensor, seg_ids: torch.Tensor, max_segments: int) -> torch.Tensor:
    """Representative key per segment: a scatter-min of row indices gives each
    segment's first row (segments past max_segments clamp into the last slot,
    whose true start still wins the min), then one gather reads its key. Slots
    past the last segment read an arbitrary key; callers mask them by count."""
    n = keys_s.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=keys_s.device)
    start = torch.full((max_segments,), n, dtype=torch.int64, device=keys_s.device)
    start.scatter_reduce_(0, torch.clamp(seg_ids.to(torch.int64), max=max_segments - 1), iota,
                          reduce="amin", include_self=True)
    return keys_s[torch.clamp(start, 0, n - 1)]


def _downsample_from_keys(cloud: PointCloud, keys: torch.Tensor, invalid_key: int, max_voxels: int) -> PointCloud:
    """Shared centroid-downsample body: stable sort by key, fused segment sums."""
    keys_s, order = torch.sort(keys, stable=True)
    valid_s = keys_s != invalid_key
    xyz_s = torch.where(valid_s[:, None], cloud.xyz[order], 0.0)
    payload = [xyz_s, valid_s.to(xyz_s.dtype)[:, None]]
    if cloud.intensity is not None:
        payload.append(torch.where(valid_s, cloud.intensity[order], 0.0)[:, None])
    payload = torch.cat(payload, dim=1)

    seg_ids, _ = _segment_ids_from_sorted_keys(keys_s)
    # ids past max_voxels go to one extra row that is dropped (segment_sum's
    # out-of-range policy: the lowest keys win)
    acc = torch.zeros((max_voxels + 1, payload.shape[1]), dtype=payload.dtype, device=payload.device)
    acc.index_add_(0, torch.clamp(seg_ids, max=max_voxels), payload)
    acc = acc[:max_voxels]
    sums, counts = acc[:, :3], acc[:, 3]
    seg_keys = _segment_keys(keys_s, seg_ids, max_voxels)

    out_mask = (counts > 0) & (seg_keys != invalid_key)
    centroids = sums / torch.clamp(counts[:, None], min=1.0)
    centroids = torch.where(out_mask[:, None], centroids, PAD_COORD)
    out_inten = None
    if cloud.intensity is not None:
        out_inten = torch.where(out_mask, acc[:, 4] / torch.clamp(counts, min=1.0), 0.0)
    return PointCloud(xyz=centroids, mask=out_mask, intensity=out_inten)


def voxel_downsample(cloud: PointCloud, resolution: float, max_voxels: int) -> PointCloud:
    """Centroid voxel-grid downsample with global int64 keys (pcl::VoxelGrid)."""
    keys = voxel_keys(cloud.xyz, cloud.mask, resolution)
    return _downsample_from_keys(cloud, keys, _INVALID_KEY, max_voxels)


def voxel_downsample_local(cloud: PointCloud, resolution: float, max_voxels: int) -> PointCloud:
    """voxel_downsample with int32 local (min-corner-anchored) keys: identical
    output (the re-key is a monotone shift) when the cloud's extent fits the
    1024-cell local grid — check statically with local_grid_fits."""
    origin = local_origin(cloud.xyz, cloud.mask, resolution)
    keys = pack_local_keys(local_cells(cloud.xyz, resolution), origin, cloud.mask)
    return _downsample_from_keys(cloud, keys, _LOCAL_INVALID, max_voxels)
