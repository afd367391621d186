"""Voxel-grid operations, sort-based and static-shaped (port of the
hdl_graph_slam_tpu/ops/voxel.py functions the prefilter and the map use).

- pcl::VoxelGrid centroid downsampling (apps/prefiltering_nodelet.cpp:56-60);
- pcl::octree occupied-voxel centres, the map's downsample
  (map_cloud_generator.cpp:39-50);
- the Gaussian voxel statistics NDT needs (ndt_omp's VoxelGridCovariance,
  registrations.cpp:105-119), with a dense cell -> row grid for the
  DIRECT1 / DIRECT7 neighbour lookups and a sorted-key binary search.

Voxel membership is an integer key per point; a sort groups points by voxel,
segment boundaries give each point a dense segment id, and per-voxel sums
are reduced into a caller-chosen capacity. Output comes in ascending key
order; when more voxels are occupied than the capacity, the lowest keys win.
Global keys are int64 (21 bits per axis) built from floor(x / res) in
integers, never through a float.

PyTorch differences from the JAX reference, handled here:
- ``jax.ops.segment_sum`` drops ids >= num_segments; PyTorch's scatters
  raise on them, so overflow ids are redirected into one discarded extra row.
- Per-voxel float sums are ``segment_reduce`` over the sorted rows, each
  voxel summed in row order on either device: a scatter with float atomics
  (``index_add_`` on the GPU) sums in launch order, and two runs over the
  same frames would then differ in their last bits.
- On the GPU, a tensor divided by a Python float is multiplied by the
  reciprocal; cells divide by a float32 tensor on the same device instead,
  the JAX package's x / float32(res) on both devices.
"""

from __future__ import annotations

import dataclasses
import math
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


def _cells(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    """floor(x / res) in xyz's float type: a true division by res rounded to
    that type (a 0-d tensor on xyz's device, not a Python float)."""
    return torch.floor(xyz / torch.full((), resolution, dtype=xyz.dtype, device=xyz.device))


def local_cells(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    """Integer cell coordinates floor(x/res) as int32 (PCL cell assignment)."""
    return _cells(xyz, resolution).to(torch.int32)


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
    """Map points to int64 voxel keys; invalid points get the sentinel key
    (sorts to the end). Each axis is offset by 2^20 and clipped to 21 bits."""
    ijk = _cells(xyz, resolution).to(torch.int64) + _AXIS_OFFSET
    ijk = torch.clamp(ijk, 0, (1 << _AXIS_BITS) - 1)
    key = (ijk[..., 0] << (2 * _AXIS_BITS)) | (ijk[..., 1] << _AXIS_BITS) | ijk[..., 2]
    return torch.where(mask, key, _INVALID_KEY)


def key_to_center(key: torch.Tensor, resolution: float) -> torch.Tensor:
    """Voxel key -> voxel centre coordinates (float32)."""
    mask = (1 << _AXIS_BITS) - 1
    ijk = torch.stack([(key >> (2 * _AXIS_BITS)) & mask, (key >> _AXIS_BITS) & mask, key & mask], dim=-1)
    return (ijk.to(torch.float32) - _AXIS_OFFSET + 0.5) * resolution


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


def _segment_sums(payload: torch.Tensor, seg_ids: torch.Tensor, valid_s: torch.Tensor,
                  max_segments: int) -> torch.Tensor:
    """Per-segment sums of the sorted rows of ``payload`` (N, C) into
    (max_segments, C), each segment summed in row order (deterministic on
    either device). Rows no segment keeps (invalid rows, and ids past
    max_segments: segment_sum's out-of-range policy, the lowest keys win)
    come last in sorted order; each gets a one-row segment past the kept
    ones, which is dropped, so no reduction walks a long run of them.
    Segment ids stay sorted, so every segment's rows are contiguous."""
    n = seg_ids.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=payload.device)
    seg = torch.where(valid_s & (seg_ids < max_segments), seg_ids.to(torch.int64), max_segments + iota)
    lengths = torch.zeros(max_segments + n, dtype=torch.int64, device=payload.device)
    lengths.index_add_(0, seg, torch.ones_like(seg))
    return torch.segment_reduce(payload, "sum", lengths=lengths, axis=0, unsafe=True)[:max_segments]


def _downsample_from_keys(cloud: PointCloud, keys: torch.Tensor, invalid_key: int, max_voxels: int) -> PointCloud:
    """Shared centroid-downsample body: stable sort by key, fused segment sums."""
    keys_s, order = torch.sort(keys, stable=True)
    valid_s = keys_s != invalid_key
    xyz_s = torch.where(valid_s[:, None], cloud.xyz[order], 0.0)
    payload = [xyz_s, valid_s.to(xyz_s.dtype)[:, None]]
    if cloud.intensity is not None:
        payload.append(torch.where(valid_s, cloud.intensity[order], 0.0)[:, None])
    seg_ids, _ = _segment_ids_from_sorted_keys(keys_s)
    acc = _segment_sums(torch.cat(payload, dim=1), seg_ids, valid_s, max_voxels)
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


def occupied_voxel_centers(cloud: PointCloud, resolution: float, max_voxels: int) -> PointCloud:
    """Occupied-voxel-centre downsample (pcl::octree getOccupiedVoxelCenters,
    map_cloud_generator.cpp:39-50): the centre of every voxel holding a valid
    point, in ascending key order, in a cloud of capacity ``max_voxels``.
    Overflow: the lowest keys win, and the ids past the capacity are masked
    out of the counts (segment_sum drops them)."""
    keys_s = torch.sort(voxel_keys(cloud.xyz, cloud.mask, resolution)).values
    seg_ids, _ = _segment_ids_from_sorted_keys(keys_s)
    seg_keys = _segment_keys(keys_s, seg_ids, max_voxels)
    counts = torch.zeros(max_voxels + 1, dtype=torch.int32, device=keys_s.device)
    counts.index_add_(0, torch.clamp(seg_ids, max=max_voxels), (keys_s != _INVALID_KEY).to(torch.int32))
    out_mask = (counts[:max_voxels] > 0) & (seg_keys != _INVALID_KEY)
    centers = key_to_center(torch.where(out_mask, seg_keys, 0), resolution).to(cloud.xyz.dtype)
    return PointCloud(xyz=torch.where(out_mask[:, None], centers, PAD_COORD), mask=out_mask)


def sort_with_order(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted_keys, permutation): a stable ascending sort, equal keys in row
    order, as the JAX ``lax.sort`` with an int32 iota payload. The
    permutation is int64, PyTorch's index type."""
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, order


def searchsorted32(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Binary search, side='left', int32 positions (jnp.searchsorted)."""
    return torch.searchsorted(sorted_keys, queries, side="left", out_int32=True)


# -- dense O(1) cell -> row grid -------------------------------------------------
#
# ndt_omp's DIRECT modes index the voxel grid directly. The table's rows are
# scattered once into a flat (G^3,) int32 grid anchored at the target's
# minimum occupied cell; every lookup is then one read. Cells outside the
# G^3 grid are not found, as cells outside the 1024^3 local grid are.

DENSE_GRID_SIZE = 256  # 256^3 int32 = 64 MB; covers 2 * far_thresh at res 1.0

# physical span the dense grid must cover per axis: the target cloud's
# extent, bounded by 2 * distance_far_thresh (the largest preset far
# threshold is 100 m, kitti)
DENSE_GRID_SPAN_M = 256.0


def dense_grid_size_for(resolution: float, span_m: float = DENSE_GRID_SPAN_M) -> int:
    """Grid size covering ``span_m`` meters per axis at ``resolution``: a
    power of two in [64, DENSE_GRID_SIZE]. Below resolution 1.0 the cap
    wins and only 256 * resolution meters are covered (cells beyond are not
    found)."""
    need = math.ceil(span_m / float(resolution))
    g = 64
    while g < need and g < DENSE_GRID_SIZE:
        g *= 2
    return g


def _split_key(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return keys >> (2 * _LOCAL_BITS), (keys >> _LOCAL_BITS) & (_LOCAL_RANGE - 1), keys & (_LOCAL_RANGE - 1)


def build_dense_grid(keys: torch.Tensor, mask: torch.Tensor, grid_size: int = DENSE_GRID_SIZE) -> torch.Tensor:
    """Scatter table rows into a flat (G^3,) int32 grid; -1 = empty cell.

    ``keys`` are the packed int32 local keys of a voxel table; rows whose
    cell lies outside the G^3 grid go to one extra slot that is dropped
    (``.at[].set(mode="drop")``). The kept keys are unique, so the scatter
    is deterministic."""
    G = grid_size
    i, j, k = _split_key(keys)
    in_grid = mask & (keys != _LOCAL_INVALID) & (i < G) & (j < G) & (k < G)
    flat = torch.where(in_grid, (i * G + j) * G + k, G * G * G)
    grid = torch.full((G * G * G + 1,), -1, dtype=torch.int32, device=keys.device)
    grid[flat.long()] = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return grid[: G * G * G]


def grid_dim(grid: torch.Tensor) -> int:
    """Per-axis cell count of a flat (G^3,) dense grid."""
    return round(grid.shape[0] ** (1.0 / 3.0))


def lookup_dense(grid: torch.Tensor, query_keys: torch.Tensor,
                 grid_size: int = DENSE_GRID_SIZE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, found) per int32 local query key: one read of the grid. A query
    outside the grid reads cell 0 (its row is returned, not found), as the
    JAX function does."""
    G = grid_size
    i, j, k = _split_key(query_keys)
    in_grid = (query_keys != _LOCAL_INVALID) & (i < G) & (j < G) & (k < G)
    idx = grid[torch.where(in_grid, (i * G + j) * G + k, 0).long()]
    return torch.clamp(idx, min=0), in_grid & (idx >= 0)


@dataclasses.dataclass(frozen=True)
class GaussianVoxels:
    """Per-voxel Gaussian statistics (mean, covariance, count) as a table
    sorted by int32 local key (ndt_omp's VoxelGridCovariance). Rows failing
    min_points carry the sentinel key and sort last."""

    keys: torch.Tensor  # (V,) int32 local keys, sorted, invalid = sentinel
    means: torch.Tensor  # (V, 3), PAD_COORD where masked
    covs: torch.Tensor  # (V, 3, 3)
    counts: torch.Tensor  # (V,) float
    mask: torch.Tensor  # (V,) bool
    resolution: float  # cell size in meters (used as float32)
    origin: torch.Tensor  # (3,) int32 local-grid anchor (min occupied cell)


def build_gaussian_voxels(cloud: PointCloud, resolution: float, max_voxels: int, min_points: int = 6,
                          regularize: str = "ndt") -> GaussianVoxels:
    """Per-voxel mean and covariance of ``cloud`` in a table of ``max_voxels``
    rows (the lowest keys win on overflow). Voxels with fewer than
    ``min_points`` points are masked (VoxelGridCovariance's
    min_points_per_voxel_). ``regularize="ndt"`` floors each covariance's
    eigenvalues at 1e-2 of the largest (PCL NDT, ops/eig3.py)."""
    origin = local_origin(cloud.xyz, cloud.mask, resolution)
    keys = pack_local_keys(local_cells(cloud.xyz, resolution), origin, cloud.mask)
    keys_s, order = sort_with_order(keys)
    valid_s = keys_s != _LOCAL_INVALID
    xyz_s = torch.where(valid_s[:, None], cloud.xyz[order], 0.0)
    seg_ids, _ = _segment_ids_from_sorted_keys(keys_s)
    outer = xyz_s[:, :, None] * xyz_s[:, None, :]
    acc = _segment_sums(torch.cat([xyz_s, valid_s.to(xyz_s.dtype)[:, None], outer.reshape(-1, 9)], dim=1),
                        seg_ids, valid_s, max_voxels)
    sums, counts, sq_sums = acc[:, :3], acc[:, 3], acc[:, 4:]
    seg_keys = _segment_keys(keys_s, seg_ids, max_voxels)

    cnt = torch.clamp(counts, min=1.0)
    means = sums / cnt[:, None]
    covs = sq_sums.reshape(-1, 3, 3) / cnt[:, None, None] - means[:, :, None] * means[:, None, :]
    vmask = (counts >= min_points) & (seg_keys != _LOCAL_INVALID)
    if regularize == "ndt":
        from .eig3 import floor_regularize

        covs = floor_regularize(covs + 1e-9 * torch.eye(3, dtype=covs.dtype, device=covs.device))
    means = torch.where(vmask[:, None], means, PAD_COORD)
    # Masked cells carry the sentinel key in the middle of the ascending
    # sequence: re-sort, or the binary search misses every key after the
    # first masked cell.
    final_keys, order2 = sort_with_order(torch.where(vmask, seg_keys, _LOCAL_INVALID))
    return GaussianVoxels(keys=final_keys, means=means[order2], covs=covs[order2], counts=counts[order2],
                          mask=vmask[order2], resolution=float(resolution), origin=origin)


def lookup_voxels(voxels: GaussianVoxels, query_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary search of int32 local query keys in the sorted key table:
    (row, found) per query; a miss returns the clipped search position."""
    idx = torch.clamp(searchsorted32(voxels.keys, query_keys), 0, voxels.keys.shape[0] - 1)
    found = (voxels.keys[idx] == query_keys) & voxels.mask[idx] & (query_keys != _LOCAL_INVALID)
    return idx, found


def query_keys_for(voxels: GaussianVoxels, xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Local keys of query points in a voxel table's grid (for lookup_voxels)."""
    return pack_local_keys(local_cells(xyz, voxels.resolution), voxels.origin, mask)


def neighbor_offsets(method: str, device=None) -> torch.Tensor:
    """DIRECT1 = the containing cell; DIRECT7 = it and its 6 face neighbours
    (ndt_omp NeighborSearchMethod, registrations.cpp:113-119), as (K, 3)
    int32 cell offsets. The order is the CUDA kernel's too (csrc/ndt.cu)."""
    if method.upper() == "DIRECT1":
        off = [(0, 0, 0)]
    else:  # DIRECT7 (KDTREE has its own path, registration/ndt.py)
        off = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    return torch.tensor(off, dtype=torch.int32, device=device)


def neighbor_query_keys(voxels: GaussianVoxels, xyz: torch.Tensor, mask: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Local keys of each query point's neighbour cells: (..., N, 3),
    (K, 3) -> (..., N, K). Offsets apply to integer cell coordinates, so an
    out-of-grid neighbour packs to the sentinel, never wraps around."""
    nijk = local_cells(xyz, voxels.resolution)[..., None, :] + offsets
    return pack_local_keys(nijk, voxels.origin, mask[..., None])
