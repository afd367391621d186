"""Batched-hypothesis plane RANSAC (port of hdl_graph_slam_tpu/ops/ransac.py).

Replaces pcl::RandomSampleConsensus + SampleConsensusModelPlane as the floor
detector drives it (apps/floor_detection_nodelet.cpp:137-144, distance
threshold 0.1): a fixed batch of K triplets, every hypothesis scored against
every point in one (N, K) masked product, the first hypothesis with the most
inliers wins. PCL returns the winner un-refined, and so does this.

The JAX ``fit_plane`` is split in two: ``sample_triplets`` draws the
triplets as it does, from a ``torch.Generator`` (whose draws cannot equal
threefry's), and ``fit_plane_from_triplets`` does what it does with them,
so a test can feed both sides the same triplets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cloud import PointCloud
from ..utils.metrics import GLOBAL_TIMER


class PlaneRansacResult(NamedTuple):
    coeffs: torch.Tensor  # (4,) best plane (unit normal, d); n.p + d = 0
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int32


def sample_triplets(generator: torch.Generator, num_hypotheses: int, n: int, count: int) -> torch.Tensor:
    """(K, 3) point indices drawn uniformly from [0, n), then taken modulo
    ``count``: the JAX package's ``randint(key, (K, 3), 0, n) % count``,
    which samples the valid prefix of a compacted cloud of capacity n."""
    tri = torch.randint(0, n, (num_hypotheses, 3), generator=generator, device=generator.device)
    return tri % max(int(count), 1)


def fit_plane_from_triplets(cloud: PointCloud, tri: torch.Tensor, distance_thresh: float = 0.1) -> PlaneRansacResult:
    """Score the planes through the K triplets ``tri`` (K, 3) against the
    cloud's valid points: cross-product normals, degenerate triplets scored
    −1, inliers at |n.p + d| < distance_thresh, the first maximum wins."""
    xyz = cloud.xyz
    p0, p1, p2 = xyz[tri[:, 0]], xyz[tri[:, 1]], xyz[tri[:, 2]]
    normal = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    degenerate = norm[:, 0] < 1e-8
    normal = normal / torch.clamp(norm, min=1e-12)
    d = -(normal * p0).sum(-1)
    # (N,3) x (3,K) in fp32 (TF32 is off package-wide)
    inlier = ((xyz @ normal.T + d[None, :]).abs() < distance_thresh) & cloud.mask[:, None]
    counts = torch.where(degenerate, -1, inlier.sum(0, dtype=torch.int32))
    best = torch.argmax(counts)  # the first maximum, as jnp.argmax
    # each of the four indexings by the 0-dim ``best`` reads it to the host
    GLOBAL_TIMER.count_copies("ransac_best", best.device, 4)
    return PlaneRansacResult(
        coeffs=torch.cat([normal[best], d[best][None]]),
        inlier_mask=inlier[:, best],
        num_inliers=counts[best],
    )

