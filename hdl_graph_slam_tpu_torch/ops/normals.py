"""k-NN PCA normal estimation, pcl::NormalEstimation semantics
(port of hdl_graph_slam_tpu/ops/normals.py).

The floor detector's normal prefilter (apps/floor_detection_nodelet.cpp:
211-238: k = 10, viewpoint (0, 0, sensor_height), verticality gate) calls
it. One closed-form 3x3 eigen-solve per point (ops/eig3.py).
"""

from __future__ import annotations

import torch

from ..core.cloud import PointCloud
from . import knn
from .eig3 import smallest_eigenvector3


def estimate_normals(cloud: PointCloud, k: int, viewpoint: torch.Tensor) -> torch.Tensor:
    """Per-point unit normals oriented towards ``viewpoint``: the smallest
    eigenvector of the covariance of the k nearest neighbours, the point
    itself included (PCL's kd-tree self-match), flipped to face the
    viewpoint (flipNormalTowardsViewpoint). Returns (N, 3); padded rows hold
    arbitrary unit vectors (mask them with cloud.mask)."""
    xyz = cloud.valid_xyz()
    idx, _ = knn.knn(xyz, xyz, k)
    nbrs = xyz[idx.long()]  # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    _, normal = smallest_eigenvector3(cov)
    flip = (normal * (viewpoint[None, :] - cloud.xyz)).sum(-1) < 0
    return torch.where(flip[:, None], -normal, normal)
