"""GICP (plane-to-plane ICP) with fast_gicp::FastGICP semantics
(port of hdl_graph_slam_tpu/registration/gicp.py).

Reference usage: src/hdl_graph_slam/registrations.cpp:27-35 (FAST_GICP is
the launch default).

- Per-point covariances from the k=20 nearest neighbours (the knn_select
  kernel on the card), eigenvalues regularized to (1e-3, 1, 1);
- per iteration: 1-NN correspondences of the transformed source in the
  target (the nn1 kernel on the card), gated by max_correspondence_distance;
  Mahalanobis weight M_i = (C_b + R C_a R^T)^-1; residual e_i = b - T a;
- Levenberg-Marquardt on SE(3) with Nielsen damping (base.lm_loop).

The associate/linearize/cost reductions are plain PyTorch in this slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import se3
from ..core.cloud import PointCloud
from ..ops import knn
from ..ops.eig3 import plane_regularize
from .base import AlignResult, lm_loop


@dataclasses.dataclass(frozen=True)
class GicpCloud:
    """A cloud preprocessed for GICP: points + regularized covariances."""

    xyz: torch.Tensor  # (N, 3)
    mask: torch.Tensor  # (N,)
    covs: torch.Tensor  # (N, 3, 3)


def _regularize_covs_plane(covs: torch.Tensor) -> torch.Tensor:
    """fast_gicp RegularizationMethod::PLANE: eigenvalues -> (1e-3, 1, 1)."""
    return plane_regularize(covs + 1e-9 * torch.eye(3, dtype=covs.dtype, device=covs.device))


def preprocess(cloud: PointCloud, k: int = 20) -> GicpCloud:
    """Per-point regularized covariances from the k nearest neighbours
    (fast_gicp calculate_covariances; k = correspondence_randomness).

    The neighbour set is exact (knn_select). The JAX package's default uses
    the 0.85-recall knn_approx, of which the exact set is a superset; its
    exact=True path and its CPU runs select the same sets."""
    xyz = cloud.valid_xyz()
    idx, _ = knn.knn_select(xyz, xyz, k)  # the cloud as its own query, in voxel-key order: the kernel's fast case
    nbrs = xyz[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    covs = torch.einsum("nki,nkj->nij", centered, centered) / k
    covs = _regularize_covs_plane(covs)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    covs = torch.where(cloud.mask[:, None, None], covs, eye)
    return GicpCloud(xyz=cloud.xyz, mask=cloud.mask, covs=covs)


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate/determinant), |det| clamped
    at 1e-20."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


class GicpCorr(NamedTuple):
    """Fixed correspondence state for one linearization (fast_gicp
    update_correspondences): target indices, gated Mahalanobis, count."""

    idx: torch.Tensor  # (N,) target index per source point
    Mw: torch.Tensor  # (N, 3, 3) gated mahalanobis (zeroed for invalid)
    num: torch.Tensor  # () int32 valid count


def _associate(T: torch.Tensor, src: GicpCloud, tgt: GicpCloud, max_corr_dist: float) -> GicpCorr:
    """NN correspondences + Mahalanobis at pose T (fixed through LM trials)."""
    R, t = T[:3, :3], T[:3, 3]
    moved = src.xyz @ R.T + t
    moved_q = torch.where(src.mask[:, None], moved, 1.0e6)
    idx, d2 = knn.nn1(moved_q, torch.where(tgt.mask[:, None], tgt.xyz, 1.0e6))
    valid = src.mask & tgt.mask[idx] & (d2 < max_corr_dist * max_corr_dist)
    RCA = R @ src.covs @ R.T
    Mw = _inv3x3(tgt.covs[idx] + RCA) * valid.to(T.dtype)[:, None, None]
    return GicpCorr(idx=idx, Mw=Mw, num=valid.sum(dtype=torch.int32))


def _linearize_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud):
    moved = src.xyz @ T[:3, :3].T + T[:3, 3]
    e = tgt.xyz[corr.idx] - moved  # (N, 3)
    # J_i = d e / d [v, w] for the left-multiplied increment exp([v,w]) T:
    # e(delta) ~= e - v - w x (T a)  =>  J = [-I | skew(moved)]
    skew = se3.hat(moved)  # (N, 3, 3)
    J = torch.cat([-torch.eye(3, dtype=T.dtype, device=T.device).expand(skew.shape), skew], dim=-1)
    MJ = corr.Mw @ J  # (N, 3, 6)
    H = torch.einsum("nji,njk->ik", J, MJ)
    Me = (corr.Mw @ e[:, :, None])[..., 0]  # (N, 3)
    b = torch.einsum("nji,nj->i", J, Me)
    cost = (e * Me).sum()
    return H, b, cost, corr.num


def _cost_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud) -> torch.Tensor:
    moved = src.xyz @ T[:3, :3].T + T[:3, 3]
    e = tgt.xyz[corr.idx] - moved
    return (e * (corr.Mw @ e[:, :, None])[..., 0]).sum()


def align(
    tgt: GicpCloud,
    src: GicpCloud,
    guess: torch.Tensor,
    max_corr_dist: float = 2.5,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 64,
    lm_init_lambda_factor: float = 1e-9,
    reassoc_displacement: float = 0.0,
) -> AlignResult:
    """Align source onto target starting from ``guess`` (4x4), following
    fast_gicp's LM loop (base.lm_loop). reassoc_displacement > 0 carries the
    correspondences across iterations within that displacement budget."""
    r_max = None
    if reassoc_displacement:
        r_max = torch.sqrt(torch.where(src.mask, (src.xyz * src.xyz).sum(-1), 0.0).amax())
    return lm_loop(
        associate=lambda T: _associate(T, src, tgt, max_corr_dist),
        linearize_at=lambda T, corr: _linearize_at(T, corr, src, tgt),
        cost_at=lambda T, corr: _cost_at(T, corr, src, tgt),
        guess=guess,
        max_iterations=max_iterations,
        transformation_epsilon=transformation_epsilon,
        lm_init_lambda_factor=lm_init_lambda_factor,
        reassoc_displacement=reassoc_displacement,
        r_max=r_max,
    )
