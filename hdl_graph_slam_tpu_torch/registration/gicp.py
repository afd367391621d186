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

Every function takes a leading batch on the source as well: that is the loop
detector's form, B candidate sources (each its own k=20 query, one
``knn_select_batched`` launch) aligned against one shared target (the B
sources' 1-NN queries go to one ``nn1`` launch), with the LM semantics of
``jax.vmap`` over ``align`` (base.lm_loop_batched).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import se3
from ..core.cloud import PointCloud
from ..ops import knn
from ..ops.eig3 import plane_regularize
from .base import AlignResult, lm_loop, lm_loop_batched


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
    cloud.xyz is (N, 3), or (B, N, 3) for B clouds in one launch.

    The neighbour set is exact (knn_select). The JAX package's default uses
    the 0.85-recall knn_approx, of which the exact set is a superset; its
    exact=True path and its CPU runs select the same sets."""
    xyz = cloud.valid_xyz()
    # each cloud is its own query, in voxel-key order: the kernel's fast case
    if xyz.ndim == 2:
        idx, _ = knn.knn_select(xyz, xyz, k)
        nbrs = xyz[idx]  # (N, k, 3)
    else:
        idx, _ = knn.knn_select_batched(xyz, xyz, k)
        nbrs = xyz[torch.arange(xyz.shape[0], device=xyz.device)[:, None, None], idx.long()]  # (B, N, k, 3)
    centered = nbrs - nbrs.mean(dim=-2, keepdim=True)
    covs = torch.einsum("...ki,...kj->...ij", centered, centered) / k
    covs = _regularize_covs_plane(covs)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    covs = torch.where(cloud.mask[..., None, None], covs, eye)
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


def _moved(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4) applied to the points xyz (..., N, 3)."""
    return xyz @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _associate(T: torch.Tensor, src: GicpCloud, tgt: GicpCloud, max_corr_dist: float) -> GicpCorr:
    """NN correspondences + Mahalanobis at pose T (fixed through LM trials).
    All sources' queries go to one nn1 launch."""
    moved_q = torch.where(src.mask[..., None], _moved(T, src.xyz), 1.0e6)
    idx, d2 = knn.nn1(moved_q.reshape(-1, 3), torch.where(tgt.mask[:, None], tgt.xyz, 1.0e6))
    idx, d2 = idx.reshape(src.mask.shape), d2.reshape(src.mask.shape)
    valid = src.mask & tgt.mask[idx] & (d2 < max_corr_dist * max_corr_dist)
    R = T[..., None, :3, :3]
    RCA = R @ src.covs @ R.transpose(-1, -2)
    Mw = _inv3x3(tgt.covs[idx] + RCA) * valid.to(T.dtype)[..., None, None]
    return GicpCorr(idx=idx, Mw=Mw, num=valid.sum(-1, dtype=torch.int32))


def _linearize_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud):
    moved = _moved(T, src.xyz)
    e = tgt.xyz[corr.idx] - moved  # (..., N, 3)
    # J_i = d e / d [v, w] for the left-multiplied increment exp([v,w]) T:
    # e(delta) ~= e - v - w x (T a)  =>  J = [-I | skew(moved)]
    skew = se3.hat(moved)  # (..., N, 3, 3)
    J = torch.cat([-torch.eye(3, dtype=T.dtype, device=T.device).expand(skew.shape), skew], dim=-1)
    MJ = corr.Mw @ J  # (..., N, 3, 6)
    H = torch.einsum("...nji,...njk->...ik", J, MJ)
    Me = (corr.Mw @ e[..., None])[..., 0]  # (..., N, 3)
    b = torch.einsum("...nji,...nj->...i", J, Me)
    cost = (e * Me).sum((-1, -2))
    return H, b, cost, corr.num


def _cost_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud) -> torch.Tensor:
    e = tgt.xyz[corr.idx] - _moved(T, src.xyz)
    return (e * (corr.Mw @ e[..., None])[..., 0]).sum((-1, -2))


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
    correspondences across iterations within that displacement budget.

    With a leading batch on the source and guess (B, 4, 4), the B sources
    align against the one target (base.lm_loop_batched): an AlignResult with
    a leading batch, whose row b is ``align(tgt, src[b], guess[b])`` up to
    float32 summation order."""
    r_max = None
    if reassoc_displacement:
        r_max = torch.sqrt(torch.where(src.mask, (src.xyz * src.xyz).sum(-1), 0.0).amax(-1))
    kw = dict(
        linearize_at=lambda T, corr: _linearize_at(T, corr, src, tgt),
        cost_at=lambda T, corr: _cost_at(T, corr, src, tgt),
        guess=guess,
        max_iterations=max_iterations,
        transformation_epsilon=transformation_epsilon,
        lm_init_lambda_factor=lm_init_lambda_factor,
        reassoc_displacement=reassoc_displacement,
        r_max=r_max,
    )
    if guess.ndim == 2:
        return lm_loop(associate=lambda T: _associate(T, src, tgt, max_corr_dist), **kw)

    def associate_rows(T, rows):
        part = GicpCloud(xyz=src.xyz[rows], mask=src.mask[rows], covs=src.covs[rows])
        return _associate(T, part, tgt, max_corr_dist)

    return lm_loop_batched(associate=associate_rows, **kw)
