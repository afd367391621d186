"""Point-to-point ICP with pcl::IterativeClosestPoint semantics
(port of hdl_graph_slam_tpu/registration/icp.py).

Reference usage: src/hdl_graph_slam/registrations.cpp:57-64 (ICP with
transformation_epsilon, max_iterations, max_correspondence_distance and
optional reciprocal correspondences).

Per iteration: 1-NN correspondences of the transformed source in the target
(the ``nn1`` kernel on the card), gated by max_correspondence_distance and,
optionally, by the reciprocal back query; the closed-form rigid alignment of
the matched pairs (Umeyama, PCL's TransformationEstimationSVD) through the
closed-form 3x3 eigensolver of ops/eig3.py, as the JAX package computes it
(not an SVD, from which it differs by up to 5e-4); convergence when the
incremental transform is below epsilon.

``align`` takes one source or a leading batch of B sources against one
target (the loop detector's candidates) with the semantics of ``jax.vmap``
over the JAX ``lax.while_loop``: a problem that has converged keeps its
state while the others iterate. All problems' queries go to one ``nn1``
launch an iteration, and the host reads one flag vector an iteration. The
single source is the batch of one, and each problem of a batch gives the
bits of its single align.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.cloud import PointCloud
from ..ops import knn
from ..ops.eig3 import _eigvec_for, eigvalsh3
from ..utils.metrics import GLOBAL_TIMER
from .base import AlignResult, _select_rows, se3_delta_converged


class _IcpState(NamedTuple):
    T: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor
    error: torch.Tensor
    num_inliers: torch.Tensor


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(v, dim=-1, keepdim=True)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def _least_aligned(v: torch.Tensor) -> torch.Tensor:
    """The standard basis vector least aligned with each v (..., 3) (an
    index_select: indexing with a 0-d tensor would read it to the host)."""
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye.index_select(0, torch.argmin(v.abs(), dim=-1).reshape(-1)).reshape(v.shape)


def procrustes_rotation(S: torch.Tensor) -> torch.Tensor:
    """Umeyama-optimal rotation from the 3x3 cross-covariance S (..., 3, 3)
    (maps src-deviations to tgt-deviations): the R = V D U^T of PCL's SVD
    solution, built from the closed-form symmetric eigensolver.

    Right singular vectors V from eig(S^T S), completed right-handed; left
    vectors u_i = S v_i normalized, Gram-Schmidt and a cross-product
    completion, so U is right-handed too and absorbs the Umeyama reflection
    flip. When both eigenvector fallbacks coincide (S ~ 0, a collapsed
    spectrum) v3 becomes the basis vector least aligned with v1; a rank-1 S
    completes U the same way; with no rotation information (S v1 ~ 0) R is
    the identity. Two Newton-Schulz polar steps pull float32 drift back onto
    SO(3)."""
    eye3 = torch.eye(3, dtype=S.dtype, device=S.device)
    StS = S.transpose(-1, -2) @ S
    lam = eigvalsh3(StS)  # ascending
    v1 = _eigvec_for(StS, lam[..., 2])
    v3 = _eigvec_for(StS, lam[..., 0])
    c31 = torch.linalg.cross(v3, v1)
    collinear = (c31 * c31).sum(-1, keepdim=True) < 1e-12
    v3 = torch.where(collinear, _least_aligned(v1), v3)
    v2 = torch.linalg.cross(v3, v1)
    v2 = v2 / torch.clamp(_norm(v2), min=1e-20)
    v3 = torch.linalg.cross(v1, v2)  # right-handed orthonormal [v1 v2 v3]
    Sv1 = (S @ v1[..., None])[..., 0]
    u1 = Sv1 / torch.clamp(_norm(Sv1), min=1e-20)
    u2 = (S @ v2[..., None])[..., 0]
    u2 = u2 - _dot(u1, u2) * u1
    alt_u = _least_aligned(u1)
    alt_u = alt_u - _dot(u1, alt_u) * u1
    u2 = torch.where(_dot(u2, u2) < 1e-12, alt_u, u2)
    u2 = u2 / torch.clamp(_norm(u2), min=1e-20)
    u3 = torch.linalg.cross(u1, u2)
    V = torch.stack([v1, v2, v3], dim=-1)
    U = torch.stack([u1, u2, u3], dim=-1)
    R = V @ U.transpose(-1, -2)
    degenerate = (Sv1 * Sv1).sum(-1) < 1e-24
    R = torch.where(degenerate[..., None, None], eye3, R)
    for _ in range(2):  # R <- R (1.5 I - 0.5 R^T R)
        R = R @ (1.5 * eye3 - 0.5 * (R.transpose(-1, -2) @ R))
    return R


def _svd_rigid(src_pts: torch.Tensor, tgt_pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted closed-form rigid transform src -> tgt (Umeyama, no scale):
    points (..., N, 3), weights (..., N) -> (..., 4, 4)."""
    wsum = torch.clamp(w.sum(-1), min=1e-12)[..., None]
    mu_s = (src_pts * w[..., None]).sum(-2) / wsum
    mu_t = (tgt_pts * w[..., None]).sum(-2) / wsum
    S = ((src_pts - mu_s[..., None, :]) * w[..., None]).transpose(-1, -2) @ (tgt_pts - mu_t[..., None, :])
    S = S / wsum[..., None]
    R = procrustes_rotation(S)
    T = torch.eye(4, dtype=S.dtype, device=S.device).expand(S.shape[:-2] + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = mu_t - (R @ mu_s[..., None])[..., 0]
    return T


def align(
    tgt: PointCloud,
    src: PointCloud,
    guess: torch.Tensor,
    max_corr_dist: float = 2.5,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 64,
    use_reciprocal: bool = False,
) -> AlignResult:
    """Align the source cloud onto the target cloud from ``guess`` (4, 4), or
    a leading batch of sources (B, N, 3) with (B, 4, 4). With
    ``use_reciprocal`` a pair counts only when the source point is also its
    target point's nearest moved source point (the back query, one
    ``nn1_batched`` launch for all problems)."""
    batched = guess.ndim == 3
    xyz = src.xyz if batched else src.xyz[None]
    mask = src.mask if batched else src.mask[None]
    T0 = guess if batched else guess[None]
    B, N = mask.shape
    dtype, dev = T0.dtype, T0.device
    tgt_q = tgt.valid_xyz()
    arange = torch.arange(N, device=dev)
    s = _IcpState(T=T0, it=torch.zeros(B, dtype=torch.int32, device=dev),
                  converged=torch.zeros(B, dtype=torch.bool, device=dev),
                  error=torch.full((B,), float("inf"), dtype=dtype, device=dev),
                  num_inliers=torch.zeros(B, dtype=torch.int32, device=dev))
    rows = range(B)
    for _ in range(max_iterations):
        # the transforms, the Procrustes sums and the pose update run one
        # problem at a time: a batched product or reduction may take another
        # summation order than the single problem's (cuBLAS picks its
        # algorithm by shape), and ICP's correspondences amplify a last-bit
        # difference; so row b of a batch is the single align of b bit for bit
        moved = torch.stack([xyz[b] @ s.T[b, :3, :3].T + s.T[b, :3, 3] for b in rows])
        moved_q = torch.where(mask[..., None], moved, 1.0e6)
        idx, d2 = knn.nn1(moved_q.reshape(-1, 3), tgt_q)
        idx, d2 = idx.reshape(B, N), d2.reshape(B, N)
        valid = mask & tgt.mask[idx] & (d2 < max_corr_dist * max_corr_dist)
        if use_reciprocal:
            back_idx, _ = knn.nn1_batched(tgt_q.expand(B, -1, -1).contiguous(), moved_q.contiguous())
            valid = valid & (torch.gather(back_idx.long(), 1, idx.long()) == arange)
        w = valid.to(dtype)
        tgt_pts = tgt.xyz[idx]
        delta = torch.stack([_svd_rigid(moved[b], tgt_pts[b], w[b]) for b in rows])  # the incremental transforms
        new = _IcpState(T=torch.stack([se3.compose(delta[b], s.T[b]) for b in rows]), it=s.it + 1,
                        converged=se3_delta_converged(delta, transformation_epsilon),
                        error=torch.where(valid, d2, 0.0).sum(-1) / torch.clamp(w.sum(-1), min=1.0),
                        num_inliers=valid.sum(-1, dtype=torch.int32))
        live = ~s.converged & (s.it < max_iterations)
        s = _select_rows(live, new, s)
        GLOBAL_TIMER.count("host_sync.icp_align")
        if not bool((~s.converged & (s.it < max_iterations)).any()):  # host sync: one a iteration
            break
    out = AlignResult(transformation=s.T, converged=s.converged, iterations=s.it, error=s.error,
                      num_inliers=s.num_inliers)
    return out if batched else AlignResult(*[x[0] for x in out])
