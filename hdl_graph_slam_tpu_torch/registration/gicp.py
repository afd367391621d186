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

The association's Mahalanobis and the linearization have hand-written
Hopper kernels (csrc/gicp.cu), each with its plain PyTorch twin here:

- ``associate``: after the correspondence search, the gate and
  M = inv3x3(C_tgt[idx] + R C_src R^T) per source row, and the valid count
  (``gicp_associate_kernel``; VGICP's voxel association ends here too);
- ``linearize``: H = sum J^T M J, b = sum J^T M e and the cost at a pose
  under carried correspondences, J never formed (``gicp_linearize_kernel``);
- ``cost``: the cost alone (its ``cost_only`` instantiation), the LM trial.

A wrapper runs its plain twin only for CPU tensors; on CUDA tensors it
launches its kernel or raises. Each counts its launches in
``<wrapper>.launches``.

Every function takes a leading batch on the source as well: that is the loop
detector's form, B candidate sources (each its own k=20 query, one
``knn_select_batched`` launch) aligned against one shared target (the B
sources' 1-NN queries go to one ``nn1`` launch), with the LM semantics of
``jax.vmap`` over ``align`` (base.lm_loop_batched).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Union

import torch

from .. import kernels
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

    idx: torch.Tensor  # (N,) int32 target index per source point
    Mw: torch.Tensor  # (N, 3, 3) gated mahalanobis (zeroed for invalid)
    num: torch.Tensor  # () int32 valid count


class DistanceGate(NamedTuple):
    """GICP's correspondence gate: src.mask & tgt_mask[idx] & (d2 <
    max_corr_dist^2), from the 1-NN search's squared distances d2."""

    d2: torch.Tensor  # (N,) float32
    tgt_mask: torch.Tensor  # (M,) bool
    max_corr_dist: float


def _moved(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4) applied to the points xyz (..., N, 3)."""
    return xyz @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _rotate_covs(R: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """R C R^T for R (..., 3, 3) and covariances C (..., N, 3, 3): each
    entry of R C, then of (R C) R^T, a left-to-right sum of three products,
    the order the association kernel rounds in."""
    Rb = R[..., None, :, :]
    RC = Rb[..., :, 0:1] * covs[..., 0:1, :] + Rb[..., :, 1:2] * covs[..., 1:2, :] + Rb[..., :, 2:3] * covs[..., 2:3, :]
    Rt = Rb[..., None, :, :]  # R[l, k] at [..., 0, l] of Rt[..., k]
    return (RC[..., :, 0:1] * Rt[..., :, 0] + RC[..., :, 1:2] * Rt[..., :, 1]
            + RC[..., :, 2:3] * Rt[..., :, 2])


def associate_plain(T: torch.Tensor, src: GicpCloud, tgt_covs: torch.Tensor, idx: torch.Tensor,
                    gate: Union[DistanceGate, torch.Tensor]) -> GicpCorr:
    """Plain twin of ``associate``."""
    if isinstance(gate, DistanceGate):
        valid = src.mask & gate.tgt_mask[idx] & (gate.d2 < gate.max_corr_dist * gate.max_corr_dist)
    else:
        valid = gate
    Mw = _inv3x3(tgt_covs[idx] + _rotate_covs(T[..., :3, :3], src.covs)) * valid.to(T.dtype)[..., None, None]
    return GicpCorr(idx=idx, Mw=Mw, num=valid.sum(-1, dtype=torch.int32))


def _batched(T: torch.Tensor, *xs: torch.Tensor) -> tuple:
    """T (4, 4) or (B, 4, 4) and per-row tensors (N, ...) or (B, N, ...) as
    contiguous batched tensors."""
    one = T.ndim == 2
    return tuple((x[None] if one else x).contiguous() for x in (T, *xs))


def _check(name: str, T: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the kernels take: float32 poses (4, 4) or (B <= 65535, 4, 4) and
    every tensor on their device."""
    if T.dtype != torch.float32 or T.shape[-2:] != (4, 4) or T.ndim not in (2, 3):
        raise ValueError(f"{name}: poses must be (4, 4) or (B, 4, 4) float32, got {tuple(T.shape)} {T.dtype}")
    if T.ndim == 3 and not 0 < T.shape[0] <= 65535:
        raise ValueError(f"{name}: batch {T.shape[0]} outside 1..65535")
    devices = {x.device for x in tensors}
    if devices != {T.device}:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}, poses on {T.device}")


def associate(T: torch.Tensor, src: GicpCloud, tgt_covs: torch.Tensor, idx: torch.Tensor,
              gate: Union[DistanceGate, torch.Tensor]) -> GicpCorr:
    """The correspondence state at the poses T (4, 4) or (B, 4, 4) of the
    sources (N, ...) or (B, N, ...), after the search named idx (int32) in
    the target: the gate (a DistanceGate for GICP, the voxel lookup's
    ``found`` flags for VGICP), M = inv3x3(tgt_covs[idx] + R C_src R^T)
    zeroed where the gate fails, and the valid count
    (``gicp_associate_kernel`` on the card: one launch, the plain twin's
    bits)."""
    dist = isinstance(gate, DistanceGate)
    flags = gate.d2 if dist else gate
    _check("gicp associate", T, src.covs, src.mask, tgt_covs, idx, flags, *([gate.tgt_mask] if dist else []))
    if T.device.type == "cpu":
        return associate_plain(T, src, tgt_covs, idx, gate)
    Tb, covs, ib, flags, smask = _batched(T, src.covs, idx, flags, src.mask)
    b, n = ib.shape
    if (ib.dtype != torch.int32 or covs.shape != (b, n, 3, 3) or covs.dtype != torch.float32
            or tgt_covs.dtype != torch.float32 or flags.shape != (b, n) or smask.shape != (b, n)
            or flags.dtype != (torch.float32 if dist else torch.bool) or smask.dtype != torch.bool
            or (dist and gate.tgt_mask.dtype != torch.bool)):
        raise ValueError(f"gicp associate: idx {tuple(ib.shape)} {ib.dtype}, covariances {tuple(covs.shape)} "
                         f"{covs.dtype} / {tgt_covs.dtype}, gate {tuple(flags.shape)} {flags.dtype}, "
                         f"mask {tuple(smask.shape)} {smask.dtype}")
    tgt_covs = tgt_covs.contiguous()
    tmask = gate.tgt_mask.contiguous() if dist else None
    Mw = torch.empty((b, n, 3, 3), dtype=torch.float32, device=T.device)
    num = torch.empty((b,), dtype=torch.int32, device=T.device)
    st = kernels.stream(Tb)
    counters, _ = kernels.workspace(Tb, st, "gicp", 2 * b, 0)
    if dist:  # d2, smask, tmask, max_corr_dist^2, no found flags
        gate_args = (flags.data_ptr(), smask.data_ptr(), tmask.data_ptr(),
                     ctypes.c_float(gate.max_corr_dist * gate.max_corr_dist), None)
    else:
        gate_args = (None, None, None, ctypes.c_float(0.0), flags.data_ptr())
    kernels.check(kernels.load("gicp").hgs_gicp_associate(
        Tb.data_ptr(), b, n, covs.data_ptr(), tgt_covs.data_ptr(), ib.data_ptr(), *gate_args, counters.data_ptr(),
        Mw.data_ptr(), num.data_ptr(), st), "gicp associate")
    associate.launches += 1
    if T.ndim == 2:
        return GicpCorr(idx=idx, Mw=Mw[0], num=num[0])
    return GicpCorr(idx=idx, Mw=Mw, num=num)


associate.launches = 0


def linearize_plain(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor):
    """Plain twin of ``linearize``."""
    moved = _moved(T, src.xyz)
    e = tgt_xyz[corr.idx] - moved  # (..., N, 3)
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


def cost_plain(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``cost``."""
    e = tgt_xyz[corr.idx] - _moved(T, src.xyz)
    return (e * (corr.Mw @ e[..., None])[..., 0]).sum((-1, -2))


# csrc/gicp.cu's launch constants: threads a block, linearization blocks a
# problem at most, floats a partial row
_THREADS, _MAX_BLOCKS, _ROW = 256, 1024, 32


def _blocks(n: int) -> int:
    """The linearization's blocks per problem over n points (gicp.cu
    blocks_for): one point a thread up to _MAX_BLOCKS blocks."""
    return min(max(-(-n // _THREADS), 1), _MAX_BLOCKS)


def _reduce(name: str, T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor, cost_only: bool):
    """One launch of gicp_linearize_kernel: out (B, 43), or (B,) cost_only."""
    _check(name, T, src.xyz, corr.idx, corr.Mw, tgt_xyz)
    Tb, xyz, idx, Mw = _batched(T, src.xyz, corr.idx, corr.Mw)
    tgt_xyz = tgt_xyz.contiguous()
    b, n = idx.shape
    if (idx.dtype != torch.int32 or xyz.shape != (b, n, 3) or Mw.shape != (b, n, 3, 3) or xyz.dtype != torch.float32
            or Mw.dtype != torch.float32 or tgt_xyz.dtype != torch.float32 or tgt_xyz.shape[-1:] != (3,)):
        raise ValueError(f"{name}: xyz {tuple(xyz.shape)} {xyz.dtype}, idx {tuple(idx.shape)} {idx.dtype}, "
                         f"Mw {tuple(Mw.shape)} {Mw.dtype}, target {tuple(tgt_xyz.shape)} {tgt_xyz.dtype}")
    nblk, st = _blocks(n), kernels.stream(Tb)
    tickets, partial = kernels.workspace(Tb, st, "gicp", b, b * nblk * _ROW)
    out = torch.empty((b,) if cost_only else (b, 43), dtype=torch.float32, device=T.device)
    kernels.check(kernels.load("gicp").hgs_gicp_linearize(
        Tb.data_ptr(), b, n, xyz.data_ptr(), idx.data_ptr(), Mw.data_ptr(), tgt_xyz.data_ptr(),
        int(cost_only), nblk, partial.data_ptr(), tickets.data_ptr(), out.data_ptr(), st), name)
    return out


def linearize(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor):
    """H (..., 6, 6), b (..., 6), cost (...) and inliers of the carried
    correspondences at the poses T (4, 4) or (B, 4, 4) against the target
    points ``tgt_xyz`` (M, 3) (GICP's cloud, VGICP's voxel means)
    (``gicp_linearize_kernel`` on the card: one launch, its last block sums
    the partial rows in float64)."""
    if T.device.type == "cpu":
        return linearize_plain(T, corr, src, tgt_xyz)
    out = _reduce("gicp linearize", T, corr, src, tgt_xyz, cost_only=False)
    linearize.launches += 1
    b, H, cost_ = out.split((6, 36, 1), dim=1)
    H, cost_ = H.view(-1, 6, 6), cost_.view(-1)
    if T.ndim == 2:
        return H[0], b[0], cost_[0], corr.num
    return H, b, cost_, corr.num


linearize.launches = 0


def cost(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor) -> torch.Tensor:
    """The cost of ``linearize`` alone (its kernel's cost_only
    instantiation on the card, the full call's bits)."""
    if T.device.type == "cpu":
        return cost_plain(T, corr, src, tgt_xyz)
    out = _reduce("gicp cost", T, corr, src, tgt_xyz, cost_only=True)
    cost.launches += 1
    return out[0] if T.ndim == 2 else out


cost.launches = 0


def _correspond(T: torch.Tensor, src: GicpCloud, tgt: GicpCloud):
    """The 1-NN search at the poses T: (idx, d2) shaped as src.mask, all
    sources' queries in one nn1 launch."""
    moved_q = torch.where(src.mask[..., None], _moved(T, src.xyz), 1.0e6)
    idx, d2 = knn.nn1(moved_q.reshape(-1, 3), torch.where(tgt.mask[:, None], tgt.xyz, 1.0e6))
    return idx.reshape(src.mask.shape), d2.reshape(src.mask.shape)


def _associate(T: torch.Tensor, src: GicpCloud, tgt: GicpCloud, max_corr_dist: float) -> GicpCorr:
    """NN correspondences + Mahalanobis at pose T (fixed through LM trials):
    the search, then ``associate`` with GICP's distance gate."""
    idx, d2 = _correspond(T, src, tgt)
    return associate(T, src, tgt.covs, idx, DistanceGate(d2, tgt.mask, max_corr_dist))


def _linearize_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud):
    return linearize(T, corr, src, tgt.xyz)


def _cost_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud) -> torch.Tensor:
    return cost(T, corr, src, tgt.xyz)


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
