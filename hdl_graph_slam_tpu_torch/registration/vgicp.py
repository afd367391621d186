"""Voxelized GICP with fast_gicp::FastVGICP semantics
(port of hdl_graph_slam_tpu/registration/vgicp.py).

Reference usage: src/hdl_graph_slam/registrations.cpp:48-56 (FAST_VGICP /
FAST_VGICP_CUDA): reg_resolution voxel size, otherwise GICP parameters.

- The target's per-point GICP covariances (gicp.preprocess, the k=20
  ``knn_select`` kernel on the card) are aggregated per voxel: the mean of
  the point means and the mean of the point covariances (fast_gicp
  GaussianVoxel ADDITIVE mode), every occupied voxel kept, no further
  regularization. The sums run in row order over the key-sorted points
  (ops/voxel.py ``_segment_sums``), so the target is the same bits run to run.
- Each source point matches the voxel that contains it: the DIRECT1 lookup
  of ``ndt.associate_cells`` (``ndt_associate_kernel<1>`` on the card; a
  dense-grid read, or the int32 key search without a grid).
- GICP's association with the lookup's found flags as its gate, then the
  distribution-to-distribution Mahalanobis LM of GICP (base.lm_loop_batched)
  against the voxel means, through ``gicp.Prepared``: the fused
  associate-and-linearize form of ``gicp_step_kernel`` at every
  association, then its linearize or cost form for the trials.

``align`` takes one source or a leading batch of B sources against one
target (the loop detector's candidates), with the semantics of ``jax.vmap``
over the JAX ``align``. The single source is the batch of one, so a batch of
one gives the single align's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.cloud import PAD_COORD, PointCloud
from ..ops import voxel as voxelops
from . import gicp, ndt
from .base import AlignResult, lm_loop_batched
from .gicp import GicpCloud, GicpCorr
from .gicp import preprocess as gicp_preprocess

_INVALID_KEY = voxelops._LOCAL_INVALID


@dataclasses.dataclass(frozen=True)
class VgicpTarget:
    keys: torch.Tensor  # (V,) sorted int32 local voxel keys (ops/voxel.py)
    means: torch.Tensor  # (V, 3), PAD_COORD where masked
    covs: torch.Tensor  # (V, 3, 3) voxel-aggregated GICP covariances
    mask: torch.Tensor  # (V,)
    resolution: float  # voxel size in meters (used as float32)
    origin: torch.Tensor  # (3,) int32 local-grid anchor
    # flat (G^3,) dense cell -> row grid, or None for the key search
    grid: Optional[torch.Tensor] = None


def preprocess_target(cloud: PointCloud, resolution: float, max_voxels: int = 8192, k: int = 20,
                      grid_size: int = voxelops.DENSE_GRID_SIZE, src: Optional[GicpCloud] = None) -> VgicpTarget:
    """Per-point GICP covariances -> voxel-aggregated Gaussians in a table of
    ``max_voxels`` rows (the lowest keys win on overflow). ``src``, the
    cloud's own gicp.preprocess when the caller has it, saves the k = 20
    selection. With grid_size > 0 the per-iteration lookup is one dense-grid
    read; voxels beyond grid_size * resolution meters from the minimum
    occupied cell are then not found."""
    gc = src if src is not None else gicp_preprocess(cloud, k=k)
    origin = voxelops.local_origin(cloud.xyz, cloud.mask, resolution)
    keys = voxelops.pack_local_keys(voxelops.local_cells(cloud.xyz, resolution), origin, cloud.mask)
    keys_s, order = voxelops.sort_with_order(keys)
    valid_s = keys_s != _INVALID_KEY
    xyz_s = torch.where(valid_s[:, None], cloud.xyz[order], 0.0)
    covs_s = torch.where(valid_s[:, None, None], gc.covs[order], 0.0)
    seg_ids, _ = voxelops._segment_ids_from_sorted_keys(keys_s)
    acc = voxelops._segment_sums(torch.cat([xyz_s, valid_s.to(xyz_s.dtype)[:, None], covs_s.reshape(-1, 9)], dim=1),
                                 seg_ids, valid_s, max_voxels)
    counts = torch.clamp(acc[:, 3], min=1.0)
    mean = acc[:, :3] / counts[:, None]
    cov = acc[:, 4:].reshape(-1, 3, 3) / counts[:, None, None]
    seg_keys = voxelops._segment_keys(keys_s, seg_ids, max_voxels)
    vmask = (acc[:, 3] > 0) & (seg_keys != _INVALID_KEY)
    final_keys = torch.where(vmask, seg_keys, _INVALID_KEY)
    grid = voxelops.build_dense_grid(final_keys, vmask, grid_size) if grid_size else None
    return VgicpTarget(keys=final_keys, means=torch.where(vmask[:, None], mean, PAD_COORD), covs=cov, mask=vmask,
                       resolution=float(resolution), origin=origin, grid=grid)


def _lookup(T: torch.Tensor, src: GicpCloud, tgt: VgicpTarget):
    """The voxel lookup at the poses T (B, 4, 4) of the B sources (B, N, 3):
    (idx, found), each (B, N), in one ``ndt_associate_kernel<1>`` launch."""
    idx, found = ndt.associate_cells(tgt, tgt.grid, src.xyz, src.mask, T, "DIRECT1")
    return idx[..., 0], found[..., 0]


def _associate(T: torch.Tensor, src: GicpCloud, tgt: VgicpTarget) -> GicpCorr:
    """Voxel correspondences + Mahalanobis at the poses T (B, 4, 4) of the B
    sources (B, N, 3): one voxel lookup and one association launch for all
    of them."""
    return gicp.associate(T, src, tgt.covs, *_lookup(T, src, tgt))


def align(
    tgt: VgicpTarget,
    src: GicpCloud,
    guess: torch.Tensor,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 64,
    lm_init_lambda_factor: float = 1e-9,
    reassoc_displacement: float = 0.0,
) -> AlignResult:
    """Align a GICP-preprocessed source onto the voxel target from ``guess``
    (4, 4), or a leading batch (B, N, 3) with (B, 4, 4) (base.lm_loop_batched).
    reassoc_displacement: see gicp.align (0.0 = per-iteration re-association).
    The kernels' inputs are checked once here (``gicp.Prepared``)."""
    batched = guess.ndim == 3
    if not batched:
        src = GicpCloud(xyz=src.xyz[None], mask=src.mask[None], covs=src.covs[None])
        guess = guess[None]
    prep = gicp.Prepared(src, tgt.covs, tgt.means)
    if not prep.cpu:
        gicp._check("vgicp align", guess, src.xyz, tgt.means)
        guess = guess.contiguous()
    r_max = None
    if reassoc_displacement:
        r_max = torch.sqrt(torch.where(src.mask, (src.xyz * src.xyz).sum(-1), 0.0).amax(-1))

    out = lm_loop_batched(
        associate=lambda T: prep.associate(T, *_lookup(T, src, tgt)),
        linearize_at=prep.linearize,
        cost_at=prep.cost,
        guess=guess,
        max_iterations=max_iterations,
        transformation_epsilon=transformation_epsilon,
        lm_init_lambda_factor=lm_init_lambda_factor,
        reassoc_displacement=reassoc_displacement,
        r_max=r_max,
        associate_linearize=lambda T: prep.associate_linearize(T, *_lookup(T, src, tgt)),
        select=prep.select,
    )
    return out if batched else AlignResult(*[x[0] for x in out])
