"""NDT (Normal Distributions Transform) with pclomp semantics
(port of hdl_graph_slam_tpu/registration/ndt.py).

Reference usage: src/hdl_graph_slam/registrations.cpp:100-121
(pclomp::NormalDistributionsTransform with reg_resolution, DIRECT7 / DIRECT1 /
KDTREE neighbour search, transformation_epsilon, max_iterations).

- The target becomes Gaussian cells (mean and regularized covariance, at
  least 6 points a cell; ops/voxel.build_gaussian_voxels), carried as one
  (V, 12) [mean | icov] row per cell, and a dense cell -> row grid.
- Each transformed source point scores -d1 exp(-d2/2 q^T S^-1 q) over its
  neighbour cells, d1 and d2 from outlier_ratio 0.55.
- Newton iterations on the 6-dof twist, the step bounded by step_size (PCL
  default 0.1); the More-Thuente line search becomes a parallel one: every
  candidate step length is scored in one launch and the best is taken.

Three reductions of the Newton loop have hand-written Hopper kernels
(csrc/ndt.cu), each with its plain PyTorch twin here:

- ``associate_cells``: the DIRECT1 / DIRECT7 cell association (``_gather_cells``),
  which VGICP's voxel lookup shares (registration/vgicp.py);
- ``derivatives``: gradient, Hessian and score at a pose under a carried
  association (``score_derivatives`` over the gathered cells);
- ``trial_scores``: the scores of L trial poses under one association
  (``_score`` under the line search's vmap).

The association is carried as cell indices (B, N, K) int32 and flags, and
the kernels read the cell rows themselves: the same function as the JAX
package's carried gathered means and icovs, at a twelfth of the bytes.
KDTREE mode associates through ``ops/knn.py::knn`` (the ``knn_select``
kernel at k = 8) over the cell means.

A wrapper runs its plain twin only for CPU tensors; on CUDA tensors it
launches its kernel or raises. Each counts its launches in
``<wrapper>.launches``.

``align`` takes one source or a leading batch of B sources against one
target (the loop detector's candidates), with the semantics of jax.vmap
over the JAX ``align``: a problem's state is frozen once it stops, the loop
runs until all have, and each ``lax.cond`` of the body is evaluated for
every problem and selected per problem. The single-source call is the
batch of one. The host reads one flag tensor per Newton iteration, and one
more in an iteration where a live problem needs the rescue (which runs
only then).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..core import se3
from ..core.cloud import PointCloud
from ..ops import knn as knnops
from ..ops import voxel as voxelops
from ..ops.small_solve import gershgorin_min, solve_spd_checked
from ..utils.metrics import GLOBAL_TIMER
from .base import AlignResult


@dataclasses.dataclass(frozen=True)
class NdtTarget:
    voxels: voxelops.GaussianVoxels
    icovs: torch.Tensor  # (V, 3, 3) inverse cell covariances, 0 where masked
    d1: float  # PCL mixture constants, float32 values
    d2: float
    # flat (G^3,) dense cell -> row grid for the DIRECT lookups, or None for
    # the sorted-key binary search (ops/voxel.py build_dense_grid)
    grid: Optional[torch.Tensor]
    cell_rows: torch.Tensor  # (V, 12) [mean | icov.flat], what the kernels read


def _mixture_constants(resolution: float, outlier_ratio: float) -> Tuple[float, float]:
    """PCL NormalDistributionsTransform::init's d1, d2, computed in float32
    as the JAX package does (on the CPU: two python floats, no device sync)."""
    res = torch.tensor(resolution, dtype=torch.float32)
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / res**3
    d3 = -torch.log(c2)
    d1 = -torch.log(c1 + c2) - d3
    d2 = -2.0 * torch.log((-torch.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return float(d1), float(d2)


def preprocess_target(cloud: PointCloud, resolution: float, max_voxels: int = 8192, outlier_ratio: float = 0.55,
                      grid_size: int = voxelops.DENSE_GRID_SIZE) -> NdtTarget:
    """Build the Gaussian cells and the mixture constants (PCL NDT init).

    grid_size > 0 also builds the flat (grid_size^3,) dense lookup grid:
    cells beyond grid_size * resolution meters of the target's minimum
    occupied cell are not found through it; grid_size = 0 keeps the
    search-based path."""
    from .gicp import _inv3x3

    gv = voxelops.build_gaussian_voxels(cloud, resolution, max_voxels, min_points=6, regularize="ndt")
    grid = voxelops.build_dense_grid(gv.keys, gv.mask, grid_size) if grid_size else None
    icovs = _inv3x3(gv.covs + 1e-6 * torch.eye(3, dtype=gv.covs.dtype, device=gv.covs.device))
    icovs = torch.where(gv.mask[:, None, None], icovs, 0.0)
    d1, d2 = _mixture_constants(resolution, outlier_ratio)
    cell_rows = torch.cat([gv.means, icovs.reshape(-1, 9)], dim=1).contiguous()
    return NdtTarget(voxels=gv, icovs=icovs, d1=d1, d2=d2, grid=grid, cell_rows=cell_rows)


def _gather_mean_icov(tgt: NdtTarget, idx: torch.Tensor):
    """(means, icovs) of a (..., K) cell-index array, from one gather of the
    combined rows."""
    rows = tgt.cell_rows[idx.long()]
    return rows[..., :3], rows[..., 3:].reshape(idx.shape + (3, 3))


def _gather_cells(voxels, grid: Optional[torch.Tensor], pts: torch.Tensor, mask: torch.Tensor,
                  offsets: torch.Tensor):
    """Cell indices and found flags of each point's neighbour cells in a
    sorted voxel table (``keys``, ``mask``, ``origin``, ``resolution``:
    a GaussianVoxels or a VGICP target), (..., N, 3) -> (..., N, K): one
    dense-grid read per cell when ``grid`` is given, else the int32 binary
    search."""
    nkeys = voxelops.neighbor_query_keys(voxels, pts, mask, offsets)
    if grid is not None:
        idx, found = voxelops.lookup_dense(grid, nkeys.reshape(-1), voxelops.grid_dim(grid))
    else:
        idx, found = voxelops.lookup_voxels(voxels, nkeys.reshape(-1))
    return idx.reshape(nkeys.shape), found.reshape(nkeys.shape)


_KDTREE_MAX_CELLS = 8


def _gather_cells_kdtree(tgt: NdtTarget, pts: torch.Tensor, mask: torch.Tensor):
    """KDTREE neighbour mode (pclomp radiusSearch over the cell centroids
    with radius = resolution, registrations.cpp:108-112): the cells whose
    mean lies within ``resolution`` of each point, among its
    _KDTREE_MAX_CELLS nearest means (``ops/knn.py::knn``: the
    ``knn_select`` kernel at k = 8 on the card, exact distances). A leading
    batch of point sets shares the target: all go to one selection."""
    means_q = torch.where(tgt.voxels.mask[:, None], tgt.voxels.means, 1.0e6)
    pts_q = torch.where(mask[..., None], pts, 1.0e6)
    idx, d2 = knnops.knn(pts_q.reshape(-1, 3), means_q, _KDTREE_MAX_CELLS)
    idx, d2 = idx.reshape(pts.shape[:-1] + (-1,)), d2.reshape(pts.shape[:-1] + (-1,))
    res = np.float32(tgt.voxels.resolution)
    found = mask[..., None] & tgt.voxels.mask[idx.long()] & (d2 <= float(res * res))
    return idx, found


def _score(tgt: NdtTarget, moved: torch.Tensor, mask: torch.Tensor, means, icovs, found) -> torch.Tensor:
    """Negative NDT score (to minimize): sum_i sum_k d1 exp(-d2/2 q M q),
    over the last two dims (N, K) of the leading batch.

    The Mahalanobis form is clamped at 0: for a PSD icov this costs nothing,
    and exp() cannot overflow to inf if an icov ever goes indefinite (a -inf
    score false-converges the Newton loop at iteration 1)."""
    q = moved[..., None, :] - means
    md = torch.clamp(torch.einsum("...ki,...kij,...kj->...k", q, icovs, q), min=0.0)
    e = tgt.d1 * torch.exp(-0.5 * tgt.d2 * md)
    w = (found & mask[..., None]).to(moved.dtype)
    return (e * w).sum((-1, -2))


def score_derivatives(d1, d2, moved0: torch.Tensor, mask: torch.Tensor, means, icovs, found):
    """Analytic gradient, Hessian and score of the NDT mixture at delta = 0
    for the left-multiplied twist (the quadratic truncation of
    exp([v, w]^) p, exact in value, gradient and Hessian at 0), with an
    optional leading batch: moved0 (..., N, 3) -> (..., 6), (..., 6, 6), (...).

    Per term s = d1 exp(-d2/2 q^T B q), a = B q, J = [I | -hat(p)]:
      ds/ddelta   = -d2 s (J^T a)
      d2s/ddelta2 = -d2 s (-d2 (J^T a)(J^T a)^T + J^T B J + S),
    with S_vv = 0, S_vw = hat(a)/2, S_wv = S_vw^T,
    S_ww = (a p^T + p a^T)/2 - (a.p) I. Every E-weighted sum over the K
    cells collapses into four per-point moments (sum E, a~, A~, B~) and 3x3
    block algebra with hat(p) (Magnusson 2009 s6.2, PCL ndt.hpp
    computeDerivatives, for the twist instead of Euler angles). The score
    is sum(E)."""
    p = moved0
    q = p[..., None, :] - means
    a = torch.einsum("...kij,...kj->...ki", icovs, q)
    u = torch.clamp((q * a).sum(-1), min=0.0)
    wgt = (found & mask[..., None]).to(p.dtype)
    E = d1 * torch.exp(-0.5 * d2 * u) * wgt

    ea = torch.einsum("...nk,...nki->...ni", E, a)
    eaa = torch.einsum("...nk,...nki,...nkj->...nij", E, a, a)
    eB = torch.einsum("...nk,...nkij->...nij", E, icovs)

    grad = -d2 * torch.cat([ea.sum(-2), torch.linalg.cross(p, ea).sum(-2)], dim=-1)

    Hp = se3.hat(p)
    AHp, HpA = eaa @ Hp, Hp @ eaa
    HpAHp = HpA @ Hp
    BHp, HpB = eB @ Hp, Hp @ eB
    HpBHp = HpB @ Hp
    hat_ea = se3.hat(ea)
    eapt = ea[..., :, None] * p[..., None, :]
    eadp = (ea * p).sum(-1)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)

    C_vv = -d2 * eaa + eB
    C_vw = -d2 * (-AHp) + (-BHp) + 0.5 * hat_ea
    C_wv = -d2 * HpA + HpB - 0.5 * hat_ea
    C_ww = -d2 * (-HpAHp) + (-HpBHp) + 0.5 * (eapt + eapt.transpose(-1, -2)) - eadp[..., None, None] * eye
    H = -d2 * torch.cat([torch.cat([C_vv.sum(-3), C_vw.sum(-3)], -1),
                         torch.cat([C_wv.sum(-3), C_ww.sum(-3)], -1)], -2)
    return grad, H, E.sum((-1, -2))


# -- the kernel wrappers and their plain twins ------------------------------------------


def _check(name: str, xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor) -> None:
    if xyz.dtype != torch.float32 or xyz.ndim != 3 or xyz.shape[2] != 3 or xyz.shape[1] == 0:
        raise ValueError(f"{name}: xyz must be (B, n, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    if mask.shape != xyz.shape[:2] or mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask must be (B, n) bool, got {tuple(mask.shape)} {mask.dtype}")
    if T.dtype != torch.float32 or T.shape[0] != xyz.shape[0] or T.shape[-2:] != (4, 4):
        raise ValueError(f"{name}: poses must be (B, ..., 4, 4) float32, got {tuple(T.shape)} {T.dtype}")
    if not (xyz.device == mask.device == T.device):
        raise ValueError(f"{name}: tensors on {xyz.device}, {mask.device}, {T.device}")
    if xyz.shape[0] > 65535:
        raise ValueError(f"{name}: batch {xyz.shape[0]} above 65535")
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {xyz.device}")


def associate_cells_plain(voxels, grid: Optional[torch.Tensor], xyz: torch.Tensor, mask: torch.Tensor,
                          T: torch.Tensor, method: str = "DIRECT7") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``associate_cells``: transform_points, then ``_gather_cells``."""
    offsets = voxelops.neighbor_offsets(method, device=xyz.device)
    return _gather_cells(voxels, grid, se3.transform_points(T, xyz), mask, offsets)


def associate_cells(voxels, grid: Optional[torch.Tensor], xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor,
                    method: str = "DIRECT7") -> Tuple[torch.Tensor, torch.Tensor]:
    """DIRECT1 / DIRECT7 cell association of B point sets at their poses in
    a sorted voxel table (its ``keys``, ``mask``, ``origin`` and
    ``resolution``) with its flat dense grid, or None for the key search:
    xyz (B, n, 3), mask (B, n), T (B, 4, 4) -> idx (B, n, K) int32, found
    (B, n, K) bool, K = 1 or 7 (ndt_associate_kernel on the card). NDT's
    cells and VGICP's voxels both associate here."""
    _check("ndt associate", xyz, mask, T)
    if xyz.device.type == "cpu":
        return associate_cells_plain(voxels, grid, xyz, mask, T, method)
    K = 1 if method.upper() == "DIRECT1" else 7
    xyz, mask, T = xyz.contiguous(), mask.contiguous(), T.contiguous()
    b, n = mask.shape
    idx = torch.empty((b, n, K), dtype=torch.int32, device=xyz.device)
    found = torch.empty((b, n, K), dtype=torch.bool, device=xyz.device)
    G = voxelops.grid_dim(grid) if grid is not None else 0
    kernels.check(kernels.load("ndt").hgs_ndt_associate(
        xyz.data_ptr(), mask.data_ptr(), T.data_ptr(), b, n, K, voxels.origin.data_ptr(),
        ctypes.c_float(voxels.resolution), None if grid is None else grid.data_ptr(), G, voxels.keys.data_ptr(),
        voxels.mask.data_ptr(), voxels.keys.shape[0], idx.data_ptr(), found.data_ptr(), kernels.stream(xyz)),
        "ndt associate")
    associate_cells.launches += 1
    return idx, found


associate_cells.launches = 0


def associate_plain(tgt: NdtTarget, xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor,
                    method: str = "DIRECT7") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``associate``."""
    return associate_cells_plain(tgt.voxels, tgt.grid, xyz, mask, T, method)


def associate(tgt: NdtTarget, xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor,
              method: str = "DIRECT7") -> Tuple[torch.Tensor, torch.Tensor]:
    """``associate_cells`` in the target's Gaussian cells: one launch a call."""
    return associate_cells(tgt.voxels, tgt.grid, xyz, mask, T, method)


def derivatives_plain(tgt: NdtTarget, xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor, idx: torch.Tensor,
                      found: torch.Tensor):
    """Plain twin of ``derivatives``: gather the cells, ``score_derivatives``."""
    means, icovs = _gather_mean_icov(tgt, idx)
    return score_derivatives(tgt.d1, tgt.d2, se3.transform_points(T, xyz), mask, means, icovs, found)


# csrc/ndt.cu's launch constants: threads a block of the reductions, blocks
# a problem at most, cells a point at most, trial poses a score launch at
# most, floats a partial row of the derivatives and of the scores
_THREADS, _MAX_BLOCKS, _MAX_K, MAX_TRIALS = 256, 1024, 8, 16
_DERIV_ROW, _SCORE_ROW = 32, MAX_TRIALS


def _blocks(n: int, K: int) -> int:
    """The blocks per problem of the derivative and score launches over n
    points of K cells (ndt.cu blocks_for): one (point, cell) pair a thread
    up to _MAX_BLOCKS blocks."""
    return min(max(-(-n * K // _THREADS), 1), _MAX_BLOCKS)


def _check_cells(name: str, xyz: torch.Tensor, idx: torch.Tensor, found: torch.Tensor, rows: torch.Tensor,
                 trials: int = 1) -> None:
    """What the reduction kernels take beyond ``_check``: the association
    idx (B, n, K) int32 and found (B, n, K) bool and the target's (V, 12)
    float32 cell rows on xyz's device, K at most _MAX_K, at most
    MAX_TRIALS trial poses."""
    if rows.dtype != torch.float32 or rows.ndim != 2 or rows.shape[1] != 12 or not rows.is_contiguous():
        raise ValueError(f"{name}: cell rows must be contiguous (V, 12) float32, got {tuple(rows.shape)} {rows.dtype}")
    if idx.dtype != torch.int32 or idx.shape[:2] != xyz.shape[:2] or idx.ndim != 3:
        raise ValueError(f"{name}: idx must be (B, n, K) int32, got {tuple(idx.shape)} {idx.dtype}")
    if found.dtype != torch.bool or found.shape != idx.shape:
        raise ValueError(f"{name}: found must be {tuple(idx.shape)} bool, got {tuple(found.shape)} {found.dtype}")
    if not (idx.device == found.device == rows.device == xyz.device):
        raise ValueError(f"{name}: association on {idx.device}, {found.device}, cells on {rows.device}, "
                         f"points on {xyz.device}")
    if not 0 < idx.shape[2] <= _MAX_K:
        raise ValueError(f"{name}: K = {idx.shape[2]} outside 1..{_MAX_K}")
    if not 0 < trials <= MAX_TRIALS:
        raise ValueError(f"{name}: {trials} trial poses outside 1..{MAX_TRIALS}")


# the reductions' workspaces (kernels.workspace): the int32 ticket counters,
# one a problem, and the float32 partial rows
_workspaces = kernels.workspaces


def _workspace(x: torch.Tensor, stream: int, batch: int, floats: int):
    """(tickets, partial) for a launch on ``stream`` of x's device with
    ``batch`` problems and ``floats`` partial values."""
    return kernels.workspace(x, stream, "ndt", batch, floats)


def derivatives(tgt: NdtTarget, xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor, idx: torch.Tensor,
                found: torch.Tensor):
    """Gradient (B, 6), Hessian (B, 6, 6) and score (B,) of the NDT mixture
    at the poses T (B, 4, 4) under the association idx / found (B, n, K)
    (ndt_derivatives_kernel on the card: one launch, its last block sums
    the partial rows)."""
    _check("ndt derivatives", xyz, mask, T)
    if xyz.device.type == "cpu":
        return derivatives_plain(tgt, xyz, mask, T, idx, found)
    _check_cells("ndt derivatives", xyz, idx, found, tgt.cell_rows)
    xyz, mask, T = xyz.contiguous(), mask.contiguous(), T.contiguous()
    idx, found = idx.contiguous(), found.contiguous()
    b, n = mask.shape
    nblk, st = _blocks(n, idx.shape[-1]), kernels.stream(xyz)
    tickets, partial = _workspace(xyz, st, b, b * nblk * _DERIV_ROW)
    out = torch.empty((b, 43), dtype=torch.float32, device=xyz.device)
    kernels.check(kernels.load("ndt").hgs_ndt_derivatives(
        xyz.data_ptr(), mask.data_ptr(), T.data_ptr(), b, n, idx.shape[-1], idx.data_ptr(), found.data_ptr(),
        tgt.cell_rows.data_ptr(), ctypes.c_float(tgt.d1), ctypes.c_float(tgt.d2), nblk, partial.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), st), "ndt derivatives")
    derivatives.launches += 1
    g, H, score = out.split((6, 36, 1), dim=1)
    return g, H.view(b, 6, 6), score.view(b)


derivatives.launches = 0


def trial_scores_plain(tgt: NdtTarget, xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor, idx: torch.Tensor,
                       found: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``trial_scores``: ``_score`` of each trial pose."""
    means, icovs = _gather_mean_icov(tgt, idx)
    moved = se3.transform_points(T, xyz[:, None])  # (B, L, n, 3)
    return _score(tgt, moved, mask[:, None], means[:, None], icovs[:, None], found[:, None])


def trial_scores(tgt: NdtTarget, xyz: torch.Tensor, mask: torch.Tensor, T: torch.Tensor, idx: torch.Tensor,
                 found: torch.Tensor) -> torch.Tensor:
    """Scores of L trial poses T (B, L, 4, 4) of each problem under its one
    association idx / found (B, n, K) -> (B, L) (ndt_score_kernel on the
    card: one launch for all L <= MAX_TRIALS trials, each point's cells
    read once)."""
    _check("ndt trial_scores", xyz, mask, T)
    if xyz.device.type == "cpu":
        return trial_scores_plain(tgt, xyz, mask, T, idx, found)
    if T.ndim != 4:
        raise ValueError(f"ndt trial_scores: poses must be (B, L, 4, 4), got {tuple(T.shape)}")
    L = T.shape[1]
    _check_cells("ndt trial_scores", xyz, idx, found, tgt.cell_rows, trials=L)
    xyz, mask, T = xyz.contiguous(), mask.contiguous(), T.contiguous()
    idx, found = idx.contiguous(), found.contiguous()
    b, n = mask.shape
    nblk, st = _blocks(n, idx.shape[-1]), kernels.stream(xyz)
    tickets, partial = _workspace(xyz, st, b, b * nblk * _SCORE_ROW)
    out = torch.empty((b, L), dtype=torch.float32, device=xyz.device)
    kernels.check(kernels.load("ndt").hgs_ndt_score(
        xyz.data_ptr(), mask.data_ptr(), T.data_ptr(), b, L, n, idx.shape[-1], idx.data_ptr(), found.data_ptr(),
        tgt.cell_rows.data_ptr(), ctypes.c_float(tgt.d1), ctypes.c_float(tgt.d2), nblk, partial.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), st), "ndt trial_scores")
    trial_scores.launches += 1
    return out


trial_scores.launches = 0


# -- align -----------------------------------------------------------------------


class _NewtonState(NamedTuple):
    T: torch.Tensor  # (B, 4, 4)
    it: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool
    score: torch.Tensor  # (B,)
    num_inliers: torch.Tensor  # (B,) int32
    # the cell association carried across iterations (fixed-cells mode),
    # refreshed only when the accumulated per-point displacement bound since
    # the last refresh exceeds the budget, or when the loop would declare
    # convergence on a stale association
    idx: torch.Tensor  # (B, N, K) int32
    found: torch.Tensor  # (B, N, K) bool
    disp: torch.Tensor  # (B,) displacement bound since the last fresh association


def _rows(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per problem of the leading batch: a where the (B,) cond holds, else b."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant vector on the device, copied there once: a copy from
    pageable host memory inside the Newton loop would be a host sync per
    iteration."""
    return torch.tensor(values, dtype=dtype, device=device)


_LADDER_FRACTIONS = (0.0, 1.0 / 27.0, 1.0 / 9.0, 1.0 / 3.0)  # of the Gershgorin shift, rungs 0-3


def _newton_direction(H: torch.Tensor, g: torch.Tensor, kdtree: bool) -> torch.Tensor:
    """The PD-shifted Newton direction -(H + shift)^-1 g, (B, 6, 6), (B, 6).

    The base margin is Marquardt-style, proportional to each diagonal entry:
    the rotation block scales like r_max^2 over the translation block
    (~1e5 at 50 m), and a spectral-scale margin * I damps the translation
    directions far below their curvature (the Newton step then collapses
    and the loop "converges" without moving). The Gershgorin rungs stay
    absolute shifts, what a truly indefinite H needs; each rung is solved by
    the unrolled Cholesky whose minimum pivot certifies PD, the least-damped
    certified rung wins, and the top rung (the global margin plus the full
    Gershgorin shift) always certifies. KDTREE's support set is
    discontinuous in pose, so it keeps the conservative global margin.
    All five rungs are one batched solve."""
    scale = torch.clamp(H.abs().sum(-1).amax(-1), min=1.0)  # >= spectral radius
    dH = torch.diagonal(H, dim1=-2, dim2=-1).abs()
    if kdtree:
        margin = 1e-3 * scale[:, None] * torch.ones_like(dH)
    else:
        margin = 1e-3 * torch.maximum(dH, 1e-9 * scale[:, None])
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    neg = torch.clamp(-gershgorin_min(H), min=0.0)
    tol = 1e-9 * scale
    fs = _constant(_LADDER_FRACTIONS, H.dtype, H.device)
    shifts = torch.cat([torch.diag_embed(margin)[:, None] + (fs[None, :] * neg[:, None])[..., None, None] * eye6,
                        ((1e-3 * scale + neg)[:, None, None] * eye6)[:, None]], dim=1)  # (B, 5, 6, 6)
    x, mp = solve_spd_checked(H[:, None] + shifts, g[:, None].expand(-1, 5, -1).contiguous())
    ok = mp > tol[:, None]
    ok[:, 4] = True  # no certified rung: the top rung's solve, as in the JAX ladder
    rung = torch.argmax(ok.to(torch.int32), dim=1)  # the first certified
    d = -x[torch.arange(H.shape[0], device=H.device), rung]
    # guaranteed descent: steepest descent if the solve still ascends
    return torch.where(((g * d).sum(-1) < 0.0)[:, None], d, -g)


def align(
    tgt: NdtTarget,
    src: PointCloud,
    guess: torch.Tensor,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 64,
    step_size: float = 0.1,
    nn_search_method: str = "DIRECT7",
    num_line_search: int = 10,
    line_search_fixed_cells: bool = True,
    reassoc_displacement: float = 0.0,
) -> AlignResult:
    """Newton-optimize the NDT mixture score from ``guess``.

    line_search_fixed_cells=True (default): the trials score against the
    cell association of the current pose, and acceptance compares the best
    trial with the current score under that same association. The
    association is refreshed only when the accumulated per-point
    displacement bound since the last refresh (per step alpha (|v| + |w|
    (r_max + |t|)), r_max = the farthest source point) exceeds
    ``reassoc_displacement`` meters, or when the loop would declare
    convergence on a stale association: then it refreshes and re-checks.
    The default 0.0 refreshes on every accepted step. A failed line search
    on a fresh association re-scores its best candidate under a fresh
    association before giving up (the rescue).
    line_search_fixed_cells=False re-associates every trial (PCL's
    More-Thuente search does, ndt.hpp computeStepLengthMT).

    src.xyz (N, 3) with guess (4, 4), or a leading batch (B, N, 3) with
    (B, 4, 4): an AlignResult with the same leading batch."""
    batched = guess.ndim == 3
    xyz = src.xyz if batched else src.xyz[None]
    mask = src.mask if batched else src.mask[None]
    T0 = guess if batched else guess[None]
    kdtree = nn_search_method.upper() == "KDTREE"
    dtype, dev = T0.dtype, T0.device
    B = T0.shape[0]
    rows = torch.arange(B, device=dev)
    L = num_line_search
    eps = transformation_epsilon

    def gather(T, xyz=xyz, mask=mask):
        if kdtree:
            return _gather_cells_kdtree(tgt, se3.transform_points(T, xyz), mask)
        return associate(tgt, xyz, mask, T, nn_search_method)

    def full_score(T):
        """Score at T under a fresh association, and that association."""
        idx, found = gather(T)
        ninl = (found & mask[..., None]).any(-1).sum(-1, dtype=torch.int32)
        return trial_scores(tgt, xyz, mask, T[:, None], idx, found)[:, 0], ninl, idx, found

    r_max = torch.sqrt(torch.where(mask, (xyz * xyz).sum(-1), 0.0).amax(-1))
    halves = _constant(tuple(0.5**i for i in range(L)), dtype, dev)

    s0, n0, idx0, found0 = full_score(T0)
    zero = torch.zeros(B, dtype=dtype, device=dev)
    s = _NewtonState(T=T0, it=torch.zeros(B, dtype=torch.int32, device=dev),
                     converged=torch.zeros(B, dtype=torch.bool, device=dev), score=s0, num_inliers=n0,
                     idx=idx0, found=found0, disp=zero)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        g, H, score0 = derivatives(tgt, xyz, mask, s.T, s.idx, s.found)
        d = _newton_direction(H, g, kdtree)
        dnorm = torch.linalg.norm(d, dim=-1)
        ddir = d / torch.where(dnorm < 1e-12, 1.0, dnorm)[:, None]
        alphas = torch.minimum(dnorm, torch.full_like(dnorm, step_size))[:, None] * halves  # (B, L)
        Ts = se3.compose(se3.se3_exp(alphas[..., None] * ddir[:, None]), s.T[:, None])  # (B, L, 4, 4)
        if line_search_fixed_cells:
            trial = trial_scores(tgt, xyz, mask, Ts, s.idx, s.found)
            current = score0
        else:
            # every trial under its own fresh association: the B x L trials
            # as a batch of B * L problems
            xyz_l, mask_l, T_l = xyz.repeat_interleave(L, 0), mask.repeat_interleave(L, 0), Ts.reshape(-1, 4, 4)
            i2, f2 = gather(T_l, xyz_l, mask_l)
            trial = trial_scores(tgt, xyz_l, mask_l, T_l[:, None], i2, f2).reshape(B, L)
            current = s.score
        best = torch.argmin(trial, dim=1)
        T_best, best_score, alpha_b = Ts[rows, best], trial[rows, best], alphas[rows, best]
        improve = best_score < current

        def fixed_cells_step(rescue):
            """The fixed-cells state after this step and its refresh flags.
            ``rescue`` is the fresh (score, inliers, idx, found) at T_best, or
            None when no live problem needs it: then no problem is rescued,
            as the rescue's own select would give."""
            imp = improve
            if rescue is not None:
                r_score, r_ninl, r_idx, r_found = rescue
                rescued = need_rescue & (r_score < current)
                imp = improve | rescued
            alpha = torch.where(imp, alpha_b, 0.0)
            new_score = torch.where(imp, best_score, current)
            # converged when the applied update is below epsilon, trusted
            # only on a fresh association (disp == 0)
            stale = s.disp > 0.0
            would_conv = alpha < eps
            radius = r_max + torch.linalg.norm(s.T[:, :3, 3], dim=-1)
            step_disp = alpha * (torch.linalg.norm(ddir[:, :3], dim=-1) + torch.linalg.norm(ddir[:, 3:], dim=-1)
                                 * radius)
            disp_next = s.disp + step_disp
            refresh = (would_conv & stale) | (disp_next > reassoc_displacement)
            new = _NewtonState(T=_rows(imp, T_best, s.T), it=s.it + 1, converged=would_conv & ~stale,
                               score=new_score, num_inliers=s.num_inliers, idx=s.idx, found=s.found, disp=disp_next)
            if rescue is not None:
                # a rescued step already carries its fresh association at T_best
                refresh = ~rescued & refresh
                new = new._replace(score=torch.where(rescued, r_score, new_score),
                                   num_inliers=torch.where(rescued, r_ninl, s.num_inliers),
                                   idx=_rows(rescued, r_idx, s.idx), found=_rows(rescued, r_found, s.found),
                                   disp=torch.where(rescued, 0.0, disp_next))
            return new, refresh

        def advance(new):
            nxt = _NewtonState(*[_rows(live, a, b) for a, b in zip(new, s)])
            return nxt, ~nxt.converged & (nxt.it < max_iterations)

        if line_search_fixed_cells:
            # the rescue: a failed fixed-association line search on a fresh
            # association with real (>= epsilon) candidates re-scores its best
            # candidate under a fresh association (new cells may come into
            # range under the step). The step is taken first without it; the
            # one flag read of the iteration says whether a live problem
            # needs it, and only then is it evaluated and the step redone
            need_rescue = ~improve & (s.disp == 0.0) & (alphas[:, 0] >= eps)
            new, refresh = fixed_cells_step(None)
            nxt, live_next = advance(new)
            # host sync: one flag tensor per iteration
            GLOBAL_TIMER.count("host_sync.ndt_align")
            flags = torch.stack([live_next, live & refresh, live & need_rescue]).cpu()
            if bool(flags[2].any()):
                new, refresh = fixed_cells_step(full_score(T_best))
                nxt, live_next = advance(new)
                GLOBAL_TIMER.count("host_sync.ndt_align")
                flags = torch.stack([live_next, live & refresh]).cpu()
        else:
            alpha = torch.where(improve, alpha_b, 0.0)
            _, ninl, idx_n, found_n = full_score(_rows(improve, T_best, s.T))
            nxt, live_next = advance(_NewtonState(
                T=_rows(improve, T_best, s.T), it=s.it + 1, converged=alpha < eps,
                score=torch.where(improve, best_score, current), num_inliers=ninl, idx=idx_n, found=found_n,
                disp=zero))
            GLOBAL_TIMER.count("host_sync.ndt_align")
            flags = live_next[None].cpu()  # host sync: one flag tensor per iteration
        was_live, s, live = live, nxt, live_next
        if line_search_fixed_cells and bool(flags[1].any()):
            # the refresh branch, at each refreshing problem's new pose
            _, ninl, idx_n, found_n = full_score(s.T)
            ref = was_live & refresh
            s = s._replace(num_inliers=torch.where(ref, ninl, s.num_inliers), idx=_rows(ref, idx_n, s.idx),
                           found=_rows(ref, found_n, s.found), disp=torch.where(ref, 0.0, s.disp))
        if not bool(flags[0].any()):
            break
    # the final score at the final pose under the carried association (fresh
    # after a convergence-gated refresh)
    err = trial_scores(tgt, xyz, mask, s.T[:, None], s.idx, s.found)[:, 0]
    out = AlignResult(transformation=s.T, converged=s.converged, iterations=s.it, error=err,
                      num_inliers=s.num_inliers)
    return out if batched else AlignResult(*[x[0] for x in out])
