"""Plain PyTorch reference of one scan-matching odometry frame.

A raw scan goes through the launch file's prefilter (the distance band,
a centroid voxel grid, the radius outlier filter), the GICP source
preparation (per-point covariances of the k nearest neighbours with the
plane regularization, eigenvalues (1e-3, 1, 1)) and FAST_GICP's
Levenberg-Marquardt loop (1-NN correspondences gated at the maximum
correspondence distance, Mahalanobis weights (C_t + R C_s R^T)^-1, Nielsen
damping, convergence on a step below the transformation epsilon).

Everything is float32 on the device it is given, the precision the
configuration states. Neighbour searches rank by the expanded distance
|t|^2 - 2 q.t of coordinates centred on the target's bounding box, a matrix
product, so that ``precision(tf32=True)`` (the control) lowers exactly
these products; every winner's distance is then taken again exactly.
Searches run in row blocks, so the largest scan fits beside the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geometry as G
from . import tf32_round as R

BLOCK = 2048  # query rows a block of a search


def _centre(target: torch.Tensor) -> torch.Tensor:
    return 0.5 * (target.amin(0) + target.amax(0))


def _ranking(query: torch.Tensor, target: torch.Tensor):
    """(Q, T) with Q @ T.T = |t|^2 - 2 q.t of the coordinates centred on
    the target's bounding box: the distance ranking as one product of
    homogeneous rows [q, 1] and [-2 t, |t|^2]."""
    c = _centre(target)
    tc = target - c
    one = torch.ones_like(query[:, :1])
    return (torch.cat([query - c, one], 1),
            torch.cat([-2.0 * tc, (tc * tc).sum(-1, keepdim=True)], 1))


def nn1(query: torch.Tensor, target: torch.Tensor):
    """(index, exact squared distance) of each query row's nearest target row."""
    Q, T = _ranking(query, target)
    Q, T = R(Q), R(T)
    idx = torch.cat([(q @ T.T).argmin(-1) for q in torch.split(Q, BLOCK)])
    d = query - target[idx]
    return idx, (d * d).sum(-1)


def knn(points: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) indices of each row's k nearest rows (itself included)."""
    Q, T = _ranking(points, points)
    Q, T = R(Q), R(T)
    return torch.cat([torch.topk(q @ T.T, k, dim=-1, largest=False).indices for q in torch.split(Q, BLOCK)])


def radius_neighbours(points: torch.Tensor, radius: float) -> torch.Tensor:
    """Rows strictly within ``radius`` of each row (itself included), by
    exact differences against the float32 radius squared."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=points.device)
    out = []
    for q in torch.split(points, 512):
        d = q[:, None, :] - points[None, :, :]
        out.append(((d * d).sum(-1) < r2).sum(-1))
    return torch.cat(out)


def prefilter(scan: np.ndarray, pf: dict, capacity: int, device) -> torch.Tensor:
    """The valid points (P, 3) a raw scan (M, 3) leaves, in ascending voxel
    order: |p| strictly inside (near, far), voxel centroids (the first
    ``capacity`` voxels in that order), then the outlier filter."""
    xyz = torch.as_tensor(np.asarray(scan, dtype=np.float32), device=device)
    if pf["use_distance_filter"]:
        d = torch.linalg.norm(xyz, dim=-1)
        xyz = xyz[(d > pf["distance_near_thresh"]) & (d < pf["distance_far_thresh"])]
    if pf["downsample_method"] in ("VOXELGRID", "APPROX_VOXELGRID"):
        res = torch.tensor(pf["downsample_resolution"], dtype=torch.float32, device=device)
        ijk = torch.floor(xyz / res).to(torch.int64) + (1 << 20)
        key = (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]
        keys, inverse, counts = torch.unique(key, sorted=True, return_inverse=True, return_counts=True)
        sums = torch.zeros((keys.shape[0], 3), dtype=torch.float64, device=device)
        sums.index_add_(0, inverse, xyz.double())
        xyz = (sums / counts[:, None].double()).float()[:capacity]
    else:
        xyz = xyz[:capacity]
    method = pf["outlier_removal_method"]
    if method == "RADIUS":
        xyz = xyz[radius_neighbours(xyz, pf["radius_radius"]) - 1 >= pf["radius_min_neighbors"]]
    elif method != "NONE":
        raise ValueError(f"reference prefilter: outlier removal {method!r} is not written yet")
    return xyz


@dataclasses.dataclass
class GicpCloud:
    xyz: torch.Tensor  # (N, 3) valid points only
    covs: torch.Tensor  # (N, 3, 3)


def smallest_eigenvectors(cov: torch.Tensor) -> torch.Tensor:
    """The unit eigenvector of each (3, 3) matrix's smallest eigenvalue,
    solved in blocks (the batched symmetric solver refuses very large batches)."""
    return torch.cat([torch.linalg.eigh(c)[1][..., 0] for c in torch.split(cov, 8192)])


def covariances(xyz: torch.Tensor, k: int) -> GicpCloud:
    """fast_gicp's covariances of the k nearest neighbours, plane-regularized."""
    nb = xyz[knn(xyz, k)]
    cen = nb - nb.mean(1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", R(cen), R(cen)) / k
    cov = cov + 1e-9 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    v = smallest_eigenvectors(cov)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return GicpCloud(xyz=xyz, covs=eye - (1.0 - 1e-3) * v[:, :, None] * v[:, None, :])


def _moved(T, xyz):
    return xyz @ T[:3, :3].T + T[:3, 3]


def _associate(T, src: GicpCloud, tgt: GicpCloud, max_corr: float):
    moved = _moved(T, src.xyz)
    idx, d2 = nn1(moved, tgt.xyz)
    valid = d2 < max_corr * max_corr
    R = T[:3, :3]
    M = torch.linalg.inv(tgt.covs[idx] + R @ src.covs @ R.T) * valid[:, None, None].to(T.dtype)
    return idx, M


def _linearize(T, idx, M, src: GicpCloud, tgt: GicpCloud):
    moved = _moved(T, src.xyz)
    e = tgt.xyz[idx] - moved
    J = torch.cat([-torch.eye(3, dtype=T.dtype, device=T.device).expand(moved.shape[0], 3, 3), G.hat(moved)], -1)
    MJ = R(M) @ R(J)
    H = torch.einsum("nji,njk->ik", R(J), R(MJ))
    Me = (R(M) @ R(e)[..., None])[..., 0]
    b = torch.einsum("nji,nj->i", R(J), R(Me))
    return H, b, (e * Me).sum()


def _cost(T, idx, M, src: GicpCloud, tgt: GicpCloud):
    e = tgt.xyz[idx] - _moved(T, src.xyz)
    return (e * (M @ e[..., None])[..., 0]).sum()


def gicp_align(tgt: GicpCloud, src: GicpCloud, guess: torch.Tensor, reg: dict):
    """(T, converged) of FAST_GICP's LM from ``guess``: each iteration
    re-associates at the current pose, takes one damped step and keeps it
    when the cost under those correspondences falls."""
    eps, max_corr = reg["reg_transformation_epsilon"], reg["reg_max_correspondence_distance"]
    T = guess.to(torch.float32)
    lam = nu = None
    eye3 = torch.eye(3, dtype=T.dtype, device=T.device)
    converged = False
    for _ in range(reg["reg_maximum_iterations"]):
        idx, M = _associate(T, src, tgt, max_corr)
        H, b, cost = _linearize(T, idx, M, src, tgt)
        if lam is None:
            lam = 1e-9 * float(H.diagonal().abs().max())
            nu = 2.0
        d = -torch.linalg.solve(H + lam * torch.eye(6, dtype=H.dtype, device=H.device), b)
        delta = G.se3_exp(d)
        T_new = delta @ T
        cost_new = _cost(T_new, idx, M, src, tgt)
        accept = bool(cost_new < cost) and bool(torch.isfinite(cost_new))
        denom = float((d * (lam * d - b)).sum())
        rho = float(cost - cost_new) / (denom if abs(denom) >= 1e-30 else 1e-30)
        if accept:
            lam, nu, T = lam * max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0), 2.0, T_new
        else:
            lam, nu = lam * nu, 2.0 * nu
        if (float((2.0 * (delta[:3, :3] - eye3)).abs().max()) < eps
                and float(delta[:3, 3].abs().max()) < eps):
            converged = True
            break
    return T, converged


class Frames:
    """The reference's prepared clouds of a course's scans, made once each."""

    def __init__(self, scans, pf: dict, reg: dict, capacity: int, device):
        self.scans, self.pf, self.reg, self.capacity, self.device = scans, pf, reg, capacity, device
        self._points: dict = {}
        self._gicp: dict = {}

    def points(self, i: int) -> torch.Tensor:
        if i not in self._points:
            self._points[i] = prefilter(self.scans[i], self.pf, self.capacity, self.device)
        return self._points[i]

    def gicp(self, i: int) -> GicpCloud:
        if i not in self._gicp:
            self._gicp[i] = covariances(self.points(i), self.reg["reg_correspondence_randomness"])
        return self._gicp[i]


def align_frame(frames: Frames, target: int, source: int, guess: np.ndarray):
    """(relative pose float64 (4, 4), converged) of scan ``source`` matched
    onto scan ``target`` from ``guess``."""
    g = torch.as_tensor(guess, dtype=torch.float32, device=frames.device)
    T, ok = gicp_align(frames.gicp(target), frames.gicp(source), g, frames.reg)
    return T.double().cpu().numpy(), ok
