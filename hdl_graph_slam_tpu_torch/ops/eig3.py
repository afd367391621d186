"""Closed-form symmetric 3x3 eigen-decomposition, branch-free and batched
(port of hdl_graph_slam_tpu/ops/eig3.py).

The trigonometric closed form (Smith 1961) serves the covariance shaping
GICP and NDT need (plane regularization, eigenvalue floors) without a batched
iterative eigh.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-20


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending. Trigonometric form."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=_EPS) / 6.0)

    # det((A - qI)/p) / 2
    b00, b11, b22 = d0 / p, d1 / p, d2 / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    # near-isotropic matrices (p2 ~ 0): all eigenvalues = q
    iso = p2 < 1e-18
    lam_min = torch.where(iso, q, lam_min)
    lam_mid = torch.where(iso, q, lam_mid)
    lam_max = torch.where(iso, q, lam_max)
    return torch.stack([lam_min, lam_mid, lam_max], dim=-1)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric (...,3,3) for eigenvalue lam (...,): the null
    direction of (A - lam I), as the largest cross product of its rows."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (n02 >= n01) & ~best12
    v = torch.where(best12[..., None], c12, torch.where(best02[..., None], c02, c01))
    v = v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=_EPS))
    # degenerate (repeated eigenvalue): any unit vector of the eigenspace
    # serves the regularization use cases; fall back to +z
    degen = torch.maximum(torch.maximum(n01, n02), n12) < 1e-24
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(degen[..., None], fallback, v)


def smallest_eigenvector3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalue, unit eigenvector) of the smallest eigenpair."""
    lam = eigvalsh3(A)[..., 0]
    return lam, _eigvec_for(A, lam)


def plane_regularize(covs: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """fast_gicp RegularizationMethod::PLANE without a full eigh:
    eigenvalues -> (eps, 1, 1) == I - (1 - eps) v_min v_min^T."""
    _, v = smallest_eigenvector3(covs)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    return eye - (1.0 - eps) * v[..., :, None] * v[..., None, :]


def floor_regularize(covs: torch.Tensor, rel_floor: float = 0.01, rel_guard: float = 1e-3) -> torch.Tensor:
    """PCL NDT cell conditioning: floor eigenvalues at rel_floor * lam_max,
    C + sum_i max(0, floor - lam_i) v_i v_i^T over the two smaller pairs.

    rel_guard adds rel_guard * lam_max * I. For a near-rank-1 cell (a ground
    ring-arc is a line of points) the closed-form f32 eigenvectors are
    noise-dominated and the rank-2 correction alone can leave a negative
    eigenvalue; the guard, 10x below the PCL floor, keeps the result PD by
    construction."""
    lams = eigvalsh3(covs)
    lam_min, lam_mid, lam_max = lams[..., 0], lams[..., 1], lams[..., 2]
    floor = rel_floor * lam_max
    v_min = _eigvec_for(covs, lam_min)
    v_mid = _eigvec_for(covs, lam_mid)
    # orthogonalize v_mid against v_min (repeated-eigenvalue robustness)
    v_mid = v_mid - (v_mid * v_min).sum(-1, keepdim=True) * v_min
    v_mid = v_mid / torch.sqrt(torch.clamp((v_mid * v_mid).sum(-1, keepdim=True), min=_EPS))
    add_min = torch.clamp(floor - lam_min, min=0.0)
    add_mid = torch.clamp(floor - lam_mid, min=0.0)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    return (
        covs
        + add_min[..., None, None] * v_min[..., :, None] * v_min[..., None, :]
        + add_mid[..., None, None] * v_mid[..., :, None] * v_mid[..., None, :]
        + (rel_guard * lam_max)[..., None, None] * eye
    )
