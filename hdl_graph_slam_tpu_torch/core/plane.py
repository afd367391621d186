"""g2o Plane3D-compatible plane math (port of hdl_graph_slam_tpu/core/plane.py).

Reproduces the minimal parameterization g2o uses for VertexPlane
(g2o/types/slam3d_addons/plane3d.h semantics), which the reference relies on
via EdgeSE3Plane (include/g2o/edge_se3_plane.hpp:40-47) and the floor
constraint wiring (apps/hdl_graph_slam_nodelet.cpp:490-500).

A plane is stored as 4 coefficients (nx, ny, nz, c) with |n| = 1 after
normalization; g2o defines distance() = -c. Every function is batched over
leading dimensions and stays differentiable in forward mode (the graph's
Jacobians are torch.func.jacfwd of these at a zero increment).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def normalize(coeffs: torch.Tensor) -> torch.Tensor:
    """Scale so the normal has unit length (g2o Plane3D::normalize)."""
    n = torch.linalg.norm(coeffs[..., :3], dim=-1, keepdim=True)
    return coeffs / torch.clamp(n, min=_EPS)


def normal(coeffs: torch.Tensor) -> torch.Tensor:
    return coeffs[..., :3]


def distance(coeffs: torch.Tensor) -> torch.Tensor:
    """g2o Plane3D::distance() == -coeffs[3]."""
    return -coeffs[..., 3]


def azimuth(v: torch.Tensor) -> torch.Tensor:
    return torch.atan2(v[..., 1], v[..., 0])


def elevation(v: torch.Tensor) -> torch.Tensor:
    return torch.atan2(v[..., 2], torch.linalg.norm(v[..., :2], dim=-1))


def rotation_of_normal(v: torch.Tensor) -> torch.Tensor:
    """g2o Plane3D::rotation(v): Rz(azimuth) * Ry(-elevation); maps the
    x-axis onto the (normalized) direction v."""
    az = azimuth(v)
    el = elevation(v)
    ca, sa = torch.cos(az), torch.sin(az)
    ce, se = torch.cos(el), torch.sin(el)
    row0 = torch.stack([ca * ce, -sa, -ca * se], dim=-1)
    row1 = torch.stack([sa * ce, ca, -sa * se], dim=-1)
    row2 = torch.stack([se, torch.zeros_like(ca), ce], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (R * v[..., None, :]).sum(-1)


def ominus(coeffs_self: torch.Tensor, coeffs_other: torch.Tensor) -> torch.Tensor:
    """g2o Plane3D::ominus(other): [azimuth(n), elevation(n), self.d - other.d]
    with n = rotation(self.normal)^T other.normal."""
    R = rotation_of_normal(normal(coeffs_self)).transpose(-1, -2)
    n = _matvec(R, normal(coeffs_other))
    d = distance(coeffs_self) - distance(coeffs_other)
    return torch.stack([azimuth(n), elevation(n), d], dim=-1)


def ominus_safe(coeffs_self: torch.Tensor, coeffs_other: torch.Tensor) -> torch.Tensor:
    """Pole-safe ominus with identical chi2 and first-order behaviour: the
    frame comes from *other* (the measurement, constant under
    differentiation), so the Jacobian stays finite at vertical normals (the
    floor-plane case, where g2o's own form is singular)."""
    R = rotation_of_normal(normal(coeffs_other)).transpose(-1, -2)
    u = _matvec(R, normal(coeffs_self))
    d = distance(coeffs_self) - distance(coeffs_other)
    return torch.stack([-azimuth(u), -elevation_from_x(u), d], dim=-1)


def elevation_from_x(v: torch.Tensor) -> torch.Tensor:
    """Elevation of a vector known to be near +x: atan2(z, |xy|)."""
    return torch.atan2(v[..., 2], torch.linalg.norm(v[..., :2], dim=-1))


def oplus(coeffs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """g2o Plane3D::oplus(v): minimal update [d_azimuth, d_elevation, d_dist]."""
    az = v[..., 0]
    el = v[..., 1]
    ce, se = torch.cos(el), torch.sin(el)
    n_local = torch.stack([ce * torch.cos(az), ce * torch.sin(az), se], dim=-1)
    R = rotation_of_normal(normal(coeffs))
    n_new = _matvec(R, n_local)
    d_new = distance(coeffs) + v[..., 2]
    return normalize(torch.cat([n_new, -d_new[..., None]], dim=-1))


def transform(T: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """g2o operator*(Isometry3, Plane3D): rotate the normal, shift the offset."""
    n2 = _matvec(T[..., :3, :3], coeffs[..., :3])
    c2 = coeffs[..., 3] - (T[..., :3, 3] * n2).sum(-1)
    return normalize(torch.cat([n2, c2[..., None]], dim=-1))
