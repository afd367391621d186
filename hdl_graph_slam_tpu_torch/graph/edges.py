"""Residual functions for every edge type of the graph
(port of hdl_graph_slam_tpu/graph/edges.py).

Each maps (vertex estimates..., measurement) -> residual and reproduces the
corresponding g2o computeError. Every function is batched over leading
dimensions (chi2 scoring calls them on whole edge tables) and is also
evaluated per edge under torch.func.vmap / jacfwd for the Jacobians, so none
uses in-place writes or reads a value back to the host.

Vertex conventions: an SE3 vertex is a 4x4 matrix with the g2o MQT local
increment (se3.se3_oplus); a plane vertex is 4 coeffs (n, c), distance = -c,
with plane.oplus as its increment.
"""

from __future__ import annotations

import torch

from ..core import plane as planelib
from ..core import se3


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _rt_vec(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v for the rotation block of T."""
    return (T[..., :3, :3] * v[..., :, None]).sum(-2)


def se3_se3(T1, T2, meas):
    """g2o EdgeSE3 (types/slam3d/edge_se3.cpp): toVectorMQT(meas^-1 T1^-1 T2),
    wired with meas = curr.odom^-1 prev.odom and vertices (curr, prev)
    (apps/hdl_graph_slam_nodelet.cpp:234-236, 568-570)."""
    delta = se3.compose(se3.inverse(meas), se3.compose(se3.inverse(T1), T2))
    return se3.mqt_log(delta)


def se3_plane(T, plane_coeffs, meas_coeffs):
    """EdgeSE3Plane (include/g2o/edge_se3_plane.hpp:40-47):
    (T^-1 plane_w).ominus(measured local plane), pole-safe variant."""
    local = planelib.transform(se3.inverse(T), plane_coeffs)
    return planelib.ominus_safe(local, meas_coeffs)


def se3_prior_xy(T, meas_xy):
    """EdgeSE3PriorXY (edge_se3_priorxy.hpp:39-44): t.xy - meas."""
    return T[..., :2, 3] - meas_xy


def se3_prior_xyz(T, meas_xyz):
    """EdgeSE3PriorXYZ (edge_se3_priorxyz.hpp:39-44): t - meas."""
    return T[..., :3, 3] - meas_xyz


def se3_prior_vec(T, meas6):
    """EdgeSE3PriorVec (edge_se3_priorvec.hpp:39-53): R^-1 direction -
    measurement, meas6 = [direction(3), measurement(3)], both normalized."""
    return _rt_vec(T, meas6[..., :3]) - meas6[..., 3:]


def se3_prior_quat(T, meas_q_wxyz):
    """EdgeSE3PriorQuat (edge_se3_priorquat.hpp:39-48): sign-align the
    estimate's quaternion to the measurement, est.vec - meas.vec."""
    q = se3.quat_from_mat(T[..., :3, :3])
    q = torch.where((_dot(q, meas_q_wxyz) < 0.0)[..., None], -q, q)
    return q[..., 1:] - meas_q_wxyz[..., 1:]


def plane_prior_normal(plane_coeffs, meas_n):
    """EdgePlanePriorNormal (edge_plane_prior.hpp:40-49)."""
    n = planelib.normal(plane_coeffs)
    n = torch.where((_dot(n, meas_n) < 0.0)[..., None], -n, n)
    return n - meas_n


def plane_prior_distance(plane_coeffs, meas_d):
    """EdgePlanePriorDistance (edge_plane_prior.hpp:80-83): meas - distance."""
    return (meas_d - planelib.distance(plane_coeffs))[..., None]


def plane_identity(p1, p2, meas4):
    """EdgePlaneIdentity (edge_plane_identity.hpp:47-59): flip p2 if
    opposing, (p2 - p1) - meas on the raw 4-vectors."""
    p2 = torch.where((_dot(p1, p2) < 0.0)[..., None], -p2, p2)
    return (p2 - p1) - meas4


def plane_parallel(p1, p2, meas3):
    """EdgePlaneParallel (edge_plane_parallel.hpp:44-56)."""
    n1 = planelib.normal(p1)
    n2 = planelib.normal(p2)
    n2 = torch.where((_dot(n1, n2) < 0.0)[..., None], -n2, n2)
    return (n2 - n1) - meas3


def plane_perpendicular(p1, p2):
    """EdgePlanePerpendicular (edge_plane_parallel.hpp:106-114): n1 . n2 of
    the normalized normals (1 dof; the measurement is unused)."""
    n1 = planelib.normal(p1)
    n2 = planelib.normal(p2)
    n1 = n1 / torch.linalg.norm(n1, dim=-1, keepdim=True)
    n2 = n2 / torch.linalg.norm(n2, dim=-1, keepdim=True)
    return _dot(n1, n2)[..., None]


def se3_point_xyz(T, point, meas3):
    """g2o EdgeSE3PointXYZ without the sensor offset (the reference never
    sets one): T^-1 point - meas."""
    return _rt_vec(T, point - T[..., :3, 3]) - meas3
