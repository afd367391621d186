"""SE(3)/SO(3) manifold operations on tensors (port of hdl_graph_slam_tpu/core/se3.py).

Conventions follow g2o's ``slam3d`` types:

- Poses are 4x4 homogeneous matrices.
- The minimal 6-dof increment is ``[dx dy dz qx qy qz]`` (translation then the
  vector part of a unit quaternion), applied by right multiplication:
  ``T <- T * mqt_exp(delta)`` (g2o VertexSE3::oplusImpl).

Every function is batched over leading dimensions and works in the dtype it
is given. Pose products are true fp32: the package turns TF32 off.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build a 4x4 SE(3) matrix from a 3x3 rotation and 3-translation."""
    T = torch.zeros((4, 4), dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    T[3, 3] = 1.0
    return T


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def _assemble(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) homogeneous matrix."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., :, None]], dim=-1), bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of an SE(3) matrix (batched ok)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])[..., 0]
    return _assemble(Rt, ti)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """SE(3) product (true fp32: TF32 is off package-wide)."""
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) to points of shape (..., 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with Taylor fallback near zero. (...,3)->(...,3,3)."""
    theta2 = (w * w).sum(-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3): (...,3,3)->(...,3). Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    # vee of the antisymmetric part
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1
    )
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-4
    # generic: theta / (2 sin theta) * v
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(sin_theta.abs() < _EPS, 1.0, sin_theta)),
    )
    w_generic = scale[..., None] * v
    # near pi: magnitudes from the diagonal extraction
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), min=0.0))
    # Relative signs from the off-diagonal sums R[i,j]+R[j,i] = 2 a_i a_j
    # (1-cos), which stay O(1) at theta == pi; anchored on the largest axis
    # component, whose absolute sign comes from the vee part.
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    P = (R + R.transpose(-1, -2)) * (1.0 - eye3) + eye3
    k = torch.argmax(axis, dim=-1)
    anchor_col = torch.gather(P, -1, k[..., None, None].expand(P.shape[:-1] + (1,)))[..., 0]
    rel_sign = torch.where(anchor_col < 0, -1.0, 1.0)
    v_anchor = torch.gather(v, -1, k[..., None])[..., 0]
    overall = torch.where(v_anchor < 0, -1.0, 1.0)
    w_pi = axis * rel_sign * overall[..., None] * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map of se(3) twist [v, w] (...,6) -> (...,4,4)."""
    v = xi[..., :3]
    w = xi[..., 3:]
    theta2 = (w * w).sum(-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2_safe)
    W = hat(w)
    WW = W @ W
    eye = _eye3_like(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    t = (V @ v[..., :, None])[..., 0]
    return _assemble(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map of SE(3): (...,4,4) -> (...,6) twist [v, w]."""
    w = so3_log(T[..., :3, :3])
    theta2 = (w * w).sum(-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / theta2_safe)
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z), branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 0.5
    s0 = 0.25 / qw0
    c0 = torch.stack([qw0, (m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0], dim=-1)

    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 0.5
    s1 = 0.25 / qx1
    c1 = torch.stack([(m21 - m12) * s1, qx1, (m01 + m10) * s1, (m02 + m20) * s1], dim=-1)

    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 0.5
    s2 = 0.25 / qy2
    c2 = torch.stack([(m02 - m20) * s2, (m01 + m10) * s2, qy2, (m12 + m21) * s2], dim=-1)

    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 0.5
    s3 = 0.25 / qz3
    c3 = torch.stack([(m10 - m01) * s3, (m02 + m20) * s3, (m12 + m21) * s3, qz3], dim=-1)

    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(
        cond0[..., None], c0, torch.where(cond1[..., None], c1, torch.where(cond2[..., None], c2, c3))
    )
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """The rotation angle of a rotation matrix (keyframe_updater.hpp:46)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def acos_qw_angle(R: torch.Tensor) -> torch.Tensor:
    """acos(q.w), the reference odometry threshold angle
    (scan_matching_odometry_nodelet.cpp:229,244). Half the rotation angle."""
    return torch.arccos(torch.clamp(quat_from_mat(R)[..., 0], -1.0, 1.0))


def mqt_exp(delta: torch.Tensor) -> torch.Tensor:
    """g2o internal::fromVectorMQT: [t(3), qvec(3)] -> SE(3); |qvec| > 1 is
    normalized as g2o does."""
    t = delta[..., :3]
    v = delta[..., 3:]
    n2 = (v * v).sum(-1)
    over = n2 > 1.0
    w = torch.sqrt(torch.clamp(1.0 - n2, min=0.0))
    q = torch.cat([w[..., None], v], dim=-1)
    qn = torch.cat([torch.zeros_like(w[..., None]), v / torch.sqrt(n2 + _EPS)[..., None]], dim=-1)
    q = torch.where(over[..., None], qn, q)
    return _assemble(mat_from_quat(q), t)


def mqt_log(T: torch.Tensor) -> torch.Tensor:
    """g2o internal::toVectorMQT: SE(3) -> [t(3), qvec(3)] with q.w >= 0."""
    q = quat_from_mat(T[..., :3, :3])
    sign = torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    return torch.cat([T[..., :3, 3], sign * q[..., 1:]], dim=-1)


def se3_oplus(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """g2o VertexSE3 oplus: right-multiply by the MQT increment."""
    return compose(T, mqt_exp(delta))


def project_so3(T: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """Pull the rotation block back onto SO(3) with Newton-Schulz polar
    iterations R <- R(1.5 I - 0.5 R^T R), so per-frame rotation error cannot
    accumulate along a multi-hundred-frame pose chain."""
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    for _ in range(steps):
        R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    return torch.cat([torch.cat([R, T[..., :3, 3:4]], dim=-1), T[..., 3:4, :]], dim=-2)
