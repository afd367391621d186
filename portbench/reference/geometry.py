"""Rigid-motion and plane arithmetic of the plain reference.

Written from the published definitions the SLAM system follows: Rodrigues'
exponential on se(3), g2o's MQT vector of an SE(3) (translation and the
quaternion's vector part, w >= 0) and its inverse, g2o's Plane3D ``ominus``
(here in the pole-safe frame of the measured plane), the quaternion of a
rotation by Shepperd's method. Every function is batched over leading
dimensions and runs in whatever dtype it is given.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def assemble(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return assemble(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """exp of the twist [v, w] (..., 6), with Taylor terms near zero."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / th2s)
    W = hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    return assemble(R, (V @ v[..., :, None])[..., 0])


def project_so3(T: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz polar step on the rotation block, R (1.5 I - 0.5 R^T R)."""
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    return assemble(R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R)), T[..., :3, 3])


def quat_wxyz(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) of rotation matrices, Shepperd's branches."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = []
    for diag, s_idx in ((1.0 + tr, 0), (1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2], 1),
                        (1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2], 2),
                        (1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2], 3)):
        big = torch.sqrt(torch.clamp(diag, min=_EPS)) * 0.5
        s = 0.25 / big
        if s_idx == 0:
            q = [big, (m[..., 2, 1] - m[..., 1, 2]) * s, (m[..., 0, 2] - m[..., 2, 0]) * s, (m[..., 1, 0] - m[..., 0, 1]) * s]
        elif s_idx == 1:
            q = [(m[..., 2, 1] - m[..., 1, 2]) * s, big, (m[..., 0, 1] + m[..., 1, 0]) * s, (m[..., 0, 2] + m[..., 2, 0]) * s]
        elif s_idx == 2:
            q = [(m[..., 0, 2] - m[..., 2, 0]) * s, (m[..., 0, 1] + m[..., 1, 0]) * s, big, (m[..., 1, 2] + m[..., 2, 1]) * s]
        else:
            q = [(m[..., 1, 0] - m[..., 0, 1]) * s, (m[..., 0, 2] + m[..., 2, 0]) * s, (m[..., 1, 2] + m[..., 2, 1]) * s, big]
        cands.append(torch.stack(q, -1))
    c1 = (m[..., 0, 0] > m[..., 1, 1]) & (m[..., 0, 0] > m[..., 2, 2])
    c2 = m[..., 1, 1] > m[..., 2, 2]
    q = torch.where((tr > 0)[..., None], cands[0],
                    torch.where(c1[..., None], cands[1], torch.where(c2[..., None], cands[2], cands[3])))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def half_angle(R: torch.Tensor) -> torch.Tensor:
    """acos(q.w): the odometry's keyframe angle (half the rotation angle)."""
    return torch.arccos(torch.clamp(quat_wxyz(R)[..., 0], -1.0, 1.0))


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """The rotation angle of R, in [0, pi], as atan2(sin, cos): the sine from
    the antisymmetric part, so that a rotation block a rounding away from
    orthonormal reads no angle where arccos of the trace would read ~1e-4."""
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    return torch.atan2(0.5 * torch.linalg.norm(v, dim=-1), c)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def mqt_log(T: torch.Tensor) -> torch.Tensor:
    """g2o toVectorMQT: [t, q.xyz] with q.w >= 0."""
    q = quat_wxyz(T[..., :3, :3])
    q = torch.where(q[..., :1] < 0, -q, q)
    return torch.cat([T[..., :3, 3], q[..., 1:]], -1)


def mqt_exp(d: torch.Tensor) -> torch.Tensor:
    """g2o fromVectorMQT for increments with |q.xyz| <= 1."""
    v = d[..., 3:]
    w = torch.sqrt(torch.clamp(1.0 - (v * v).sum(-1), min=0.0))
    return assemble(mat_from_quat(torch.cat([w[..., None], v], -1)), d[..., :3])


def _azimuth(v):
    return torch.atan2(v[..., 1], v[..., 0])


def _elevation(v):
    return torch.atan2(v[..., 2], torch.linalg.norm(v[..., :2], dim=-1))


def _plane_frame(n: torch.Tensor) -> torch.Tensor:
    """g2o Plane3D::rotation: Rz(azimuth) Ry(-elevation), x onto n."""
    az, el = _azimuth(n), _elevation(n)
    ca, sa, ce, se = torch.cos(az), torch.sin(az), torch.cos(el), torch.sin(el)
    z = torch.zeros_like(ca)
    return torch.stack([torch.stack([ca * ce, -sa, -ca * se], -1),
                        torch.stack([sa * ce, ca, -sa * se], -1),
                        torch.stack([se, z, ce], -1)], -2)


def plane_in_frame(T: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """The world plane (n, c) seen from the pose T: (T^-1) * plane, normalized."""
    Ti = inverse(T)
    n = (Ti[..., :3, :3] @ plane[..., :3, None])[..., 0]
    c = plane[..., 3] - (Ti[..., :3, 3] * n).sum(-1)
    out = torch.cat([n, c[..., None]], -1)
    return out / torch.linalg.norm(out[..., :3], dim=-1, keepdim=True)


def plane_error(local: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """g2o EdgeSE3Plane's error, local.ominus(meas), taken in the measured
    plane's frame: [-azimuth(u), -elevation(u), d_local - d_meas] with
    u = frame(meas)^T n_local and d = -c."""
    u = (_plane_frame(meas[..., :3]).transpose(-1, -2) @ local[..., :3, None])[..., 0]
    return torch.stack([-_azimuth(u), -_elevation(u), meas[..., 3] - local[..., 3]], -1)


def pose_gap(A: torch.Tensor, B: torch.Tensor, lever_m: float) -> torch.Tensor:
    """|t| + lever_m * angle of A^-1 B: how far a point lever_m from the
    sensor moves between the two poses, at most."""
    D = inverse(A) @ B
    return torch.linalg.norm(D[..., :3, 3], dim=-1) + lever_m * rotation_angle(D[..., :3, :3])
