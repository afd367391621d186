"""Trajectory export (TUM/KITTI formats) and ATE/RPE evaluation.

The reference validates by visual inspection against golden bags (SURVEY.md
§4, §6); this module adds the quantitative evaluation BASELINE.md requires:
absolute trajectory error after Umeyama alignment and relative pose error,
following the standard TUM evaluation definitions.

A copy of hdl_graph_slam_tpu/io/trajectory.py (numpy only): the port
never imports the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def save_tum(path: str, traj: Sequence[Tuple[float, np.ndarray]]) -> None:
    """TUM format: stamp tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for stamp, T in traj:
            t = T[:3, 3]
            q = _quat_wxyz(T[:3, :3])
            f.write(
                f"{stamp:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def load_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        stamp, tx, ty, tz, qx, qy, qz, qw = vals[:8]
        T = np.eye(4)
        T[:3, :3] = _mat_from_quat_wxyz(np.array([qw, qx, qy, qz]))
        T[:3, 3] = [tx, ty, tz]
        out.append((stamp, T))
    return out


def save_kitti(path: str, traj: Sequence[Tuple[float, np.ndarray]]) -> None:
    """KITTI format: 12 row-major values of the 3x4 pose per line."""
    with open(path, "w") as f:
        for _, T in traj:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n")


def umeyama_align(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Rigid SE(3) (no scale) aligning est positions onto ref: (N,3)x2 -> (4,4)."""
    mu_e = est.mean(0)
    mu_r = ref.mean(0)
    S = (est - mu_e).T @ (ref - mu_r) / est.shape[0]
    U, _, Vt = np.linalg.svd(S)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_r - R @ mu_e
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def ate_rmse(est_traj, ref_traj, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of positions) with time association."""
    est_p, ref_p = _associate_positions(est_traj, ref_traj)
    if est_p.shape[0] < 2:
        return float("nan")
    if align:
        T = umeyama_align(est_p, ref_p)
        est_p = est_p @ T[:3, :3].T + T[:3, 3]
    return float(np.sqrt(np.mean(np.sum((est_p - ref_p) ** 2, axis=1))))


def rpe_rmse(est_traj, ref_traj, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over ``delta``-frame intervals:
    (translation RMSE [m], rotation RMSE [rad])."""
    est, ref = _associate_poses(est_traj, ref_traj)
    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dr = np.linalg.inv(ref[i]) @ ref[i + delta]
        e = np.linalg.inv(dr) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        tr = np.clip((np.trace(e[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        rerrs.append(np.arccos(tr))
    if not terrs:
        return float("nan"), float("nan")
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))


def _associate_positions(est_traj, ref_traj, max_dt: float = 0.05):
    est, ref = _associate(est_traj, ref_traj, max_dt)
    return (
        np.array([T[:3, 3] for _, T in est]).reshape(-1, 3),
        np.array([T[:3, 3] for _, T in ref]).reshape(-1, 3),
    )


def _associate_poses(est_traj, ref_traj, max_dt: float = 0.05):
    est, ref = _associate(est_traj, ref_traj, max_dt)
    return [T for _, T in est], [T for _, T in ref]


def _associate(est_traj, ref_traj, max_dt):
    ref_stamps = np.array([s for s, _ in ref_traj])
    est_out, ref_out = [], []
    for s, T in est_traj:
        if len(ref_stamps) == 0:
            break
        j = int(np.argmin(np.abs(ref_stamps - s)))
        if abs(ref_stamps[j] - s) <= max_dt:
            est_out.append((s, T))
            ref_out.append(ref_traj[j])
    return est_out, ref_out


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    tr = np.trace(R)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2.0
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
        q = np.zeros(4)
        q[1 + i] = s / 4.0
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _mat_from_quat_wxyz(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
