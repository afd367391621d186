"""Plain PyTorch reference of the pose graph hdl_graph_slam optimizes.

Keyframe pose nodes; an SE(3) edge between consecutive keyframes whose
measurement is their relative odometry and whose information comes from
the fitness score of the two keyframe clouds (the saturating exponential of
hdl_graph_slam's InformationMatrixCalculator); an SE(3) loop edge, under a
Huber kernel, where a loop closed; an SE(3)-to-plane edge from
each keyframe with a detected floor to the fixed plane z = 0, information
I / floor_edge_stddev. The error vectors are g2o's: the MQT vector of
meas^-1 T_i^-1 T_j, and the observed plane's ominus the measured one.

``solve`` is Levenberg-Marquardt on those errors with increments
right-multiplied onto each pose (T exp(d) in g2o's MQT form), the Jacobian
of the whitened errors by forward-mode differentiation, and a dense damped
solve. Started from the poses under judgement, it moves them by as much as
they miss its optimum; the objective leaves a global motion in the plane
free, and the solve moves no pose along it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from . import geometry as G
from .odometry import nn1


@dataclasses.dataclass
class Graph:
    poses: torch.Tensor  # (K, 4, 4) the start of the solve
    odom: List[Tuple[int, int, np.ndarray, np.ndarray]]  # (i, j, meas 4x4, info 6x6)
    floors: List[Tuple[int, np.ndarray, np.ndarray]]  # (i, coeffs (4,), info 3x3)
    loops: List[Tuple[int, int, np.ndarray, np.ndarray]] = dataclasses.field(default_factory=list)
    loop_huber: float = 1.0  # the loop edges' Huber kernel width


def fitness(target: torch.Tensor, source: torch.Tensor, rel: np.ndarray) -> float:
    """Mean squared distance from each source point, moved by ``rel``, to
    its nearest target point."""
    T = torch.as_tensor(rel, dtype=source.dtype, device=source.device)
    moved = source @ T[:3, :3].T + T[:3, 3]
    _, d2 = nn1(moved, target)
    return float(d2.double().mean())


def information(score: float, inf: dict) -> np.ndarray:
    """InformationMatrixCalculator: a translation and a rotation variance,
    each min + (max - min) (1 - e^{-a x}) / (1 - e^{-a x_max})."""
    out = np.eye(6)
    if inf["use_const_inf_matrix"]:
        out[:3, :3] /= inf["const_stddev_x"]
        out[3:, 3:] /= inf["const_stddev_q"]
        return out
    a, x_max = inf["var_gain_a"], inf["fitness_score_thresh"]
    y = (1.0 - np.exp(-a * score)) / (1.0 - np.exp(-a * x_max))
    wx = inf["min_stddev_x"] ** 2 + (inf["max_stddev_x"] ** 2 - inf["min_stddev_x"] ** 2) * y
    wq = inf["min_stddev_q"] ** 2 + (inf["max_stddev_q"] ** 2 - inf["min_stddev_q"] ** 2) * y
    out[:3, :3] /= wx
    out[3:, 3:] /= wq
    return out


def project_rotation(T: np.ndarray) -> np.ndarray:
    """The nearest rotation (polar decomposition) in the rotation block."""
    T = np.asarray(T, dtype=np.float64).copy()
    U, _, Vt = np.linalg.svd(T[:3, :3])
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    T[:3, :3] = R
    return T


def _tables(g: Graph, dtype, device):
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    se3 = g.odom + g.loops
    oi = torch.tensor([e[0] for e in se3], dtype=torch.long, device=device)
    oj = torch.tensor([e[1] for e in se3], dtype=torch.long, device=device)
    om = t(np.stack([e[2] for e in se3])) if se3 else None
    ow = t(np.stack([np.linalg.cholesky(e[3]).T for e in se3])) if se3 else None
    fi = torch.tensor([e[0] for e in g.floors], dtype=torch.long, device=device)
    fm = t(np.stack([e[1] for e in g.floors])) if g.floors else None
    fw = t(np.stack([np.linalg.cholesky(e[2]).T for e in g.floors])) if g.floors else None
    return oi, oj, om, ow, fi, fm, fw


def solve(g: Graph, dtype=torch.float64, max_iterations: int = 200) -> torch.Tensor:
    """The poses (K, 4, 4) of the LM solve from ``g.poses``, in ``dtype``."""
    device = g.poses.device
    oi, oj, om, ow, fi, fm, fw = _tables(g, dtype, device)
    plane = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device)
    K = g.poses.shape[0]

    def residuals(poses, d):
        P = poses @ G.mqt_exp(d.reshape(K, 6))
        parts = []
        if om is not None:
            e = G.mqt_log(G.inverse(om) @ G.inverse(P[oi]) @ P[oj])
            parts.append((ow @ e[..., None])[..., 0].reshape(-1))
        if fm is not None:
            e = G.plane_error(G.plane_in_frame(P[fi], plane.expand(fi.shape[0], 4)), fm)
            parts.append((fw @ e[..., None])[..., 0].reshape(-1))
        return torch.cat(parts)

    # the loop edges' rows: 6 each, after the odometry edges'
    first_loop, n_loops = 6 * len(g.odom), len(g.loops)
    delta2 = g.loop_huber ** 2

    def robust(r):
        """(chi2 under the kernels, the rows' IRLS scale sqrt(rho'))."""
        scale = torch.ones_like(r)
        if not n_loops:
            return float((r * r).sum()), scale
        e2 = (r[first_loop:first_loop + 6 * n_loops].reshape(n_loops, 6) ** 2).sum(-1)
        out = e2 > delta2
        rho = torch.where(out, 2.0 * torch.sqrt(e2) * g.loop_huber - delta2, e2)
        w = torch.where(out, g.loop_huber / torch.sqrt(torch.clamp(e2, min=1e-30)), torch.ones_like(e2))
        scale[first_loop:first_loop + 6 * n_loops] = torch.sqrt(w).repeat_interleave(6)
        chi2 = float((r * r).sum() - (r[first_loop:first_loop + 6 * n_loops] ** 2).sum() + rho.sum())
        return chi2, scale

    poses = g.poses.to(dtype)
    zero = torch.zeros(6 * K, dtype=dtype, device=device)
    r = residuals(poses, zero)
    chi2, scale = robust(r)
    lam = None
    nu = 2.0
    eye = torch.eye(6 * K, dtype=dtype, device=device)
    for _ in range(max_iterations):
        J = torch.func.jacfwd(lambda d: residuals(poses, d))(zero) * scale[:, None]
        H, b = J.T @ J, J.T @ (r * scale)
        if lam is None:
            lam = 1e-5 * float(H.diagonal().max())
        dx = -torch.linalg.solve(H + lam * eye, b)
        trial = poses @ G.mqt_exp(dx.reshape(K, 6))
        r_new = residuals(trial, zero)
        chi2_new, scale_new = robust(r_new)
        if chi2_new < chi2 and np.isfinite(chi2_new):
            denom = float(dx @ (lam * dx - b))
            rho = (chi2 - chi2_new) / (denom if abs(denom) > 1e-30 else 1e-30)
            lam *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            poses, r, chi2, scale = trial, r_new, chi2_new, scale_new
            if float(dx.abs().max()) < 1e-10:
                break
        else:
            lam *= nu
            nu *= 2.0
            if lam > 1e30:
                break
    return poses


def move(judged: torch.Tensor, g: Graph, lever_m: float) -> float:
    """How far the reference's float64 solve from the judged poses moves
    them: the largest pose gap (|t| + lever * angle) over the keyframes."""
    start = dataclasses.replace(g, poses=judged.double())
    return float(G.pose_gap(start.poses, solve(start), lever_m).max())
