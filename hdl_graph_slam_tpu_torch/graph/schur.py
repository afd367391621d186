"""Schur-complement elimination of the landmark (plane / point) vertices
(port of hdl_graph_slam_tpu/graph/schur.py).

g2o's BlockSolver marginalizes landmark vertices before the pose solve
(GraphSLAM::optimize, src/hdl_graph_slam/graph_slam.cpp:28-30). With the
state layout [poses 6Np | planes 3Nl | points 3Nm] (graph/linearize.py) the
damped system A = H + lam diag partitions as

    [App Apl] [dxp]   [-bp]
    [Alp All] [dxl] = [-bl]

where All is block-diagonal (3x3 per landmark) when no landmark-landmark
edge exists, as in every graph HdlGraphSlam builds (landmarks touch only
poses). Then

    S = App - Apl All^-1 Alp,   S dxp = -(bp - Apl All^-1 bl),
    dxl = -All^-1 (bl + Alp dxp),

with All^-1 a batched closed-form 3x3 inverse, and the dense solve shrinks
from (6Np + 3NL)^3 to (6Np)^3. Plane-plane edges (plane_identity /
plane_parallel / plane_perpendicular) break the block diagonal:
graph/solver.py refuses "schur" for such graphs.
"""

from __future__ import annotations

import torch

from .types import GraphData

# edge types whose two endpoints are landmarks (All is then not block-diagonal)
LANDMARK_COUPLING_EDGES = ("plane_identity", "plane_parallel", "plane_perpendicular")


def has_landmark_coupling(data: GraphData) -> bool:
    """Whether any landmark-landmark edge table is allocated (a shape-level
    check, as the JAX package's)."""
    return any(data.edges.get(k) is not None and data.edges[k].vi.shape[0] > 0 for k in LANDMARK_COUPLING_EDGES)


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant), |det|
    clamped at 1e-30 (the float64 solve's; gicp._inv3x3 clamps at 1e-20)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1e-30, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def solve_schur(A: torch.Tensor, b: torch.Tensor, n_pose_dof: int) -> torch.Tensor:
    """Solve A dx = -b by eliminating the trailing landmark block.

    ``A`` is already damped and free-dof masked (a unit diagonal on fixed
    dofs, as graph/solver.py makes it), with the landmark dofs after the
    first ``n_pose_dof`` rows and a block-diagonal landmark-landmark part."""
    P = n_pose_dof
    L = A.shape[0] - P
    if L == 0:
        return -torch.linalg.solve_ex(A, b)[0]
    nL = L // 3
    App, Apl = A[:P, :P], A[:P, P:]
    bp, bl = b[:P], b[P:]
    blk = A[P:, P:].reshape(nL, 3, nL, 3)
    ar = torch.arange(nL, device=A.device)
    binv = _inv3x3(blk[ar, :, ar, :])  # (nL, 3, 3) diagonal blocks of All, inverted
    W = torch.einsum("pkj,kji->pki", Apl.reshape(P, nL, 3), binv).reshape(P, L)  # Apl All^-1
    S = App - W @ Apl.T  # Alp = Apl^T (A symmetric)
    dxp = -torch.linalg.solve_ex(S, bp - W @ bl)[0]
    dxl = -torch.einsum("kij,kj->ki", binv, (bl + Apl.T @ dxp).reshape(nL, 3)).reshape(L)
    return torch.cat([dxp, dxl])
