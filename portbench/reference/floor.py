"""Plain PyTorch reference of the floor detector (hdl_graph_slam's
FloorDetectionNodelet with PCL's RANSAC plane model).

The prefiltered cloud is clipped to the height band around the ground
(sensor height +- the clip range, no tilt), kept where the k = 10 PCA
normal is within the normal threshold of vertical, then planes through
random point triplets are scored by their inliers; the first plane with
the most inliers wins, unrefined, as PCL returns it. The triplets are drawn
as the system under test draws them: a generator on the device seeded 0,
one (hypotheses, 3) draw over [0, capacity) per detection that reaches the
sampling, taken modulo the point count.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import tf32_round as R
from .odometry import knn, smallest_eigenvectors


def floor_points(xyz: torch.Tensor, fl: dict) -> torch.Tensor:
    """The points of the height band whose normals are near vertical, in
    their order in ``xyz``."""
    h, r = fl["sensor_height"], fl["height_clip_range"]
    band = xyz[(xyz[:, 2] + (h + r) > 0) & ~(xyz[:, 2] + (h - r) > 0)]
    if not fl["use_normal_filtering"] or band.shape[0] < 3:
        return band
    nb = band[knn(band, min(10, band.shape[0]))]
    cen = nb - nb.mean(1, keepdim=True)
    normal = smallest_eigenvectors(torch.einsum("nki,nkj->nij", R(cen), R(cen)) / nb.shape[1])
    keep = normal[:, 2].abs() > math.cos(math.radians(fl["normal_filter_thresh"]))
    return band[keep]


def inliers(points: torch.Tensor, plane: torch.Tensor, thresh: float) -> int:
    """Points within ``thresh`` of the plane n.p + d = 0, in float64."""
    p = plane.double()
    return int(((points.double() @ p[:3] + p[3]).abs() < thresh).sum())


def detect(xyz: torch.Tensor, fl: dict, capacity: int, draw):
    """(coefficients float64 (4,) or None, the band's points) of one cloud;
    ``draw()`` gives the (hypotheses, 3) triplets over [0, capacity), called
    only when the band holds enough points."""
    pts = floor_points(xyz, fl)
    n = pts.shape[0]
    if n < fl["floor_pts_thresh"]:
        return None, pts
    tri = draw() % n
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    normal = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.clamp(norm, min=1e-12)
    d = -(normal * p0).sum(-1)
    counts = ((R(pts) @ R(normal).T + d[None, :]).abs() < fl["ransac_distance_thresh"]).sum(0)
    counts = torch.where(norm[:, 0] < 1e-8, -1, counts)
    best = int(torch.argmax(counts))
    if int(counts[best]) < fl["floor_pts_thresh"]:
        return None, pts
    coeffs = torch.cat([normal[best], d[best][None]]).double().cpu().numpy()
    if abs(coeffs[2]) < math.cos(math.radians(fl["floor_normal_thresh"])):
        return None, pts
    return (-coeffs if coeffs[2] < 0 else coeffs), pts


def triplet_drawer(fl: dict, capacity: int, device):
    """A detector's triplet draws, one (hypotheses, 3) draw a call, from a
    generator on ``device`` seeded 0."""
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return lambda: torch.randint(0, capacity, (fl["ransac_hypotheses"], 3), generator=g, device=device)


def shortfall(pts: torch.Tensor, ref: Optional[np.ndarray], got: Optional[np.ndarray], thresh: float) -> float:
    """How many fewer of the band's points the judged plane ``got`` holds
    than the reference's plane ``ref``, as a share of the reference's; 1
    when only one of them found a floor, 0 when neither did."""
    if ref is None or got is None:
        return 0.0 if ref is None and got is None else 1.0
    dev = pts.device
    best = inliers(pts, torch.as_tensor(ref, device=dev), thresh)
    held = inliers(pts, torch.as_tensor(got, device=dev), thresh)
    return max(0.0, (best - held) / max(best, 1))
