"""Pose-graph storage: struct-of-arrays edge tables and the host-side builder
(port of hdl_graph_slam_tpu/graph/types.py).

Replaces g2o's pointer graph (GraphSLAM facade, src/hdl_graph_slam/
graph_slam.cpp) with dense integer-indexed tables: one table per edge type,
each padded to a capacity bucket as in the JAX package (the same padding, so
the two optimisers see the same shapes). Vertex ids are dense sequential ints
per kind. GraphBuilder is numpy and mirrors the GraphSLAM add_*_node /
add_*_edge API (graph_slam.hpp:44-116); ``freeze`` moves it to tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .robust import KERNEL_IDS

# edge-type registry: (vertex kinds, measurement shape, residual dim)
EDGE_SPECS = {
    "se3_se3": (("pose", "pose"), (4, 4), 6),
    "se3_plane": (("pose", "plane"), (4,), 3),
    "se3_prior_xy": (("pose",), (2,), 2),
    "se3_prior_xyz": (("pose",), (3,), 3),
    "se3_prior_vec": (("pose",), (6,), 3),
    "se3_prior_quat": (("pose",), (4,), 3),
    "plane_prior_normal": (("plane",), (3,), 3),
    "plane_prior_distance": (("plane",), (), 1),
    "plane_identity": (("plane", "plane"), (4,), 4),
    "plane_parallel": (("plane", "plane"), (3,), 3),
    "plane_perpendicular": (("plane", "plane"), (3,), 1),
    "se3_point_xyz": (("pose", "point"), (3,), 3),
}

VERTEX_DOF = {"pose": 6, "plane": 3, "point": 3}


@dataclasses.dataclass(frozen=True)
class EdgeTable:
    vi: torch.Tensor  # (E,) int64 first-vertex index (within its kind)
    vj: torch.Tensor  # (E,) int64 second-vertex index (0 for unary edges)
    meas: torch.Tensor  # (E, *meas_shape)
    info: torch.Tensor  # (E, d, d) information matrix
    kernel_id: torch.Tensor  # (E,) int64 robust-kernel id
    kernel_delta: torch.Tensor  # (E,) kernel size
    mask: torch.Tensor  # (E,) bool


@dataclasses.dataclass(frozen=True)
class GraphData:
    poses: torch.Tensor  # (Np, 4, 4)
    pose_fixed: torch.Tensor  # (Np,) bool
    pose_mask: torch.Tensor  # (Np,) bool (allocated vertices)
    planes: torch.Tensor  # (Nl, 4)
    plane_fixed: torch.Tensor
    plane_mask: torch.Tensor
    points: torch.Tensor  # (Nm, 3)
    point_fixed: torch.Tensor
    point_mask: torch.Tensor
    edges: Dict[str, EdgeTable]  # keyed by EDGE_SPECS name

    @property
    def num_dof(self) -> int:
        return 6 * self.poses.shape[0] + 3 * self.planes.shape[0] + 3 * self.points.shape[0]

    def replace(self, **changes) -> "GraphData":
        return dataclasses.replace(self, **changes)


def _bucket(n: int, quantum: int = 64) -> int:
    if n == 0:
        return 0
    b = quantum
    while b < n:
        b *= 2
    return b


class GraphBuilder:
    """Host-side accretion of vertices and edges (numpy), frozen on demand.

    API parity with hdl_graph_slam::GraphSLAM (graph_slam.hpp:44-116); ids
    are plain ints per vertex kind.
    """

    def __init__(self):
        self.poses: List[np.ndarray] = []
        self.pose_fixed: List[bool] = []
        self.planes: List[np.ndarray] = []
        self.plane_fixed: List[bool] = []
        self.points: List[np.ndarray] = []
        self.point_fixed: List[bool] = []
        self.edge_rows: Dict[str, List[dict]] = {k: [] for k in EDGE_SPECS}

    # -- nodes (graph_slam.cpp:107-132) -------------------------------------

    def add_se3_node(self, pose: np.ndarray, fixed: bool = False) -> int:
        self.poses.append(np.asarray(pose, dtype=np.float64).reshape(4, 4))
        self.pose_fixed.append(fixed)
        return len(self.poses) - 1

    def add_plane_node(self, coeffs: np.ndarray, fixed: bool = False) -> int:
        c = np.asarray(coeffs, dtype=np.float64).reshape(4)
        n = np.linalg.norm(c[:3])
        self.planes.append(c / max(n, 1e-12))
        self.plane_fixed.append(fixed)
        return len(self.planes) - 1

    def add_point_xyz_node(self, xyz: np.ndarray, fixed: bool = False) -> int:
        self.points.append(np.asarray(xyz, dtype=np.float64).reshape(3))
        self.point_fixed.append(fixed)
        return len(self.points) - 1

    def set_pose_fixed(self, idx: int, fixed: bool = True):
        self.pose_fixed[idx] = fixed

    def set_plane_fixed(self, idx: int, fixed: bool = True):
        self.plane_fixed[idx] = fixed

    # -- edges (graph_slam.cpp:134-273) -------------------------------------

    def _add_edge(self, etype: str, vi: int, vj: int, meas, info, kernel="NONE", kernel_delta=1.0) -> int:
        kinds, mshape, rdim = EDGE_SPECS[etype]
        info = np.asarray(info, dtype=np.float64)
        if info.ndim == 0:
            info = np.eye(rdim) * float(info)
        self.edge_rows[etype].append(
            dict(
                vi=vi,
                vj=vj,
                meas=np.asarray(meas, dtype=np.float64).reshape(mshape),
                info=info.reshape(rdim, rdim),
                kernel_id=KERNEL_IDS[kernel],
                kernel_delta=float(kernel_delta),
            )
        )
        return len(self.edge_rows[etype]) - 1

    def add_se3_edge(self, vi, vj, relative_pose, info, **kw) -> int:
        return self._add_edge("se3_se3", vi, vj, relative_pose, info, **kw)

    def add_se3_plane_edge(self, pose_id, plane_id, plane_coeffs, info, **kw) -> int:
        return self._add_edge("se3_plane", pose_id, plane_id, plane_coeffs, info, **kw)

    def add_se3_prior_xy_edge(self, pose_id, xy, info, **kw) -> int:
        return self._add_edge("se3_prior_xy", pose_id, 0, xy, info, **kw)

    def add_se3_prior_xyz_edge(self, pose_id, xyz, info, **kw) -> int:
        return self._add_edge("se3_prior_xyz", pose_id, 0, xyz, info, **kw)

    def add_se3_prior_vec_edge(self, pose_id, direction, measurement, info, **kw) -> int:
        d = np.asarray(direction, dtype=np.float64)
        m = np.asarray(measurement, dtype=np.float64)
        # g2o setMeasurement normalizes both halves (edge_se3_priorvec.hpp:56-59)
        meas6 = np.concatenate([d / np.linalg.norm(d), m / np.linalg.norm(m)])
        return self._add_edge("se3_prior_vec", pose_id, 0, meas6, info, **kw)

    def add_se3_prior_quat_edge(self, pose_id, quat_wxyz, info, **kw) -> int:
        q = np.asarray(quat_wxyz, dtype=np.float64).reshape(4)
        if q[0] < 0:
            q = -q  # g2o setMeasurement sign normalization
        return self._add_edge("se3_prior_quat", pose_id, 0, q, info, **kw)

    def add_plane_normal_prior_edge(self, plane_id, normal, info, **kw) -> int:
        return self._add_edge("plane_prior_normal", plane_id, 0, normal, info, **kw)

    def add_plane_distance_prior_edge(self, plane_id, distance, info, **kw) -> int:
        return self._add_edge("plane_prior_distance", plane_id, 0, distance, info, **kw)

    def add_plane_identity_edge(self, p1, p2, meas, info, **kw) -> int:
        return self._add_edge("plane_identity", p1, p2, meas, info, **kw)

    def add_plane_parallel_edge(self, p1, p2, meas, info, **kw) -> int:
        return self._add_edge("plane_parallel", p1, p2, meas, info, **kw)

    def add_plane_perpendicular_edge(self, p1, p2, info, **kw) -> int:
        return self._add_edge("plane_perpendicular", p1, p2, np.zeros(3), info, **kw)

    def add_se3_point_xyz_edge(self, pose_id, point_id, xyz, info, **kw) -> int:
        return self._add_edge("se3_point_xyz", pose_id, point_id, xyz, info, **kw)

    # -- stats ----------------------------------------------------------------

    @property
    def num_vertices(self) -> int:
        return len(self.poses) + len(self.planes) + len(self.points)

    @property
    def num_edges(self) -> int:
        return sum(len(v) for v in self.edge_rows.values())

    # -- freeze / thaw --------------------------------------------------------

    def freeze_numpy(self) -> Dict[str, np.ndarray]:
        """The padded graph as numpy arrays (float64), keyed as
        ``state.graph_data_from_numpy`` reads them."""
        npose = _bucket(len(self.poses), 16)
        nplane = _bucket(len(self.planes), 4)
        npoint = _bucket(len(self.points), 4)

        poses = np.tile(np.eye(4), (npose, 1, 1))
        if self.poses:
            poses[: len(self.poses)] = np.stack(self.poses)
        planes = np.tile(np.array([0.0, 0.0, 1.0, 0.0]), (nplane, 1))
        if self.planes:
            planes[: len(self.planes)] = np.stack(self.planes)
        points = np.zeros((npoint, 3))
        if self.points:
            points[: len(self.points)] = np.stack(self.points)

        def mask_pad(flags, n):
            m = np.zeros(n, dtype=bool)
            m[: len(flags)] = True
            f = np.zeros(n, dtype=bool)
            f[: len(flags)] = np.asarray(flags, dtype=bool)
            return m, f

        out = dict(poses=poses, planes=planes, points=points)
        for kind, flags, n in (("pose", self.pose_fixed, npose), ("plane", self.plane_fixed, nplane),
                               ("point", self.point_fixed, npoint)):
            out[f"{kind}_mask"], out[f"{kind}_fixed"] = mask_pad(flags, n)

        for etype, rows in self.edge_rows.items():
            _, mshape, rdim = EDGE_SPECS[etype]
            cap = _bucket(len(rows), 64)
            meas = np.zeros((cap,) + mshape)
            if etype == "se3_se3":
                meas[:] = np.eye(4)
            table = dict(vi=np.zeros(cap, dtype=np.int32), vj=np.zeros(cap, dtype=np.int32), meas=meas,
                         info=np.zeros((cap, rdim, rdim)), kernel_id=np.zeros(cap, dtype=np.int32),
                         kernel_delta=np.ones(cap), mask=np.zeros(cap, dtype=bool))
            for i, r in enumerate(rows):
                for key in ("vi", "vj", "meas", "info", "kernel_id", "kernel_delta"):
                    table[key][i] = r[key]
                table["mask"][i] = True
            for key, value in table.items():
                out[f"{etype}.{key}"] = value
        return out

    def freeze(self, dtype=torch.float64, device=None) -> GraphData:
        """Pad everything to capacity buckets and move to tensors on
        ``device`` (None = cuda)."""
        from ..state import graph_data_from_numpy

        return graph_data_from_numpy(self.freeze_numpy(), dtype=dtype, device=device)

    def update_estimates(self, data: GraphData) -> None:
        """Write optimized vertex estimates back into the builder (one copy
        to the host for all vertex kinds)."""
        flat = torch.cat([data.poses.reshape(-1), data.planes.reshape(-1), data.points.reshape(-1)])
        flat = flat.cpu().numpy().astype(np.float64)
        n_pose, n_plane = data.poses.numel(), data.planes.numel()
        poses = flat[:n_pose].reshape(-1, 4, 4)
        planes = flat[n_pose:n_pose + n_plane].reshape(-1, 4)
        points = flat[n_pose + n_plane:].reshape(-1, 3)
        for i in range(len(self.poses)):
            self.poses[i] = poses[i]
        for i in range(len(self.planes)):
            self.planes[i] = planes[i]
        for i in range(len(self.points)):
            self.points[i] = points[i]
