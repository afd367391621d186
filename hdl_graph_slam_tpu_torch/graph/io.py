"""Graph persistence: .g2o text format + robust-kernel sidecar
(port of hdl_graph_slam_tpu/graph/io.py).

Equivalent of g2o::SparseOptimizer::save/load (GraphSLAM::save/load,
src/hdl_graph_slam/graph_slam.cpp:323-349) and the robust-kernel sidecar
(src/g2o/robust_kernel_io.cpp:45-154). Tag names match the reference's
G2O_REGISTER_TYPE table (graph_slam.cpp:33-42, including its
EDGE_PLANE_PAERPENDICULAR typo) so files cross-load against a real g2o
build of the reference.

Vertex ids are globalized the way g2o files expect (one id space): poses
first, then planes, then points, preserving insertion order.

The quaternions go through the port's core/se3.py in float64 on the CPU (the
same branch-free Shepperd form as the JAX package's), so both packages write
the same text for the same graph and read each other's files.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core import se3
from .robust import KERNEL_IDS, KERNEL_NAMES
from .types import GraphBuilder

_EDGE_TAGS = {
    "se3_se3": "EDGE_SE3:QUAT",
    "se3_plane": "EDGE_SE3_PLANE",
    "se3_prior_xy": "EDGE_SE3_PRIORXY",
    "se3_prior_xyz": "EDGE_SE3_PRIORXYZ",
    "se3_prior_vec": "EDGE_SE3_PRIORVEC",
    "se3_prior_quat": "EDGE_SE3_PRIORQUAT",
    "plane_prior_normal": "EDGE_PLANE_PRIOR_NORMAL",
    "plane_prior_distance": "EDGE_PLANE_PRIOR_DISTANCE",
    "plane_identity": "EDGE_PLANE_IDENTITY",
    "plane_parallel": "EDGE_PLANE_PARALLEL",
    "plane_perpendicular": "EDGE_PLANE_PAERPENDICULAR",  # sic (reference typo)
    "se3_point_xyz": "EDGE_SE3_TRACKXYZ",
}
_TAG_TO_TYPE = {v: k for k, v in _EDGE_TAGS.items()}

_UNARY = {"se3_prior_xy", "se3_prior_xyz", "se3_prior_vec", "se3_prior_quat",
          "plane_prior_normal", "plane_prior_distance"}

# vertex kinds per edge type (order = g2o vertices() order)
_EDGE_KINDS = {
    "se3_se3": ("pose", "pose"),
    "se3_plane": ("pose", "plane"),
    "plane_identity": ("plane", "plane"),
    "plane_parallel": ("plane", "plane"),
    "plane_perpendicular": ("plane", "plane"),
    "se3_point_xyz": ("pose", "point"),
    "se3_prior_xy": ("pose",),
    "se3_prior_xyz": ("pose",),
    "se3_prior_vec": ("pose",),
    "se3_prior_quat": ("pose",),
    "plane_prior_normal": ("plane",),
    "plane_prior_distance": ("plane",),
}


def _quat_xyzw_from_mat(R):
    q = se3.quat_from_mat(torch.as_tensor(np.asarray(R), dtype=torch.float64)).numpy()
    return [q[1], q[2], q[3], q[0]]


def _mat_from_quat_wxyz(q) -> np.ndarray:
    return se3.mat_from_quat(torch.tensor(q, dtype=torch.float64)).numpy()


def _upper_triangular(info: np.ndarray) -> List[float]:
    d = info.shape[0]
    return [info[i, j] for i in range(d) for j in range(i, d)]


def save_g2o(builder: GraphBuilder, path: str) -> None:
    pose_base = 0
    plane_base = len(builder.poses)
    point_base = plane_base + len(builder.planes)

    lines = []
    for i, T in enumerate(builder.poses):
        t = T[:3, 3]
        q = _quat_xyzw_from_mat(T[:3, :3])
        lines.append(
            f"VERTEX_SE3:QUAT {pose_base + i} "
            + " ".join(f"{v:.9g}" for v in [*t, *q])
        )
        if builder.pose_fixed[i]:
            lines.append(f"FIX {pose_base + i}")
    for i, c in enumerate(builder.planes):
        lines.append(f"VERTEX_PLANE {plane_base + i} " + " ".join(f"{v:.9g}" for v in c))
        if builder.plane_fixed[i]:
            lines.append(f"FIX {plane_base + i}")
    for i, p in enumerate(builder.points):
        lines.append(f"VERTEX_TRACKXYZ {point_base + i} " + " ".join(f"{v:.9g}" for v in p))
        if builder.point_fixed[i]:
            lines.append(f"FIX {point_base + i}")

    kernel_lines = []
    for etype, rows in builder.edge_rows.items():
        tag = _EDGE_TAGS[etype]
        kinds = _EDGE_KINDS[etype]
        base = {"pose": pose_base, "plane": plane_base, "point": point_base}
        for r in rows:
            ids = [base[kinds[0]] + r["vi"]]
            if len(kinds) == 2:
                ids.append(base[kinds[1]] + r["vj"])
            meas = np.asarray(r["meas"])
            if etype == "se3_se3":
                t = meas[:3, 3]
                q = _quat_xyzw_from_mat(meas[:3, :3])
                mvals = [*t, *q]
            elif etype == "se3_prior_quat":
                # g2o write order: w x y z (edge_se3_priorquat.hpp:64)
                mvals = list(meas)
            elif etype == "plane_prior_distance":
                mvals = [float(meas)]
            else:
                mvals = list(np.atleast_1d(meas).reshape(-1))
            ivals = _upper_triangular(np.asarray(r["info"]))
            lines.append(
                f"{tag} " + " ".join(str(i) for i in ids) + " "
                + " ".join(f"{v:.9g}" for v in mvals) + " "
                + " ".join(f"{v:.9g}" for v in ivals)
            )
            if r["kernel_id"] != 0:
                # reference robust_kernel_io format (robust_kernel_io.cpp:66-71):
                # <num_vertices> <id0> [<id1>] <KernelType> <delta>
                kernel_lines.append(
                    f"{len(ids)} " + " ".join(str(i) for i in ids)
                    + f" {KERNEL_NAMES[r['kernel_id']]} {r['kernel_delta']:.9g}"
                )

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path + ".kernels", "w") as f:
        f.write("\n".join(kernel_lines) + ("\n" if kernel_lines else ""))


def load_g2o(path: str) -> GraphBuilder:
    """Rebuild a GraphBuilder from a .g2o file written by save_g2o.

    Vertex kind is inferred from the tag; global ids are mapped back to
    per-kind indices by first recording every vertex line.
    """
    g = GraphBuilder()
    id_map: Dict[int, tuple] = {}  # global id -> (kind, local index)
    fixed_ids = []
    edge_lines = []

    for line in open(path):
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "VERTEX_SE3:QUAT":
            gid = int(parts[1])
            tx, ty, tz, qx, qy, qz, qw = [float(v) for v in parts[2:9]]
            R = _mat_from_quat_wxyz([qw, qx, qy, qz])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            id_map[gid] = ("pose", g.add_se3_node(T))
        elif tag == "VERTEX_PLANE":
            gid = int(parts[1])
            id_map[gid] = ("plane", g.add_plane_node([float(v) for v in parts[2:6]]))
        elif tag == "VERTEX_TRACKXYZ":
            gid = int(parts[1])
            id_map[gid] = ("point", g.add_point_xyz_node([float(v) for v in parts[2:5]]))
        elif tag == "FIX":
            fixed_ids.append(int(parts[1]))
        elif tag in _TAG_TO_TYPE:
            edge_lines.append(parts)

    for gid in fixed_ids:
        kind, idx = id_map[gid]
        if kind == "pose":
            g.set_pose_fixed(idx)
        elif kind == "plane":
            g.set_plane_fixed(idx)
        else:
            g.point_fixed[idx] = True

    def info_from(vals, d):
        info = np.zeros((d, d))
        k = 0
        for i in range(d):
            for j in range(i, d):
                info[i, j] = info[j, i] = vals[k]
                k += 1
        return info

    for parts in edge_lines:
        etype = _TAG_TO_TYPE[parts[0]]
        unary = etype in _UNARY
        n_ids = 1 if unary else 2
        ids = [id_map[int(v)][1] for v in parts[1 : 1 + n_ids]]
        vals = [float(v) for v in parts[1 + n_ids :]]
        if etype == "se3_se3":
            tx, ty, tz, qx, qy, qz, qw = vals[:7]
            R = _mat_from_quat_wxyz([qw, qx, qy, qz])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            g.add_se3_edge(ids[0], ids[1], T, info_from(vals[7:], 6))
        elif etype == "se3_plane":
            g.add_se3_plane_edge(ids[0], ids[1], vals[:4], info_from(vals[4:], 3))
        elif etype == "se3_prior_xy":
            g.add_se3_prior_xy_edge(ids[0], vals[:2], info_from(vals[2:], 2))
        elif etype == "se3_prior_xyz":
            g.add_se3_prior_xyz_edge(ids[0], vals[:3], info_from(vals[3:], 3))
        elif etype == "se3_prior_vec":
            g.add_se3_prior_vec_edge(ids[0], vals[:3], vals[3:6], info_from(vals[6:], 3))
        elif etype == "se3_prior_quat":
            g.add_se3_prior_quat_edge(ids[0], vals[:4], info_from(vals[4:], 3))
        elif etype == "plane_prior_normal":
            g.add_plane_normal_prior_edge(ids[0], vals[:3], info_from(vals[3:], 3))
        elif etype == "plane_prior_distance":
            g.add_plane_distance_prior_edge(ids[0], vals[0], info_from(vals[1:], 1))
        elif etype == "plane_identity":
            g.add_plane_identity_edge(ids[0], ids[1], vals[:4], info_from(vals[4:], 4))
        elif etype == "plane_parallel":
            g.add_plane_parallel_edge(ids[0], ids[1], vals[:3], info_from(vals[3:], 3))
        elif etype == "plane_perpendicular":
            g.add_plane_perpendicular_edge(ids[0], ids[1], info_from(vals[3:], 1))
        elif etype == "se3_point_xyz":
            g.add_se3_point_xyz_edge(ids[0], ids[1], vals[:3], info_from(vals[3:], 3))

    # robust-kernel sidecar
    import os

    kpath = path + ".kernels"
    if os.path.exists(kpath):
        # reference format (robust_kernel_io.cpp:66-71, KernelData::match):
        # "<num_vertices> <global_id...> <KernelType> <delta>"; kernels attach
        # to every edge whose global vertex-id tuple matches.
        inv_id = {v: k for k, v in id_map.items()}  # (kind, local) -> global
        rows_by_gids: Dict[tuple, list] = {}
        for etype, rows in g.edge_rows.items():
            kinds = _EDGE_KINDS[etype]
            for r in rows:
                local = (r["vi"],) if len(kinds) == 1 else (r["vi"], r["vj"])
                gids = tuple(inv_id[(k, i)] for k, i in zip(kinds, local))
                rows_by_gids.setdefault(gids, []).append(r)
        for line in open(kpath):
            parts = line.split()
            if not parts:
                continue
            n = int(parts[0])
            gids = tuple(int(v) for v in parts[1 : 1 + n])
            name, delta = parts[1 + n], float(parts[2 + n])
            for r in rows_by_gids.get(gids, []):
                r["kernel_id"] = KERNEL_IDS[name]
                r["kernel_delta"] = delta
    return g
