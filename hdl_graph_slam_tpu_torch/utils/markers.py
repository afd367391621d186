"""Graph visualization export (a copy of hdl_graph_slam_tpu/utils/markers.py).

Equivalent of HdlGraphSlamNodelet::create_marker_array
(apps/hdl_graph_slam_nodelet.cpp:619-809), which publishes rviz markers:
node spheres colored by age, odometry/loop edges colored by type, the loop
detection radius. Without ROS, the same content is exported as structured
JSON (for any viewer) and PLY line/point sets (viewable in CloudCompare /
MeshLab / Open3D).
"""

from __future__ import annotations

import json

import numpy as np


def graph_summary(slam) -> dict:
    """Structured graph content: nodes (with age colors), edges by type."""
    nodes = []
    n = len(slam.keyframes)
    for i, kf in enumerate(slam.keyframes):
        p = slam.graph.poses[kf.node_id][:3, 3]
        nodes.append(
            {
                "id": kf.node_id,
                "stamp": kf.stamp,
                "position": [float(v) for v in p],
                "age_ratio": i / max(1, n - 1),  # the reference's color key
                "accum_distance": kf.accum_distance,
            }
        )
    edges = {}
    for etype, rows in slam.graph.edge_rows.items():
        if not rows:
            continue
        edges[etype] = [
            {"vi": r["vi"], "vj": r["vj"], "kernel": int(r["kernel_id"])} for r in rows
        ]
    out = {
        "nodes": nodes,
        "edges": edges,
        "loop_detection_radius": slam.loop_detector.cfg.distance_thresh,
        "num_vertices": slam.graph.num_vertices,
        "num_edges": slam.graph.num_edges,
    }
    if slam.floor_plane_node_id is not None:
        out["floor_plane"] = [float(v) for v in slam.graph.planes[slam.floor_plane_node_id]]
    return out


def save_graph_json(slam, path: str) -> None:
    with open(path, "w") as f:
        json.dump(graph_summary(slam), f, indent=1)


def save_graph_ply(slam, path: str) -> None:
    """Nodes as colored vertices + odometry/loop edges as PLY edge list."""
    kfs = slam.keyframes
    n = len(kfs)
    if n == 0:
        return
    node_index = {kf.node_id: i for i, kf in enumerate(kfs)}
    positions = np.stack([slam.graph.poses[kf.node_id][:3, 3] for kf in kfs])
    colors = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        t = i / max(1, n - 1)
        colors[i] = [int(255 * t), 0, int(255 * (1 - t))]  # age gradient

    edge_list = []
    for etype in ("se3_se3",):
        for r in slam.graph.edge_rows[etype]:
            if r["vi"] in node_index and r["vj"] in node_index:
                edge_list.append((node_index[r["vi"]], node_index[r["vj"]]))

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {len(edge_list)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p, c in zip(positions, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        for a, b in edge_list:
            f.write(f"{a} {b}\n")
