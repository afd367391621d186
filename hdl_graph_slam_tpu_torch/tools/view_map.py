"""Offline map/trajectory/graph viewer — the rviz config's role
(rviz/hdl_graph_slam.rviz: map_points + markers + odom displays) without a
ROS GUI: renders a top-down (and optional side) view of the map cloud, the
optimized trajectory, and graph edges to a PNG. A copy of
hdl_graph_slam_tpu/tools/view_map.py; matplotlib is imported only inside
render().

Usage:
    python -m hdl_graph_slam_tpu_torch.tools.view_map \
        --map map.pcd --traj traj.txt --graph graph.json --out view.png

Inputs are exactly what run.py writes (--out-map / --out-traj /
--out-graph-json), so `run.py ... && view_map ...` replaces the reference's
`roslaunch + rviz` loop for offline work.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def render(
    map_xyz=None,
    traj=None,
    graph=None,
    out: str = "view.png",
    max_points: int = 400_000,
    side: bool = False,
):
    """Render to ``out``. map_xyz (N,3); traj [(stamp, 4x4)]; graph = the
    utils/markers.py save_graph_json dict (nodes + edges)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nrows = 2 if side else 1
    fig, axes = plt.subplots(nrows, 1, figsize=(12, 12 if side else 10), squeeze=False)
    ax = axes[0][0]

    if map_xyz is not None and len(map_xyz):
        pts = np.asarray(map_xyz)
        if pts.shape[0] > max_points:
            pts = pts[np.random.default_rng(0).choice(pts.shape[0], max_points, replace=False)]
        # color by height — the rviz AXIS_COLOR map_points display analog
        ax.scatter(pts[:, 0], pts[:, 1], c=pts[:, 2], s=0.2, cmap="viridis", linewidths=0)
    if graph is not None:
        # utils/markers.py graph_summary schema: nodes[{id, position, ...}],
        # edges{etype: [{vi, vj, kernel}]}. Only se3 edges are drawn: the
        # other families (se3_plane, priors, ...) reference vertex ids in
        # their own per-kind id spaces (plane/point indices), which do not
        # resolve against the keyframe node list.
        nodes = {n["id"]: n for n in graph.get("nodes", [])}
        for e in graph.get("edges", {}).get("se3", []):
            a, b = nodes.get(e.get("vi")), nodes.get(e.get("vj"))
            if not (a and b):
                continue
            # consecutive keyframes = odometry; an id jump = loop closure
            loop = abs(e["vi"] - e["vj"]) > 1
            color, lw, z = ("red", 1.4, 3) if loop else ("0.4", 0.6, 2)
            ax.plot([a["position"][0], b["position"][0]],
                    [a["position"][1], b["position"][1]],
                    color=color, linewidth=lw, zorder=z)
    if traj:
        T = np.asarray([p for _, p in traj])
        ax.plot(T[:, 0, 3], T[:, 1, 3], "-", color="black", linewidth=1.5, zorder=4)
        ax.plot(T[0, 0, 3], T[0, 1, 3], "go", zorder=5, label="start")
        ax.plot(T[-1, 0, 3], T[-1, 1, 3], "rs", zorder=5, label="end")
        ax.legend(loc="upper right")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title("map (top-down)")

    if side:
        ax2 = axes[1][0]
        if map_xyz is not None and len(map_xyz):
            ax2.scatter(pts[:, 0], pts[:, 2], c=pts[:, 2], s=0.2, cmap="viridis", linewidths=0)
        if traj:
            ax2.plot(T[:, 0, 3], T[:, 2, 3], "-", color="black", linewidth=1.5)
        ax2.set_xlabel("x [m]")
        ax2.set_ylabel("z [m]")
        ax2.set_title("side (x-z)")

    fig.tight_layout()
    fig.savefig(out, dpi=130)
    plt.close(fig)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", help="map PCD (run.py --out-map)")
    ap.add_argument("--traj", help="TUM trajectory (run.py --out-traj)")
    ap.add_argument("--graph", help="graph JSON (run.py --out-graph-json)")
    ap.add_argument("--out", default="view.png")
    ap.add_argument("--side", action="store_true", help="add an x-z side view")
    ap.add_argument("--max-points", type=int, default=400_000)
    args = ap.parse_args(argv)

    map_xyz = traj = graph = None
    if args.map:
        from ..io.pcd import load_pcd

        map_xyz, _ = load_pcd(args.map)
    if args.traj:
        from ..io.trajectory import load_tum

        traj = load_tum(args.traj)
    if args.graph:
        with open(args.graph) as f:
            graph = json.load(f)
    if map_xyz is None and traj is None and graph is None:
        ap.error("nothing to render: pass --map / --traj / --graph")
    out = render(map_xyz, traj, graph, out=args.out, side=args.side, max_points=args.max_points)
    print(json.dumps({"written": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
