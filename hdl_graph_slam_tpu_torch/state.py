"""Carrying state across frameworks as numpy arrays.

The system has no weights; its state is the odometry state and the pose
graph.

- Odometry: the keyframe target GicpCloud (xyz (N,3), mask (N,), covs
  (N,3,3)), keyframe_pose, prev_trans and prev_delta (each 4x4) and
  keyframe_stamp. Its numpy form is a flat dict with the keys of
  ``STATE_KEYS``, which the JAX package's OdomState fills field for field
  (tgt.xyz -> "tgt_xyz", ...).
- The frozen pose graph (graph.types.GraphData): a flat dict with the
  vertex fields under their own names ("poses", "pose_fixed", ...) and each
  edge table's fields under "<edge type>.<field>" ("se3_se3.vi", ...). The
  JAX package's GraphBuilder.freeze output fills it field for field; the
  port's GraphBuilder.freeze_numpy makes the same dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.device import resolve_device
from .frontend.odometry_device import OdomState
from .graph.types import EDGE_SPECS, EdgeTable, GraphData
from .registration.gicp import GicpCloud

STATE_KEYS = ("tgt_xyz", "tgt_mask", "tgt_covs", "keyframe_pose", "prev_trans", "keyframe_stamp", "prev_delta")
GRAPH_VERTEX_KEYS = ("poses", "pose_fixed", "pose_mask", "planes", "plane_fixed", "plane_mask",
                     "points", "point_fixed", "point_mask")
EDGE_KEYS = ("vi", "vj", "meas", "info", "kernel_id", "kernel_delta", "mask")
_FLOAT_KEYS = ("poses", "planes", "points", "meas", "info", "kernel_delta")


def graph_data_from_numpy(arrays: Dict[str, np.ndarray], dtype=torch.float64, device=None) -> GraphData:
    """The port's GraphData on ``device`` (None = cuda) from its numpy form:
    float fields in ``dtype``, indices int64, masks bool."""
    dev = resolve_device(device)
    edge_keys = [f"{e}.{k}" for e in EDGE_SPECS for k in EDGE_KEYS]
    missing = [k for k in GRAPH_VERTEX_KEYS + tuple(edge_keys) if k not in arrays]
    if missing:
        raise KeyError(f"graph_data_from_numpy: missing {missing}")

    def tensor(key, field):
        a = np.asarray(arrays[key])
        if field in _FLOAT_KEYS:
            return torch.from_numpy(np.array(a, dtype=np.float64)).to(device=dev, dtype=dtype)
        if field in ("vi", "vj", "kernel_id"):
            return torch.from_numpy(np.array(a, dtype=np.int64)).to(dev)
        return torch.from_numpy(np.array(a, dtype=bool)).to(dev)

    edges = {e: EdgeTable(**{k: tensor(f"{e}.{k}", k) for k in EDGE_KEYS}) for e in EDGE_SPECS}
    return GraphData(**{k: tensor(k, k) for k in GRAPH_VERTEX_KEYS}, edges=edges)


def graph_data_to_numpy(data: GraphData) -> Dict[str, np.ndarray]:
    """The numpy form of a GraphData (the inverse of graph_data_from_numpy)."""
    out = {k: getattr(data, k).cpu().numpy() for k in GRAPH_VERTEX_KEYS}
    for e, table in data.edges.items():
        for k in EDGE_KEYS:
            out[f"{e}.{k}"] = getattr(table, k).cpu().numpy()
    return out


def odom_state_from_numpy(arrays: Dict[str, np.ndarray], device) -> OdomState:
    """The port's OdomState on ``device`` from its numpy form (float32, mask bool)."""
    missing = [k for k in STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"odom_state_from_numpy: missing {missing}")

    def f32(key):
        return torch.from_numpy(np.array(arrays[key], dtype=np.float32)).to(device)

    return OdomState(
        tgt=GicpCloud(
            xyz=f32("tgt_xyz"),
            mask=torch.from_numpy(np.array(arrays["tgt_mask"], dtype=bool)).to(device),
            covs=f32("tgt_covs"),
        ),
        keyframe_pose=f32("keyframe_pose"),
        prev_trans=f32("prev_trans"),
        keyframe_stamp=f32("keyframe_stamp").reshape(()),
        prev_delta=f32("prev_delta"),
    )


def odom_state_to_numpy(state: OdomState) -> Dict[str, np.ndarray]:
    """The numpy form of an OdomState (the inverse of odom_state_from_numpy)."""
    return {
        "tgt_xyz": state.tgt.xyz.cpu().numpy(),
        "tgt_mask": state.tgt.mask.cpu().numpy(),
        "tgt_covs": state.tgt.covs.cpu().numpy(),
        "keyframe_pose": state.keyframe_pose.cpu().numpy(),
        "prev_trans": state.prev_trans.cpu().numpy(),
        "keyframe_stamp": state.keyframe_stamp.cpu().numpy(),
        "prev_delta": state.prev_delta.cpu().numpy(),
    }
