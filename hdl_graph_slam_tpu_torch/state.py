"""Carrying state across frameworks as numpy arrays.

The system has no weights; its state is the odometry state and the pose
graph.

- Odometry: the keyframe target, keyframe_pose, prev_trans and prev_delta
  (each 4x4) and keyframe_stamp. Its numpy form is a flat dict, which the
  JAX package's OdomState fills field for field (tgt.xyz -> "tgt_xyz",
  ...): ``STATE_KEYS`` for a GICP target (a GicpCloud: xyz (N,3), mask
  (N,), covs (N,3,3)); for the other methods "tgt_kind" names the target
  and ``TARGET_KEYS`` its fields: an ICP target is the PointCloud (xyz,
  mask), a VGICP target its voxel table (vgicp.VgicpTarget), an NDT target
  its Gaussian cells with icovs, d1 and d2 (ndt.NdtTarget). A voxel
  target's dense grid is not carried: "tgt_grid_size" (0 for none) rebuilds
  it from the keys, and NDT's cell rows are rebuilt from its means and
  icovs.
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
from .core.cloud import PointCloud
from .ops import voxel as voxelops
from .registration.gicp import GicpCloud
from .registration.ndt import NdtTarget
from .registration.vgicp import VgicpTarget
from .utils.metrics import GLOBAL_TIMER

STATE_KEYS = ("tgt_xyz", "tgt_mask", "tgt_covs", "keyframe_pose", "prev_trans", "keyframe_stamp", "prev_delta")
ODOM_KEYS = STATE_KEYS[3:]
_VOXEL_KEYS = ("tgt_keys", "tgt_means", "tgt_covs", "tgt_mask", "tgt_resolution", "tgt_origin", "tgt_grid_size")
TARGET_KEYS = {
    "gicp": STATE_KEYS[:3],
    "icp": ("tgt_xyz", "tgt_mask"),
    "vgicp": _VOXEL_KEYS,
    "ndt": _VOXEL_KEYS + ("tgt_counts", "tgt_icovs", "tgt_d1", "tgt_d2"),
}
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
            t = torch.from_numpy(np.array(a, dtype=np.float64)).to(device=dev, dtype=dtype)
        elif field in ("vi", "vj", "kernel_id"):
            t = torch.from_numpy(np.array(a, dtype=np.int64)).to(dev)
        else:
            t = torch.from_numpy(np.array(a, dtype=bool)).to(dev)
        GLOBAL_TIMER.count_copies("graph_freeze", t)
        return t

    edges = {e: EdgeTable(**{k: tensor(f"{e}.{k}", k) for k in EDGE_KEYS}) for e in EDGE_SPECS}
    return GraphData(**{k: tensor(k, k) for k in GRAPH_VERTEX_KEYS}, edges=edges)


def graph_data_to_numpy(data: GraphData) -> Dict[str, np.ndarray]:
    """The numpy form of a GraphData (the inverse of graph_data_from_numpy)."""
    out = {k: getattr(data, k).cpu().numpy() for k in GRAPH_VERTEX_KEYS}
    for e, table in data.edges.items():
        for k in EDGE_KEYS:
            out[f"{e}.{k}"] = getattr(table, k).cpu().numpy()
    return out


def _target_from_numpy(kind: str, arrays: Dict[str, np.ndarray], device):
    def t(key, dtype=np.float32):
        return torch.from_numpy(np.array(arrays[key], dtype=dtype)).to(device)

    if kind == "gicp":
        return GicpCloud(xyz=t("tgt_xyz"), mask=t("tgt_mask", bool), covs=t("tgt_covs"))
    if kind == "icp":
        return PointCloud(xyz=t("tgt_xyz"), mask=t("tgt_mask", bool))
    keys, mask, G = t("tgt_keys", np.int32), t("tgt_mask", bool), int(arrays["tgt_grid_size"])
    grid = voxelops.build_dense_grid(keys, mask, G) if G else None
    res = float(np.float32(arrays["tgt_resolution"]))
    if kind == "vgicp":
        return VgicpTarget(keys=keys, means=t("tgt_means"), covs=t("tgt_covs"), mask=mask, resolution=res,
                           origin=t("tgt_origin", np.int32), grid=grid)
    voxels = voxelops.GaussianVoxels(keys=keys, means=t("tgt_means"), covs=t("tgt_covs"), counts=t("tgt_counts"),
                                     mask=mask, resolution=res, origin=t("tgt_origin", np.int32))
    icovs = t("tgt_icovs")
    return NdtTarget(voxels=voxels, icovs=icovs, d1=float(np.float32(arrays["tgt_d1"])),
                     d2=float(np.float32(arrays["tgt_d2"])), grid=grid,
                     cell_rows=torch.cat([voxels.means, icovs.reshape(-1, 9)], dim=1).contiguous())


def _target_to_numpy(tgt) -> Dict[str, np.ndarray]:
    def n(x):
        return x.cpu().numpy()

    if isinstance(tgt, GicpCloud):
        return {"tgt_kind": np.array("gicp"), "tgt_xyz": n(tgt.xyz), "tgt_mask": n(tgt.mask), "tgt_covs": n(tgt.covs)}
    if isinstance(tgt, PointCloud):
        return {"tgt_kind": np.array("icp"), "tgt_xyz": n(tgt.xyz), "tgt_mask": n(tgt.mask)}
    vox, kind = (tgt.voxels, "ndt") if isinstance(tgt, NdtTarget) else (tgt, "vgicp")
    out = {"tgt_kind": np.array(kind), "tgt_keys": n(vox.keys), "tgt_means": n(vox.means), "tgt_covs": n(vox.covs),
           "tgt_mask": n(vox.mask), "tgt_resolution": np.float32(vox.resolution), "tgt_origin": n(vox.origin),
           "tgt_grid_size": np.int64(0 if tgt.grid is None else voxelops.grid_dim(tgt.grid))}
    if kind == "ndt":
        out.update(tgt_counts=n(vox.counts), tgt_icovs=n(tgt.icovs), tgt_d1=np.float32(tgt.d1),
                   tgt_d2=np.float32(tgt.d2))
    return out


def odom_state_from_numpy(arrays: Dict[str, np.ndarray], device) -> OdomState:
    """The port's OdomState on ``device`` from its numpy form (floats
    float32, masks bool, keys and origins int32). "tgt_kind" (gicp, icp,
    vgicp or ndt) names the target; without it the target is GICP's."""
    kind = str(arrays.get("tgt_kind", "gicp"))
    if kind not in TARGET_KEYS:
        raise ValueError(f"odom_state_from_numpy: unknown target kind {kind!r}")
    missing = [k for k in TARGET_KEYS[kind] + ODOM_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"odom_state_from_numpy: missing {missing}")

    def f32(key):
        return torch.from_numpy(np.array(arrays[key], dtype=np.float32)).to(device)

    return OdomState(
        tgt=_target_from_numpy(kind, arrays, device),
        keyframe_pose=f32("keyframe_pose"),
        prev_trans=f32("prev_trans"),
        keyframe_stamp=f32("keyframe_stamp").reshape(()),
        prev_delta=f32("prev_delta"),
    )


def odom_state_to_numpy(state: OdomState) -> Dict[str, np.ndarray]:
    """The numpy form of an OdomState (the inverse of odom_state_from_numpy)."""
    return {
        **_target_to_numpy(state.tgt),
        "keyframe_pose": state.keyframe_pose.cpu().numpy(),
        "prev_trans": state.prev_trans.cpu().numpy(),
        "keyframe_stamp": state.keyframe_stamp.cpu().numpy(),
        "prev_delta": state.prev_delta.cpu().numpy(),
    }
