"""Carrying odometry state across frameworks as numpy arrays.

The system has no weights; its state is the odometry state: the keyframe
target GicpCloud (xyz (N,3), mask (N,), covs (N,3,3)), keyframe_pose,
prev_trans and prev_delta (each 4x4) and keyframe_stamp. Its numpy form is a
flat dict with the keys of ``STATE_KEYS``, which the JAX package's OdomState
fills field for field (tgt.xyz -> "tgt_xyz", ...).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .frontend.odometry_device import OdomState
from .registration.gicp import GicpCloud

STATE_KEYS = ("tgt_xyz", "tgt_mask", "tgt_covs", "keyframe_pose", "prev_trans", "keyframe_stamp", "prev_delta")


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
