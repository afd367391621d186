"""Windowed device-resident odometry: K frames per call
(port of hdl_graph_slam_tpu/frontend/window.py).

The whole frame step (prefilter + odometry + gates + keyframe switch,
scan_matching_odometry_nodelet.cpp:165-262) runs for a window of K staged
scans. The JAX ``lax.scan`` becomes a frame loop over tensors that stay on
the device; frame-to-frame sequencing (prev_trans as the next guess,
keyframe switching) is preserved exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.cloud import PAD_COORD, PointCloud
from ..core.config import OdometryConfig, PrefilterConfig
from ..core.device import resolve_device
from ..utils.metrics import GLOBAL_TIMER
from .odometry_device import OdomState, device_step_impl, initial_state, make_method_fns, step_kwargs
from .prefilter import make_prefilter_fn


def stack_scans(scans, capacity: int, dtype=np.float32):
    """Pad a list of (n_i, 3) raw scans into (K, capacity, 3) xyz + (K, capacity)
    mask numpy arrays, ready for a single host-to-device copy."""
    k = len(scans)
    xyz = np.full((k, capacity, 3), PAD_COORD, dtype=dtype)
    mask = np.zeros((k, capacity), dtype=bool)
    for i, s in enumerate(scans):
        s = np.asarray(s, dtype=dtype).reshape(-1, 3)
        if s.shape[0] > capacity:
            # uniform strided subsample (see core.cloud.from_numpy): head
            # truncation of ring-major lidar data drops the upper rings.
            s = s[np.linspace(0, s.shape[0] - 1, capacity).round().astype(np.int64)]
        n = s.shape[0]
        xyz[i, :n] = s[:n]
        mask[i, :n] = True
    return xyz, mask


class OdometryWindow:
    """Runs K-frame odometry windows on ``device`` (None = cuda)."""

    def __init__(
        self,
        cfg: Optional[OdometryConfig] = None,
        prefilter_cfg: Optional[PrefilterConfig] = None,
        out_capacity: int = 8192,
        device=None,
        max_voxels: int = 8192,
    ):
        self.cfg = cfg or OdometryConfig()
        self.prefilter_cfg = prefilter_cfg
        self.device = resolve_device(device)
        self._pf = make_prefilter_fn(prefilter_cfg, out_capacity) if prefilter_cfg is not None else None
        self._fns = make_method_fns(self.cfg.registration, max_voxels=max_voxels)
        self.frames = 0  # frames through init_state and the windows: the next frame's index

    def _prefilter(self, cloud: PointCloud, ang_vel: torch.Tensor) -> PointCloud:
        if self._pf is None:
            return cloud
        eye = torch.eye(4, dtype=cloud.xyz.dtype, device=self.device)
        return self._pf(cloud, eye, ang_vel)

    def init_state(self, stamp: float, raw_cloud: PointCloud, ang_vel=None) -> OdomState:
        """Bootstrap from the first frame: it becomes the keyframe target
        (scan_matching_odometry_nodelet.cpp:166-174). ``ang_vel`` (3,) deskews
        the bootstrap scan when the prefilter config enables deskewing."""
        prep, make_tgt, _ = self._fns
        dtype = raw_cloud.xyz.dtype
        cloud = PointCloud(xyz=raw_cloud.xyz.to(self.device), mask=raw_cloud.mask.to(self.device))
        if ang_vel is None:
            ang_vel = torch.zeros(3, dtype=dtype)
        cloud = self._prefilter(cloud, torch.as_tensor(ang_vel, dtype=dtype, device=self.device))
        self.frames = 1
        return initial_state(make_tgt(cloud, prep(cloud)), stamp, dtype, self.device)

    def run(self, state: OdomState, xyz, mask, stamps, ang_vel=None):
        """Process a window. xyz (K, N, 3), mask (K, N), stamps (K,) — tensors
        or numpy arrays. ``ang_vel`` (K, 3) per-frame angular velocity for
        deskewing (default zeros). Returns (new_state, odoms (K, 4, 4), status
        dict of (K, ...) tensors)."""
        state, odoms, status, _, _ = self.run_with_clouds(state, xyz, mask, stamps, ang_vel)
        return state, odoms, status

    def run_with_clouds(self, state: OdomState, xyz, mask, stamps, ang_vel=None):
        """Like :meth:`run` but also returns the per-frame prefiltered clouds as
        (K, out_capacity, 3) xyz + (K, out_capacity) mask tensors."""
        first = self.frames
        with GLOBAL_TIMER.span("window", rid=first):
            dtype = state.keyframe_pose.dtype
            dev = self.device
            inputs = [torch.as_tensor(x, dtype=t) for x, t in ((xyz, dtype), (mask, torch.bool), (stamps, dtype))]
            if ang_vel is not None:
                inputs.append(torch.as_tensor(ang_vel, dtype=dtype))
            GLOBAL_TIMER.count_copies("window_inputs", dev, sum(x.device.type == "cpu" for x in inputs))
            xyz, mask, stamps, *rest = [x.to(dev) for x in inputs]
            k = stamps.shape[0]
            ang_vel = rest[0] if rest else torch.zeros((k, 3), dtype=dtype, device=dev)
            prep, make_tgt, align = self._fns
            msf = torch.eye(4, dtype=dtype, device=dev)
            kwargs = step_kwargs(self.cfg)
            odoms, statuses, fxyz, fmask = [], [], [], []
            for i in range(k):
                with GLOBAL_TIMER.span("frame", rid=first + i):
                    cloud = self._prefilter(PointCloud(xyz=xyz[i], mask=mask[i]), ang_vel[i])
                    state, odom, status = device_step_impl(
                        state, cloud, stamps[i], msf, prep, make_tgt, align, **kwargs
                    )
                odoms.append(odom)
                statuses.append(status)
                fxyz.append(cloud.xyz)
                fmask.append(cloud.mask)
            self.frames = first + k
            status = {key: torch.stack([s[key] for s in statuses]) for key in statuses[0]}
            return state, torch.stack(odoms), status, torch.stack(fxyz), torch.stack(fmask)
