"""Device-resident scan-matching odometry
(port of hdl_graph_slam_tpu/frontend/odometry_device.py).

One frame step keeps its state on the device:

    state', odom, status = step(state, cloud, stamp)

- the registration target (preprocessed keyframe) lives in device memory;
- alignment runs from the prev_trans guess (scan_matching_odometry_nodelet
  .cpp:210);
- the convergence gate, transform thresholding and keyframe switch
  (:214-252) are tensor selects, so a frame reads nothing back to the host
  outside the registration loop's per-iteration flags
  (registration/base.py, registration/ndt.py, registration/icp.py). For
  GICP the new target is the frame's own preprocessed source, for ICP its
  cloud, selected elementwise. NDT's and VGICP's voxel targets (a sort,
  segment sums, a dense-grid scatter) are rebuilt only on switching frames,
  as the JAX lax.cond does: the frame reads its switch flag to the host
  (one more sync a frame).

Every reference method runs: FAST_GICP / GICP, FAST_VGICP /
FAST_VGICP_CUDA, ICP and NDT / NDT_OMP.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import se3
from ..core.cloud import PointCloud
from ..core.config import OdometryConfig, RegistrationConfig
from ..core.device import resolve_device
from ..registration import factory
from ..utils.metrics import GLOBAL_TIMER


@dataclasses.dataclass(frozen=True)
class OdomState:
    tgt: object  # current keyframe, preprocessed (GicpCloud, VgicpTarget, PointCloud or NdtTarget)
    keyframe_pose: torch.Tensor  # (4,4)
    prev_trans: torch.Tensor  # (4,4) transform since keyframe
    keyframe_stamp: torch.Tensor  # ()
    prev_delta: torch.Tensor  # (4,4) last accepted frame-to-frame motion


def make_method_fns(cfg: RegistrationConfig, max_voxels: int = 8192):
    """(preprocess_src, make_target, align) for the configured method
    (select_registration_method, src/hdl_graph_slam/registrations.cpp:22-124,
    through registration/factory.py); ``max_voxels`` is the NDT and VGICP
    targets' cell capacity."""
    return (lambda cloud: factory.prepare_source(cfg, cloud),
            lambda cloud, src: factory.make_target(cfg, cloud, max_voxels, source=src),
            lambda tgt, src, guess: factory.align(cfg, tgt, src, guess))


def _select(cond: torch.Tensor, a, b):
    """Elementwise select between two dataclasses of tensors (a field that
    is None in both stays None)."""
    def pick(x, y):
        return None if x is None and y is None else torch.where(cond, x, y)

    return type(a)(**{f.name: pick(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)})


def _next_target(switch: torch.Tensor, cloud: PointCloud, src, make_tgt, tgt):
    """The keyframe target after this frame: selected elementwise on the
    device where the factory allows it, else built only when the host reads
    that the frame switched."""
    with GLOBAL_TIMER.span("keyframe_switch"):
        if factory.elementwise_target(tgt):
            return _select(switch, make_tgt(cloud, src), tgt)
        GLOBAL_TIMER.count("host_sync.keyframe_switch")
        return make_tgt(cloud, src) if bool(switch) else tgt


def device_step_impl(
    state: OdomState,
    cloud: PointCloud,
    stamp: torch.Tensor,
    msf_delta: torch.Tensor,
    prep,
    make_tgt,
    align,
    keyframe_delta_trans: float,
    keyframe_delta_angle: float,
    keyframe_delta_time: float,
    transform_thresholding: bool,
    max_acceptable_trans: float,
    max_acceptable_angle: float,
    constant_velocity_guess: bool = False,
):
    """One odometry frame (matching(), scan_matching_odometry_nodelet.cpp:165-262)."""
    with GLOBAL_TIMER.span("odometry_step"):
        src = prep(cloud)
        guess = se3.compose(state.prev_trans, msf_delta)
        if constant_velocity_guess:
            # translation-only warm start from the last accepted frame-to-frame
            # motion, capped at 2 m/frame; extrapolating rotation fed attitude
            # jitter forward and ran away in the JAX package's round 5
            pd_t = state.prev_delta[:3, 3]
            sane = (torch.linalg.norm(pd_t) <= 2.0) & torch.isfinite(pd_t).all()
            delta_cv = torch.eye(4, dtype=guess.dtype, device=guess.device)
            delta_cv[:3, 3] = torch.where(sane, pd_t, 0.0)
            guess = se3.compose(guess, delta_cv)
        res = align(state.tgt, src, guess)

        # convergence gate (:214-218): ignore the frame, keep prev_trans
        trans = torch.where(res.converged, res.transformation, state.prev_trans)
        # one Newton-Schulz step per frame keeps the pose chain on SO(3)
        trans = se3.project_so3(trans)

        # transform thresholding (:223-233) with the reference's acos(q.w) angle
        delta = se3.compose(se3.inverse(state.prev_trans), trans)
        too_large = (torch.linalg.norm(delta[:3, 3]) > max_acceptable_trans) | (
            se3.acos_qw_angle(delta[:3, :3]) > max_acceptable_angle
        )
        reject = too_large & res.converged & bool(transform_thresholding)
        trans = torch.where(reject, state.prev_trans, trans)
        accepted = res.converged & ~reject

        odom = se3.compose(state.keyframe_pose, trans)

        # keyframe switch (:244-252)
        d_trans = torch.linalg.norm(trans[:3, 3])
        d_angle = se3.acos_qw_angle(trans[:3, :3])
        d_time = stamp - state.keyframe_stamp
        switch = accepted & (
            (d_trans > keyframe_delta_trans) | (d_angle > keyframe_delta_angle) | (d_time > keyframe_delta_time)
        )

        eye = torch.eye(4, dtype=odom.dtype, device=odom.device)
        # frame-to-frame motion of this frame (for the constant-velocity warm
        # start); the previous estimate is kept when the frame was rejected
        frame_delta = se3.compose(se3.inverse(state.prev_trans), trans)
        new_state = OdomState(
            tgt=_next_target(switch, cloud, src, make_tgt, state.tgt),
            keyframe_pose=torch.where(switch, odom, state.keyframe_pose),
            prev_trans=torch.where(switch, eye, torch.where(accepted, trans, state.prev_trans)),
            keyframe_stamp=torch.where(switch, stamp, state.keyframe_stamp),
            prev_delta=torch.where(accepted, frame_delta, state.prev_delta),
        )
        n_src = torch.clamp(cloud.mask.sum(dtype=torch.int32), min=1)
        status = dict(
            converged=res.converged,
            error=res.error,
            iterations=res.iterations,
            num_inliers=res.num_inliers,
            inlier_fraction=res.num_inliers.to(odom.dtype) / n_src.to(odom.dtype),
            keyframe_switched=switch,
            relative_pose=res.transformation,
            # ScanMatchingStatus.prediction_errors[0] (scan_matching_odometry_
            # nodelet.cpp:330-332): T_final^-1 * msf_delta
            prediction_error=se3.compose(se3.inverse(res.transformation), msf_delta),
        )
        return new_state, odom, status


def initial_state(tgt, stamp: float, dtype: torch.dtype, device) -> OdomState:
    """The state of a bootstrap frame: its cloud is the keyframe target."""
    eye = torch.eye(4, dtype=dtype, device=device)
    return OdomState(
        tgt=tgt,
        keyframe_pose=eye,
        prev_trans=eye.clone(),
        keyframe_stamp=torch.tensor(stamp, dtype=dtype, device=device),
        prev_delta=eye.clone(),
    )


def step_kwargs(cfg: OdometryConfig) -> dict:
    """The threshold arguments of device_step_impl from an OdometryConfig."""
    return dict(
        keyframe_delta_trans=cfg.keyframe_delta_trans,
        keyframe_delta_angle=cfg.keyframe_delta_angle,
        keyframe_delta_time=cfg.keyframe_delta_time,
        transform_thresholding=cfg.transform_thresholding,
        max_acceptable_trans=cfg.max_acceptable_trans,
        max_acceptable_angle=cfg.max_acceptable_angle,
        constant_velocity_guess=cfg.constant_velocity_guess,
    )


class DeviceOdometry:
    """Runs the device step one frame per call on ``device`` (None = cuda)."""

    def __init__(self, cfg: Optional[OdometryConfig] = None, device=None, max_voxels: int = 8192):
        self.cfg = cfg or OdometryConfig()
        self.device = resolve_device(device)
        self.state: Optional[OdomState] = None
        self.last_status = None
        self._fns = make_method_fns(self.cfg.registration, max_voxels=max_voxels)

    def step(self, stamp: float, cloud: PointCloud, msf_delta=None, msf_source: str = "imu") -> torch.Tensor:
        """The odometry pose of this frame, on the device. ``msf_source``
        labels the guess provider in last_status (prediction_labels)."""
        cloud = PointCloud(xyz=cloud.xyz.to(self.device), mask=cloud.mask.to(self.device))
        dtype = cloud.xyz.dtype
        prep, make_tgt, align = self._fns
        if self.state is None:
            self.state = initial_state(make_tgt(cloud, prep(cloud)), stamp, dtype, self.device)
            return torch.eye(4, dtype=dtype, device=self.device)
        have_guess = msf_delta is not None
        if msf_delta is None:
            msf_delta = torch.eye(4, dtype=dtype)
        GLOBAL_TIMER.count_copies("device_odometry_args", self.device, 2)
        self.state, odom, status = device_step_impl(
            self.state, cloud,
            torch.tensor(stamp, dtype=dtype, device=self.device),
            torch.as_tensor(msf_delta, dtype=dtype, device=self.device),
            prep, make_tgt, align, **step_kwargs(self.cfg),
        )
        status["prediction_labels"] = (msf_source,) if have_guess else ()
        self.last_status = status
        return odom
