"""Registration method factory and host-side wrapper
(port of hdl_graph_slam_tpu/registration/factory.py).

Equivalent of hdl_graph_slam::select_registration_method
(src/hdl_graph_slam/registrations.cpp:22-124) with the pcl::Registration-style
surface the backend uses (set a target once, align sources with a guess,
read the fitness score). Method mapping (reference -> this engine):

- FAST_GICP, GICP, GICP_OMP -> registration.gicp (fast_gicp semantics);
- FAST_VGICP, FAST_VGICP_CUDA -> registration.vgicp;
- ICP -> registration.icp;
- NDT, NDT_OMP (KDTREE / DIRECT1 / DIRECT7) -> registration.ndt.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.cloud import PointCloud
from ..core.config import RegistrationConfig
from ..ops import knn
from ..ops import voxel as voxelops
from ..utils.metrics import GLOBAL_TIMER
from . import gicp, icp, ndt, vgicp
from .base import AlignResult


def method_of(cfg: RegistrationConfig) -> str:
    """The engine family of a configured method, as the JAX factory maps it."""
    m = cfg.registration_method.upper()
    if "VGICP" in m:
        return "VGICP"
    if "GICP" in m:
        return "GICP"
    if m == "ICP":
        return "ICP"
    return "NDT"


def dense_grid_size(cfg: RegistrationConfig) -> int:
    """The dense voxel grid of the configured resolution and span."""
    return voxelops.dense_grid_size_for(cfg.reg_resolution, span_m=cfg.reg_dense_span_m or voxelops.DENSE_GRID_SPAN_M)


def prepare_source(cfg: RegistrationConfig, cloud: PointCloud):
    """A source cloud (or a leading batch of them) as the configured method
    aligns it: GICP's and VGICP's per-point covariances; NDT and ICP take
    the cloud as it is."""
    if method_of(cfg) in ("NDT", "ICP"):
        return cloud
    return gicp.preprocess(cloud, k=cfg.reg_correspondence_randomness)


def make_target(cfg: RegistrationConfig, cloud: PointCloud, max_voxels: int = 8192, source=None):
    """The preprocessed target of ``cloud`` for the configured method.
    ``source`` (prepare_source of the same cloud), when given, is reused: a
    GICP target is that source as it is, a VGICP target aggregates its
    covariances into voxels. An ICP target is the cloud."""
    method = method_of(cfg)
    if method == "NDT":
        return ndt.preprocess_target(cloud, cfg.reg_resolution, max_voxels=max_voxels,
                                     grid_size=dense_grid_size(cfg))
    if method == "VGICP":
        return vgicp.preprocess_target(cloud, cfg.reg_resolution, max_voxels=max_voxels,
                                       k=cfg.reg_correspondence_randomness, grid_size=dense_grid_size(cfg),
                                       src=source)
    if method == "ICP":
        return cloud
    return source if source is not None else prepare_source(cfg, cloud)


def elementwise_target(tgt) -> bool:
    """Whether a keyframe switch may select the next target elementwise on
    the device, with the frame's target made on every frame: a GICP target
    is the frame's own prepared source and an ICP target its cloud, so they
    cost nothing more. Any other target (NDT's, VGICP's voxels) is a build
    of its own, made only on switching frames."""
    return isinstance(tgt, (gicp.GicpCloud, PointCloud))


def align(cfg: RegistrationConfig, tgt, source, guess: torch.Tensor) -> AlignResult:
    """Align a prepared source (N rows with a (4, 4) guess, or a leading
    batch with (B, 4, 4)) onto a target with the configuration's options."""
    method = method_of(cfg)
    eps, iters = cfg.reg_transformation_epsilon, cfg.reg_maximum_iterations
    if method == "NDT":
        return ndt.align(tgt, source, guess, transformation_epsilon=eps, max_iterations=iters,
                         nn_search_method=cfg.reg_nn_search_method, reassoc_displacement=cfg.reg_reassoc_displacement)
    if method == "VGICP":
        return vgicp.align(tgt, source, guess, transformation_epsilon=eps, max_iterations=iters,
                           reassoc_displacement=cfg.reg_reassoc_displacement)
    if method == "ICP":
        return icp.align(tgt, source, guess, max_corr_dist=cfg.reg_max_correspondence_distance,
                         transformation_epsilon=eps, max_iterations=iters,
                         use_reciprocal=cfg.reg_use_reciprocal_correspondences)
    return gicp.align(tgt, source, guess, max_corr_dist=cfg.reg_max_correspondence_distance,
                      transformation_epsilon=eps, max_iterations=iters,
                      reassoc_displacement=cfg.reg_reassoc_displacement)


class Registration:
    """Stateful wrapper: the target is preprocessed once per set_target, as
    pcl::Registration::setInputTarget (scan_matching_odometry_nodelet.cpp:250)."""

    def __init__(self, cfg: Optional[RegistrationConfig] = None, max_voxels: int = 8192):
        self.cfg = cfg or RegistrationConfig()
        self.max_voxels = max_voxels  # the target voxel capacity of VGICP and NDT; GICP has none
        self.method = method_of(self.cfg)
        self._target_cloud: Optional[PointCloud] = None
        self._target_state = None
        self._last_result: Optional[AlignResult] = None
        self._last_source: Optional[PointCloud] = None

    def set_target(self, cloud: PointCloud) -> None:
        self._target_cloud = cloud
        self._target_state = make_target(self.cfg, cloud, self.max_voxels)

    def align(self, source: PointCloud, guess=None) -> AlignResult:
        """Preprocess ``source`` and align it onto the target from ``guess``."""
        if self._target_state is None:
            raise RuntimeError("set_target() must be called before align()")
        dtype, dev = source.xyz.dtype, source.xyz.device
        if guess is None:
            guess = torch.eye(4, dtype=dtype, device=dev)
        else:
            guess = torch.as_tensor(guess, dtype=dtype)
            if guess.device != dev:
                GLOBAL_TIMER.count("host_sync.align_guess")  # a blocking copy to the device
                guess = guess.to(dev)
        result = align(self.cfg, self._target_state, prepare_source(self.cfg, source), guess)
        self._last_result = result
        self._last_source = source
        return result

    def get_fitness_score(self, max_range: float = float("inf")) -> float:
        """pcl::Registration::getFitnessScore of the last alignment."""
        if self._last_result is None or self._target_cloud is None:
            return float("inf")
        score = knn.fitness_score(self._target_cloud.valid_xyz(), self._last_source.xyz, self._last_source.mask,
                                  self._last_result.transformation, max_range=max_range)
        GLOBAL_TIMER.count("host_sync.fitness_score")
        return float(score)


def select_registration_method(cfg: RegistrationConfig, max_voxels: int = 8192) -> Registration:
    return Registration(cfg, max_voxels=max_voxels)
