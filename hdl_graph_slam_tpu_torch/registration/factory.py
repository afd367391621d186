"""Registration method factory and host-side wrapper
(port of hdl_graph_slam_tpu/registration/factory.py).

Equivalent of hdl_graph_slam::select_registration_method
(src/hdl_graph_slam/registrations.cpp:22-124) with the pcl::Registration-style
surface the backend uses (set a target once, align sources with a guess,
read the fitness score). This slice ports FAST_GICP / GICP / GICP_OMP
(registration.gicp); VGICP, NDT and ICP raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.cloud import PointCloud
from ..core.config import RegistrationConfig
from ..ops import knn
from . import gicp
from .base import AlignResult


def method_of(cfg: RegistrationConfig) -> str:
    """The engine family of a configured method, as the JAX factory maps
    it; raises for the families the port does not have yet."""
    m = cfg.registration_method.upper()
    if "VGICP" in m:
        raise NotImplementedError(f"{cfg.registration_method}: VGICP is ROADMAP Queue 1 item 7 of the port")
    if "GICP" in m:
        return "GICP"
    if m == "ICP":
        raise NotImplementedError(f"{cfg.registration_method}: ICP is ROADMAP Queue 1 item 9 of the port")
    raise NotImplementedError(f"{cfg.registration_method}: NDT is ROADMAP Queue 1 item 8 of the port")


class Registration:
    """Stateful wrapper: the target is preprocessed once per set_target, as
    pcl::Registration::setInputTarget (scan_matching_odometry_nodelet.cpp:250)."""

    def __init__(self, cfg: Optional[RegistrationConfig] = None, max_voxels: int = 8192):
        self.cfg = cfg or RegistrationConfig()
        self.max_voxels = max_voxels  # the target voxel capacity of VGICP and NDT (items 7-8); GICP has none
        self.method = method_of(self.cfg)
        self._target_cloud: Optional[PointCloud] = None
        self._target_state: Optional[gicp.GicpCloud] = None
        self._last_result: Optional[AlignResult] = None
        self._last_source: Optional[PointCloud] = None

    def set_target(self, cloud: PointCloud) -> None:
        self._target_cloud = cloud
        self._target_state = gicp.preprocess(cloud, k=self.cfg.reg_correspondence_randomness)

    def align(self, source: PointCloud, guess=None) -> AlignResult:
        """Preprocess ``source`` and align it onto the target from ``guess``."""
        if self._target_state is None:
            raise RuntimeError("set_target() must be called before align()")
        c = self.cfg
        dtype, dev = source.xyz.dtype, source.xyz.device
        guess = torch.eye(4, dtype=dtype, device=dev) if guess is None else torch.as_tensor(guess, dtype=dtype).to(dev)
        src = gicp.preprocess(source, k=c.reg_correspondence_randomness)
        result = gicp.align(
            self._target_state, src, guess,
            max_corr_dist=c.reg_max_correspondence_distance,
            transformation_epsilon=c.reg_transformation_epsilon,
            max_iterations=c.reg_maximum_iterations,
            reassoc_displacement=c.reg_reassoc_displacement,
        )
        self._last_result = result
        self._last_source = source
        return result

    def get_fitness_score(self, max_range: float = float("inf")) -> float:
        """pcl::Registration::getFitnessScore of the last alignment."""
        if self._last_result is None or self._target_cloud is None:
            return float("inf")
        score = knn.fitness_score(self._target_cloud.valid_xyz(), self._last_source.xyz, self._last_source.mask,
                                  self._last_result.transformation, max_range=max_range)
        return float(score)


def select_registration_method(cfg: RegistrationConfig) -> Registration:
    return Registration(cfg)
