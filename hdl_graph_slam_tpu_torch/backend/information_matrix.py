"""Edge information-matrix calculation
(port of hdl_graph_slam_tpu/backend/information_matrix.py).

Equivalent of InformationMatrixCalculator
(src/hdl_graph_slam/information_matrix_calculator.cpp:25-80): constant
diagonal, or fitness-adaptive via the saturating-exponential weight
    w(x) = min + (max - min) * (1 - e^{-a x}) / (1 - e^{-a x_max})
applied separately to translation and rotation variances. The fitness score
is the mean squared 1-NN distance of cloud2 moved into cloud1's frame: the
nn1 kernel per pair, and one nn1_batched launch (each pair its own target)
for a keyframe flush.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.cloud import PointCloud
from ..core.config import InformationMatrixConfig
from ..ops import knn


class InformationMatrixCalculator:
    def __init__(self, cfg: Optional[InformationMatrixConfig] = None):
        self.cfg = cfg or InformationMatrixConfig()

    @staticmethod
    def calc_fitness_score(cloud1: PointCloud, cloud2: PointCloud, relpose: np.ndarray,
                           max_range: float = np.inf) -> float:
        rel = torch.as_tensor(np.asarray(relpose), dtype=cloud2.xyz.dtype).to(cloud2.xyz.device)
        return float(knn.fitness_score(cloud1.valid_xyz(), cloud2.xyz, cloud2.mask, rel, max_range=max_range))

    def calc_information_matrix(self, cloud1: PointCloud, cloud2: PointCloud, relpose: np.ndarray) -> np.ndarray:
        if self.cfg.use_const_inf_matrix:
            return self.information_from_fitness(0.0)
        return self.information_from_fitness(self.calc_fitness_score(cloud1, cloud2, relpose))

    def information_from_fitness(self, fitness: float) -> np.ndarray:
        """Information matrix from an already computed fitness score (the
        batched loop matcher's, same formula and max_range=inf)."""
        c = self.cfg
        inf = np.eye(6)
        if c.use_const_inf_matrix:
            inf[:3, :3] /= c.const_stddev_x
            inf[3:, 3:] /= c.const_stddev_q
            return inf
        w_x = self._weight(c.var_gain_a, c.fitness_score_thresh, c.min_stddev_x**2, c.max_stddev_x**2, fitness)
        w_q = self._weight(c.var_gain_a, c.fitness_score_thresh, c.min_stddev_q**2, c.max_stddev_q**2, fitness)
        inf[:3, :3] /= w_x
        inf[3:, 3:] /= w_q
        return inf

    def calc_information_matrices_batched(self, pairs) -> list:
        """Information matrices for a batch of (cloud1, cloud2, relpose)
        keyframe pairs: one nn1_batched launch and one host copy. Pairs of
        mixed capacities take the per-pair path, as in the JAX package."""
        if not pairs:
            return []
        c = self.cfg
        if c.use_const_inf_matrix or len(pairs) == 1:
            return [self.calc_information_matrix(c1, c2, rp) for (c1, c2, rp) in pairs]
        caps1 = {c1.capacity for (c1, _, _) in pairs}
        caps2 = {c2.capacity for (_, c2, _) in pairs}
        if len(caps1) != 1 or len(caps2) != 1:
            return [self.calc_information_matrix(c1, c2, rp) for (c1, c2, rp) in pairs]
        tgt = torch.stack([c1.valid_xyz() for (c1, _, _) in pairs])
        src = torch.stack([c2.xyz for (_, c2, _) in pairs])
        msk = torch.stack([c2.mask for (_, c2, _) in pairs])
        rel = torch.from_numpy(np.stack([np.asarray(rp) for (_, _, rp) in pairs])).to(src.device, src.dtype)
        scores = knn.fitness_score(tgt, src, msk, rel).cpu().numpy()
        return [self.information_from_fitness(float(s)) for s in scores]

    @staticmethod
    def _weight(a, max_x, min_y, max_y, x) -> float:
        y = (1.0 - np.exp(-a * x)) / (1.0 - np.exp(-a * max_x))
        return float(min_y + (max_y - min_y) * y)
