"""Loop-closure detection with batched candidate registration
(port of hdl_graph_slam_tpu/backend/loop_detector.py).

Equivalent of hdl_graph_slam::LoopDetector (include/hdl_graph_slam/
loop_detector.hpp:31-184): candidate gating by accumulated-distance
difference, XY distance between current estimates and distance since the
last accepted loop edge; then scan matching of each candidate against the
new keyframe from a z-flattened guess; acceptance iff the best fitness
beats fitness_score_thresh.

Where the reference aligns candidates one at a time
(loop_detector.hpp:135-154), the gated candidates are stacked (padded to a
power of two) and aligned together: one knn_select_batched launch for their
covariances, one nn1 launch per LM re-association for all their points
against the shared target, one for their fitness scores, and one host copy
of the results. VGICP candidates share the same covariance launch and one
association launch per LM re-association (``ndt_associate_kernel<1>``); ICP
candidates one nn1 launch an iteration; NDT candidates align in one batched
``ndt.align`` (each Newton step's association, derivatives and trial scores
one launch for all of them). Every reference method runs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.cloud import PointCloud
from ..core.config import LoopDetectorConfig
from ..ops import knn
from ..registration import factory
from ..registration.factory import Registration
from ..utils.metrics import GLOBAL_TIMER
from .keyframe import KeyFrame


@dataclasses.dataclass
class Loop:
    key1: KeyFrame  # new keyframe (loop end)
    key2: KeyFrame  # matched past keyframe (loop start)
    relative_pose: np.ndarray  # key1^-1 * key2 (align result, cand -> new)
    # fitness of the winning alignment (mean squared 1-NN distance at
    # fitness_score_max_range), reused for the loop edge's information
    fitness: float = float("inf")


class LoopDetector:
    def __init__(self, cfg: Optional[LoopDetectorConfig] = None):
        self.cfg = cfg or LoopDetectorConfig()
        self.last_edge_accum_distance = 0.0
        self._registration = Registration(self.cfg.registration)
        # parity/debug path: per-candidate host loop instead of the batch
        self.force_sequential = False

    # -- candidate gating (loop_detector.hpp:81-109) -------------------------

    def find_candidates(self, keyframes: Sequence[KeyFrame], new_keyframe: KeyFrame, estimates: np.ndarray) -> List[int]:
        cfg = self.cfg
        if new_keyframe.accum_distance - self.last_edge_accum_distance < cfg.min_edge_interval:
            return []
        out = []
        dists = []
        new_pos = estimates[new_keyframe.node_id][:2, 3]
        for i, k in enumerate(keyframes):
            if new_keyframe.accum_distance - k.accum_distance < cfg.accum_distance_thresh:
                continue
            pos = estimates[k.node_id][:2, 3]
            d = np.linalg.norm(pos - new_pos)
            if d > cfg.distance_thresh:
                continue
            out.append(i)
            dists.append(d)
        # bound the batch: keep the max_candidates closest candidates
        if len(out) > cfg.max_candidates:
            order = np.argsort(dists)[: cfg.max_candidates]
            out = [out[j] for j in order]
        return out

    # -- matching ------------------------------------------------------------

    def detect(self, keyframes: Sequence[KeyFrame], new_keyframes: Sequence[KeyFrame],
               estimates: np.ndarray) -> List[Loop]:
        """estimates: (num_nodes, 4, 4) current optimized pose estimates."""
        loops = []
        for nk in new_keyframes:
            with GLOBAL_TIMER.span("loop_candidates"):
                cand_idx = self.find_candidates(keyframes, nk, estimates)
            GLOBAL_TIMER.count("loop_candidates", len(cand_idx))
            if not cand_idx:
                continue
            with GLOBAL_TIMER.span("loop_match"):
                loop = self._match(keyframes, cand_idx, nk, estimates)
            if loop is not None:
                loops.append(loop)
        return loops

    def _match(self, keyframes: Sequence[KeyFrame], cand_idx: List[int], new_keyframe: KeyFrame,
               estimates: np.ndarray) -> Optional[Loop]:
        cfg = self.cfg
        if not cand_idx:
            return None
        # z-flattened init guesses (loop_detector.hpp:139-146)
        new_est = estimates[new_keyframe.node_id]
        guesses = []
        for i in cand_idx:
            guess = np.linalg.inv(new_est) @ estimates[keyframes[i].node_id]
            guess[2, 3] = 0.0
            guesses.append(guess)

        match = self._match_sequential if self.force_sequential else self._match_batched
        scores, transforms, convergeds = match([keyframes[i].cloud for i in cand_idx], new_keyframe.cloud, guesses)

        if GLOBAL_TIMER.on:
            GLOBAL_TIMER.count("loops_matched", sum(1 for j in range(len(cand_idx))
                                                    if convergeds[j] and scores[j] <= cfg.fitness_score_thresh))
        best_score = np.inf
        best: Optional[int] = None
        for j in range(len(cand_idx)):
            if not convergeds[j] or scores[j] > best_score:
                continue
            best_score = scores[j]
            best = j

        if best is None or best_score > cfg.fitness_score_thresh:
            return None

        self.last_edge_accum_distance = new_keyframe.accum_distance
        return Loop(
            key1=new_keyframe,
            key2=keyframes[cand_idx[best]],
            relative_pose=np.asarray(transforms[best], dtype=np.float64),
            fitness=float(best_score),
        )

    def _match_sequential(self, sources, target, guesses):
        """Per-candidate host loop (parity/debug path: one alignment and one
        host sync per candidate)."""
        reg = self._registration
        reg.set_target(target)
        scores, transforms, convs = [], [], []
        for src, guess in zip(sources, guesses):
            res = reg.align(src, guess=guess)
            scores.append(reg.get_fitness_score(self.cfg.fitness_score_max_range))
            GLOBAL_TIMER.count("host_sync.loop_match_sequential", 2)  # the pose and the flag
            transforms.append(res.transformation.cpu().numpy())
            convs.append(bool(res.converged))
        return scores, transforms, convs

    def _match_batched(self, sources: List[PointCloud], target: PointCloud, guesses):
        """Stack the candidates (padded to the next power of two with the
        first candidate repeated, results discarded, as the JAX package
        bounds its compiled variants) and run preprocessing, alignment and
        fitness for the whole batch; one host copy of the results."""
        c = self.cfg.registration
        tgt_state = factory.make_target(c, target, self._registration.max_voxels)
        n_real = len(sources)
        pad_to = 1
        while pad_to < n_real:
            pad_to *= 2
        sources = list(sources) + [sources[0]] * (pad_to - n_real)
        guesses = list(guesses) + [guesses[0]] * (pad_to - n_real)

        dev = target.xyz.device
        cap = max(s.capacity for s in sources)
        xyz = torch.full((len(sources), cap, 3), 1.0e6, dtype=torch.float32, device=dev)
        mask = torch.zeros((len(sources), cap), dtype=torch.bool, device=dev)
        for j, s in enumerate(sources):
            xyz[j, : s.capacity] = s.xyz
            mask[j, : s.capacity] = s.mask
        GLOBAL_TIMER.count_copies("loop_guesses", dev)
        guesses_t = torch.from_numpy(np.stack(guesses)).to(dev, xyz.dtype)

        transforms, convs, scores = batched_match(c, tgt_state, target.valid_xyz(), xyz, mask, guesses_t,
                                                  fitness_max_range=self.cfg.fitness_score_max_range)
        # ONE host copy for the whole candidate batch
        GLOBAL_TIMER.count("host_sync.loop_match")
        out = torch.cat([transforms.reshape(len(sources), -1), convs[:, None].to(transforms.dtype),
                         scores[:, None].to(transforms.dtype)], dim=1).cpu().numpy()
        transforms = out[:, :16].reshape(-1, 4, 4)
        convs, scores = out[:, 16] > 0.5, out[:, 17]
        return list(scores)[:n_real], list(transforms)[:n_real], list(convs)[:n_real]


def batched_match(cfg, tgt_state, tgt_xyz_filled, xyz, mask, guesses, *, fitness_max_range):
    """The JAX ``_batched_match``: (preprocess + align + fitness) over the
    candidate batch against one shared, preprocessed target, with the
    registration configuration ``cfg``. Returns (transforms (B,4,4),
    converged (B,), fitness (B,)) on the device."""
    src = factory.prepare_source(cfg, PointCloud(xyz=xyz, mask=mask))
    res = factory.align(cfg, tgt_state, src, guesses)
    score = knn.fitness_score(tgt_xyz_filled, xyz, mask, res.transformation, max_range=fitness_max_range)
    return res.transformation, res.converged, score
