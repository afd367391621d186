"""The judgement of a run's outputs by the reference, and the reference run
in the program's place (the control).

A run's odometry is an ``OdometryRecord``: per position p of the drive the
scan it read, its stamp, the pose the program returned, the keyframe it was
matched against, whether it switched keyframes and whether it converged.
``judge_odometry`` re-matches sampled frames against the same keyframe
from the same guess the program's state held (the previous pose relative to
the keyframe) and compares the relative poses; it also recomputes each
sampled frame's keyframe decision. ``judge_floors`` detects the floor of
sampled frames and scores the program's plane on the reference's floor
points. ``judge_graph`` solves the keyframe graph from the program's
optimized poses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import floor as F
from . import geometry as G
from . import graph as GR
from .odometry import Frames, align_frame

LEVER_M = 10.0  # pose gaps: |t| plus this lever times the rotation angle
# a floor plane holding this share fewer band points than the reference's
# best is a RANSAC near-tie, taken as found; past it the reference's plane
# stands in the graph
FLOOR_TIE = 0.01
# a keyframe decision is not judged where the reference's relative pose lies
# within this many of the matcher's stopping steps (reg_transformation_epsilon)
# of a threshold: two sound matchers stop up to a step apart, so such a
# decision is a near-tie either way
SWITCH_MARGIN_STEPS = 2.0


@dataclass
class OdometryRecord:
    scan: List[int] = field(default_factory=list)  # course scan of each position
    stamp: List[float] = field(default_factory=list)
    odom: List[np.ndarray] = field(default_factory=list)  # (4, 4) float64
    keyframe: List[int] = field(default_factory=list)  # position matched against (itself at p = 0)
    switched: List[bool] = field(default_factory=list)
    converged: List[bool] = field(default_factory=list)


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.inv(a) @ b


def _guess(rec: OdometryRecord, p: int) -> np.ndarray:
    k = rec.keyframe[p]
    return np.eye(4) if p - 1 == k else _rel(rec.odom[k], rec.odom[p - 1])


def _decide(trans: np.ndarray, ok: bool, dt: float, odo: dict, margin: float = 0.0):
    """(switch, judged, dx, da): the keyframe rule on a relative pose,
    whether it lies more than ``margin`` clear of every threshold, and the
    translation and half angle it read."""
    T = torch.as_tensor(trans)
    dx = float(torch.linalg.norm(T[:3, 3]))
    da = float(G.half_angle(T[:3, :3]))
    switch = ok and (dx > odo["keyframe_delta_trans"] or da > odo["keyframe_delta_angle"]
                     or dt > odo["keyframe_delta_time"])
    clear = (abs(dx - odo["keyframe_delta_trans"]) > margin
             and abs(da - odo["keyframe_delta_angle"]) > margin)
    return switch, clear, dx, da


def judge_odometry(rec: OdometryRecord, frames: Frames, positions, odo: dict, project: bool) -> dict:
    """The pose gaps over ``positions`` (each, the largest and the compared
    quantiles), the keyframe decisions that differ, and those left unjudged
    as near-ties: each as (position, the reference's translation and half
    angle, the program's translation, whether the program switched).
    ``project``: the windowed path's Newton-Schulz step on each frame's
    relative pose."""
    gaps, mismatches, near = [], [], []
    margin = SWITCH_MARGIN_STEPS * frames.reg["reg_transformation_epsilon"]
    for p in positions:
        k = rec.keyframe[p]
        guess = _guess(rec, p)
        T, ok = align_frame(frames, rec.scan[k], rec.scan[p], guess)
        if not ok:
            T = guess
        if project:
            T = G.project_so3(torch.as_tensor(T)).numpy()
        got = _rel(rec.odom[k], rec.odom[p])
        gaps.append(float(G.pose_gap(torch.as_tensor(got), torch.as_tensor(T), LEVER_M)))
        switch, clear, dx, da = _decide(T, ok, rec.stamp[p] - rec.stamp[k], odo, margin)
        seen = (p, round(dx, 5), round(da, 5), round(float(np.linalg.norm(got[:3, 3])), 5), bool(rec.switched[p]))
        if not clear:
            near.append(seen)
        elif switch != rec.switched[p]:
            mismatches.append(seen)
    return {"pose_gap_m": max(gaps) if gaps else 0.0, **gap_quantiles(gaps),
            "switch_mismatches": len(mismatches), "switch_mismatch_at": mismatches, "switch_near_ties": near,
            "gaps": gaps}


def gap_quantiles(gaps) -> dict:
    """The compared quantiles of the sampled pose gaps: the median, and the
    90th percentile, which a fault on a tenth of the frames or more moves."""
    if not gaps:
        return {"pose_gap_median_m": 0.0, "pose_gap_p90_m": 0.0}
    return {"pose_gap_median_m": float(np.median(gaps)), "pose_gap_p90_m": float(np.percentile(gaps, 90))}


def odometry_chain(frames: Frames, scans: List[int], stamps: List[float], odo: dict,
                   project: bool) -> OdometryRecord:
    """The reference's own odometry over the scans, as the program runs it:
    each frame matched against the keyframe from the previous relative
    pose, the convergence gate, the keyframe rule (the control's producer)."""
    rec = OdometryRecord(scan=[scans[0]], stamp=[stamps[0]], odom=[np.eye(4)], keyframe=[0],
                         switched=[True], converged=[True])
    k, prev = 0, np.eye(4)
    for p in range(1, len(scans)):
        T, ok = align_frame(frames, scans[k], scans[p], prev)
        trans = T if ok else prev
        if project:
            trans = G.project_so3(torch.as_tensor(trans)).numpy()
        odom = rec.odom[k] @ trans
        switch = _decide(trans, ok, stamps[p] - stamps[k], odo)[0]
        rec.scan.append(scans[p])
        rec.stamp.append(stamps[p])
        rec.odom.append(odom)
        rec.keyframe.append(k)
        rec.switched.append(switch)
        rec.converged.append(ok)
        if switch:
            k, prev = p, np.eye(4)
        elif ok:
            prev = trans
    return rec


def reference_floors(rec: OdometryRecord, frames: Frames, positions, fl: dict, capacity: int) -> dict:
    """The reference's floor coefficients (or None) and band points at
    ``positions`` of one job: the detector runs on every frame of the job up
    to the last of them, its generator drawing for each frame whose band
    holds enough points, as the detector under judgement draws."""
    want, out = set(positions), {}
    draw = F.triplet_drawer(fl, capacity, frames.device)
    for p in range(max(want, default=-1) + 1):
        out_p = F.detect(frames.points(rec.scan[p]), fl, capacity, draw)
        if p in want:
            out[p] = out_p
    return out


def floor_shortfall(floors: Dict[int, Optional[np.ndarray]], ref: dict, fl: dict) -> float:
    """The largest shortfall of the program's floor planes against the
    reference's, on the reference's band points."""
    return max((F.shortfall(pts, c, floors.get(p), fl["ransac_distance_thresh"]) for p, (c, pts) in ref.items()),
               default=0.0)


@dataclass
class GraphRecord:
    keyframes: List[int]  # positions of the keyframes in the graph, in order
    poses: np.ndarray  # (K, 4, 4) the program's optimized poses
    floors: List[Optional[np.ndarray]]  # the floor coefficients of the keyframe's edge in the graph, if any
    loops: List[tuple] = field(default_factory=list)  # (i, j, the program's relative pose T_i^-1 T_j)


def reference_graph(g: GraphRecord, rec: OdometryRecord, frames: Frames, inf: dict, floor_stddev: float,
                    floors: dict, fl_thresh: float, device, dtype=torch.float64, loop_huber: float = 1.0):
    """(graph, loop gaps): the graph of those keyframes: odometry edges
    from the recorded poses with the reference's fitness information; a
    floor edge from each keyframe whose floor the graph holds, judged
    against the plane the reference detects (``floors``: position ->
    (coefficients or None, band points)): the program's plane where it holds
    within FLOOR_TIE as many band points (RANSAC's near-ties pick either of
    two planes), else the reference's; and each loop edge the program
    closed, its relative pose the program's (as the odometry edges' are)
    with the reference's fitness information. The gaps are those loop poses
    against the reference's match of the same two clouds from them."""
    odom = []
    for i in range(1, len(g.keyframes)):
        cur, prev = g.keyframes[i], g.keyframes[i - 1]
        meas = _rel(GR.project_rotation(rec.odom[cur]), GR.project_rotation(rec.odom[prev]))
        score = GR.fitness(frames.points(rec.scan[cur]), frames.points(rec.scan[prev]), meas)
        odom.append((i, i - 1, meas, GR.information(score, inf)))
    edges = []
    for i, (k, got) in enumerate(zip(g.keyframes, g.floors)):
        if got is None:
            continue
        ref, pts = floors[k]
        plane = got if F.shortfall(pts, ref, got, fl_thresh) <= FLOOR_TIE else ref
        if plane is not None:
            edges.append((i, np.asarray(plane, dtype=np.float64), np.eye(3) / floor_stddev))
    loops, gaps = [], []
    for i, j, meas in g.loops:
        a, b = rec.scan[g.keyframes[i]], rec.scan[g.keyframes[j]]
        T, _ = align_frame(frames, a, b, meas)
        gaps.append(float(G.pose_gap(torch.as_tensor(meas), torch.as_tensor(T), LEVER_M)))
        loops.append((i, j, meas, GR.information(GR.fitness(frames.points(a), frames.points(b), meas), inf)))
    graph = GR.Graph(poses=torch.as_tensor(np.asarray(g.poses), dtype=dtype, device=device), odom=odom,
                     floors=edges, loops=loops, loop_huber=loop_huber)
    return graph, gaps


def judge_graph(g: GraphRecord, rec: OdometryRecord, frames: Frames, inf: dict, floor_stddev: float,
                floors: dict, fl_thresh: float, loop_huber: float):
    """(how far the reference's solve moves the program's optimized poses,
    the loop edges' gaps)."""
    graph, gaps = reference_graph(g, rec, frames, inf, floor_stddev, floors, fl_thresh, frames.device,
                                  loop_huber=loop_huber)
    return GR.move(graph.poses, graph, LEVER_M), gaps


def keyframes_of(rec: OdometryRecord, backend: dict) -> List[int]:
    """The positions the backend's keyframe updater admits from the poses."""
    out, last = [], None
    for p, T in enumerate(rec.odom):
        T = GR.project_rotation(T)
        if last is None:
            out.append(p)
            last = T
            continue
        d = _rel(last, T)
        da = float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)))
        if np.linalg.norm(d[:3, 3]) >= backend["keyframe_delta_trans"] or da >= backend["keyframe_delta_angle"]:
            out.append(p)
            last = T
    return out
