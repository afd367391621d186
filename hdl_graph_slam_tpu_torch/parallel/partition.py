"""Hierarchical submap partitioning for multi-host graph optimization
(port of hdl_graph_slam_tpu/parallel/partition.py).

BASELINE.json config #5 calls for keyframes/map blocks partitioned per host
on long sequences. The reference has no equivalent (single-process g2o);
this module supplies the standard submap hierarchy, laid out so each level
maps onto the hardware:

1. **Partition**: keyframes split into contiguous blocks of ``block_size``,
   each based at its first pose or, where it holds one, at its globally
   fixed pose (``_based_at_fixed``; the JAX package always at the first).
2. **Intra-block refinement** (embarrassingly parallel — one block per host
   or per device): each block's subgraph is optimized with its base pose
   fixed, yielding refined poses relative to the block base. The subgraph
   contains the se3_se3 edges interior to the block PLUS every unary prior
   (GPS xy/xyz, IMU vec/quat) and fixed-plane (floor) edge on its poses,
   re-expressed exactly in the block-base frame (see `_subgraph`).
3. **Condensed inter-block graph** (tiny — one SE3 node per block): every
   cross-block se3_se3 edge is re-expressed as a constraint between block
   bases using the refined local poses, and each block's prior edges are
   condensed into ONE SE3 anchor edge on its base carrying the exact
   Gauss-Newton quadratic of those priors (see `_condense_priors`); a
   global LM solves block placements.
4. **Composition**: global pose = optimized base @ refined local pose.

This is an approximation of the joint optimum (exact when intra-block
estimates are locally rigid), converging to it as blocks are re-refined;
`hierarchical_optimize` supports multiple rounds.

Prior-edge handling (round-3 fix — previously floor/GPS/IMU edges were
silently DROPPED from both levels, so a GPS-aided run in submap mode
ignored GPS):

- Intra-block, with base pose ``B = [R|t]`` held fixed and local poses
  ``L = B^-1 T``:
  * se3_prior_xyz ``t(BL) - m``  ==  R * (t(L) - R^T (m - t)): a LOCAL
    xyz prior with meas ``R^T (m - t)`` and info ``R^T W R`` — exact.
  * se3_prior_xy: same device via a rank-2 xyz prior (info ``R^T P^T W2
    P R`` with P the xy-selector) — exact.
  * se3_prior_vec ``R(BL)^T d - m  ==  R(L)^T (R^T d) - m``: a local vec
    prior with direction ``R^T d`` — exact.
  * se3_prior_quat: local quat prior with meas ``quat(R^T R_m)`` — exact
    zero set; first-order-equivalent chi2 (the g2o vec-difference residual
    is not left-equivariant; its wiring uses isotropic info, for which the
    approximation is second-order).
  * se3_plane to a FIXED plane p: local fixed plane node ``B^T p``
    (= plane transformed by B^-1), measurement unchanged — exact.
- Inter-block: each block's priors, with refined locals frozen, define a
  6-dof Gauss-Newton quadratic (H_b, b_b) in the base's right-increment.
  It is attached as one se3_se3 edge between the base and a fixed identity
  anchor node: measurement ``(B @ exp(-pinv(H_b) b_b))^-1`` (the GN
  optimum of the quadratic) and information ``J^-T H_b J^-1`` where J is
  the edge's own Jacobian wrt the base increment — so the condensed solve
  sees exactly the priors' gradient and Gauss-Newton Hessian at the
  linearization point.

Edges the hierarchy cannot condense (plane-plane constraints, plane
priors, se3_point_xyz landmarks, se3_plane to a NON-fixed plane) trigger a
final full-graph LM refinement pass warm-started from the hierarchical
solution (`_needs_dense_fallback`); the production backend only ever
creates the supported kinds (hdl_graph_slam_nodelet.cpp:234-500 wires
se3_se3 + priors + the single fixed floor plane).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..core import se3
from ..core.device import resolve_device
from ..graph import edges as E
from ..graph.linearize import chi2_only
from ..graph.robust import rho_and_weight
from ..graph.solver import optimize as graph_optimize
from ..graph.types import GraphBuilder

_PRIOR_TYPES = ("se3_prior_xy", "se3_prior_xyz", "se3_prior_vec", "se3_prior_quat")
_UNSUPPORTED_TYPES = (
    "plane_prior_normal",
    "plane_prior_distance",
    "plane_identity",
    "plane_parallel",
    "plane_perpendicular",
    "se3_point_xyz",
)


@dataclasses.dataclass
class Block:
    pose_ids: List[int]  # global pose indices, contiguous
    base_id: int  # the block's base: its first pose, or its fixed one (_based_at_fixed)


def partition_poses(num_poses: int, block_size: int, offset: int = 0) -> List[Block]:
    """Contiguous blocks of ``block_size``; with ``offset`` the first block
    has only ``offset`` poses, shifting every later boundary. Alternating
    offsets between rounds moves block-boundary poses (whose priors act
    only through the condensed level) into block interiors."""
    blocks = []
    start = 0
    while start < num_poses:
        size = offset if (start == 0 and 0 < offset < min(block_size, num_poses)) else block_size
        ids = list(range(start, min(start + size, num_poses)))
        blocks.append(Block(pose_ids=ids, base_id=ids[0]))
        start += size
    return blocks


def _based_at_fixed(blocks: List[Block], pose_fixed: List[bool]) -> List[Block]:
    """Base each block that holds a globally fixed pose at (the first such)
    pose. A block with a fixed pose is fixed in the condensed graph, so its
    base never moves; based at its first pose, that pose would never move
    either. The backend's anchor node (node 1, fixed, tied to the first
    keyframe by a weak edge) shares a block with the first keyframe, which
    then stayed at its odometry pose while the floor edges lifted the other
    keyframes onto the fixed floor plane, 1.8 m above it on golden_town.
    Based at the anchor, the first keyframe is refined like any other. The
    JAX package bases every block at its first pose; the two agree wherever
    a block's fixed pose is its first (tests/test_torch_parallel.py)."""
    for block in blocks:
        fixed = [g for g in block.pose_ids if pose_fixed[g]]
        if fixed:
            block.base_id = fixed[0]
    return blocks


def _quat_from_mat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), numpy (Shepperd)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2.0
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _plane_in_base_frame(base: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Global plane (n, d) expressed in the block-base frame: (R^T n, d + t.n)
    (= planelib.transform(inv(base), coeffs); normal stays unit)."""
    R, t = base[:3, :3], base[:3, 3]
    return np.concatenate([R.T @ coeffs[:3], [coeffs[3] + t @ coeffs[:3]]])


def _copy_edge_kernel(sub: GraphBuilder, etype: str, row: dict) -> None:
    sub.edge_rows[etype][-1]["kernel_id"] = row["kernel_id"]
    sub.edge_rows[etype][-1]["kernel_delta"] = row["kernel_delta"]


def _subgraph(builder: GraphBuilder, block: Block) -> Tuple[GraphBuilder, Dict[int, int]]:
    """Intra-block subgraph: interior se3_se3 edges plus this block's unary
    priors and fixed-plane edges re-expressed in the base frame (module
    docstring derivations). The block base is fixed, as is any pose fixed
    in the parent graph (e.g. the backend's anchor node).

    Returns (sub-builder, global->local id map).
    """
    id_map = {g: i for i, g in enumerate(block.pose_ids)}
    sub = GraphBuilder()
    base_pose = builder.poses[block.base_id]
    base_inv = np.linalg.inv(base_pose)
    R, t = base_pose[:3, :3], base_pose[:3, 3]
    for g in block.pose_ids:
        sub.add_se3_node(base_inv @ builder.poses[g], fixed=(g == block.base_id) or builder.pose_fixed[g])
    for row in builder.edge_rows["se3_se3"]:
        vi, vj = row["vi"], row["vj"]
        if vi in id_map and vj in id_map:
            sub._add_edge("se3_se3", id_map[vi], id_map[vj], row["meas"], row["info"])
            _copy_edge_kernel(sub, "se3_se3", row)

    for row in builder.edge_rows["se3_prior_xyz"]:
        if row["vi"] in id_map:
            sub.edge_rows["se3_prior_xyz"].append(
                dict(row, vi=id_map[row["vi"]], meas=R.T @ (row["meas"] - t), info=R.T @ row["info"] @ R)
            )
    P = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    for row in builder.edge_rows["se3_prior_xy"]:
        if row["vi"] in id_map:
            m3 = np.array([row["meas"][0], row["meas"][1], builder.poses[row["vi"]][2, 3]])
            sub.edge_rows["se3_prior_xyz"].append(
                dict(
                    row,
                    vi=id_map[row["vi"]],
                    meas=R.T @ (m3 - t),
                    info=R.T @ (P.T @ row["info"] @ P) @ R,
                )
            )
    for row in builder.edge_rows["se3_prior_vec"]:
        if row["vi"] in id_map:
            meas6 = row["meas"].copy()
            meas6[:3] = R.T @ meas6[:3]
            sub.edge_rows["se3_prior_vec"].append(dict(row, vi=id_map[row["vi"]], meas=meas6))
    for row in builder.edge_rows["se3_prior_quat"]:
        if row["vi"] in id_map:
            qm = row["meas"]
            Rm = _quat_to_mat_np(qm)
            ql = _quat_from_mat_np(R.T @ Rm)
            if ql[0] < 0:
                ql = -ql
            sub.edge_rows["se3_prior_quat"].append(dict(row, vi=id_map[row["vi"]], meas=ql))

    plane_local: Dict[int, int] = {}
    for row in builder.edge_rows["se3_plane"]:
        if row["vi"] in id_map and builder.plane_fixed[row["vj"]]:
            pg = row["vj"]
            if pg not in plane_local:
                plane_local[pg] = sub.add_plane_node(_plane_in_base_frame(base_pose, builder.planes[pg]), fixed=True)
            sub.edge_rows["se3_plane"].append(dict(row, vi=id_map[row["vi"]], vj=plane_local[pg]))
    return sub, id_map


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _needs_dense_fallback(builder: GraphBuilder) -> bool:
    if any(builder.edge_rows[t] for t in _UNSUPPORTED_TYPES):
        return True
    return any(not builder.plane_fixed[row["vj"]] for row in builder.edge_rows["se3_plane"])


def _condense_priors(
    builder: GraphBuilder,
    blocks: List[Block],
    local_poses: Dict[int, np.ndarray],
    block_of: Dict[int, int],
    device: torch.device,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Per-block Gauss-Newton quadratic of all prior/fixed-plane edges.

    For each prior on pose g in block b, the residual as a function of the
    base right-increment xi is r(base @ exp(xi) @ L_g) with L_g frozen at
    its refined value. Returns {block: (H_b 6x6, b_b 6)} accumulated over
    the block's priors, including first-order robust reweighting (the same
    rho' scaling graph/linearize.py applies). One batched program per edge
    type (``torch.func.vmap`` of ``jacfwd``, float64 on ``device``), not one
    dispatch per edge; the per-block sums run on the host in row order.
    """
    out: Dict[int, List[np.ndarray]] = {}

    def accumulate(etype, rfn, extra_of_row=None, row_filter=None):
        rows = [r for r in builder.edge_rows[etype] if r["vi"] in block_of and (row_filter is None or row_filter(r))]
        if not rows:
            return

        def t64(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(device)

        bases = t64(np.stack([builder.poses[blocks[block_of[r["vi"]]].base_id] for r in rows]))
        locs = t64(np.stack([local_poses[r["vi"]] for r in rows]))
        meas = t64(np.stack([r["meas"] for r in rows]))
        info = t64(np.stack([r["info"] for r in rows]))
        kid = torch.tensor([r["kernel_id"] for r in rows], dtype=torch.int64, device=device)
        kdelta = t64([r["kernel_delta"] for r in rows])
        extra = t64(np.stack([extra_of_row(r) for r in rows]) if extra_of_row else np.zeros((len(rows), 1)))

        def one(Bb, L, m, ex, z):
            def rf(xi):
                r = rfn(se3.compose(se3.compose(Bb, se3.mqt_exp(xi)), L), m, ex)
                return r, r

            return jacfwd(rf, has_aux=True)(z)

        J, r = vmap(one)(bases, locs, meas, extra, torch.zeros(len(rows), 6, dtype=torch.float64, device=device))
        chi2 = torch.einsum("ei,eij,ej->e", r, info, r)
        _, w = rho_and_weight(chi2, kid, kdelta)
        wi = info * w[:, None, None]
        He = torch.einsum("eia,eij,ejb->eab", J, wi, J).cpu().numpy()
        be = torch.einsum("eia,eij,ej->ea", J, wi, r).cpu().numpy()
        for k, row in enumerate(rows):
            b = block_of[row["vi"]]
            if b not in out:
                out[b] = [np.zeros((6, 6)), np.zeros(6)]
            out[b][0] += He[k]
            out[b][1] += be[k]

    accumulate("se3_prior_xyz", lambda T, m, ex: E.se3_prior_xyz(T, m))
    accumulate("se3_prior_xy", lambda T, m, ex: E.se3_prior_xy(T, m))
    accumulate("se3_prior_vec", lambda T, m, ex: E.se3_prior_vec(T, m))
    accumulate("se3_prior_quat", lambda T, m, ex: E.se3_prior_quat(T, m))
    accumulate(
        "se3_plane",
        lambda T, m, ex: E.se3_plane(T, ex, m),
        extra_of_row=lambda r: builder.planes[r["vj"]],
        row_filter=lambda r: builder.plane_fixed[r["vj"]],  # non-fixed planes go to the dense fallback
    )
    return {b: (Hb, bb) for b, (Hb, bb) in out.items()}


def _anchor_edge(Bhat: np.ndarray, Hb: np.ndarray, bb: np.ndarray, device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """The se3_se3 edge (base -> fixed identity anchor) carrying a block's
    prior quadratic: measurement ``(Bhat exp(-pinv(H_b) b_b))^-1`` and
    information ``W = J^-T H_b J^-1``, J the edge's own Jacobian in the
    base's increment (numpy float64 but for J and the exponential)."""
    delta = -np.linalg.pinv(Hb, rcond=1e-12) @ bb
    dt = torch.from_numpy(delta).to(device)
    Bstar = Bhat @ se3.mqt_exp(dt).cpu().numpy()
    meas = np.linalg.inv(Bstar)
    Bh, m = torch.from_numpy(Bhat).to(device), torch.from_numpy(meas).to(device)
    eye = torch.eye(4, dtype=torch.float64, device=device)
    J = jacfwd(lambda xi: E.se3_se3(se3.compose(Bh, se3.mqt_exp(xi)), eye, m))(torch.zeros_like(dt))
    Ji = np.linalg.inv(J.cpu().numpy())
    W = Ji.T @ Hb @ Ji
    return meas, 0.5 * (W + W.T)


def _gauge_edge(bases: List[np.ndarray], quads: Dict[int, Tuple[np.ndarray, np.ndarray]], device: torch.device,
                weight: float = 1e6) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The se3_se3 edge (block 0's base -> the fixed identity anchor) that
    pins the global motions the priors leave free, or None when they pin
    all six. A graph with no fixed pose whose only priors are floor edges
    (the CLI's ``outdoor`` graph) is free in world x, y and yaw. The
    condensed anchor edges are the priors' quadratics at the bases, so far
    from the bases such a motion changes their chi2 a little: the condensed
    LM then crawls along it for hundreds of iterations, and a rounding-level
    change of the input moves the result by ~1e-5 m. The free motions are the
    null space of the priors' information over a motion applied to every
    base, ``H_tau = sum_b A_b^T H_b A_b`` (A_b the base's right increment of
    that motion); the edge's information is ``weight`` on that null space,
    mapped through the edge's Jacobian in the same motion, and its residual
    is zero at the base. (The JAX package adds no such edge: it fixes base 0
    only in a graph with no prior.)"""
    def t64(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(device)

    z = torch.zeros(6, dtype=torch.float64, device=device)
    H = np.zeros((6, 6))
    for bi, (Hb, _) in quads.items():
        B = t64(bases[bi])
        A = jacfwd(lambda tau: se3.mqt_log(se3.compose(se3.compose(se3.inverse(B), se3.mqt_exp(tau)), B)))(z)
        A = A.cpu().numpy()
        H += A.T @ Hb @ A
    evals, evecs = np.linalg.eigh(0.5 * (H + H.T))
    null = evecs[:, evals <= 1e-9 * max(float(evals.max()), 1e-300)]
    if null.shape[1] == 0:
        return None
    meas = np.linalg.inv(bases[0])
    B0, m = t64(bases[0]), t64(meas)
    eye = torch.eye(4, dtype=torch.float64, device=device)
    M = jacfwd(lambda tau: E.se3_se3(se3.compose(se3.mqt_exp(tau), B0), eye, m))(z).cpu().numpy()
    Mi = np.linalg.inv(M)
    W = weight * Mi.T @ null @ null.T @ Mi
    return meas, 0.5 * (W + W.T)


def hierarchical_optimize(
    builder: GraphBuilder,
    block_size: int = 64,
    intra_iterations: int = 50,
    inter_iterations: int = 100,
    rounds: int = 1,
    final_refine_iterations: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> None:
    """Optimize ``builder`` in place via the submap hierarchy, every solve in
    float64 on ``device`` (None = cuda).

    Each intra-block solve is independent — in a multi-host deployment each
    host runs the solves for its resident blocks (the block subgraphs are
    exactly the per-host keyframe shards); only the condensed base graph
    (one pose per block) needs global communication.

    ``final_refine_iterations``: iterations for the full-graph LM pass run
    after the hierarchy when the graph contains edge types the hierarchy
    cannot condense (None = auto: ``inter_iterations`` when such edges
    exist, else skipped).
    """
    dev = resolve_device(device)
    n = len(builder.poses)
    if n == 0:
        return

    def full_chi2() -> float:
        return float(chi2_only(builder.freeze(device=dev))[1])

    has_priors = any(builder.edge_rows[t] for t in _PRIOR_TYPES) or any(
        builder.plane_fixed[row["vj"]] for row in builder.edge_rows["se3_plane"]
    )

    # monotone safeguard: block-coordinate rounds can oscillate around the
    # joint optimum; keep the best full-graph chi2 iterate (chi2_only is one
    # cheap no-Jacobian pass per round)
    best_chi2 = full_chi2()
    best_poses = [p.copy() for p in builder.poses]

    for round_idx in range(rounds):
        # alternate block boundaries so every pose is a block INTERIOR in
        # half the rounds (boundary bases are fixed intra-block, so their
        # priors only act through the condensed linearization)
        blocks = _based_at_fixed(partition_poses(n, block_size, offset=(round_idx % 2) * (block_size // 2)),
                                 builder.pose_fixed)
        # --- intra-block refinement (parallel axis) ------------------------
        local_poses: Dict[int, np.ndarray] = {}
        block_of: Dict[int, int] = {}
        for bi, block in enumerate(blocks):
            sub, id_map = _subgraph(builder, block)
            if sub.num_edges > 0:
                data, _ = graph_optimize(sub.freeze(device=dev), max_iterations=intra_iterations)
                sub.update_estimates(data)
            for g, l in id_map.items():
                local_poses[g] = sub.poses[l]
                block_of[g] = bi

        # --- condensed inter-block graph ----------------------------------
        cond = GraphBuilder()
        for block in blocks:
            fixed = any(builder.pose_fixed[g] for g in block.pose_ids)
            cond.add_se3_node(builder.poses[block.base_id], fixed=fixed)
        if not any(cond.pose_fixed) and not has_priors:
            cond.set_pose_fixed(0, True)  # gauge anchor when nothing else pins it
        n_inter = 0
        for row in builder.edge_rows["se3_se3"]:
            vi, vj = row["vi"], row["vj"]
            if vi not in block_of or vj not in block_of:
                continue
            bi, bj = block_of[vi], block_of[vj]
            if bi == bj:
                continue
            # edge residual zero when meas = Ti^-1 Tj with Ti = Bi Li:
            # base-level measurement M' satisfying  M' = Li * meas * Lj^-1
            meas_base = local_poses[vi] @ row["meas"] @ np.linalg.inv(local_poses[vj])
            cond.add_se3_edge(bi, bj, meas_base, row["info"])
            n_inter += 1

        if has_priors:
            quads = _condense_priors(builder, blocks, local_poses, block_of, dev)
            if quads:
                anchor = cond.add_se3_node(np.eye(4), fixed=True)
                for bi, (Hb, bb) in sorted(quads.items()):
                    meas, W = _anchor_edge(builder.poses[blocks[bi].base_id], Hb, bb, dev)
                    cond.add_se3_edge(bi, anchor, meas, W)
                    n_inter += 1
                gauge = None if any(cond.pose_fixed[:len(blocks)]) else _gauge_edge(
                    [builder.poses[b.base_id] for b in blocks], quads, dev)
                if gauge is not None:
                    cond.add_se3_edge(0, anchor, *gauge)

        if n_inter > 0 and (len(blocks) > 1 or has_priors):
            data, _ = graph_optimize(cond.freeze(device=dev), max_iterations=inter_iterations)
            cond.update_estimates(data)

        # --- composition ---------------------------------------------------
        for g in range(n):
            bi = block_of.get(g)
            if bi is None or builder.pose_fixed[g]:
                continue  # globally fixed poses never move
            builder.poses[g] = cond.poses[bi] @ local_poses[g]

        chi2 = full_chi2()
        if chi2 < best_chi2:
            best_chi2 = chi2
            best_poses = [p.copy() for p in builder.poses]

    for g in range(n):
        builder.poses[g] = best_poses[g]

    if _needs_dense_fallback(builder):
        iters = inter_iterations if final_refine_iterations is None else final_refine_iterations
        if iters > 0:
            data, _ = graph_optimize(builder.freeze(device=dev), max_iterations=iters)
            builder.update_estimates(data)
