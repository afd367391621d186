"""Exact brute-force nearest-neighbour search (port of hdl_graph_slam_tpu/ops/knn.py
and of the TPU kernel hdl_graph_slam_tpu/ops/pallas_nn.py).

Three functions have hand-written Hopper kernels (csrc/knn.cu), each with its
plain PyTorch twin here:

- ``nn1``: exact 1-NN, the function of the TPU kernel ``nn1_pallas`` and of
  the XLA ``nn1``. GICP association runs it at every re-association.
- ``knn_select``: the exact k nearest neighbours (k = 10, 20 or 21 on the
  card), the port's counterpart of ``knn_approx`` as GICP preprocessing
  calls it (neighbour set only, with the expanded-form distances). Exact
  selection is a superset of the 0.85 recall ``knn_approx`` guarantees.
  ``knn`` (the XLA ``knn``: floor normals, the statistical outlier filter)
  is ``knn_select`` plus an exact rescore in plain PyTorch.
- ``radius_count``: targets strictly within a radius (the radius outlier
  filter).

Both also have a batched form (``nn1_batched``, ``knn_select_batched``): B
independent problems, each query set against its own target, in one launch
(the batch is the kernels' grid y dimension). Callers whose B query sets
share one target flatten them into one unbatched call instead.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. Each wrapper
counts its kernel launches in ``<wrapper>.launches``; ``knn_select`` also
counts them per k in ``knn_select.launches_k``.

Selection arithmetic (both versions): coordinates are centred on the bounding
box of the valid targets (|x| < 1e5 on every axis) and ranked by
d = |t|^2 - 2 q.t in float32, never TF32: NN selection precision is a
correctness surface (package docstring). The lowest index wins ties.

``launch_info`` reports the kernels' launch plans (grid, shared memory,
occupancy) on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import kernels

_VALID_ABS = 1.0e5


def _bbox_center(target: torch.Tensor) -> torch.Tensor:
    """Midpoint of the valid targets' bounding box (0 on an axis with none)."""
    valid = (target.abs() < _VALID_ABS).all(dim=-1, keepdim=True)
    lo = torch.where(valid, target, _VALID_ABS).amin(dim=0)
    hi = torch.where(valid, target, -_VALID_ABS).amax(dim=0)
    return torch.where(hi >= lo, 0.5 * (lo + hi), 0.0)


def _check(name: str, query: torch.Tensor, target: torch.Tensor) -> None:
    for what, x in (("query", query), ("target", target)):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name}: {what} must be (n, 3) float32, got {tuple(x.shape)} {x.dtype}")
    if query.device != target.device:
        raise ValueError(f"{name}: query on {query.device}, target on {target.device}")
    if query.shape[0] == 0 or target.shape[0] == 0:
        raise ValueError(f"{name}: empty query or target")


def _stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device, as the raw pointer the C entry
    points take (without building a torch.cuda.Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def nn1_plain(query: torch.Tensor, target: torch.Tensor, chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch exact 1-NN: the same centring and expansion as the
    kernel, min plus masked-iota argmin (lowest index among ties), then the
    exact squared distance of the winner."""
    center = _bbox_center(target)
    tc = target - center
    t_norm2 = (tc * tc).sum(-1)
    cols = torch.arange(target.shape[0], dtype=torch.int32, device=target.device)
    idx = []
    for qc in torch.split(query - center, chunk):
        d = -2.0 * (qc @ tc.T) + t_norm2
        dmin = d.amin(dim=-1, keepdim=True)
        idx.append(torch.where(d <= dmin, cols, 2**30).amin(dim=-1))
    idx = torch.clamp(torch.cat(idx), max=target.shape[0] - 1)
    diff = query - target[idx]
    return idx, (diff * diff).sum(-1)


def nn1(query: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: for each query row the index (int32) of the closest target
    row and the exact squared distance. query (N,3), target (M,3) float32 with
    PAD_COORD sentinels in invalid rows -> (N,), (N,)."""
    _check("nn1", query, target)
    if query.device.type == "cpu":
        return nn1_plain(query, target)
    if query.device.type != "cuda":
        raise ValueError(f"nn1: unsupported device {query.device}")
    query, target = query.contiguous(), target.contiguous()
    n, m = query.shape[0], target.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=query.device)
    dist2 = torch.empty(n, dtype=torch.float32, device=query.device)
    lib = kernels.load("knn")
    stream = _stream(query)
    kernels.check(lib.hgs_nn1(query.data_ptr(), n, target.data_ptr(), m,
                              idx.data_ptr(), dist2.data_ptr(), stream), "nn1")
    nn1.launches += 1
    return idx, dist2


nn1.launches = 0


# the k the kernel is compiled for: GICP's correspondence_randomness (20), the
# floor normals (10) and the statistical outlier filter's mean_k + 1 (21)
KNN_SELECT_KS = (10, 20, 21)


def _lex_key(d: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (d, column): the float32 bits mapped to an
    order-preserving int32 in the high word, the column in the low word."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)  # + 0.0 turns -0.0 into +0.0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    return (ordered << 32) | cols


def knn_select_plain(query: torch.Tensor, target: torch.Tensor, k: int,
                     chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch exact k-NN selection: the same centring and expansion
    as the kernel, then ``torch.topk`` on (distance, index) keys, so the
    lowest index wins exact ties as in the kernel and ``lax.top_k``. Returns
    idx (N,k) int32 and the distances |t|^2 - 2 q.t + |q|^2 of the centred
    coordinates, ascending."""
    center = _bbox_center(target)
    tc = target - center
    t_norm2 = (tc * tc).sum(-1)
    idx, dist = [], []
    for qc in torch.split(query - center, chunk):
        d = -2.0 * (qc @ tc.T) + t_norm2
        cand = torch.topk(_lex_key(d), k, dim=-1, largest=False, sorted=True).indices
        idx.append(cand.to(torch.int32))
        dist.append(d.gather(-1, cand) + (qc * qc).sum(-1, keepdim=True))
    return torch.cat(idx), torch.cat(dist)


def knn_select(query: torch.Tensor, target: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact k nearest targets of each query: idx (N,k) int32 ordered by
    distance, with the expanded-form squared distances (N,k). Used where the
    consumer needs the neighbour SET (GICP covariances).

    Speed, not the result, depends on the row order: the kernel scans the
    targets of query row i from a little before target row i, wrapping
    around. It is fast when the cloud is its own query in a spatially
    coherent row order (GICP preprocessing passes the prefilter's voxel-key
    output), since the true neighbours then come first; other orders pass
    more candidates to its merges (PERF.md has both times)."""
    _check("knn_select", query, target)
    if not 0 < k <= target.shape[0]:
        raise ValueError(f"knn_select: k={k} with {target.shape[0]} targets")
    if query.device.type == "cpu":
        return knn_select_plain(query, target, k)
    if query.device.type != "cuda":
        raise ValueError(f"knn_select: unsupported device {query.device}")
    if k not in KNN_SELECT_KS:
        raise ValueError(f"knn_select: the kernel is built for k in {KNN_SELECT_KS}, not {k}")
    query, target = query.contiguous(), target.contiguous()
    n, m = query.shape[0], target.shape[0]
    idx = torch.empty((n, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((n, k), dtype=torch.float32, device=query.device)
    lib = kernels.load("knn")
    stream = _stream(query)
    kernels.check(lib.hgs_knn_select(query.data_ptr(), n, target.data_ptr(), m, k,
                                     idx.data_ptr(), dist.data_ptr(), stream), "knn_select")
    knn_select.launches += 1
    knn_select.launches_k[k] += 1
    return idx, dist


knn_select.launches = 0
knn_select.launches_k = dict.fromkeys(KNN_SELECT_KS, 0)


def _check_batched(name: str, query: torch.Tensor, target: torch.Tensor) -> None:
    for what, x in (("query", query), ("target", target)):
        if x.dtype != torch.float32 or x.ndim != 3 or x.shape[2] != 3:
            raise ValueError(f"{name}: {what} must be (B, n, 3) float32, got {tuple(x.shape)} {x.dtype}")
    if query.shape[0] != target.shape[0]:
        raise ValueError(f"{name}: batch {query.shape[0]} of queries vs {target.shape[0]} of targets")
    if query.device != target.device:
        raise ValueError(f"{name}: query on {query.device}, target on {target.device}")
    if 0 in query.shape[:2] or target.shape[1] == 0:
        raise ValueError(f"{name}: empty batch, query or target")
    if query.shape[0] > MAX_BATCH:
        raise ValueError(f"{name}: batch {query.shape[0]} above {MAX_BATCH}")


MAX_BATCH = 65535  # the kernels' grid y dimension


def nn1_batched_plain(query: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``nn1_batched``: ``nn1_plain`` on each problem."""
    out = [nn1_plain(q, t) for q, t in zip(query, target)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def nn1_batched(query: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of B independent problems in one launch: query (B,n,3)
    against target (B,m,3), each problem centred on its own targets ->
    idx (B,n) int32, dist2 (B,n). Row b equals ``nn1(query[b], target[b])``."""
    _check_batched("nn1_batched", query, target)
    if query.device.type == "cpu":
        return nn1_batched_plain(query, target)
    if query.device.type != "cuda":
        raise ValueError(f"nn1_batched: unsupported device {query.device}")
    query, target = query.contiguous(), target.contiguous()
    b, n, m = query.shape[0], query.shape[1], target.shape[1]
    idx = torch.empty((b, n), dtype=torch.int32, device=query.device)
    dist2 = torch.empty((b, n), dtype=torch.float32, device=query.device)
    lib = kernels.load("knn")
    kernels.check(lib.hgs_nn1_batched(query.data_ptr(), b, n, target.data_ptr(), m,
                                      idx.data_ptr(), dist2.data_ptr(), _stream(query)), "nn1_batched")
    nn1_batched.launches += 1
    return idx, dist2


nn1_batched.launches = 0


def knn_select_batched_plain(query: torch.Tensor, target: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``knn_select_batched``: ``knn_select_plain`` on each problem."""
    out = [knn_select_plain(q, t, k) for q, t in zip(query, target)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def knn_select_batched(query: torch.Tensor, target: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact k nearest targets of B independent problems in one launch:
    query (B,n,3) against target (B,m,3) -> idx (B,n,k) int32 and the
    expanded-form distances (B,n,k). Row b equals
    ``knn_select(query[b], target[b], k)``; the same row-order remark holds
    for its speed."""
    _check_batched("knn_select_batched", query, target)
    if not 0 < k <= target.shape[1]:
        raise ValueError(f"knn_select_batched: k={k} with {target.shape[1]} targets")
    if query.device.type == "cpu":
        return knn_select_batched_plain(query, target, k)
    if query.device.type != "cuda":
        raise ValueError(f"knn_select_batched: unsupported device {query.device}")
    if k not in KNN_SELECT_KS:
        raise ValueError(f"knn_select_batched: the kernel is built for k in {KNN_SELECT_KS}, not {k}")
    query, target = query.contiguous(), target.contiguous()
    b, n, m = query.shape[0], query.shape[1], target.shape[1]
    idx = torch.empty((b, n, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((b, n, k), dtype=torch.float32, device=query.device)
    lib = kernels.load("knn")
    kernels.check(lib.hgs_knn_select_batched(query.data_ptr(), b, n, target.data_ptr(), m, k,
                                             idx.data_ptr(), dist.data_ptr(), _stream(query)), "knn_select_batched")
    knn_select_batched.launches += 1
    return idx, dist


knn_select_batched.launches = 0


def launch_info(kernel: str, n: int, m: int, batch: int = 1, k: int = 20) -> dict:
    """The launch plan the C entry point makes for ``kernel`` ("nn1",
    "knn_select" at ``k`` or "radius_count") at n queries and m targets (per
    problem of a batch of ``batch``) on the current CUDA device, with the
    occupancy the runtime reports for it; ``grid_blocks`` is per problem."""
    which = {"nn1": 0, "knn_select": 1, "radius_count": 2}[kernel]
    out = (ctypes.c_int * 7)()
    kernels.check(kernels.load("knn").hgs_knn_launch_info_batched(which, batch, n, m, k, ctypes.addressof(out)),
                  f"{kernel} launch info")
    keys = ("blocks_per_sm", "threads_per_block", "dynamic_smem_bytes", "grid_blocks", "registers_per_thread",
            "stage_rows", "static_smem_bytes")
    info = dict(zip(keys, out))
    info["resident_warps_per_sm"] = info["blocks_per_sm"] * info["threads_per_block"] // 32
    return info


def knn(query: torch.Tensor, target: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN indices and exact squared distances, ascending: query
    (N,3), target (M,3) -> (N,k) int32, (N,k). The XLA ``knn``'s semantics:
    the k nearest by the bbox-centred expanded form, lowest index on ties,
    then the exact difference-form squared distances, stably sorted.

    The selection is ``knn_select``: on CUDA tensors its kernel (k must be
    one of ``KNN_SELECT_KS``), on CPU tensors its plain twin. The rescore
    (gather, exact d², stable sort) is plain PyTorch on either."""
    cand, _ = knn_select(query, target, k)
    diff = query[:, None, :] - target[cand.long()]
    d_sorted, order = torch.sort((diff * diff).sum(-1), dim=-1, stable=True)
    return torch.gather(cand, -1, order), d_sorted


def radius_count_plain(query: torch.Tensor, target: torch.Tensor, radius: float,
                       chunk: int = 512) -> torch.Tensor:
    """Plain twin of ``radius_count``: the same difference form on the
    uncentred coordinates against the same float32 r²."""
    r2 = radius * radius  # compared with float32 distances: rounded to float32, as the kernel's argument
    out = []
    for q in torch.split(query, chunk):
        diff = q[:, None, :] - target[None, :, :]
        out.append(((diff * diff).sum(-1) < r2).sum(-1, dtype=torch.int32))
    return torch.cat(out)


def radius_count(query: torch.Tensor, target: torch.Tensor, radius: float) -> torch.Tensor:
    """Number of targets strictly within ``radius`` of each query row, a
    coincident target (the query itself) included, as PCL's radiusSearch
    counts it: (N,3), (M,3) -> (N,) int32.

    The squared distance is the exact difference form, where the XLA op
    expands |q|² − 2 q·t + |t|²; the two differ only for pairs within the
    expanded form's rounding of r²."""
    _check("radius_count", query, target)
    if query.device.type == "cpu":
        return radius_count_plain(query, target, radius)
    if query.device.type != "cuda":
        raise ValueError(f"radius_count: unsupported device {query.device}")
    query, target = query.contiguous(), target.contiguous()
    n, m = query.shape[0], target.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=query.device)
    lib = kernels.load("knn")
    kernels.check(lib.hgs_radius_count(query.data_ptr(), n, target.data_ptr(), m, radius * radius, out.data_ptr(),
                                       _stream(query)), "radius_count")
    radius_count.launches += 1
    return out


radius_count.launches = 0


def fitness_score(
    target_xyz: torch.Tensor,
    source_xyz: torch.Tensor,
    source_mask: torch.Tensor,
    relpose: torch.Tensor,
    max_range: float = float("inf"),
) -> torch.Tensor:
    """PCL getFitnessScore (information_matrix_calculator.cpp:49-80): mean
    squared 1-NN distance of the transformed source into the target over
    matches with dist <= max_range; +inf when no point matches.

    Batched over a leading dimension B of the source, its mask and relpose:
    with a (M,3) target shared by all B the queries go to one ``nn1`` call,
    with a (B,M,3) target (one per problem) to one ``nn1_batched`` call."""
    moved = source_xyz @ relpose[..., :3, :3].transpose(-1, -2) + relpose[..., None, :3, 3]
    moved = torch.where(source_mask[..., None], moved, 1.0e6)
    if moved.ndim == 2:
        _, d2 = nn1(moved, target_xyz)
    elif target_xyz.ndim == 2:
        _, d2 = nn1(moved.reshape(-1, 3), target_xyz)
        d2 = d2.reshape(moved.shape[:-1])
    else:
        _, d2 = nn1_batched(moved, target_xyz)
    ok = source_mask & (d2 <= max_range)
    nr = ok.sum(-1)
    total = torch.where(ok, d2, 0.0).sum(-1)
    return torch.where(nr > 0, total / torch.clamp(nr, min=1), float("inf"))
