"""The edge-sharded pose-graph LM across processes (port of
hdl_graph_slam_tpu/parallel/multihost.py), on ``torch.distributed``.

Every process holds the same full graph, linearizes its contiguous block of
every edge table, and all-reduces (SUM) H, b and both chi2 values in each
iteration; the damped solve and the update then run in every process on the
same sums, so every process keeps the same estimates. This is the JAX
package's ``shard_map`` with ``psum`` over a mesh that spans processes; its
collectives are XLA's, these are ``torch.distributed``'s.

Usage (the same in every process):

    initialize("tcp://host:port", num_processes, process_id, device="cuda:0")
    out, stats = distributed_optimize_multihost(data, max_iterations=...)

The process group's backend follows the device (NCCL for CUDA, gloo for the
CPU) unless ``backend`` names one; nothing switches the backend or the
device when one fails. NCCL takes one process per GPU; two processes on one
GPU must ask for gloo, whose all-reduce takes CUDA tensors.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import torch
import torch.distributed as tdist

from ..core.device import resolve_device
from ..graph.solver import OptimizeStats, optimize
from ..graph.types import GraphData
from .dist import ShardedLinearizer, _edges_to, shard_edges


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device: Optional[Union[str, torch.device]] = None, backend: Optional[str] = None) -> str:
    """Join the default process group as rank ``process_id`` of
    ``num_processes``. ``coordinator_address`` is ``"host:port"`` (read as
    ``tcp://host:port``) or a URL passed on as it is (``tcp://...``,
    ``file://...``). ``device`` (None = cuda) picks the backend: NCCL for
    CUDA, gloo for the CPU; ``backend`` overrides that. A CUDA device
    without an index becomes this process's card, ``cuda:<local rank>``
    (``local_device_index``), which is made the current device. Returns the
    backend."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_device_index(process_id))
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend=backend, init_method=url, world_size=num_processes, rank=process_id)
    return backend


def local_device_index(process_id: int) -> int:
    """The card of process ``process_id`` on its box: ``LOCAL_RANK`` where
    the launcher sets it (torchrun does), else the rank modulo the box's
    cards, so that the ranks of a box spread over its cards (NCCL refuses
    two ranks on one)."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else process_id % torch.cuda.device_count()


def _all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """One SUM all-reduce of the flattened tensors; every rank gets the same
    bits back."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


def distributed_optimize_multihost(data: GraphData, max_iterations: int = 512) -> Tuple[GraphData, OptimizeStats]:
    """graph.solver.optimize with this process's block of edge rows (block
    ``rank`` of ``world_size``, contiguous in every padded table) and the
    system all-reduced over the default process group each iteration.

    Returns (the graph with the optimized vertices, the stats) as tensors
    on ``data``'s device, the same in every process; ``update_estimates``
    and ``.cpu().numpy()`` read them as they read ``optimize``'s."""
    rank, world = tdist.get_rank(), tdist.get_world_size()
    dev = data.poses.device
    block = shard_edges(data, world)[rank]
    lin = ShardedLinearizer([(dev, _edges_to(block, dev))], home=dev, reduce=_all_reduce_sum)
    return optimize(data, max_iterations=max_iterations, linearizer=lin)
