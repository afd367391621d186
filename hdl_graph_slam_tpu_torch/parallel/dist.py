"""Sharded loop-candidate registration and the edge-sharded pose-graph LM
over a mesh of devices in one process (port of
hdl_graph_slam_tpu/parallel/dist.py).

The reference has no distributed backend (SURVEY.md §2.5). The two scaling
axes of the JAX package, on ``torch.device``s:

1. **Candidate-parallel registration**: the candidate batch of a loop match
   is cut into contiguous slices, one per mesh entry; each entry aligns its
   slice against the replicated target with the batched align.
2. **Edge-parallel linearization**: every edge table is cut into
   contiguous shards, one per mesh entry; each entry linearizes its shard
   into a partial (H, b, chi2) on its device, and the partials are added on
   the first entry's device in shard order, never with float atomics, so
   the sum is the same on every run. The damped solve and the vertex update
   run there, and the estimates are copied to every shard's device each
   iteration (vertices are replicated). The JAX package does this in one
   ``shard_map`` program with a ``psum``.

A ``Mesh`` is an ordered list of devices and may name one device more than
once: several shards on one card, or eight CPU entries in the tests (the JAX
package's eight virtual CPU devices).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..core.device import resolve_device
from ..graph.linearize import Linearizer, apply_delta, build_system, chi2_only, free_dof_mask
from ..graph.solver import OptimizeStats, dense_step, optimize
from ..graph.types import EdgeTable, GraphData


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """``device`` None or ``"cuda"``: the first ``n_devices`` local CUDA
    devices (all of them by default). A device with an index, or the CPU:
    that device ``n_devices`` times (once by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} CUDA devices asked for, {count} present")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    n = 1 if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be >= 1, not {n}")
    return Mesh((dev,) * n)


# ---------------------------------------------------------------------------
# pytrees of tensors (dataclasses, named tuples, tuples, lists, dicts)
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _tree_leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _tree_concat(trees: list, device: torch.device):
    """Leafwise concatenation along the leading axis on ``device``."""
    leaves = [_tree_leaves(t) for t in trees]
    it = iter([torch.cat([ls[i].to(device) for ls in leaves]) for i in range(len(leaves[0]))])
    return _tree_map(lambda _: next(it), trees[0])


# ---------------------------------------------------------------------------
# candidate-parallel registration
# ---------------------------------------------------------------------------


def sharded_candidate_align(mesh: Mesh, tgt_state, srcs, guesses: torch.Tensor, align_fn: Callable):
    """The batched ``align_fn(tgt_state, srcs, guesses)`` with the candidate
    axis cut into contiguous slices, one per mesh entry (as
    ``torch.tensor_split`` cuts; an entry may get none). ``srcs`` is a pytree
    with a leading batch axis K, ``guesses`` (K, 4, 4); the target is
    copied to each entry's device. The results are concatenated on the
    first entry's device; a one-entry mesh on the inputs' device gives
    ``align_fn``'s own output bit for bit."""
    parts = []
    for dev, rows in zip(mesh.devices, torch.arange(guesses.shape[0]).tensor_split(mesh.size)):
        if rows.numel() == 0:
            continue
        lo, hi = int(rows[0]), int(rows[-1]) + 1
        take = lambda x: x[lo:hi].to(dev)  # noqa: E731  (used in this iteration only)
        parts.append(align_fn(_tree_map(lambda x: x.to(dev), tgt_state), _tree_map(take, srcs), take(guesses)))
    return _tree_concat(parts, mesh.devices[0])


# ---------------------------------------------------------------------------
# edge-parallel LM
# ---------------------------------------------------------------------------


def _pad_edges_for_shards(data: GraphData, n_shards: int) -> GraphData:
    """Pad every edge table to a multiple of ``n_shards`` rows with rows that
    add exactly zero: mask False, ``kernel_delta`` 1, vertex 0, zero
    information, and a measurement at which every residual is finite (the
    identity for ``se3_se3``, zeros elsewhere; GraphBuilder.freeze's own
    padding)."""
    edges = {}
    for etype, t in data.edges.items():
        rem = (-t.vi.shape[0]) % n_shards
        if rem == 0:  # empty tables too: every shard gets none
            edges[etype] = t
            continue

        def pad(a, fill=0):
            return torch.cat([a, torch.full((rem,) + a.shape[1:], fill, dtype=a.dtype, device=a.device)])

        if etype == "se3_se3":
            eye = torch.eye(4, dtype=t.meas.dtype, device=t.meas.device).expand(rem, 4, 4)
            meas = torch.cat([t.meas, eye])
        else:
            meas = pad(t.meas)
        edges[etype] = EdgeTable(vi=pad(t.vi), vj=pad(t.vj), meas=meas, info=pad(t.info),
                                 kernel_id=pad(t.kernel_id), kernel_delta=pad(t.kernel_delta, 1),
                                 mask=pad(t.mask, False))
    return data.replace(edges=edges)


def shard_edges(data: GraphData, n_shards: int) -> List[dict]:
    """The edge tables cut into ``n_shards`` contiguous row blocks (after
    ``_pad_edges_for_shards``): shard i holds rows [i E/n, (i+1) E/n)."""
    data = _pad_edges_for_shards(data, n_shards)
    out = [{} for _ in range(n_shards)]
    for etype, t in data.edges.items():
        per = t.vi.shape[0] // n_shards
        for i in range(n_shards):
            out[i][etype] = EdgeTable(*(getattr(t, f.name)[i * per:(i + 1) * per]
                                        for f in dataclasses.fields(EdgeTable)))
    return out


_VERTEX_FIELDS = ("poses", "pose_fixed", "pose_mask", "planes", "plane_fixed", "plane_mask",
                  "points", "point_fixed", "point_mask")


def _edges_to(edges: dict, device: torch.device) -> dict:
    return {k: EdgeTable(*(getattr(t, f.name).to(device) for f in dataclasses.fields(EdgeTable)))
            for k, t in edges.items()}


def _graph_to(data: GraphData, device: torch.device, edges: Optional[dict] = None) -> GraphData:
    """``data``'s vertices on ``device`` (no copy where they lie there
    already), with ``edges`` (default: ``data``'s own, moved as well)."""
    if edges is None:
        edges = _edges_to(data.edges, device)
    return data.replace(edges=edges, **{k: getattr(data, k).to(device) for k in _VERTEX_FIELDS})


class ShardedLinearizer(Linearizer):
    """A Linearizer over edge shards held in this process, each on its own
    device: ``shards`` is a list of (device, edge tables). Each call copies
    the vertices to every shard's device, linearizes each shard there, adds
    the partials on ``home`` in shard order, and hands the sums to
    ``reduce`` (the cross-process all-reduce of parallel/multihost.py), if
    any, which returns them summed over every process. Its copies between
    devices and its collectives keep the LM loop eager."""

    capturable = False

    def __init__(self, shards: Sequence[Tuple[torch.device, dict]], home: torch.device,
                 reduce: Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]] = None):
        self.shards, self.home, self.reduce = list(shards), home, reduce

    def _sum(self, fn, data: GraphData) -> tuple:
        parts = [fn(_graph_to(data, dev, edges)) for dev, edges in self.shards]
        total = [p.to(self.home) for p in parts[0]]
        for part in parts[1:]:
            total = [a + p.to(self.home) for a, p in zip(total, part)]
        if self.reduce is not None:
            total = self.reduce(total)
        return tuple(total)

    def system(self, data: GraphData):
        return self._sum(build_system, data)

    def chi2(self, data: GraphData):
        return self._sum(chi2_only, data)


def _mesh_linearizer(mesh: Mesh, data: GraphData) -> ShardedLinearizer:
    """Shard i of ``data``'s edge tables on ``mesh.devices[i]``."""
    return ShardedLinearizer([(dev, _edges_to(e, dev)) for dev, e in zip(mesh.devices, shard_edges(data, mesh.size))],
                             home=mesh.devices[0])


def distributed_optimize(mesh: Mesh, data: GraphData, max_iterations: int = 512) -> Tuple[GraphData, OptimizeStats]:
    """graph.solver.optimize with edge-sharded linearization over ``mesh``.
    The LM loop runs on the mesh's first device and returns there; the
    result is the single-device optimize's up to the reassociation of the
    shards' sums, and on a one-entry mesh it is that optimize's bit for bit."""
    lin = _mesh_linearizer(mesh, data)
    return optimize(_graph_to(data, mesh.devices[0]), max_iterations=max_iterations, linearizer=lin)


def distributed_lm_step(mesh: Mesh, data: GraphData, lam) -> Tuple[GraphData, torch.Tensor]:
    """One LM step with edge-sharded linearization: solve
    (H_f + lam diag(free)) dx = -b_f from the shards' summed system and
    apply dx. Returns (the updated graph on the mesh's first device, the
    robust chi2 before the step); accepting or rejecting is the caller's."""
    home = mesh.devices[0]
    data = _graph_to(data, home)
    H, b, _, chi2_rob = _mesh_linearizer(mesh, data).system(data)
    free_f = free_dof_mask(data).to(H.dtype)
    dx = dense_step(H, b, torch.as_tensor(lam, dtype=H.dtype, device=home), free_f)
    return apply_delta(data, dx), chi2_rob
