"""Levenberg-Marquardt pose-graph solver on the device
(port of hdl_graph_slam_tpu/graph/solver.py).

Replaces g2o::SparseOptimizer + OptimizationAlgorithmLevenberg
(GraphSLAM::optimize, src/hdl_graph_slam/graph_slam.cpp:292-321). Per
iteration: linearization of all edge tables (linearize.py), the damped
solve (H + lam I) dx = -b over the free dofs (dense Cholesky; or the
landmark Schur complement, graph/schur.py; or matrix-free PCG,
graph/pcg.py), the manifold update, and the chi2-gated accept/reject with
Nielsen damping.

The JAX ``lax.while_loop`` becomes a Python loop whose state never leaves
the device. The host reads the ``done`` flag every ``CHECK_EVERY``
iterations; the state is frozen once ``done`` is set (every field is
selected against its previous value, and the iteration count stops), so the
extra iterations between two reads change nothing and ``data``, ``lam``,
``nu`` and ``iterations`` equal the JAX loop's.

One pass (``_lm_pass``) has two launch paths, chosen from what the call
holds:

- replayed, for CUDA tensors with a linearizer that can be captured
  (``Linearizer.capturable``) and the dense or Schur solve: the solve's
  device work runs from CUDA graphs captured once per shape key
  (``GraphCache``): the prologue (chi2, the initial damping), CHECK_EVERY
  passes, one pass, and the final chi2, each on the key's static buffers
  (``StaticSolve``). A solve copies its graph into those buffers and
  replays; between two replays of CHECK_EVERY passes the host reads
  ``done``, as the eager loop does, so both give the same passes and bits;
- eager, for everything else: CPU tensors, ``parallel/``'s
  ``ShardedLinearizer`` (its sums cross devices and processes), and PCG
  (its CG loop reads its residual on the host).

A failed Cholesky (an indefinite damped system) yields NaN, as
``jnp.linalg.cholesky`` does: the trial's chi2 is then not finite and the
step is rejected, never raised.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from ..utils.metrics import GLOBAL_TIMER
from .linearize import Linearizer, apply_delta, free_dof_mask
from .pcg import linearize_blocks, solve_pcg
from .schur import has_landmark_coupling, solve_schur
from .types import EdgeTable, GraphData

CHECK_EVERY = 4  # iterations between two host reads of ``done``
GRAPH_CACHE_KEYS = 16  # shape keys whose captured solves a process keeps (the least recently used goes)

_VERTEX_FIELDS = tuple(f.name for f in dataclasses.fields(GraphData) if f.name != "edges")
_EDGE_FIELDS = tuple(f.name for f in dataclasses.fields(EdgeTable))


class OptimizeStats(NamedTuple):
    iterations: torch.Tensor
    chi2_before: torch.Tensor
    chi2_after: torch.Tensor
    chi2_robust_before: torch.Tensor
    chi2_robust_after: torch.Tensor
    lam_final: torch.Tensor


def _select(cond: torch.Tensor, new: GraphData, old: GraphData) -> GraphData:
    """Vertex estimates of ``new`` where cond, else ``old`` (edges, masks and
    flags are the same in both)."""
    return old.replace(poses=torch.where(cond, new.poses, old.poses),
                       planes=torch.where(cond, new.planes, old.planes),
                       points=torch.where(cond, new.points, old.points))


def _free_block(H: torch.Tensor, free_f: torch.Tensor) -> torch.Tensor:
    """H on the free dofs, with a unit diagonal on the fixed ones."""
    return H * free_f[:, None] * free_f[None, :] + torch.diag(1.0 - free_f)


def dense_step(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor, free_f: torch.Tensor) -> torch.Tensor:
    """dx solving (H_f + lam diag(free)) dx = -b_f, H_f the free block with a
    unit diagonal on fixed dofs; NaN where the Cholesky fails."""
    A = _free_block(H, free_f) + lam * torch.diag(free_f)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info == 0, L, torch.full((), float("nan"), dtype=L.dtype, device=L.device))
    return -torch.cholesky_solve((b * free_f)[:, None], L)[:, 0]


def _lm_start(data: GraphData, lin: Linearizer, free: torch.Tensor) -> tuple:
    """The solve's prologue: (chi2 raw, chi2 robust, lam, nu, iterations,
    done) at the start, lam by g2o's computeLambdaInit (tau times the largest
    free diagonal entry of H)."""
    dtype, dev = data.poses.dtype, data.poses.device
    chi2_raw0, chi2_rob0 = lin.chi2(data)
    H0, _, _, _ = lin.system(data)
    zero = torch.zeros((), dtype=dtype, device=dev)
    lam0 = 1e-5 * torch.where(free, torch.diagonal(H0), zero).amax()
    lam = torch.where(lam0 > 0, lam0, torch.full((), 1e-5, dtype=dtype, device=dev))
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    return chi2_raw0, chi2_rob0, lam, nu, it, done


def _lm_pass(data: GraphData, lam, nu, it, done, lin: Linearizer, linear_solver: str, free: torch.Tensor,
             free_f: torch.Tensor) -> tuple:
    """One accept/reject step from (data, lam, nu, iterations, done); once
    ``done`` every field keeps its value and the count stops."""
    if linear_solver == "pcg":
        with GLOBAL_TIMER.span("linearize"):
            sys_ = linearize_blocks(data)
        chi2_rob, bf = sys_.chi2_robust, sys_.b * free_f
        with GLOBAL_TIMER.span("linear_solve"):
            dx = solve_pcg(sys_, lam, free)
    else:
        with GLOBAL_TIMER.span("linearize"):
            H, b, _, chi2_rob = lin.system(data)
        bf = b * free_f
        with GLOBAL_TIMER.span("linear_solve"):
            if linear_solver == "schur":
                dx = solve_schur(_free_block(H, free_f) + lam * torch.diag(free_f), bf, 6 * data.poses.shape[0])
            else:
                dx = dense_step(H, b, lam, free_f)
    with GLOBAL_TIMER.span("trial_chi2"):
        data_new = apply_delta(data, dx)
        _, chi2_new = lin.chi2(data_new)

    accept = (chi2_new < chi2_rob) & torch.isfinite(chi2_new)
    denom = torch.dot(dx, lam * dx - bf)
    rho = (chi2_rob - chi2_new) / torch.where(denom.abs() < 1e-30, 1e-30, denom)
    lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_next = torch.where(accept, lam_acc, lam * nu)
    nu_next = torch.where(accept, 2.0, 2.0 * nu)
    step_small = accept & (dx.abs().amax() < 1e-10)
    done_next = step_small | (lam_next > 1e30)

    live = ~done
    return (_select(live & accept, data_new, data), torch.where(live, lam_next, lam),
            torch.where(live, nu_next, nu), it + live.to(it.dtype), done | done_next)


def _done_read(done: torch.Tensor) -> bool:
    with GLOBAL_TIMER.span("done_check"):
        GLOBAL_TIMER.count("host_sync.graph_done")
        return bool(done)


def _optimize_eager(data: GraphData, max_iterations: int, linear_solver: str,
                    lin: Linearizer) -> tuple[GraphData, OptimizeStats]:
    """The LM loop launched pass by pass from the host."""
    free = free_dof_mask(data)
    free_f = free.to(data.poses.dtype)
    chi2_raw0, chi2_rob0, lam, nu, it, done = _lm_start(data, lin, free)
    for i in range(max_iterations):
        with GLOBAL_TIMER.span("lm_iteration"):
            GLOBAL_TIMER.count("graph_lm_iterations")
            data, lam, nu, it, done = _lm_pass(data, lam, nu, it, done, lin, linear_solver, free, free_f)
            if (i + 1) % CHECK_EVERY == 0 and _done_read(done):
                break
    chi2_raw1, chi2_rob1 = lin.chi2(data)
    stats = OptimizeStats(iterations=it, chi2_before=chi2_raw0, chi2_after=chi2_raw1,
                          chi2_robust_before=chi2_rob0, chi2_robust_after=chi2_rob1, lam_final=lam)
    return data, stats


def _map_tensors(data: GraphData, fn) -> GraphData:
    return GraphData(**{k: fn(getattr(data, k)) for k in _VERTEX_FIELDS},
                     edges={e: EdgeTable(**{k: fn(getattr(t, k)) for k in _EDGE_FIELDS}) for e, t in data.edges.items()})


def solve_key(data: GraphData, linear_solver: str, lin: Linearizer) -> tuple:
    """What a captured solve is specialised to: the solver, the linearizer's
    class, the device, and the shapes and dtypes of the vertex tensors and of
    each non-empty edge table, in the graph's table order (the order the
    sums run in)."""
    def sig(t):
        return tuple(t.shape), t.dtype

    return (linear_solver, type(lin), str(data.poses.device), tuple(sig(getattr(data, k)) for k in _VERTEX_FIELDS),
            tuple((e, tuple(sig(getattr(t, k)) for k in _EDGE_FIELDS))
                  for e, t in data.edges.items() if t.vi.shape[0] > 0))


class StaticSolve:
    """One shape key's LM solve on buffers made once: the graph, the vertex
    estimates, the damping, the count, ``done`` and the chi2s. Each step
    (``start``, ``passes(n)``, ``finish``) reads and writes only these, so a
    CUDA graph captured from a step replays it on whatever graph ``load``
    copied in last."""

    def __init__(self, data: GraphData, linear_solver: str, lin: Linearizer):
        self.linear_solver, self.lin = linear_solver, lin
        dtype, dev = data.poses.dtype, data.poses.device
        self.data = _map_tensors(data, torch.empty_like)
        self.free = torch.empty(data.num_dof, dtype=torch.bool, device=dev)
        self.free_f = torch.empty(data.num_dof, dtype=dtype, device=dev)
        self.scalars = torch.empty(6, dtype=dtype, device=dev)  # lam, nu, chi2 raw / robust before, after
        self.it = torch.empty((), dtype=torch.int32, device=dev)
        self.done = torch.empty((), dtype=torch.bool, device=dev)

    def load(self, data: GraphData) -> None:
        """Copy ``data`` (of this solve's key) into the buffers."""
        for k in _VERTEX_FIELDS:
            getattr(self.data, k).copy_(getattr(data, k))
        for e, t in data.edges.items():
            if t.vi.shape[0] > 0:
                for k in _EDGE_FIELDS:
                    getattr(self.data.edges[e], k).copy_(getattr(t, k))

    def start(self) -> None:
        free = free_dof_mask(self.data)
        self.free.copy_(free)
        self.free_f.copy_(free.to(self.free_f.dtype))
        chi2_raw0, chi2_rob0, lam, nu, it, done = _lm_start(self.data, self.lin, free)
        self.scalars[:4].copy_(torch.stack([lam, nu, chi2_raw0, chi2_rob0]))
        self.it.copy_(it)
        self.done.copy_(done)

    def passes(self, n: int) -> None:
        d = self.data
        data, lam, nu, it, done = d, self.scalars[0], self.scalars[1], self.it, self.done
        for _ in range(n):
            data, lam, nu, it, done = _lm_pass(data, lam, nu, it, done, self.lin, self.linear_solver, self.free,
                                               self.free_f)
        d.poses.copy_(data.poses)
        d.planes.copy_(data.planes)
        d.points.copy_(data.points)
        self.scalars[:2].copy_(torch.stack([lam, nu]))
        self.it.copy_(it)
        self.done.copy_(done)

    def finish(self) -> None:
        self.scalars[4:].copy_(torch.stack(self.lin.chi2(self.data)))

    def result(self, data: GraphData) -> tuple[GraphData, OptimizeStats]:
        """``data`` with the solved estimates, and the stats, in tensors of
        their own (the next ``load`` overwrites the buffers)."""
        d, s = self.data, self.scalars.clone()
        out = data.replace(poses=d.poses.clone(), planes=d.planes.clone(), points=d.points.clone())
        return out, OptimizeStats(iterations=self.it.clone(), chi2_before=s[2], chi2_after=s[4],
                                  chi2_robust_before=s[3], chi2_robust_after=s[5], lam_final=s[0])


def drive(solve: StaticSolve, launch, max_iterations: int) -> None:
    """A loaded solve's steps, as the eager loop takes them: the prologue,
    CHECK_EVERY passes between two reads of ``done``, the passes that
    ``max_iterations`` leaves one by one, the final chi2. ``launch(name, n,
    step)`` runs ``step``, named ``name``, which runs ``n`` LM passes (a
    graph replay, or the step itself)."""
    launch("start", 0, solve.start)
    full, rest = divmod(max_iterations, CHECK_EVERY)
    for _ in range(full):
        launch("passes", CHECK_EVERY, lambda: solve.passes(CHECK_EVERY))
        GLOBAL_TIMER.count("graph_lm_iterations", CHECK_EVERY)
        if _done_read(solve.done):
            break
    else:
        for _ in range(rest):
            launch("passes", 1, lambda: solve.passes(1))
            GLOBAL_TIMER.count("graph_lm_iterations")
    launch("finish", 0, solve.finish)


class _Captured:
    """A StaticSolve whose steps run as CUDA graphs: the first solve warms
    every step up eagerly on the capture stream, each step is captured at its
    first use (no step runs while it is captured, so a solve's state stays as
    it was), and every later launch replays on the caller's stream."""

    def __init__(self, data: GraphData, linear_solver: str, lin: Linearizer, stream, cache: "GraphCache"):
        self.solve = StaticSolve(data, linear_solver, lin)
        self.stream, self.cache = stream, cache
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}
        self.last = torch.cuda.Event()  # the end of this key's last solve
        # warm-up: cuBLAS / cuSOLVER handles and workspaces on the capture
        # stream, and every step's first-call work, before any capture
        self.solve.load(data)
        caller = torch.cuda.current_stream(stream.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            self.solve.start()
            self.solve.passes(1)
            self.solve.finish()
        caller.wait_stream(stream)

    def launch(self, name: str, n: int, step) -> None:
        g = self.graphs.get((name, n))
        if g is None:
            with GLOBAL_TIMER.span("graph_capture"):
                g = torch.cuda.CUDAGraph()
                caller = torch.cuda.current_stream(self.stream.device)
                self.stream.wait_stream(caller)
                with torch.cuda.stream(self.stream):
                    g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        step()
                    finally:
                        g.capture_end()
                caller.wait_stream(self.stream)
            self.graphs[(name, n)] = g
            self.cache.captures += 1
            GLOBAL_TIMER.count("graph_lm_captures")
        with GLOBAL_TIMER.span("graph_replay"):
            g.replay()
        if n:
            self.cache.replayed += n
            GLOBAL_TIMER.count("graph_lm_replayed", n)

    def run(self, data: GraphData, max_iterations: int) -> tuple[GraphData, OptimizeStats]:
        stream = torch.cuda.current_stream(self.stream.device)
        stream.wait_event(self.last)  # a solve on another stream may still read the buffers
        self.solve.load(data)
        drive(self.solve, self.launch, max_iterations)
        out = self.solve.result(data)
        self.last.record(stream)
        return out


class GraphCache:
    """The captured solves of one process, by ``solve_key``, the
    ``capacity`` most recently used kept. One solve runs at a time (the
    buffers are the key's). ``captures`` counts the graphs captured and
    ``replayed`` the LM passes run by replay."""

    def __init__(self, capacity: int = GRAPH_CACHE_KEYS):
        self.capacity = capacity
        self.captures = 0
        self.replayed = 0
        self._entries: OrderedDict = OrderedDict()
        self._streams: dict = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def solve(self, data: GraphData, max_iterations: int, linear_solver: str,
              lin: Linearizer) -> tuple[GraphData, OptimizeStats]:
        key = solve_key(data, linear_solver, lin)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                dev = data.poses.device
                stream = self._streams.get(dev)
                if stream is None:
                    stream = self._streams[dev] = torch.cuda.Stream(dev)
                entry = self._entries[key] = _Captured(data, linear_solver, lin, stream, self)
                while len(self._entries) > self.capacity:
                    _, old = self._entries.popitem(last=False)
                    old.last.synchronize()  # its graphs' memory is released once nothing reads it
            else:
                self._entries.move_to_end(key)
            return entry.run(data, max_iterations)


GRAPHS = GraphCache()


def _replayable(data: GraphData, linear_solver: str, lin: Linearizer) -> bool:
    """Whether the solve can run from CUDA graphs: CUDA tensors, a linearizer
    that can be captured, and a solve with no host read inside a pass."""
    return data.poses.is_cuda and lin.capturable and linear_solver != "pcg"


def optimize(data: GraphData, max_iterations: int = 512, linear_solver: str = "dense",
             linearizer: Optional[Linearizer] = None) -> tuple[GraphData, OptimizeStats]:
    """Run LM for up to max_iterations accept/reject steps.

    linearizer: where the system and the chi2 come from (None: every edge
    table of ``data``, linearize.py; parallel/: the shards' sums, the JAX
    package's ``axis_name``). The dense and Schur solves read it; PCG, whose
    matrix-free blocks have no sharded form in either package, refuses one.

    linear_solver:
    - "dense": Cholesky over all dofs;
    - "schur": eliminate the plane / point landmark blocks first
      (graph/schur.py, g2o's landmark marginalization); refused for graphs
      with landmark-landmark edges, which HdlGraphSlam never creates;
    - "pcg": matrix-free Jacobi-preconditioned CG (graph/pcg.py), no dense H.
    """
    if linear_solver not in ("dense", "schur", "pcg"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    if linear_solver == "pcg" and linearizer is not None:
        raise ValueError("linear_solver='pcg' linearizes its own blocks and takes no linearizer")
    if linear_solver == "schur" and has_landmark_coupling(data):
        raise ValueError("linear_solver='schur' requires a block-diagonal landmark block; "
                         "this graph has plane-plane edges — use 'dense'")
    lin = Linearizer() if linearizer is None else linearizer
    if _replayable(data, linear_solver, lin):
        return GRAPHS.solve(data, max_iterations, linear_solver, lin)
    return _optimize_eager(data, max_iterations, linear_solver, lin)
