"""The pose-graph LM's replayed launch path (hdl_graph_slam_tpu_torch/graph/
solver.py: StaticSolve, drive, GraphCache) against its eager loop.

On the CPU the static-buffer path runs its steps directly (what a CUDA graph
would replay) and must equal the eager loop bit for bit: poses, planes,
points, lam, iterations and the four chi2s, for the dense and Schur solves,
over three bucket shapes, the host's passes and done reads included.
se3._assemble's bottom row (a fill, no host scalar copied) equals the item
assignment it replaced, bit for bit. Cases marked ``cuda`` run on a card
only (``python -m pytest tests/test_torch_graph_replay.py -m cuda`` there):
the replayed solve against the eager one, no host sync inside a step, and
the solves that stay eager.
"""

import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu_torch.core import se3
from hdl_graph_slam_tpu_torch.graph import GraphBuilder, solver
from hdl_graph_slam_tpu_torch.graph.linearize import Linearizer
from hdl_graph_slam_tpu_torch.parallel.dist import ShardedLinearizer
from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER, tracing


class EagerLinearizer(Linearizer):
    """Every edge table, as Linearizer, but kept out of CUDA graphs."""

    capturable = False


def _noise(rng, t_sd, r_sd):
    w = rng.normal(0.0, r_sd, 3)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + (np.sin(th) / max(th, 1e-12)) * K + ((1 - np.cos(th)) / max(th * th, 1e-24)) * K @ K
    T[:3, 3] = rng.normal(0.0, t_sd, 3)
    return T


def ring_graph(n: int, seed: int = 0, floor: bool = False, prior: bool = False) -> GraphBuilder:
    """A fixed anchor and ``n`` poses on a 10 m circle, noisy odometry, a
    Huber loop edge every 5 poses back to the start; with ``floor`` a plane
    landmark seen from every pose; with ``prior`` an xyz prior on the last
    pose (a new edge type, so a new shape key)."""
    rng = np.random.default_rng(seed)

    def pose(k):
        a = 2.0 * np.pi * k / n
        T = np.eye(4)
        T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[:3, 3] = [10.0 * np.cos(a), 10.0 * np.sin(a), 0.0]
        return T

    g = GraphBuilder()
    anchor = g.add_se3_node(np.eye(4), fixed=True)
    ids, est = [], pose(0)
    for k in range(n):
        if k:
            rel = np.linalg.inv(pose(k - 1)) @ pose(k) @ _noise(rng, 0.05, 0.01)
            est = est @ rel
        ids.append(g.add_se3_node(est))
        if k:
            g.add_se3_edge(ids[k], ids[k - 1], np.linalg.inv(rel), np.eye(6) * 100.0)
    g.add_se3_edge(anchor, ids[0], np.linalg.inv(pose(0)), np.eye(6) * 10.0)
    for k in range(5, n, 5):
        rel = np.linalg.inv(pose(k)) @ pose(0) @ _noise(rng, 0.02, 0.002)
        g.add_se3_edge(ids[k], ids[0], rel, np.eye(6) * 400.0, kernel="Huber", kernel_delta=1.0)
    if floor:
        plane = g.add_plane_node([0.0, 0.0, 1.0, 1.8])
        for k in range(n):
            nl = pose(k)[:3, :3].T @ np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.01, 3)
            g.add_se3_plane_edge(ids[k], plane, np.concatenate([nl / np.linalg.norm(nl), [1.8]]), np.eye(3) * 10.0)
    if prior:
        g.add_se3_prior_xyz_edge(ids[-1], pose(n - 1)[:3, 3], np.eye(3) * 5.0)
    return g


# three bucket shapes: 16 poses; 32 poses with a floor landmark; the 16-pose
# ring with a new edge type
SHAPES = {"ring12": dict(n=12), "floor24": dict(n=24, floor=True), "ring12_prior": dict(n=12, prior=True)}


def static_solve(data, max_iterations, linear_solver, lin=None):
    """optimize's replayed path with each step run as it is (what its CUDA
    graph replays), on a StaticSolve of the graph's key."""
    lin = Linearizer() if lin is None else lin
    solve = solver.StaticSolve(data, linear_solver, lin)
    solve.load(data)
    solver.drive(solve, lambda name, n, step: step(), max_iterations)
    return solve.result(data)


def assert_same_solve(a, b):
    (da, sa), (db, sb) = a, b
    for k in ("poses", "planes", "points"):
        assert torch.equal(getattr(da, k), getattr(db, k)), k
    for k in sa._fields:
        x, y = getattr(sa, k), getattr(sb, k)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), (k, x, y)


def traced(fn):
    with tracing():
        out = fn()
    return out, GLOBAL_TIMER.drain()["counters"]


# each shape and solver over 10 iterations (two chunks, then two single
# passes), and one solve that stops at a done read (28 passes)
CASES = [(shape, ls, 10) for shape in SHAPES for ls in ("dense", "schur")] + [("ring12", "schur", 40)]


@pytest.mark.parametrize("shape,linear_solver,max_iterations", CASES)
def test_static_path_equals_the_eager_loop(shape, linear_solver, max_iterations):
    """The static-buffer path's steps, run as they are, give the eager
    loop's solve bit for bit, with the same passes and done reads."""
    data = ring_graph(**SHAPES[shape]).freeze(device="cpu")
    eager, c_eager = traced(lambda: solver._optimize_eager(data, max_iterations, linear_solver, Linearizer()))
    static, c_static = traced(lambda: static_solve(data, max_iterations, linear_solver))
    assert_same_solve(static, eager)
    assert c_static["graph_lm_iterations"] == c_eager["graph_lm_iterations"]
    assert c_static["host_sync.graph_done"] == c_eager["host_sync.graph_done"]
    assert float(eager[1].chi2_robust_after) < float(eager[1].chi2_robust_before)
    if max_iterations == 40:
        assert c_eager["graph_lm_iterations"] < 40  # stopped at a done read


def test_static_buffers_take_each_solve_whole():
    """One StaticSolve loaded with two graphs of its key in turn (other
    values, the same shapes) solves each as the eager loop does: load
    overwrites every buffer a step reads."""
    a = ring_graph(12, seed=1).freeze(device="cpu")
    b = ring_graph(12, seed=2).freeze(device="cpu")
    assert solver.solve_key(a, "dense", Linearizer()) == solver.solve_key(b, "dense", Linearizer())
    solve = solver.StaticSolve(a, "dense", Linearizer())
    for data, its in ((a, 6), (b, 5), (a, 3)):
        solve.load(data)
        solver.drive(solve, lambda name, n, step: step(), its)
        assert_same_solve(solve.result(data), solver._optimize_eager(data, its, "dense", Linearizer()))


def test_results_do_not_alias_the_buffers():
    """A solve's returned estimates and stats are tensors of their own: the
    next load leaves them as they were."""
    a = ring_graph(12, seed=1).freeze(device="cpu")
    solve = solver.StaticSolve(a, "dense", Linearizer())
    solve.load(a)
    solver.drive(solve, lambda name, n, step: step(), 8)
    out, st = solve.result(a)
    kept = out.poses.clone(), [t.clone() for t in st]
    solve.load(ring_graph(12, seed=3).freeze(device="cpu"))
    solve.start()
    assert torch.equal(out.poses, kept[0]) and all(torch.equal(x, y) for x, y in zip(st, kept[1]))
    assert out.edges is a.edges


def test_solve_key_separates_shapes_and_reuses_equal_ones():
    """Graphs of equal shapes share a key whatever their values; a pose
    bucket, an edge bucket, a new edge type, the dtype, the solver or the
    linearizer's class each make another."""
    lin = Linearizer()
    key = solver.solve_key(ring_graph(12, seed=0).freeze(device="cpu"), "dense", lin)
    assert key == solver.solve_key(ring_graph(12, seed=5).freeze(device="cpu"), "dense", Linearizer())
    assert key == solver.solve_key(ring_graph(15, seed=5).freeze(device="cpu"), "dense", lin)  # same buckets
    others = [
        solver.solve_key(ring_graph(20).freeze(device="cpu"), "dense", lin),  # 32-pose bucket
        solver.solve_key(ring_graph(12, prior=True).freeze(device="cpu"), "dense", lin),  # a new edge type
        solver.solve_key(ring_graph(12).freeze(dtype=torch.float32, device="cpu"), "dense", lin),
        solver.solve_key(ring_graph(12).freeze(device="cpu"), "schur", lin),
        solver.solve_key(ring_graph(12).freeze(device="cpu"), "dense", EagerLinearizer()),
    ]
    g = ring_graph(12)
    for k in range(70):  # 71 odometry-like edges: the 128-edge bucket
        g.add_se3_edge(1 + k % 12, 1 + (k + 1) % 12, np.eye(4), np.eye(6))
    others.append(solver.solve_key(g.freeze(device="cpu"), "dense", lin))
    assert len({key, *others}) == 1 + len(others)


def test_cpu_solves_and_uncapturable_linearizers_stay_eager():
    """CPU tensors, a ShardedLinearizer and PCG take the eager loop: the
    decision reads the tensors' device, the linearizer's ``capturable`` and
    the solver, nothing else; optimize on the CPU leaves the process's
    graph cache untouched."""
    assert Linearizer.capturable and not ShardedLinearizer.capturable
    data = ring_graph(12).freeze(device="cpu")
    assert not solver._replayable(data, "dense", Linearizer())
    before = (len(solver.GRAPHS), solver.GRAPHS.captures, solver.GRAPHS.replayed)
    (out, st), c = traced(lambda: solver.optimize(data, max_iterations=8))
    assert (len(solver.GRAPHS), solver.GRAPHS.captures, solver.GRAPHS.replayed) == before
    assert "graph_lm_replayed" not in c and "graph_lm_captures" not in c
    assert_same_solve((out, st), solver._optimize_eager(data, 8, "dense", Linearizer()))


def _assemble_by_item(R, t):
    """se3._assemble as it was: the bottom row's 1 written by item assignment."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., :, None]], dim=-1), bottom], dim=-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_assemble_equals_the_item_assignment(dtype, batch):
    """se3._assemble (a fill of the bottom row's last entry) gives the item
    assignment's matrices bit for bit, single and batched, and under vmap
    (as the graph's Jacobians call it)."""
    g = torch.Generator().manual_seed(0)
    R = torch.randn(batch + (3, 3), generator=g, dtype=dtype)
    t = torch.randn(batch + (3,), generator=g, dtype=dtype)
    assert torch.equal(se3._assemble(R, t), _assemble_by_item(R, t))
    xi = torch.randn(batch + (6,), generator=g, dtype=dtype)
    T = se3.se3_exp(xi)
    assert torch.equal(T[..., 3, :], torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype).expand(batch + (4,)))
    if batch:
        flat_R, flat_t = R.reshape(-1, 3, 3), t.reshape(-1, 3)
        assert torch.equal(torch.func.vmap(se3._assemble)(flat_R, flat_t), _assemble_by_item(flat_R, flat_t))


# -- on a card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("linear_solver", ["dense", "schur"])
def test_replay_equals_eager_on_the_card(card, shape, linear_solver):
    """optimize's replayed solve equals the eager loop's on the card bit for
    bit (twice: the first solve captures, the second replays), each pass
    replayed; at 10 iterations the single-pass graph runs too."""
    data = ring_graph(**SHAPES[shape]).freeze(device=card)
    for its in (40, 40, 10):
        replayed0 = solver.GRAPHS.replayed
        (out, c) = traced(lambda: solver.optimize(data, max_iterations=its, linear_solver=linear_solver))
        eager = solver.optimize(data, max_iterations=its, linear_solver=linear_solver, linearizer=EagerLinearizer())
        assert_same_solve(out, eager)
        assert c["graph_lm_replayed"] == c["graph_lm_iterations"] == solver.GRAPHS.replayed - replayed0


@pytest.mark.cuda
@pytest.mark.parametrize("linear_solver", ["dense", "schur"])
def test_no_host_sync_inside_a_step(card, linear_solver):
    """Every step a graph holds (prologue, CHECK_EVERY passes, one pass,
    final chi2) runs on the card with no host sync: torch's sync debug mode
    raises on one."""
    data = ring_graph(24, floor=True).freeze(device=card)
    solve = solver.StaticSolve(data, linear_solver, Linearizer())
    solve.load(data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solve.start()
        solve.passes(solver.CHECK_EVERY)
        solve.passes(1)
        solve.finish()
        se3.inverse(se3.se3_exp(torch.zeros(6, device=card)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sharded_linearizer_and_pcg_stay_eager_on_the_card(card):
    """A ShardedLinearizer (one shard on the card) and PCG run the eager
    loop: no capture, no replay."""
    data = ring_graph(12).freeze(device=card)
    before = (solver.GRAPHS.captures, solver.GRAPHS.replayed)
    lin = ShardedLinearizer([(card, data.edges)], home=card)
    (_, c) = traced(lambda: (solver.optimize(data, max_iterations=8, linearizer=lin),
                             solver.optimize(data, max_iterations=8, linear_solver="pcg")))
    assert (solver.GRAPHS.captures, solver.GRAPHS.replayed) == before
    assert c["graph_lm_iterations"] == 16 and "graph_lm_replayed" not in c
