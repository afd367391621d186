"""The port's tracer (utils/metrics.py): off by default and silent, the
span trees of the per-frame, windowed and backend paths with their request
ids, the counters, a worker thread's own spans, the bounded buffer, self
time; and tools/trace_cells.py's reductions of a profiled slice."""

import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu_torch.backend import HdlGraphSlam
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import PRESETS, OdometryConfig, PrefilterConfig, RegistrationConfig
from hdl_graph_slam_tpu_torch.frontend import OdometryWindow
from hdl_graph_slam_tpu_torch.frontend.window import stack_scans
from hdl_graph_slam_tpu_torch.graph import GraphBuilder, optimize
from hdl_graph_slam_tpu_torch.graph.solver import CHECK_EVERY
from hdl_graph_slam_tpu_torch.pipeline import AsyncBackend, SlamPipeline
from hdl_graph_slam_tpu_torch.utils import metrics
from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER, StageTimer, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 lane runs six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracer_left_off():
    """Every test leaves the module-global tracer off and empty."""
    yield
    GLOBAL_TIMER.disable()
    GLOBAL_TIMER.reset()


def make_world(seed=0, n=12000):
    """A 30 m room: floor at z = 0 and four 4 m walls."""
    rng = np.random.default_rng(seed)
    pts = [np.stack([rng.uniform(-15, 15, n // 2), rng.uniform(-15, 15, n // 2), rng.normal(0, 0.01, n // 2)], 1)]
    for k in range(4):
        m = n // 8
        w = np.stack([rng.uniform(-15, 15, m), np.full(m, 15.0) + rng.normal(0, 0.01, m), rng.uniform(0, 4, m)], 1)
        a = k * np.pi / 2
        pts.append(w @ np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]).T)
    return np.concatenate(pts).astype(np.float32)


def scan_at(world, x, seed=0, n_keep=2000):
    """The world's points within 25 m of a sensor 1.8 m above (x, 0, 0), in
    the sensor frame."""
    rng = np.random.default_rng(seed)
    local = world - np.float32([x, 0.0, 1.8])
    d = np.linalg.norm(local, axis=1)
    local = local[(d > 0.5) & (d < 25.0)]
    return local[rng.choice(local.shape[0], min(n_keep, local.shape[0]), replace=False)]


@pytest.fixture(scope="module")
def world():
    return make_world()


def run_frames(world, n, pipe=None):
    """``n`` frames 0.6 m and 1 s apart through process_frame (outdoor
    preset at 2048 rows, keyframes every 0.5 m, a cycle every 2 s)."""
    if pipe is None:
        cfg = PRESETS["outdoor"]()
        cfg.backend.keyframe_delta_trans = 0.5
        cfg.backend.graph_update_interval = 2.0
        pipe = SlamPipeline(cfg, cloud_capacity=2048, device="cpu")
    for i in range(n):
        pipe.process_frame(float(i), scan_at(world, 0.6 * i, seed=i))
    return pipe


def by_id(spans):
    return {s["id"]: s for s in spans}


def test_tracer_off_records_nothing(world, monkeypatch):
    """Off (the default), a 4-frame process_frame run leaves no span and no
    counter, every span() is the one shared no-op, and no clock or profiler
    call is made."""
    assert not GLOBAL_TIMER.on
    assert GLOBAL_TIMER.span("a") is GLOBAL_TIMER.span("b", rid=3)

    def boom(*a, **k):
        raise AssertionError("called while the tracer is off")

    monkeypatch.setattr(GLOBAL_TIMER, "_record_function", boom)
    monkeypatch.setattr(metrics.time, "perf_counter_ns", boom)
    run_frames(world, 4)
    assert GLOBAL_TIMER.drain() == {"spans": [], "counters": {}, "dropped": 0, "summary": {}}


def test_frame_and_cycle_trees(world):
    """On, each frame's spans form the ``frame`` tree (ingest, prefilter,
    odometry > odometry_step > align, floor) under its frame index; each
    optimize cycle is a root under its cycle index whose graph_optimize
    holds one lm_iteration a host pass, as many as graph_lm_iterations, each
    with its linearize, linear_solve and trial_chi2."""
    with tracing():
        pipe = run_frames(world, 7)
    got = GLOBAL_TIMER.drain()
    spans, c = got["spans"], got["counters"]
    ids = by_id(spans)
    frames = [s for s in spans if s["name"] == "frame"]
    assert [s["rid"] for s in frames] == list(range(7)) and all(s["parent"] is None for s in frames)
    for f in frames:
        kids = [s["name"] for s in spans if s["parent"] == f["id"]]
        assert kids == ["ingest", "prefilter", "odometry", "floor"]
        assert all(s["rid"] == f["rid"] for s in spans if s["parent"] == f["id"])
    steps = [s for s in spans if s["name"] == "odometry_step"]
    assert len(steps) == 7 and all(ids[s["parent"]]["name"] == "odometry" for s in steps)
    aligns = [s for s in spans if s["name"] == "align"]
    assert len(aligns) == 6 and all(ids[s["parent"]]["name"] == "odometry_step" for s in aligns)
    assert all(ids[s["parent"]]["rid"] == s["rid"] for s in aligns)

    cycles = [s for s in spans if s["name"] == "optimize_cycle"]
    assert [s["rid"] for s in cycles] == list(range(len(cycles))) == list(range(pipe.slam.cycles))
    assert all(s["parent"] is None for s in cycles)
    first = [s["name"] for s in spans if s["parent"] == cycles[0]["id"]]
    assert first[:2] == ["flush_queues", "loop_detect"]
    solves = [s for s in spans if s["name"] == "graph_optimize"]
    assert solves and all(ids[s["parent"]]["name"] == "optimize_cycle" for s in solves)
    passes = [s for s in spans if s["name"] == "lm_iteration"]
    assert all(ids[s["parent"]]["name"] == "graph_optimize" for s in passes)
    assert len(passes) == c["graph_lm_iterations"] > 0
    for p in passes[:3]:
        assert [s["name"] for s in spans if s["parent"] == p["id"]][:3] == ["linearize", "linear_solve", "trial_chi2"]
    assert c["keyframes_admitted"] == len(pipe.slam.keyframes)
    assert c["host_sync.odometry_result"] == 6 and c["host_sync.floor_count"] == 7
    assert c["host_sync.lm_loop"] == c["lm_iterations"]
    assert c.get("loop_candidates", 0) >= c.get("loops_added", 0) >= 0


def test_graph_passes_run_past_the_reported_iterations():
    """The LM's host passes (graph_lm_iterations, one lm_iteration span
    each) reach the next done check past the iterations its stats report."""
    g = GraphBuilder()
    ids = [g.add_se3_node(np.eye(4), fixed=(i == 0)) for i in range(6)]
    rng = np.random.default_rng(0)
    for i in range(1, 6):
        rel = np.eye(4)
        rel[:3, 3] = [1.0, 0.0, 0.0] + rng.normal(0, 0.05, 3)
        g.add_se3_edge(ids[i], ids[i - 1], rel, np.eye(6) * 10.0)
    with tracing():
        _, stats = optimize(g.freeze(device="cpu"), max_iterations=64)
    got = GLOBAL_TIMER.drain()
    passes = got["counters"]["graph_lm_iterations"]
    it = int(stats.iterations)
    assert sum(1 for s in got["spans"] if s["name"] == "lm_iteration") == passes
    assert it <= passes <= it + CHECK_EVERY - 1 and (passes % CHECK_EVERY == 0 or passes == 64)
    assert got["counters"]["host_sync.graph_done"] == passes // CHECK_EVERY


def test_lm_iterations_sum_the_frames_iterations(world):
    """lm_iterations (and the one host sync an iteration) over a window is
    the sum of its frames' AlignResult.iterations; the window's frames carry
    their indices after the bootstrap frame."""
    win = OdometryWindow(OdometryConfig(keyframe_delta_trans=1.0, registration=RegistrationConfig(
        reg_reassoc_displacement=0.1)), prefilter_cfg=PrefilterConfig(downsample_resolution=0.4,
                                                                     outlier_removal_method="NONE"),
        out_capacity=2048, device="cpu")
    state = win.init_state(0.0, cloud.from_numpy(scan_at(world, 0.0), capacity=4096, device="cpu"))
    xyz, mask = stack_scans([scan_at(world, 0.4 * i, seed=i) for i in range(1, 5)], capacity=4096)
    with tracing():
        _, _, status = win.run(state, xyz, mask, np.arange(1, 5, dtype=np.float32))
    got = GLOBAL_TIMER.drain()
    c = got["counters"]
    assert c["lm_iterations"] == int(status["iterations"].sum()) == c["host_sync.lm_loop"]
    assert c.get("lm_reassociations", 0) >= 0
    (window,) = [s for s in got["spans"] if s["name"] == "window"]
    frames = [s for s in got["spans"] if s["name"] == "frame"]
    assert window["rid"] == 1 and [s["rid"] for s in frames] == [1, 2, 3, 4]
    assert all(s["parent"] == window["id"] for s in frames)
    steps = [s for s in got["spans"] if s["name"] == "odometry_step"]
    assert [s["rid"] for s in steps] == [1, 2, 3, 4]


def test_async_backend_cycle_parents_its_own_spans(world):
    """A cycle on AsyncBackend's thread is a root there (not a child of the
    span the main thread holds open), and its children hang under it on
    the same thread."""
    slam = HdlGraphSlam(PRESETS["base"](), device="cpu")
    for i in range(3):
        pose = np.eye(4)
        pose[0, 3] = 3.0 * i
        c = cloud.from_numpy(scan_at(world, 3.0 * i, seed=i), capacity=2048, device="cpu")
        slam.add_frame(float(i), pose, c)
    with tracing():
        with GLOBAL_TIMER.span("main_thread_block"):
            with AsyncBackend(slam, interval=0.01) as backend:
                for _ in range(2000):
                    if backend.cycles >= 1:
                        break
                    threading.Event().wait(0.005)
    got = GLOBAL_TIMER.drain()
    assert backend.cycles >= 1
    ids = by_id(got["spans"])
    main = [s for s in got["spans"] if s["name"] == "main_thread_block"]
    cycles = [s for s in got["spans"] if s["name"] == "optimize_cycle"]
    assert main and cycles and all(s["parent"] is None and s["thread"] != main[0]["thread"] for s in cycles)
    kids = [s for s in got["spans"] if s["parent"] is not None and ids[s["parent"]]["name"] == "optimize_cycle"]
    assert kids and all(s["thread"] == ids[s["parent"]]["thread"] and s["rid"] == ids[s["parent"]]["rid"]
                        for s in kids)


def test_full_buffer_counts_its_drops():
    """Spans past the capacity are dropped and counted; the totals keep them."""
    tr = StageTimer()
    tr.enable(capacity=3)
    for _ in range(5):
        with tr.span("s"):
            pass
    got = tr.drain()
    assert len(got["spans"]) == 3 and got["dropped"] == 2 and got["summary"]["s"]["count"] == 5
    assert tr.drain()["spans"] == [] and tr.summary()["dropped"] == 0


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    """A 100 ms parent with children over [10, 30) and [40, 70) ms has 50 ms
    of its own; each child's self time is its duration; the parent's request
    id reaches the children."""
    clock = iter([0, 10_000_000, 30_000_000, 40_000_000, 70_000_000, 100_000_000])
    monkeypatch.setattr(metrics.time, "perf_counter_ns", lambda: next(clock))
    tr = StageTimer()
    tr.enable()
    with tr.span("parent", rid=7):
        with tr.span("child"):
            pass
        with tr.span("child"):
            pass
    got = tr.drain()
    s = got["summary"]
    assert s["parent"]["total_s"] == pytest.approx(0.1) and s["parent"]["self_s"] == pytest.approx(0.05)
    assert s["child"]["total_s"] == pytest.approx(0.05) == s["child"]["self_s"] and s["child"]["count"] == 2
    parent = [x for x in got["spans"] if x["name"] == "parent"][0]
    assert [(x["parent"], x["rid"]) for x in got["spans"] if x["name"] == "child"] == [(parent["id"], 7)] * 2


def test_counters_and_spans_from_many_threads():
    """Counts and spans from more threads than cores, switching often, lose
    no update."""
    tr = StageTimer()
    tr.enable(capacity=1 << 20)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with tr.span("w"):
                    tr.count("n")
                    tr.count("m", 2)

        threads = [threading.Thread(target=work) for _ in range(max(16, 2 * (os.cpu_count() or 1)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = tr.drain()
    n = 500 * len(threads)
    assert got["counters"] == {"m": 2 * n, "n": n} and got["summary"]["w"]["count"] == n == len(got["spans"])
    assert len({x["id"] for x in got["spans"]}) == n and all(x["parent"] is None for x in got["spans"])


def test_device_counters_are_read_once_and_zeroed():
    """A device counter's slots reach the counters under DEVICE_COUNTERS'
    names when drained, and start again from zero."""
    tr = StageTimer()
    tr.enable()
    slots = tr.device_counter("radius_count", "cpu")
    assert tr.device_counter("radius_count", "cpu") is slots
    slots += torch.tensor([5, 2, 1], dtype=torch.int32)
    got = tr.drain()["counters"]
    assert got == {"radius_count_tiles_full": 5, "radius_count_tiles_point": 2, "radius_count_wait_expired": 1}
    assert int(slots.abs().sum()) == 0 and set(metrics.DEVICE_COUNTERS["radius_count"]) <= set(metrics.COUNTERS)


def test_copies_are_counted_only_off_the_cpu():
    """count_copies counts blocking copies to a card, and none on the CPU
    (where the program makes none) or into an empty tensor."""
    tr = StageTimer()
    tr.count_copies("x", torch.device("cuda", 0), 2)
    tr.enable()
    tr.count_copies("x", torch.device("cpu"), 5)
    tr.count_copies("x", "cpu")
    tr.count_copies("x", torch.device("cuda", 0), 2)
    tr.count_copies("x", torch.device("cuda"))
    tr.count_copies("x", torch.empty(0, device="meta"))
    tr.count_copies("x", torch.empty(2, device="meta"))
    tr.count_copies("x", torch.empty(2))
    assert tr.drain()["counters"] == {"host_sync.x": 4}


def test_trace_cells_hooks_on_a_small_cell(monkeypatch):
    """tools/trace_cells.py's hooks on the benchmark's odometry entry (a
    small cell on the CPU): the tracer runs over the profiled slice and the
    sync-count window, and each drained window holds its frames' spans and
    LM iterations."""
    from portbench.entries import common
    from portbench.tests.helpers import run_small, small_cell

    for owner, attr in ((common, "Profiled"), (common.TR, "count_syncs"), (common.TR, "Spans")):
        monkeypatch.setattr(owner, attr, getattr(owner, attr))  # restored after the test
    tool, state = _tool(), {}
    tool.install(state)
    run = run_small(small_cell("kitti_hdl64.odometry_window"), trace=True)
    assert run.correct and not GLOBAL_TIMER.on
    for part, frames in (("slice", run.ctx["profile"]["frames"]), ("window", run.ctx["syncs"]["frames"])):
        summary = state[part]["program"]["summary"]
        assert summary["frame"]["count"] == summary["odometry_step"]["count"] == frames == 4
        assert state[part]["program"]["counters"]["lm_iterations"] >= frames
    got = tool.window_numbers(state["window"]["program"], 4)
    assert got["gicp_iterations_per_frame"] == state["window"]["program"]["counters"]["lm_iterations"] / 4


def test_every_counter_the_program_bumps_is_in_the_table():
    """Each counter name in the program's sources is one COUNTERS names
    (host syncs by the ``host_sync`` entry)."""
    import re

    pkg = os.path.join(REPO, "hdl_graph_slam_tpu_torch")
    names = set()
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                names |= set(re.findall(r'GLOBAL_TIMER\.count\("([\w.]+)"', open(os.path.join(d, f)).read()))
    assert names and {n.split(".")[0] if n.startswith("host_sync.") else n for n in names} <= set(metrics.COUNTERS)


def _tool():
    spec = importlib.util.spec_from_file_location("trace_cells", os.path.join(REPO, "tools", "trace_cells.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slice(with_program: bool):
    """A synthetic profiled slice: benchmark span pb/step over [0, 100) with
    program spans hgs/align [10, 60) > hgs/linearize [20, 30); three kernels
    launched from host ops inside them; with ``with_program`` the device
    mirrors of the program's ranges too."""
    host = [dict(kind="host", name="pb/step", start=0, end=100, thread=1),
            dict(kind="host", name="aten::mm", start=5, end=6, thread=1, kernels=["gemm"]),
            dict(kind="host", name="launch", start=22, end=23, thread=1, kernels=["gicp_step_kernel"]),
            dict(kind="host", name="launch", start=40, end=41, thread=1, kernels=["nn1_kernel"])]
    dev = [dict(kind="device", name="gemm", start=6, end=8, thread=7),
           dict(kind="device", name="gicp_step_kernel", start=24, end=26, thread=7),
           dict(kind="device", name="nn1_kernel", start=42, end=50, thread=7)]
    if with_program:
        host += [dict(kind="host", name="hgs/align", start=10, end=60, thread=1),
                 dict(kind="host", name="hgs/linearize", start=20, end=30, thread=1)]
        dev += [dict(kind="device", name="hgs/align", start=24, end=50, thread=7),
                dict(kind="device", name="hgs/linearize", start=24, end=26, thread=7)]
    return host + dev


def test_slice_reduction_leaves_the_program_annotations_out():
    """The device operations, busy time and idle gaps' lengths are the same
    with and without the program's annotations; a reduction that drops only
    the benchmark's counts the mirrored ranges; each kernel is put down to
    the innermost program span around its launch, and each gap to the
    innermost benchmark and program spans at its start."""
    tool = _tool()
    bare, traced = tool.reduce_slice(_slice(False), 1e-4), tool.reduce_slice(_slice(True), 1e-4)
    for k in ("device_ops", "busy_s"):
        assert bare[k] == traced[k]
    assert bare["device_ops"] == 3 and bare["busy_s"] == pytest.approx(12e-6)
    assert traced["device_ops_with_program_annotations"] == 5 and bare["device_ops_with_program_annotations"] == 3
    assert traced["device_ops_by_span"] == {"outside any program span": 1, "linearize": 1, "align": 1}
    assert traced["device_ops_attributed"] == traced["device_ops"]
    assert sorted(traced["idle_gaps"]) == [["step/linearize", pytest.approx(16e-6)], ["step/outside",
                                                                                   pytest.approx(16e-6)]]
    assert sorted(bare["idle_gaps"]) == [["step/outside", pytest.approx(32e-6)]]
    # inside hgs/align [10, 60): busy [24, 26) and [42, 50)
    assert traced["idle_share_in"]["align"] == pytest.approx(1.0 - 10.0 / 50.0)
    assert traced["idle_share_in"]["graph_optimize"] is None


def test_window_numbers_read_the_replay_counters():
    """The pose graph's replay share is its replayed passes over all its
    passes, beside the graphs captured and the host ms of a replayed pass
    (the graph_replay spans over the replayed passes); without replays the
    share is 0, without passes None."""
    tool = _tool()
    spans = [dict(name="graph_replay", t0_ns=0, t1_ns=int(2e6)), dict(name="graph_replay", t0_ns=0, t1_ns=int(6e6))]
    program = dict(counters={"graph_lm_iterations": 40, "graph_lm_replayed": 36, "graph_lm_captures": 3},
                   spans=spans, dropped=0)
    got = tool.window_numbers(program, frames=10)
    assert (got["graph_captures"], got["graph_replayed"]) == (3, 36)
    assert got["graph_replay_share"] == 0.9 and got["graph_replay_host_ms_per_pass"] == pytest.approx(8.0 / 36)
    eager = tool.window_numbers(dict(counters={"graph_lm_iterations": 8}, spans=[], dropped=0), frames=1)
    assert eager["graph_replay_share"] == 0.0 and eager["graph_replay_host_ms_per_pass"] is None
    assert tool.window_numbers(dict(counters={}, spans=[], dropped=0), frames=0)["graph_replay_share"] is None


def test_window_numbers_read_the_drained_counters():
    """Per frame and per cycle ratios of a drained window, None where the
    window holds nothing to read."""
    tool = _tool()
    spans = [dict(name="lm_iteration", t0_ns=0, t1_ns=int(3e6)), dict(name="lm_iteration", t0_ns=0, t1_ns=int(5e6)),
             dict(name="lm_iteration", t0_ns=0, t1_ns=int(4e6)), dict(name="optimize_cycle", t0_ns=0, t1_ns=1),
             dict(name="optimize_cycle", t0_ns=0, t1_ns=1)]
    program = dict(counters={"host_sync.a": 30, "host_sync.b": 10, "lm_iterations": 80, "loop_candidates": 8,
                             "loops_added": 2, "graph_lm_iterations": 12}, spans=spans, dropped=0)
    got = tool.window_numbers(program, frames=10, sync_count=50, graph_iterations=9)
    assert got["host_syncs_per_frame"] == 4.0 and got["host_syncs_covered"] == 0.8
    assert got["gicp_iterations_per_frame"] == 8.0 and got["graph_host_ms_per_iteration"] == pytest.approx(4.0)
    assert got["loop_candidates_per_cycle"] == 4.0 and got["loop_accept_share"] == 0.25
    assert (got["graph_passes"], got["graph_iterations_reported"]) == (12, 9)
    empty = tool.window_numbers(dict(counters={}, spans=[], dropped=0), frames=0)
    assert all(empty[k] is None for k in ("host_syncs_per_frame", "gicp_iterations_per_frame",
                                          "graph_host_ms_per_iteration", "loop_candidates_per_cycle",
                                          "loop_accept_share", "host_syncs_covered"))
