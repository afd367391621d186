#!/usr/bin/env python3
"""The program's tracer on the benchmark's cells, on one CUDA card.

    python3 tools/trace_cells.py attribute --workload <cell> --seed N [--seconds S] [--out DIR]
    python3 tools/trace_cells.py overhead --workload <cell> --seed N [--pairs 2] [--seconds 51]
    python3 tools/trace_cells.py same_work --workload <cell> --seed N [--rounds 10] [--frames 300]

Both run the cell's entry (``portbench/entries/<entry>.py``) in this process
as ``portbench/run.py`` does, with the benchmark's files as they are.

``attribute`` runs it as ``--trace 1`` does, with the program's tracer
(``utils/metrics.py``) on over the profiled slice and over the window after
it: ``odometry_window``'s sync-count window, ``slam_run``'s spanned window.
Over that window torch's sync-debug warnings are also recorded by call site.
It writes ``<--out>/trace_<cell>_<seed>.json`` (default ``_cache/trace_cells``)
and prints one JSON line:

- the profiled slice's device operations with the program's ``hgs/``
  annotations left out (torch mirrors each ``record_function`` range onto
  the device timeline) and with them in, as a reduction that drops only the
  benchmark's ``pb/`` ranges counts them;
- the slice's device operations by the program span that launched them
  (through the launching host op), and its idle gaps named
  ``<innermost pb span>/<innermost hgs span>``;
- the device idle share inside the program's ``graph_optimize`` and
  ``align`` spans;
- the window's counters (host syncs by site against torch's count, LM
  iterations, loop candidates, the pose graph's passes against the
  iterations its solves report, and how many of them CUDA graphs replayed:
  ``graph_lm_replayed`` / ``graph_lm_iterations`` is the replay share,
  ``graph_lm_captures`` the graphs captured) and the per-layer numbers
  they give.

``same_work`` times the cell's first window (a 64-frame odometry window,
or ``--frames`` frames of a fresh ``slam_run`` pipeline) ``--rounds`` times a
side, tracer off and on in turns, on the same inputs, and each side's host
cost of one span and one count.

``overhead`` runs the entry as ``--trace 0`` does, ``--pairs`` times with the
tracer off and on in turns (off, on; on, off; ...; the two runs of a pair
on one seed, so on the same inputs), and prints each run's end-to-end rate
and a last line with both sides' medians.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import traceback
import warnings
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROGRAM, BENCH = "hgs/", "pb/"
TRACE_CAPACITY = 1 << 18
SITE_ROOTS = ("hdl_graph_slam_tpu_torch", "portbench")


# -- reductions of a torch.profiler run (plain data in, plain data out) --------

def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(merged, windows) -> float:
    """Length of the union ``merged`` inside the union ``windows``."""
    total, i = 0.0, 0
    for a, b in windows:
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < b:
            total += max(0.0, min(b, merged[j][1]) - max(a, merged[j][0]))
            j += 1
    return total


def innermost(ranges, points):
    """For each point (time, thread), the innermost of ``ranges`` (start,
    end, thread, name) open at that time on that thread, or None: ranges of
    one thread nest."""
    by_thread = defaultdict(list)
    for r in ranges:
        by_thread[r[2]].append(r)
    marks = defaultdict(list)
    for th, rs in by_thread.items():
        for k, (a, b, _, name) in enumerate(rs):
            marks[th].append((a, 0, k, name))
            marks[th].append((b, 2, k, name))
    for i, (t, th) in enumerate(points):
        marks[th].append((t, 1, i, None))
    out = [None] * len(points)
    for th, ms in marks.items():
        stack, closed = [], set()
        for _, kind, k, name in sorted(ms, key=lambda m: (m[0], m[1])):
            if kind == 0:
                stack.append((k, name))
            elif kind == 2:
                closed.add(k)
                while stack and stack[-1][0] in closed:
                    stack.pop()
            else:
                open_ = [n for j, n in stack if j not in closed]
                out[k] = open_[-1] if open_ else None
    return out


def reduce_slice(events, wall_s: float, idle_in=("graph_optimize", "align")) -> dict:
    """``events``: dicts of a profiled slice, each with ``kind`` ("device",
    "host"), ``name``, ``start``, ``end`` (us), ``thread``; a host event may
    carry ``kernels``, the device operations it launched (names). Returns
    the device operations without and with the program's annotations, those
    by the program span that launched them, the idle gaps named by the
    innermost benchmark and program spans open at their start, and the idle
    share inside the named program spans."""
    def annotation(name):
        return name.startswith(PROGRAM) or name.startswith(BENCH)

    dev = [e for e in events if e["kind"] == "device" and not annotation(e["name"])]
    dev_with_program = [e for e in events if e["kind"] == "device" and not e["name"].startswith(BENCH)]
    host = [e for e in events if e["kind"] == "host"]
    spans = {p: [(e["start"], e["end"], e["thread"], e["name"][len(p):]) for e in host if e["name"].startswith(p)]
             for p in (PROGRAM, BENCH)}
    merged = union([(e["start"], e["end"]) for e in dev])
    busy = sum(b - a for a, b in merged)

    launchers = [e for e in host if not annotation(e["name"]) and e.get("kernels")]
    where = innermost(spans[PROGRAM], [(e["start"], e["thread"]) for e in launchers])
    by_span = Counter()
    for e, name in zip(launchers, where):
        by_span[name or "outside any program span"] += sum(1 for k in e["kernels"] if not annotation(k))

    gaps = [(a1, b0 - a1) for (_, a1), (b0, _) in zip(merged, merged[1:])]
    main = Counter(r[2] for r in spans[BENCH] or spans[PROGRAM]).most_common(1)
    th = main[0][0] if main else None
    outer = innermost(spans[BENCH], [(t, th) for t, _ in gaps])
    inner = innermost(spans[PROGRAM], [(t, th) for t, _ in gaps])
    named = defaultdict(float)
    for (_, length), o, i in zip(gaps, outer, inner):
        named[f"{o or 'outside'}/{i or 'outside'}"] += length * 1e-6

    idle = {}
    for name in idle_in:
        windows = union([(a, b) for a, b, _, n in spans[PROGRAM] if n == name])
        wall = sum(b - a for a, b in windows)
        idle[name] = None if wall <= 0 else 1.0 - overlap(merged, windows) / wall
    return {
        "wall_s": wall_s, "busy_s": busy * 1e-6,
        "device_ops": len(dev), "device_ops_with_program_annotations": len(dev_with_program),
        "device_ops_by_span": dict(by_span.most_common()),
        "device_ops_attributed": sum(by_span.values()),
        "idle_gaps": sorted(([k, v] for k, v in named.items()), key=lambda kv: -kv[1])[:12],
        "idle_share_in": idle,
    }


def profile_events(prof) -> list:
    """A torch.profiler run's events as ``reduce_slice`` takes them."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        kind = "device" if e.device_type == DeviceType.CUDA else "host"
        out.append({"kind": kind, "name": e.name, "start": e.time_range.start, "end": e.time_range.end,
                    "thread": e.thread, "kernels": [k.name for k in getattr(e, "kernels", [])] if kind == "host"
                    else None})
    return out


# -- the window's numbers ------------------------------------------------------

def window_numbers(program: dict, frames: int, sync_count=None, graph_iterations=None) -> dict:
    """The per-layer numbers a window's drained tracer gives (None where
    the window holds nothing to read)."""
    c, spans = program["counters"], program["spans"]
    syncs = sum(v for k, v in c.items() if k.startswith("host_sync."))
    lm_ms = sorted((s["t1_ns"] - s["t0_ns"]) * 1e-6 for s in spans if s["name"] == "lm_iteration")
    replay_ms = sum((s["t1_ns"] - s["t0_ns"]) * 1e-6 for s in spans if s["name"] == "graph_replay")
    cycles = sum(1 for s in spans if s["name"] == "optimize_cycle")
    out = {
        "frames": frames,
        "host_syncs_per_frame": syncs / frames if frames else None,
        "host_syncs_counted": syncs,
        "host_syncs_torch": sync_count,
        "host_syncs_covered": (syncs / sync_count) if sync_count else None,
        "gicp_iterations_per_frame": c.get("lm_iterations", 0) / frames if frames else None,
        "graph_host_ms_per_iteration": statistics.median(lm_ms) if lm_ms else None,
        "loop_candidates_per_cycle": c.get("loop_candidates", 0) / cycles if cycles else None,
        "loop_accept_share": (c.get("loops_added", 0) / c["loop_candidates"]) if c.get("loop_candidates") else None,
        "graph_passes": c.get("graph_lm_iterations"),
        "graph_iterations_reported": graph_iterations,
        "graph_captures": c.get("graph_lm_captures", 0),
        "graph_replayed": c.get("graph_lm_replayed", 0),
        "graph_replay_share": c.get("graph_lm_replayed", 0) / c["graph_lm_iterations"]
        if c.get("graph_lm_iterations") else None,
        "graph_replay_host_ms_per_pass": replay_ms / c["graph_lm_replayed"] if c.get("graph_lm_replayed") else None,
        "cycles": cycles,
        "dropped": program["dropped"],
    }
    return out


# -- hooks on the benchmark's entry --------------------------------------------

@contextlib.contextmanager
def sync_sites(sites: Counter):
    """Record torch's sync-debug warnings inside the block by call site: the
    three innermost frames in the program or the benchmark."""
    import torch

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if any(f"/{r}/" in f.filename for r in SITE_ROOTS)][-3:]
        sites[" <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}" for f in reversed(frames))
              or f"{filename}:{lineno}"] += 1

    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)


def install(state: dict):
    """Wrap the entries' profiled slice and the window after it so that the
    tracer runs over both; what it drained goes into ``state``."""
    from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER
    from portbench.entries import common

    class TracedProfiled(common.Profiled):
        def __enter__(self):
            out = super().__enter__()
            GLOBAL_TIMER.enable(TRACE_CAPACITY)
            return out

        def __exit__(self, *exc):
            GLOBAL_TIMER.disable()
            super().__exit__(*exc)
            state["slice"] = {"prof": self.prof, "wall_s": self.wall, "program": GLOBAL_TIMER.drain()}
            return False

    @contextlib.contextmanager
    def traced_count_syncs(box, device):
        sites = Counter()
        GLOBAL_TIMER.enable(TRACE_CAPACITY)
        try:
            with sync_sites(sites):
                yield
        finally:
            GLOBAL_TIMER.disable()
        box.append(sum(sites.values()))
        state["window"] = {"program": GLOBAL_TIMER.drain(), "sites": sites, "sync_count": box[-1]}

    class TracedSpans(common.TR.Spans):
        def wrap(self, owner, attr, name, sync=False, keep=None):
            if sync and not getattr(self, "_sites", None):
                self._sites = Counter()
                self._block = sync_sites(self._sites)
                self._block.__enter__()
                GLOBAL_TIMER.enable(TRACE_CAPACITY)
            super().wrap(owner, attr, name, sync=sync, keep=keep)

        def restore(self):
            super().restore()
            if getattr(self, "_sites", None) is not None and "window" not in state:
                GLOBAL_TIMER.disable()
                self._block.__exit__(None, None, None)
                state["window"] = {"program": GLOBAL_TIMER.drain(), "sites": self._sites,
                                   "sync_count": sum(self._sites.values())}

    common.Profiled = TracedProfiled
    common.TR.count_syncs = traced_count_syncs
    common.TR.Spans = TracedSpans


def make_env(workload: str, seed: int, seconds: float, trace: bool):
    from portbench import harness
    from portbench.run import Env

    harness.set_cache_env()
    cell = harness.find_cell(workload)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_cells.py: no CUDA card")
    torch.set_num_threads(4)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    return Env(cell, seed % (1 << 63), seconds, trace, torch.device("cuda", 0), time.perf_counter())


def card() -> dict:
    import subprocess

    import torch

    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": limit}


def check_radius() -> dict:
    """radius_count on the card against its plain twin, its statistics, and
    the tracer's device counter: the kernel's third slot reaches the tracer."""
    import torch
    from hdl_graph_slam_tpu_torch.ops import knn
    from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER

    g = torch.Generator().manual_seed(0)
    q = (torch.rand(20000, 3, generator=g) * 40.0 - 20.0).cuda()
    tiles = knn.radius_count_tiles(q, q, 0.5)
    GLOBAL_TIMER.enable()
    try:
        counts = knn.radius_count(q, q, 0.5)
    finally:
        GLOBAL_TIMER.disable()
    with_tracer = GLOBAL_TIMER.drain()["counters"]
    plain = knn.radius_count_plain(q.cpu(), q.cpu(), 0.5)
    return {"equal_plain": bool(torch.equal(counts.cpu(), plain)), "stats_call_equal": bool(torch.equal(
        tiles["counts"].cpu(), plain)), "full": tiles["full"], "point": tiles["point"],
        "wait_expired": tiles["wait_expired"], "tracer_counters": with_tracer}


def attribute(args) -> dict:
    from portbench import harness

    state = {}
    install(state)
    out = {"workload": args.workload, "seed": args.seed, "card": card()}
    if args.check_radius:
        out["radius_check"] = check_radius()
    env = make_env(args.workload, args.seed, args.seconds, True)
    run = harness.entry(env.cell.mix["entry"]).run(env)
    out["correct"] = run.correct
    out["e2e"] = run.e2e
    out["bench_per_layer"] = {m["name"]: harness.metric_reader(m["name"])(run.ctx) for m in env.cell.per_layer}
    sl = state["slice"]
    reduced = reduce_slice(profile_events(sl["prof"]), sl["wall_s"])
    frames = run.ctx["profile"]["frames"]
    reduced["frames"] = frames
    reduced["device_ops_per_frame"] = reduced["device_ops"] / frames
    reduced["bench_device_ops"] = run.ctx["profile"]["device_ops"]  # the benchmark's count, tracer on
    reduced["counters"] = sl["program"]["counters"]
    reduced["summary"] = sl["program"]["summary"]
    out["slice"] = reduced
    win = state["window"]
    if "syncs" in run.ctx:
        frames = run.ctx["syncs"]["frames"]
        graph_its = None
    else:
        frames = len(run.ctx["spans"]["frame"])
        graph_its = sum(run.ctx["spans"]["graph_iterations"])
    # torch's count in the program's own code: the benchmark's spans synchronise too
    program_syncs = sum(v for k, v in win["sites"].items() if not k.startswith("portbench"))
    out["window"] = window_numbers(win["program"], frames, program_syncs, graph_its)
    out["window"]["host_syncs_torch_all"] = win["sync_count"]
    out["window"]["counters"] = win["program"]["counters"]
    out["window"]["summary"] = win["program"]["summary"]
    counted = {k[len("host_sync."):]: v for k, v in win["program"]["counters"].items() if k.startswith("host_sync.")}
    out["window"]["host_sync_counters"] = counted
    out["window"]["sync_sites"] = dict(win["sites"].most_common())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"trace_{args.workload}_{args.seed}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    brief = {k: out[k] for k in ("workload", "seed", "correct", "e2e", "bench_per_layer")}
    brief["slice"] = {k: reduced[k] for k in ("frames", "device_ops", "device_ops_with_program_annotations",
                                              "bench_device_ops", "device_ops_attributed", "idle_gaps",
                                              "idle_share_in", "busy_s", "wall_s")}
    brief["slice"]["device_ops_by_span"] = dict(list(reduced["device_ops_by_span"].items())[:12])
    brief["window"] = {k: v for k, v in out["window"].items() if k not in ("summary", "sync_sites", "counters")}
    brief["file"] = os.path.relpath(path, ROOT)
    return brief


def overhead(args) -> dict:
    from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER
    from portbench import harness

    rates = {"off": [], "on": []}
    metric = None
    order = []
    for p in range(args.pairs):
        order += ["off", "on"] if p % 2 == 0 else ["on", "off"]
    for i, side in enumerate(order):
        env = make_env(args.workload, args.seed + i // 2, args.seconds, False)  # a pair's sides share a seed
        metric = [m["name"] for m in env.cell.end_to_end if m["name"] != "setup_s"][0]
        if side == "on":
            GLOBAL_TIMER.enable(TRACE_CAPACITY)
        try:
            run = harness.entry(env.cell.mix["entry"]).run(env)
        finally:
            GLOBAL_TIMER.disable()
        drained = GLOBAL_TIMER.drain()
        rates[side].append(run.e2e[metric])
        print(json.dumps({"run": i, "side": side, "seed": env.seed, metric: run.e2e[metric],
                          "setup_s": run.e2e["setup_s"], "correct": run.correct,
                          "spans": sum(v["count"] for v in drained["summary"].values()),
                          "dropped": drained["dropped"]}), flush=True)
    med = {k: statistics.median(v) for k, v in rates.items()}
    return {"workload": args.workload, "metric": metric, "off": rates["off"], "on": rates["on"],
            "median_off": med["off"], "median_on": med["on"], "on_over_off": med["on"] / med["off"],
            "card": card()}


def call_cost(n: int = 200_000) -> dict:
    """Host microseconds a span (open and close) and a count take, tracer
    off and on (no profiler running)."""
    from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER

    out = {}
    for side in ("off", "on"):
        if side == "on":
            GLOBAL_TIMER.enable(n + 1)
        t0 = time.perf_counter()
        for _ in range(n):
            with GLOBAL_TIMER.span("x"):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            GLOBAL_TIMER.count("y")
        t2 = time.perf_counter()
        GLOBAL_TIMER.disable()
        GLOBAL_TIMER.reset()
        out[side] = {"span_us": 1e6 * (t1 - t0) / n, "count_us": 1e6 * (t2 - t1) / n}
    return out


def same_work(args) -> dict:
    """The tracer's cost on identical work: the cell's first window of
    frames (odometry_window: one 64-frame window from the bootstrapped
    state; slam_run: a fresh pipeline over the first ``--frames`` frames,
    its optimize cycles included) run again and again, tracer off and on in
    turns, each run timed to a device synchronisation."""
    import numpy as np
    import torch
    from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER
    from portbench import course as C
    from portbench.entries import common

    env = make_env(args.workload, args.seed, args.seconds, False)
    cfg, mix, dev = env.cell.config, env.cell.mix, env.device
    prog = common.program_config(cfg)
    course = C.build(cfg["sensor"], mix["course"], env.seed, dev)
    scans, period = common.Scans(course.scans), course.period_s
    if mix["entry"] == "odometry_window":
        from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
        from hdl_graph_slam_tpu_torch.frontend.window import OdometryWindow, stack_scans

        raw, frames = cfg["raw_capacity"], mix["window"]
        win = OdometryWindow(prog.odometry, prefilter_cfg=prog.prefilter, out_capacity=cfg["cloud_capacity"],
                             device=dev)
        state0 = win.init_state(0.0, cloudlib.from_numpy(scans[0], capacity=raw, device=dev))
        xyz, mask = stack_scans([scans[f] for f in range(1, frames + 1)], capacity=raw)
        stamps = np.asarray([f * period for f in range(1, frames + 1)], dtype=np.float32)

        def once():
            win.run_with_clouds(state0, xyz, mask, stamps)[1].cpu()
    else:
        from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline

        frames = args.frames

        def once():
            pipe = SlamPipeline(prog, cloud_capacity=cfg["cloud_capacity"], device=dev)
            for p in range(frames):
                pipe.process_frame(p * period, scans[p])

    once()
    walls, spans = {"off": [], "on": []}, []
    for r in range(args.rounds):
        for side in ("off", "on") if r % 2 == 0 else ("on", "off"):
            if side == "on":
                GLOBAL_TIMER.enable(TRACE_CAPACITY)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            once()
            torch.cuda.synchronize()
            walls[side].append(time.perf_counter() - t0)
            GLOBAL_TIMER.disable()
            drained = GLOBAL_TIMER.drain()
            if side == "on":
                spans.append(sum(v["count"] for v in drained["summary"].values()))
    med = {k: statistics.median(v) for k, v in walls.items()}
    return {"workload": args.workload, "frames": frames, "rounds": args.rounds, "walls_s": walls,
            "median_s": med, "ms_per_frame": {k: 1e3 * v / frames for k, v in med.items()},
            "on_over_off": med["on"] / med["off"], "spans_per_frame": statistics.median(spans) / frames,
            "call_cost": call_cost(), "card": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("attribute", "overhead", "same_work"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1234567)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=10, help="same_work: rounds of one run a side")
    ap.add_argument("--frames", type=int, default=300, help="same_work in slam_run: frames a run")
    ap.add_argument("--check-radius", action="store_true", help="first check radius_count's statistics on the card")
    ap.add_argument("--out", default=os.path.join(ROOT, "_cache", "trace_cells"), help="attribute: the JSON's directory")
    args = ap.parse_args(argv)
    out = {"attribute": attribute, "overhead": overhead, "same_work": same_work}[args.mode](args)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
