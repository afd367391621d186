"""Entry ``slam_run``: ``SlamPipeline.run``'s path, one ``process_frame`` a
scan (prefilter, per-frame odometry, floor detection, keyframes, and the
backend's ``optimize_cycle`` inline whenever the stream time passes the
graph cadence), as the offline CLI without ``--window`` and the reference's
per-scan nodelets run it.

A job is a fresh ``SlamPipeline`` over the mix's first ``job_frames``
frames of the course, stamps ``period_s`` apart, ending in ``finish`` as
``run`` does. Jobs run back to back, and the window ends with the first job
to end after ``--seconds``: every window holds whole jobs, so its work does
not depend on where the clock stops. The rate counts every frame through
``process_frame`` (with the cycles it triggered and the jobs' flushes) over
the window's wall time.

With ``--trace 1`` the first job's frames from the end of its first
optimize cycle to the end of the first cycle that solved the graph run
under the profiler; the rest of the window runs with spans that
synchronise the card at the end of each frame, cycle and graph solve.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import course as C
from ..harness import Run
from ..reference import check as RC
from ..reference.odometry import Frames
from . import common


class Job:
    """One SlamPipeline over the course and what it returned, frame by frame."""

    def __init__(self, prog, cap, dev):
        from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline

        self.pipe = SlamPipeline(prog, cloud_capacity=cap, device=dev)
        self.rec = RC.OdometryRecord()
        self.floors = {}
        self.cycles = 0
        self.finished = False
        self.p = 0
        self.t0 = time.perf_counter()
        self.period = None
        det = self.pipe.floor.detect if self.pipe.floor is not None else None
        if det is not None:
            def detect(cloud, _det=det):
                out = _det(cloud)
                self.floors[self.p] = None if out is None else np.asarray(out, dtype=np.float64)
                return out

            self.pipe.floor.detect = detect
        slam = self.pipe.slam

        def cycle():
            out = type(slam).optimize_cycle(slam)  # the class's method as it is now (spans wrap it)
            self.cycles += 1
            return out

        slam.optimize_cycle = cycle

    def frame(self, scans, period):
        """Process the next frame of the course."""
        p = self.p
        odo = self.pipe.odometry
        kf = 0 if odo.keyframe is None else int(round(odo.keyframe_stamp / period))
        pose = self.pipe.process_frame(p * period, scans[p])
        st = odo.last_status
        self.rec.scan.append(p)
        self.rec.stamp.append(p * period)
        self.rec.odom.append(np.asarray(pose, dtype=np.float64))
        self.rec.keyframe.append(kf if p else 0)
        self.rec.converged.append(True if (p == 0 or st is None) else bool(st.has_converged))
        self.rec.switched.append(True)
        if p:
            self.rec.switched[p] = int(round(odo.keyframe_stamp / period)) == p
        self.p += 1

    def graph(self) -> RC.GraphRecord:
        """The keyframes in the graph, their optimized poses, which hold a
        floor edge, and the loop edges (the se3 edges under a robust kernel)."""
        from hdl_graph_slam_tpu_torch.graph.robust import KERNEL_IDS

        slam = self.pipe.slam
        kfs = list(slam.keyframes)
        index = {k.node_id: i for i, k in enumerate(kfs)}
        loop_kernel = KERNEL_IDS[slam.cfg.backend.loop_closure_edge_robust_kernel]
        loops = [(index[e["vi"]], index[e["vj"]], np.asarray(e["meas"])) for e in slam.graph.edge_rows["se3_se3"]
                 if e["kernel_id"] == loop_kernel and e["vi"] in index and e["vj"] in index]
        return RC.GraphRecord(keyframes=[int(round(k.stamp / self.period)) for k in kfs],
                              poses=np.stack([slam.graph.poses[k.node_id] for k in kfs]),
                              floors=[None if k.floor_coeffs is None else np.asarray(k.floor_coeffs, dtype=np.float64)
                                      for k in kfs], loops=loops)


def _drive(jobs, make, scans, period, n, until):
    """Process frames, starting jobs of ``n`` frames as they end, until ``until()``."""
    while not until():
        if not jobs or jobs[-1].finished:
            jobs.append(make())
            jobs[-1].period = period
        job = jobs[-1]
        job.frame(scans, period)
        if job.p == n:
            job.pipe.finish()
            job.finished = True


def run(env) -> Run:
    from hdl_graph_slam_tpu_torch.backend import slam as slam_mod
    from hdl_graph_slam_tpu_torch.pipeline import SlamPipeline

    cfg, mix, dev = env.cell.config, env.cell.mix, env.device
    prog = common.program_config(cfg)
    env.note("entry_start_s", time.perf_counter() - env.t0)
    course = C.build(cfg["sensor"], mix["course"], env.seed, dev)
    env.note("cast_done_s", time.perf_counter() - env.t0)
    scans, period, cap, n = course.scans, course.period_s, cfg["cloud_capacity"], mix["job_frames"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def make():
        return Job(prog, cap, dev)

    # warm-up on a pipeline of its own: a short job and its flush, which
    # solves the graph once (every kernel and library the window uses)
    warm = [make()]
    warm[0].period = period
    _drive(warm, make, scans, period, mix["warmup_frames"], lambda: warm[-1].finished)
    del warm
    common.sync(dev)
    env.setup_done()

    jobs: list = []
    ctx = {}
    t0 = time.perf_counter()
    if env.trace:
        spans = common.TR.Spans()
        spans.wrap(SlamPipeline, "process_frame", "process_frame")
        spans.wrap(slam_mod.HdlGraphSlam, "optimize_cycle", "optimize_cycle")
        spans.wrap(slam_mod, "graph_optimize", "graph_optimize")
        _drive(jobs, make, scans, period, n, lambda: bool(jobs) and (jobs[-1].cycles >= 1 or jobs[-1].finished))
        first = jobs[-1].p
        with common.Profiled(dev) as prof:
            _drive(jobs, make, scans, period, n, lambda: jobs[-1].finished
                   or (jobs[-1].pipe.slam.last_stats is not None and jobs[-1].p > first))
        spans.restore()
        traced = jobs[-1].p - first
        env.note("profiled_frames", (first, jobs[-1].p))
        spans = common.TR.Spans()
        spans.wrap(SlamPipeline, "process_frame", "frame", sync=True)
        spans.wrap(slam_mod.HdlGraphSlam, "optimize_cycle", "optimize_cycle", sync=True)
        spans.wrap(slam_mod, "graph_optimize", "graph_optimize", sync=True,
                   keep=lambda out: int(out[1].iterations))
        t1 = time.perf_counter()
        _drive(jobs, make, scans, period, n, lambda: jobs[-1].finished and time.perf_counter() - t0 >= env.seconds)
        spans.restore()
        env.note("cycles_s", [round(x, 3) for x in spans.walls["optimize_cycle"]])
        env.note("graph_s_iterations", list(zip([round(x, 3) for x in spans.walls["graph_optimize"]],
                                                spans.results["graph_optimize"])))
        ctx["spans"] = {"window_s": time.perf_counter() - t1, "frame": spans.walls["frame"],
                        "optimize_cycle": spans.walls["optimize_cycle"],
                        "graph_optimize": spans.walls["graph_optimize"],
                        "graph_iterations": spans.results["graph_optimize"]}
    else:
        _drive(jobs, make, scans, period, n,
               lambda: bool(jobs) and jobs[-1].finished and time.perf_counter() - t0 >= env.seconds)
    wall = time.perf_counter() - t0
    frames = sum(j.p for j in jobs)
    env.note("job_s", [round(b.t0 - a.t0, 3) for a, b in zip(jobs, jobs[1:])] + [round(t0 + wall - jobs[-1].t0, 3)])
    if env.trace:
        ctx["profile"] = prof.reduce(traced)  # after the window: reading the trace takes a while

    device = common.device_numbers(dev)
    # the graph judged: the last finished job's, else the last that solved one
    optimized = [j for j in jobs if j.finished] or [j for j in jobs if j.pipe.slam.last_stats is not None]
    graphs = [(j.graph(), j.rec, j.floors) for j in optimized[-1:]]
    failed = sum(1 for j in jobs for c in j.rec.converged if not c)
    records = [(j.rec, j.floors) for j in jobs]
    del jobs, optimized  # the program's state goes before the reference runs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    env.note("not_converged", [(i, q) for i, (r, _) in enumerate(records) for q, c in enumerate(r.converged)
                               if not c][:20])
    env.note("graph_frames_keyframes_loops", [(len(r.scan), len(g.keyframes), len(g.loops)) for g, r, _ in graphs])
    t_check = time.perf_counter()
    p = cfg["params"]
    ref = Frames(scans, p["prefilter"], p["registration"], cap, dev)
    rng = np.random.default_rng([env.seed, 2])
    pairs = common.sample(rng, [(i, q) for i, (r, _) in enumerate(records) for q in range(1, len(r.scan))],
                          mix["check_frames"])
    gaps, mismatches, near, at = [], 0, [], []
    for i, (r, floors) in enumerate(records):
        pos = [q for (j, q) in pairs if j == i]
        judged = RC.judge_odometry(r, ref, pos, p["odometry"], project=False)
        gaps, mismatches = gaps + judged["gaps"], mismatches + judged["switch_mismatches"]
        near, at = near + [(i,) + m for m in judged["switch_near_ties"]], at + [(i,) + m for m in judged["switch_mismatch_at"]]
    env.note("switch_near_ties_mismatch_at", (near, at))
    env.note("gaps", sorted(zip(gaps, pairs), reverse=True)[:5])
    env.note("all_gaps", [float(f"{x:.4g}") for x in gaps])
    gaps_all = gaps
    move = 0.0
    for g, rec, floors in graphs:
        planes = RC.reference_floors(rec, ref, range(len(rec.scan)), p["floor"], cap)
        floor_pos = common.sample(rng, range(len(rec.scan)), mix["check_floors"])
        env.note("floor_shortfall", RC.floor_shortfall(floors, {q: planes[q] for q in floor_pos}, p["floor"]))
        move, loop_gaps = RC.judge_graph(g, rec, ref, p["information"], p["backend"]["floor_edge_stddev"], planes,
                                         p["floor"]["ransac_distance_thresh"],
                                         p["backend"]["loop_closure_edge_robust_kernel_size"])
        env.note("loop_gaps", loop_gaps)
        gaps_all = gaps + loop_gaps
    env.note("pose_gap_m", max(gaps_all, default=0.0))
    kept = [int(ref.points(records[i][0].scan[q]).shape[0]) for i, q in pairs]
    env.note("points_kept_min_max", (min(kept, default=0), max(kept, default=0)))
    env.note("check_s", time.perf_counter() - t_check)
    limits, q = mix["limits"], RC.gap_quantiles(gaps)
    out = Run(attempted=frames, failed=failed,
              e2e={"slam_frames_per_s": frames / wall, "setup_s": env.setup_s},
              checks={"pose_gap_median_m": (q["pose_gap_median_m"], limits["pose_gap_median_m"]),
                      "pose_gap_p90_m": (q["pose_gap_p90_m"], limits["pose_gap_p90_m"]),
                      "switch_mismatches": (mismatches, limits["switch_mismatches"]),
                      "graph_move_m": (move, limits["graph_move_m"])},
              ctx=ctx, device_extra=device)
    if env.trace:
        out.breakdown = common.breakdown(ctx["profile"])
        out.device_extra.update(busy_s=ctx["profile"]["busy_s"], window_s=ctx["profile"]["wall_s"])
    return out


def control(env, frames: int) -> dict:
    """The reference in the program's place over the first ``frames``
    frames of a job, each part one precision below the configuration's:
    odometry and floors with TF32 products, the graph solved in float32
    from the odometry chain. Judged as a run is: the readings of the
    control."""
    from ..reference import graph as RG
    from ..reference import precision

    cfg, mix, dev = env.cell.config, env.cell.mix, env.device
    course = C.build(cfg["sensor"], mix["course"], env.seed, dev)
    p, cap, period = cfg["params"], cfg["cloud_capacity"], course.period_s
    with precision(tf32=True):
        mine = Frames(course.scans, p["prefilter"], p["registration"], cap, dev)
        rec = RC.odometry_chain(mine, list(range(frames)), [i * period for i in range(frames)], p["odometry"],
                                project=False)
        kfs = RC.keyframes_of(rec, p["backend"])
        mine_floors = RC.reference_floors(rec, mine, list(range(frames)), p["floor"], cap)
        g = RC.GraphRecord(keyframes=kfs, poses=np.stack([RG.project_rotation(rec.odom[k]) for k in kfs]),
                           floors=[mine_floors[k][0] for k in kfs])
        graph, _ = RC.reference_graph(g, rec, mine, p["information"], p["backend"]["floor_edge_stddev"],
                                      mine_floors, p["floor"]["ransac_distance_thresh"], dev, dtype=torch.float32)
        g.poses = RG.solve(graph, dtype=torch.float32).double().cpu().numpy()
    floors = {k: c for k, (c, _) in mine_floors.items()}
    del mine, mine_floors
    ref = Frames(course.scans, p["prefilter"], p["registration"], cap, dev)
    rng = np.random.default_rng([env.seed, 2])
    positions = common.sample(rng, range(1, frames), mix["check_frames"])
    judged = RC.judge_odometry(rec, ref, positions, p["odometry"], project=False)
    floor_pos = common.sample(rng, range(frames), mix["check_floors"])
    planes = RC.reference_floors(rec, ref, range(frames), p["floor"], cap)
    return {"pose_gap_m": judged["pose_gap_m"], "pose_gap_median_m": judged["pose_gap_median_m"],
            "pose_gap_p90_m": judged["pose_gap_p90_m"], "switch_mismatches": judged["switch_mismatches"],
            "floor_shortfall": RC.floor_shortfall(floors, {q: planes[q] for q in floor_pos}, p["floor"]),
            "graph_move_m": RC.judge_graph(g, rec, ref, p["information"], p["backend"]["floor_edge_stddev"], planes,
                                           p["floor"]["ransac_distance_thresh"],
                                           p["backend"]["loop_closure_edge_robust_kernel_size"])[0]}
