"""Entry ``odometry_window``: the windowed odometry, as
``SlamPipeline.run_windowed`` drives it, without the backend.

Frame 0 bootstraps the keyframe (``OdometryWindow.init_state``); then
windows of ``window`` host scans, padded by ``stack_scans`` to the raw
capacity, go through ``OdometryWindow.run_with_clouds`` (prefilter,
covariances, LM GICP, the keyframe logic, all on the device), the state
carried from window to window, and each window's poses come back to the
host in one copy. The drive repeats its closed route lap after lap until
the window's time is up; the rate counts every frame whose pose reached the
host over the wall time of all the windows.

With ``--trace 1`` the first ``trace_frames`` frames run as one shorter
window under the profiler, and the next window under torch's sync-debug
count, before the plain windows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import course as C
from ..harness import Run
from ..reference import check as RC
from ..reference.odometry import Frames
from . import common


def _windows(env, win, state, scans, period, start, count, raw):
    """Run ``count`` frames from frame ``start`` as one window: (state,
    poses float64 (count, 4, 4), status)."""
    from hdl_graph_slam_tpu_torch.frontend.window import stack_scans

    frames = range(start, start + count)
    xyz, mask = stack_scans([scans[f] for f in frames], capacity=raw)
    stamps = np.asarray([f * period for f in frames], dtype=np.float32)
    state, odoms, status, _, _ = win.run_with_clouds(state, xyz, mask, stamps)
    return state, odoms.cpu().numpy().astype(np.float64), status


def run(env) -> Run:
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.frontend import window as window_mod
    from hdl_graph_slam_tpu_torch.frontend.window import OdometryWindow

    cfg, mix, dev = env.cell.config, env.cell.mix, env.device
    prog = common.program_config(cfg)
    env.note("entry_start_s", time.perf_counter() - env.t0)
    course = C.build(cfg["sensor"], mix["course"], env.seed, dev)
    env.note("cast_done_s", time.perf_counter() - env.t0)
    scans = common.Scans(course.scans)
    period, raw, cap, W = course.period_s, cfg["raw_capacity"], cfg["cloud_capacity"], mix["window"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def make():
        return OdometryWindow(prog.odometry, prefilter_cfg=prog.prefilter, out_capacity=cap, device=dev)

    def bootstrap(win):
        return win.init_state(0.0, cloudlib.from_numpy(scans[0], capacity=raw, device=dev))

    # warm-up on an instance of its own: the bootstrap and one window
    warm = make()
    _windows(env, warm, bootstrap(warm), scans, period, 1, mix["warmup_frames"], raw)
    del warm
    win = make()
    state = bootstrap(win)
    common.sync(dev)
    env.setup_done()

    poses, statuses = [np.eye(4)], []
    ctx = {}
    f = 1
    t0 = time.perf_counter()
    if env.trace:
        spans = common.TR.Spans()
        spans.wrap(window_mod, "device_step_impl", "odometry_step")
        spans.wrap(window_mod, "stack_scans", "stack_scans")
        spans.wrap(OdometryWindow, "_prefilter", "prefilter")
        spans.wrap(OdometryWindow, "run_with_clouds", "window")
        n = mix["trace_frames"]
        with common.Profiled(dev) as prof:
            state, od, st = _windows(env, win, state, scans, period, f, n, raw)
        spans.restore()
        poses.extend(od)
        statuses.append(st)
        f += n
        box = []
        with common.TR.count_syncs(box, dev):
            state, od, st = _windows(env, win, state, scans, period, f, W, raw)
        poses.extend(od)
        statuses.append(st)
        f += W
        ctx = {"syncs": {"count": box[0], "frames": W}}
    while time.perf_counter() - t0 < env.seconds:
        state, od, st = _windows(env, win, state, scans, period, f, W, raw)
        poses.extend(od)
        statuses.append(st)
        f += W
    wall = time.perf_counter() - t0
    frames = f - 1
    if env.trace:
        ctx["profile"] = prof.reduce(n)  # after the window: reading the trace takes a while

    device = common.device_numbers(dev)
    switched = [True] + [bool(x) for s in statuses for x in s["keyframe_switched"].cpu().tolist()]
    converged = [True] + [bool(x) for s in statuses for x in s["converged"].cpu().tolist()]
    del win, state, statuses
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec = RC.OdometryRecord(scan=[p % len(scans) for p in range(f)], stamp=[p * period for p in range(f)],
                            odom=poses, switched=switched, converged=converged)
    k = 0
    for p in range(f):
        rec.keyframe.append(k)
        if p and switched[p]:
            k = p
    env.note("not_converged", [p for p in range(f) if not converged[p]][:20])
    t_check = time.perf_counter()
    rng = np.random.default_rng([env.seed, 1])
    positions = common.sample(rng, range(1, f), mix["check_frames"])
    ref = Frames(course.scans, cfg["params"]["prefilter"], cfg["params"]["registration"], cap, dev)
    judged = RC.judge_odometry(rec, ref, positions, cfg["params"]["odometry"], project=True)
    env.note("gaps", sorted(zip(judged["gaps"], positions), reverse=True)[:5])
    env.note("all_gaps", [float(f"{x:.4g}") for x in judged["gaps"]])
    env.note("pose_gap_m", judged["pose_gap_m"])
    env.note("switch_near_ties_mismatch_at", (judged["switch_near_ties"], judged["switch_mismatch_at"]))
    kept = [int(ref.points(rec.scan[p]).shape[0]) for p in positions]
    env.note("points_kept_min_max", (min(kept, default=0), max(kept, default=0)))
    env.note("check_s", time.perf_counter() - t_check)
    limits = mix["limits"]
    out = Run(attempted=frames, failed=frames - sum(converged[1:]),
              e2e={"odom_frames_per_s": frames / wall, "setup_s": env.setup_s},
              checks={"pose_gap_median_m": (judged["pose_gap_median_m"], limits["pose_gap_median_m"]),
                      "pose_gap_p90_m": (judged["pose_gap_p90_m"], limits["pose_gap_p90_m"]),
                      "switch_mismatches": (judged["switch_mismatches"], limits["switch_mismatches"])},
              ctx=ctx, device_extra=device)
    if env.trace:
        out.breakdown = common.breakdown(ctx["profile"])
        out.device_extra.update(busy_s=ctx["profile"]["busy_s"], window_s=ctx["profile"]["wall_s"])
    return out


def control(env, frames: int) -> dict:
    """The reference in the program's place, its products in TF32, over the
    first ``frames`` frames, judged as a run is: the readings of the
    control."""
    from ..reference import precision

    cfg, mix, dev = env.cell.config, env.cell.mix, env.device
    course = C.build(cfg["sensor"], mix["course"], env.seed, dev)
    p = cfg["params"]
    cap = cfg["cloud_capacity"]
    with precision(tf32=True):
        mine = Frames(course.scans, p["prefilter"], p["registration"], cap, dev)
        rec = RC.odometry_chain(mine, [i % len(course.scans) for i in range(frames)],
                                [i * course.period_s for i in range(frames)], p["odometry"], project=True)
    del mine
    rng = np.random.default_rng([env.seed, 1])
    positions = common.sample(rng, range(1, frames), mix["check_frames"])
    ref = Frames(course.scans, p["prefilter"], p["registration"], cap, dev)
    judged = RC.judge_odometry(rec, ref, positions, p["odometry"], project=True)
    return {"pose_gap_m": judged["pose_gap_m"], "pose_gap_median_m": judged["pose_gap_median_m"],
            "pose_gap_p90_m": judged["pose_gap_p90_m"], "switch_mismatches": judged["switch_mismatches"]}
