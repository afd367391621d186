#!/usr/bin/env python3
"""Frames/s of the port's windowed odometry on the bench course, on one GPU.

    python3 tools/odometry_fps.py [--root DIR] [--repeats 3]
    python3 tools/odometry_fps.py --against DIR --pairs 10 [--repeats 3]

The first form runs chip_smoke.py's main path (``chip_smoke.main_path`` and
``drive_window``: bench.py's configs, course seed 0, 256 frames)
``--repeats`` times after one 16-frame warm-up window and prints one JSON
line per run with frames/s and the gate values. ``--root`` picks the
checkout whose ``hdl_graph_slam_tpu_torch`` is imported (default: this one).

The second form compares two checkouts on one card: it runs the first form
in ``--pairs`` pairs of processes, this checkout and ``--against`` in turns
(against, this; this, against; ...), and prints each process's median and
a last JSON line with the medians and quartiles of both sides and the
number of pairs in which this checkout was slower.

The course's raw scans are cached in ``--scans`` (default
``_cache/course_seed0.npz`` in this checkout, git-ignored), written on first
use, since generating them takes longer than a run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (module level: stdlib and numpy only)


def load_scans(path: str) -> list:
    """The bench course's raw scans (seed chip_smoke.SEED), from ``path``
    when it exists, else generated and saved there."""
    if os.path.exists(path):
        with np.load(path) as z:
            return [z[f"s{i}"] for i in range(len(z.files))]
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_FRAMES, BENCH_STEP, make_course

    scans = make_course(BENCH_FRAMES, BENCH_STEP, seed=chip_smoke.SEED)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, **{f"s{i}": s for i, s in enumerate(scans)})
    os.replace(tmp, path)
    return scans


def run_here(root: str, repeats: int, scans_path: str) -> None:
    import torch

    sys.path.insert(0, os.path.abspath(root))
    scans = load_scans(scans_path)
    win, first, xyz, mask, stamps = chip_smoke.main_path(scans)
    chip_smoke.drive_window(win, first, xyz[:16], mask[:16], stamps[:16])  # warm-up: builds the kernels
    frames = xyz.shape[0]
    for rep in range(repeats):
        _, odoms, status, dt = chip_smoke.drive_window(win, first, xyz, mask, stamps)
        print(json.dumps(dict(root=os.path.abspath(root), repeat=rep, fps=frames / dt,
                              final_x=float(odoms[-1, 0, 3]),
                              converged_fraction=float(status["converged"].double().mean()),
                              device=torch.cuda.get_device_name(0))), flush=True)


def run_pairs(against: str, pairs: int, repeats: int, scans_path: str) -> None:
    load_scans(scans_path)
    sides = {"against": os.path.abspath(against), "this": REPO}
    med = {"against": [], "this": []}
    for p in range(pairs):
        for side in (("against", "this") if p % 2 == 0 else ("this", "against")):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", sides[side],
                                  "--repeats", str(repeats), "--scans", scans_path],
                                 capture_output=True, text=True, timeout=900, check=True)
            fps = [json.loads(x)["fps"] for x in out.stdout.splitlines() if x.startswith("{")]
            med[side].append(float(np.median(fps)))
            print(json.dumps(dict(pair=p, side=side, root=sides[side], fps=fps, median_fps=med[side][-1],
                                  process_s=time.perf_counter() - t0)), flush=True)
    summary = dict(pairs=pairs, repeats=repeats)
    for side, v in med.items():
        summary[side] = dict(root=sides[side], median_fps=float(np.median(v)),
                             q1_fps=float(np.percentile(v, 25)), q3_fps=float(np.percentile(v, 75)),
                             min_fps=min(v), max_fps=max(v))
    summary["this_slower_in_pairs"] = int(sum(t < a for t, a in zip(med["this"], med["against"])))
    print(json.dumps(summary), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to import hdl_graph_slam_tpu_torch from")
    ap.add_argument("--against", default=None, help="second checkout: compare the two in pairs of processes")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3, help="256-frame windows per process")
    ap.add_argument("--scans", default=os.path.join(REPO, "_cache", "course_seed0.npz"),
                    help=".npz cache of the course's raw scans")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("odometry_fps: torch.cuda.is_available() is False; this tool needs a GPU", file=sys.stderr)
        return 2
    if args.against:
        run_pairs(args.against, args.pairs, args.repeats, os.path.abspath(args.scans))
    else:
        run_here(args.root, args.repeats, os.path.abspath(args.scans))
    return 0


if __name__ == "__main__":
    sys.exit(main())
