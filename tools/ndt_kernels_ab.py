#!/usr/bin/env python3
"""The NDT kernels and radius_count of two checkouts on one GPU: their
outputs bit for bit, and their times.

    python3 tools/ndt_kernels_ab.py --against DIR [--rounds 3]

Two NDT cases, as chip_smoke.py's ``ndt_kernels`` phase builds them:
``bench`` (bench course frames 0 and 1 through bench.py's prefilter at 8192
rows, the target at 2.0 m cells, DIRECT7) and ``imu`` (golden_town frames 0
and 1 at the imu path's shapes, ``chip_smoke.ndt_imu_case``). In each, the
source at check_ndt's pose is associated through the dense grid
(``associate``) and through the key search (``associate_search``: the
target without its grid), then the derivatives, the 10 trial scores along
the Newton direction and the one trial at the pose are computed. Three
radius_count cases, as chip_smoke.py's ``kernel_filters`` phase times them:
``radius_golden_keyframe`` (golden_town frame 0 at the host path's 4096
rows, r = 0.8 m) and ``radius_outdoor_16384`` / ``radius_imu_16384``
(golden_town frame ``chip_smoke.RADIUS_FRAME`` through the cli's and the
imu path's prefilters, ``chip_smoke.radius_frame``). Every call is timed
(kernel_ms, device_ms, host_ms: chip_smoke.py's measures) by each checkout's
``hdl_graph_slam_tpu_torch``. Each side runs in its own process,
``--rounds`` times in turns (against, this; this, against; ...), and prints
one JSON line a process. The last line holds the median times of both sides
and, per case and output, whether the two sides' first-round values are
equal bit for bit, and else their largest difference over the largest
|value|; and the same between this side's first and last process.

The raw scans are cached in ``_cache/kernels_ab_scans.npz`` (git-ignored).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (module level: stdlib and numpy only)

CALLS = ("associate", "associate_search", "derivatives", "trial_scores", "trial_scores_L1")


def scans(path: str) -> dict:
    """Bench course frames 0-1 and golden_town frames 0-1, from ``path``
    when it exists, else cast and saved there."""
    if not os.path.exists(path):
        from hdl_graph_slam_tpu_torch.utils.course import BENCH_STEP, make_course

        bench = make_course(1, BENCH_STEP, seed=chip_smoke.SEED)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, b0=bench[0], b1=bench[1], g0=chip_smoke._golden_scan(0), g1=chip_smoke._golden_scan(1))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def run_side(root: str, scans_path: str, dump: str) -> None:
    """One checkout's kernels on every case: a JSON line of times, the
    outputs to ``dump``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.frontend import Prefilter
    from hdl_graph_slam_tpu_torch.ops import knn, voxel
    from hdl_graph_slam_tpu_torch.registration import ndt
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_RAW_CAPACITY

    raw = scans(scans_path)
    pf = Prefilter(chip_smoke.bench_configs()[0], out_capacity=chip_smoke.N_KERNEL, device="cuda")
    tgt_cloud, src = (pf(cloudlib.from_numpy(raw[k], capacity=BENCH_RAW_CAPACITY, device="cuda")) for k in ("b0", "b1"))
    res = chip_smoke.NDT_MAIN_REG["reg_resolution"]
    cases = dict(bench=(ndt.preprocess_target(tgt_cloud, res, max_voxels=chip_smoke.N_KERNEL,
                                              grid_size=voxel.dense_grid_size_for(res)), src, res, "DIRECT7"),
                 imu=chip_smoke.ndt_imu_case([raw["g0"], raw["g1"]]))
    outputs, times = {}, {}

    def record(key, fn):
        out = fn()
        for j, x in enumerate(out if isinstance(out, tuple) else (out,)):
            outputs[f"{key}/{j}"] = x.cpu().numpy()
        times[key] = dict(kernel_ms=chip_smoke.time_ms(fn), device_ms=chip_smoke.time_ms(fn, device_only=True),
                          host_ms=chip_smoke.host_ms(fn))

    for case, (tgt, cloud, _, method) in cases.items():
        xyz, mask = cloud.xyz[None].contiguous(), cloud.mask[None].contiguous()
        T = se3.se3_exp(torch.tensor(chip_smoke.NDT_TWISTS[0], device="cuda"))[None]
        keyed = dataclasses.replace(tgt, grid=None)
        idx, found = ndt.associate(tgt, xyz, mask, T, method)
        g, H, _ = ndt.derivatives(tgt, xyz, mask, T, idx, found)
        Ts = chip_smoke.ndt_trial_poses(T, g, H)
        fns = dict(associate=lambda: ndt.associate(tgt, xyz, mask, T, method),
                   associate_search=lambda: ndt.associate(keyed, xyz, mask, T, method),
                   derivatives=lambda: ndt.derivatives(tgt, xyz, mask, T, idx, found),
                   trial_scores=lambda: ndt.trial_scores(tgt, xyz, mask, Ts, idx, found),
                   trial_scores_L1=lambda: ndt.trial_scores(tgt, xyz, mask, T[:, None], idx, found))
        for name in CALLS:
            record(f"{case}/{name}", fns[name])
    # kernel_filters' golden keyframe is golden_town frame 0
    radius = {"radius_golden_keyframe": (chip_smoke.golden_cloud(raw["g0"]).valid_xyz().contiguous(),
                                         chip_smoke.RADIUS_M)}
    for preset in chip_smoke.RADIUS_PRESETS:
        x, _, r = chip_smoke.radius_frame(raw[f"g{chip_smoke.RADIUS_FRAME}"], preset)
        radius[f"radius_{preset}_16384"] = (x, r)
    for case, (x, r) in radius.items():
        record(case, lambda: knn.radius_count(x, x, r))
    np.savez(dump, **outputs)
    print(json.dumps(dict(root=os.path.abspath(root), device=torch.cuda.get_device_name(0), times=times)), flush=True)


def compare(a: str, b: str) -> dict:
    """Per output: "identical", or the largest |a - b| over the largest |b|."""
    out = {}
    with np.load(a) as za, np.load(b) as zb:
        for k in za.files:
            x, y = za[k], zb[k]
            if x.tobytes() == y.tobytes():
                out[k] = "identical"
            else:
                x, y = x.astype(np.float64), y.astype(np.float64)
                out[k] = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", help=argparse.SUPPRESS)  # one side's process
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    ap.add_argument("--scans", default=os.path.join(REPO, "_cache", "kernels_ab_scans.npz"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ndt_kernels_ab: torch.cuda.is_available() is False; this tool needs a GPU", file=sys.stderr)
        return 2
    if args.root:
        run_side(args.root, args.scans, args.dump)
        return 0
    if not args.against:
        ap.error("--against DIR is required")
    scans(args.scans)
    os.makedirs(os.path.join(REPO, "_cache"), exist_ok=True)
    sides = {"against": os.path.abspath(args.against), "this": REPO}
    times = {side: [] for side in sides}

    def dump(side, r):
        return os.path.join(REPO, "_cache", f"kernels_ab_{side}_{r}.npz")

    for r in range(args.rounds):
        for side in (("against", "this") if r % 2 == 0 else ("this", "against")):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", sides[side], "--dump",
                                   dump(side, r), "--scans", args.scans], capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise RuntimeError(f"{side} side failed:\n{proc.stderr[-4000:]}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            times[side].append(line["times"])
            print(json.dumps(dict(round=r, side=side, **line)), flush=True)
    # the two sides' first rounds; this side's first and last (two processes)
    summary = dict(rounds=args.rounds, bits=compare(dump("this", 0), dump("against", 0)),
                   bits_this_across_processes=compare(dump("this", 0), dump("this", args.rounds - 1)))
    for side, runs in times.items():
        summary[side] = dict(root=sides[side], **{key: {m: float(np.median([t[key][m] for t in runs]))
                                                       for m in runs[0][key]} for key in runs[0]})
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
