#!/usr/bin/env python3
"""The GICP kernels of two checkouts on one GPU: their outputs bit for bit,
and their times.

    python3 tools/gicp_kernels_ab.py --against DIR [--rounds 2]

Cases, as chip_smoke.py's ``gicp_kernels`` phase builds them: ``bench``
(bench course frames 0 and 1 through bench.py's prefilter at 8192 rows,
``gicp.preprocess``, the source at NDT_TWISTS[0]: one problem, the main
path's shape), with GICP's 1-NN search and 2.5 m gate and with VGICP's
voxel lookup over frame 0's 1.0 m target; and ``loop`` (golden_town frame
LOOP_TARGET_FRAME as the target, its LOOP_CANDIDATE_OFFSETS frames as
B = 8 sources of 4096 rows at the truth guesses z-flattened: the loop
detector's batch). Both checkouts run the public wrappers ``associate``,
``linearize`` and ``cost``. A checkout with ``gicp.Prepared`` also runs
``associate_linearize`` and the prepared calls the LM loop launches: the
fused form, associate, linearize and cost. Every call is timed (kernel_ms,
device_ms, host_ms: chip_smoke.py's measures). Each side runs in its own
process, ``--rounds`` times in turns (against, this; this, against; ...),
and prints one JSON line a process. The last line holds the median times
of both sides and, per output the two sides share, whether their
first-round values are equal bit for bit, else their largest difference
over the largest |value|; the same between this side's first and last
process; and the card's name and power limit.

The raw scans are cached in ``_cache/gicp_ab_scans.npz`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (module level: stdlib and numpy only)

LOOP_FRAMES = [chip_smoke.LOOP_TARGET_FRAME] + [chip_smoke.LOOP_TARGET_FRAME + o
                                                 for o in chip_smoke.LOOP_CANDIDATE_OFFSETS]


def scans(path: str) -> dict:
    """Bench course frames 0-1 and the loop case's golden_town frames, from
    ``path`` when it exists, else cast and saved there."""
    if not os.path.exists(path):
        from hdl_graph_slam_tpu_torch.utils.course import BENCH_STEP, make_course

        bench = make_course(1, BENCH_STEP, seed=chip_smoke.SEED)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, b0=bench[0], b1=bench[1], **{f"g{i}": chip_smoke._golden_scan(i) for i in LOOP_FRAMES})
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def run_side(root: str, scans_path: str, dump: str) -> None:
    """One checkout's kernels on every case: a JSON line of times, the
    outputs to ``dump``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.frontend import Prefilter
    from hdl_graph_slam_tpu_torch.ops import voxel
    from hdl_graph_slam_tpu_torch.registration import gicp, ndt, vgicp
    from hdl_graph_slam_tpu_torch.utils import course
    from hdl_graph_slam_tpu_torch.utils.course import BENCH_RAW_CAPACITY

    raw = scans(scans_path)
    pf = Prefilter(chip_smoke.bench_configs()[0], out_capacity=chip_smoke.N_KERNEL, device="cuda")
    c0, c1 = (pf(cloudlib.from_numpy(raw[k], capacity=BENCH_RAW_CAPACITY, device="cuda")) for k in ("b0", "b1"))
    tgt, one = gicp.preprocess(c0), gicp.preprocess(c1)
    T = se3.se3_exp(torch.tensor(chip_smoke.NDT_TWISTS[0], device="cuda")).contiguous()
    idx, d2 = gicp._correspond(T, one, tgt)
    gate = gicp.DistanceGate(d2, tgt.mask, chip_smoke.GICP_MAX_CORR_M)
    res = chip_smoke.VGICP_MAIN_REG["reg_resolution"]
    vtgt = vgicp.preprocess_target(c0, res, max_voxels=chip_smoke.N_KERNEL, grid_size=voxel.dense_grid_size_for(res))
    vidx, found = ndt.associate_cells(vtgt, vtgt.grid, one.xyz[None], one.mask[None], T[None], "DIRECT1")
    vidx, found = vidx[0, :, 0].contiguous(), found[0, :, 0].contiguous()
    # the loop detector's batch
    truth = course.golden_town_sensor_poses()
    gt = gicp.preprocess(chip_smoke.golden_cloud(raw[f"g{LOOP_FRAMES[0]}"]))
    clouds = [chip_smoke.golden_cloud(raw[f"g{i}"]) for i in LOOP_FRAMES[1:]]
    src8 = gicp.preprocess(PointCloud(xyz=torch.stack([c.xyz for c in clouds]), mask=torch.stack([c.mask for c in clouds])))
    guesses = []
    for i in LOOP_FRAMES[1:]:
        m = np.linalg.inv(truth[LOOP_FRAMES[0]]) @ truth[i]
        m[2, 3] = 0.0
        guesses.append(m)
    T8 = torch.from_numpy(np.stack(guesses)).float().cuda().contiguous()
    idx8, d28 = gicp._correspond(T8, src8, gt)
    gate8 = gicp.DistanceGate(d28, gt.mask, chip_smoke.GICP_MAX_CORR_M)

    outputs, times = {}, {}

    def record(key, fn):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        flat = [x for o in out for x in (o if isinstance(o, tuple) else (o,))]
        for j, x in enumerate(flat):
            outputs[f"{key}/{j}"] = x.cpu().numpy()
        times[key] = dict(kernel_ms=chip_smoke.time_ms(fn), device_ms=chip_smoke.time_ms(fn, device_only=True),
                          host_ms=chip_smoke.host_ms(fn))

    corr = gicp.associate(T, one, tgt.covs, idx, gate)
    corr8 = gicp.associate(T8, src8, gt.covs, idx8, gate8)
    record("bench/associate", lambda: gicp.associate(T, one, tgt.covs, idx, gate))
    record("bench/associate_vgicp", lambda: gicp.associate(T, one, vtgt.covs, vidx, found))
    record("bench/linearize", lambda: gicp.linearize(T, corr, one, tgt.xyz))
    record("bench/cost", lambda: gicp.cost(T, corr, one, tgt.xyz))
    record("loop/associate", lambda: gicp.associate(T8, src8, gt.covs, idx8, gate8))
    record("loop/linearize", lambda: gicp.linearize(T8, corr8, src8, gt.xyz))
    record("loop/cost", lambda: gicp.cost(T8, corr8, src8, gt.xyz))
    if hasattr(gicp, "Prepared"):
        record("bench/associate_linearize", lambda: gicp.associate_linearize(T, one, tgt.covs, tgt.xyz, idx, gate))
        for case, (s, tg, i, flags, Tc, c) in dict(
                bench=(one, tgt, idx, d2, T, corr), loop=(src8, gt, idx8, d28, T8, corr8)).items():
            p = gicp.Prepared(s, tg.covs, tg.xyz, tg.mask, chip_smoke.GICP_MAX_CORR_M)
            record(f"{case}/prepared/fused", lambda: p.associate_linearize(Tc, i, flags))
            record(f"{case}/prepared/associate", lambda: p.associate(Tc, i, flags))
            record(f"{case}/prepared/linearize", lambda: p.linearize(Tc, c))
            record(f"{case}/prepared/cost", lambda: p.cost(Tc, c))
    np.savez(dump, **outputs)
    print(json.dumps(dict(root=os.path.abspath(root), device=torch.cuda.get_device_name(0), times=times)), flush=True)


def compare(a: str, b: str) -> dict:
    """Per output both files hold: "identical", or the largest |a - b| over
    the largest |b|."""
    out = {}
    with np.load(a) as za, np.load(b) as zb:
        for k in sorted(set(za.files) & set(zb.files)):
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
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--root", help=argparse.SUPPRESS)  # one side's process
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    ap.add_argument("--scans", default=os.path.join(REPO, "_cache", "gicp_ab_scans.npz"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gicp_kernels_ab: torch.cuda.is_available() is False; this tool needs a GPU", file=sys.stderr)
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
        return os.path.join(REPO, "_cache", f"gicp_ab_{side}_{r}.npz")

    for r in range(args.rounds):
        for side in (("against", "this") if r % 2 == 0 else ("this", "against")):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", sides[side], "--dump",
                                   dump(side, r), "--scans", args.scans], capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise RuntimeError(f"{side} side failed:\n{proc.stderr[-4000:]}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            times[side].append(line["times"])
            print(json.dumps(dict(round=r, side=side, **line)), flush=True)
    summary = dict(rounds=args.rounds, card=chip_smoke.nvidia_smi("name,power.limit"),
                   bits=compare(dump("this", 0), dump("against", 0)),
                   bits_this_across_processes=compare(dump("this", 0), dump("this", args.rounds - 1)))
    for side, runs in times.items():
        summary[side] = dict(root=sides[side], **{key: {m: float(np.median([t[key][m] for t in runs]))
                                                       for m in runs[0][key]} for key in runs[0]})
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
