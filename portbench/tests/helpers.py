"""Small cells for the CPU tests: the benchmark's own cells with the sensor,
capacities, course and samples cut so that the port's plain PyTorch path
runs them on the CPU in seconds."""

from __future__ import annotations

import copy
import time

import torch

from portbench import harness
from portbench.run import Env


def small_cell(workload: str, frames: int = 16):
    cell = harness.find_cell(workload)
    cfg, mix = copy.deepcopy(cell.config), copy.deepcopy(cell.mix)
    cfg["sensor"].update(rings=16, azimuth_steps=360)
    cfg["raw_capacity"], cfg["cloud_capacity"] = 8192, 4096
    cfg["params"]["prefilter"]["downsample_resolution"] = 0.5
    mix["course"].update(frames=frames, step_m=0.5)
    mix.update(window=4, warmup_frames=2, trace_frames=4, check_frames=12)
    if "check_floors" in mix:
        mix.update(check_floors=3, job_frames=frames)
        cfg["params"]["floor"]["floor_pts_thresh"] = 32
        cfg["params"]["backend"].update(graph_update_interval=0.5, keyframe_delta_trans=0.5)
    cell.config, cell.mix = cfg, mix
    return cell


def run_small(cell, seconds: float = 3.0, trace: bool = False, seed: int = 3, device="cpu"):
    torch.manual_seed(0)
    env = Env(cell, seed, seconds, trace, torch.device(device), time.perf_counter())
    return harness.entry(cell.mix["entry"]).run(env)
