"""What the entries share: the program's configuration as the cell's file
states it, the profiled slice, and the result's device numbers."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import trace as TR

# configuration file section -> SlamConfig attribute path
SECTIONS = {"prefilter": ("prefilter",), "odometry": ("odometry",), "registration": ("odometry", "registration"),
            "floor": ("floor",), "backend": ("backend",), "loop": ("loop",),
            "loop_registration": ("loop", "registration"), "information": ("information",)}


def program_config(config: dict):
    """The program's SlamConfig: the launch file's preset with every
    parameter the configuration file states set as stated (an unknown name
    raises)."""
    from hdl_graph_slam_tpu_torch.core.config import PRESETS, wire_derived

    cfg = PRESETS[config["preset"]]()
    for section, values in config["params"].items():
        obj = cfg
        for attr in SECTIONS[section]:
            obj = getattr(obj, attr)
        for key, value in values.items():
            if not hasattr(obj, key):
                raise KeyError(f"configuration parameter {section}.{key} is not one of the program's")
            setattr(obj, key, value)
    return wire_derived(cfg)


class Scans:
    """Course scans by frame number: frame f reads scan f mod n."""

    def __init__(self, scans):
        self.scans = scans

    def __getitem__(self, f: int) -> np.ndarray:
        return self.scans[f % len(self.scans)]

    def __len__(self):
        return len(self.scans)


class Profiled:
    """A torch.profiler window with the program's launches recorded."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        self.launches = TR.Launches().install()
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.device(self.device).type == "cuda" else []))
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        self.launches.restore()
        self.launches.finish()  # counts the kept inputs and lets them go
        return False

    def reduce(self, frames: int) -> dict:
        prof = TR.reduce_profile(self.prof, self.wall, frames)
        prof["launch_calls"] = dict(self.launches.calls)
        prof["bound_s"] = dict(self.launches.bound_s)
        return prof


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_numbers(device, count: int = 1) -> dict:
    """The result's ``device``; a CPU run (the tests') says so."""
    from ..harness import power_limit_w

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()), "power_limit_w": power_limit_w()}


def breakdown(prof: dict) -> dict:
    return {"device_ops": prof["device_ops_top"], "idle_gaps": prof["idle_gaps"]}


def sample(rng: np.random.Generator, candidates, count: int) -> list:
    """``count`` of the candidates drawn from the seed, the last always among them."""
    candidates = list(candidates)
    if len(candidates) <= count:
        return candidates
    pick = set(rng.choice(len(candidates) - 1, size=count - 1, replace=False).tolist())
    return [c for i, c in enumerate(candidates[:-1]) if i in pick] + [candidates[-1]]
