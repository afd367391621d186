"""The benchmark's general part: it finds a cell's files by the names in
``BENCHMARK.json``, keeps the program's caches inside the checkout, checks
the card, runs the cell's entry, reads the per-layer metrics and prints the
one result line.

A cell names a configuration (``configs/<config>.json``: the deployment's
parameters, sensor and capacities) and a traffic mix (``mixes/<mix>.json``:
the course, the entry that drives the program and its sizes). The entry is
``entries/<entry>.py``; each per-layer metric is ``metrics/<name>.py``, a
``read(ctx)`` over what the traced run recorded, returning None where it
found nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "_cache", "portbench")
# modules that may not be loaded in the process that prints the result:
# JAX and the JAX package this port was made from, by whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hdl_graph_slam_tpu")


def set_cache_env() -> None:
    """Point every build and kernel cache a CUDA program may use at fixed
    directories inside the checkout (the program's own nvcc cache,
    ``hdl_graph_slam_tpu_torch/_build/``, already lies there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its configuration and mix."""

    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, benchmark_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    bench = load_json(benchmark_path)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json ({sorted(work)})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    mix = load_json(os.path.join(HERE, "mixes", f"{w['traffic']}.json"))

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(name=name, workload=w, config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def entry(name: str):
    """The entry module ``entries/<name>.py``."""
    return importlib.import_module(f"portbench.entries.{name}")


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a cell's run hands back to the harness."""

    attempted: int
    failed: int
    e2e: dict  # end-to-end metric name -> value
    checks: dict  # compared number -> (value, limit)
    ctx: dict = field(default_factory=dict)  # what the traced run recorded, for the metric readers
    device_extra: dict = field(default_factory=dict)
    breakdown: dict = None

    @property
    def correct(self) -> bool:
        return all(v == v and v <= lim for v, lim in self.checks.values())


def power_limit_w():
    """The card's power limit in W (nvidia-smi), or None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_loaded(modules=None) -> list:
    """Top-level names of FORBIDDEN_MODULES among ``modules`` (sys.modules)."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(t for t in FORBIDDEN_MODULES if t in tops)


def result_line(cell: Cell, run: Run, device: dict, trace: bool) -> dict:
    """The contract's last line, the checks last."""
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        if trace:
            value = metric_reader(m["name"])(run.ctx)
        else:
            value = run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.breakdown:
        line["breakdown"] = run.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def print_checks(run: Run) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v == v and v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
