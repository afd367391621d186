"""Tracing / metrics: per-stage timing (port of hdl_graph_slam_tpu/utils/metrics.py).

A stage records host wall times into a registry that dumps as JSON or a
Chrome trace-event file (Perfetto / chrome://tracing). StageTimer is a copy
of the JAX package's. ``GLOBAL_TIMER`` holds the spans of
SlamPipeline.process_frame (ingest, prefilter, odometry, floor_detection,
optimize_cycle) and of AsyncBackend (async_optimize_cycle); the CLI resets
it at start and writes it with ``--trace``.

The spans are host wall time with no device synchronisation: on the card a
span measures the time to launch its work (plus whatever host syncs the stage
makes itself), not the device time. chip_smoke.py's StageClock, which
synchronises at the end of each stage, is the source of stage times on the
card; ``device_trace`` records a torch.profiler trace of device work.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional


class StageTimer:
    """Aggregating wall-clock timer with trace-event export."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.events: List[dict] = []
        self._t0 = time.perf_counter()
        self.keep_events = True

    def reset(self) -> None:
        """Forget every span recorded so far."""
        self.totals.clear()
        self.counts.clear()
        self.events.clear()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self.totals[name] += end - start
            self.counts[name] += 1
            if self.keep_events:
                self.events.append(
                    {
                        "name": name,
                        "ph": "X",
                        "ts": (start - self._t0) * 1e6,
                        "dur": (end - start) * 1e6,
                        "pid": 0,
                        "tid": 0,
                    }
                )

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(1, self.counts[name]), 3),
            }
            for name in sorted(self.totals)
        }

    def dump_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)

    def dump_summary(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace (CPU and, when present, CUDA activity) of the
    enclosed block, written to ``logdir`` as a Chrome trace file."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
