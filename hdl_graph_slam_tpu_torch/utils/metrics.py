"""The port's tracer: spans and counters inside the program, off by default.

``GLOBAL_TIMER`` is the one tracer; the program opens its spans and bumps
its counters where the work happens (the pipeline, the frontend, the
registration loops, the backend cycle, the pose-graph LM).

Off (the default), ``span(name)`` returns one shared no-op context and
``count(name)`` returns, each after reading one flag: no clock, no
allocation, no profiler call.

On (``GLOBAL_TIMER.enable(capacity)``, or ``with tracing(capacity):``), each
span records:

- its name and its parent, the innermost span open on the same thread (a
  backend cycle on a worker thread parents its own spans);
- the request it belongs to: a frame's index for per-frame work, an
  optimize cycle's index for backend work; a span given none takes its
  parent's;
- its thread and its host start and end (``time.perf_counter_ns``).

Each span also opens a profiler range named ``"hgs/" + name`` (torch's
``_RecordFunctionFast``, what ``torch.profiler.record_function`` records,
without its Python wrapper's cost): under a profiler it lies on the
kernels' clock, so an idle gap of the device can be put down to the program
stage open at its start (``device_trace`` around a traced run writes both
into one Chrome trace). Unlike a ``record_function`` range it is not
mirrored onto the device timeline, so the profile's device events are the
same with the tracer on.

Records go into a buffer of ``capacity`` spans; a span past it is counted
in ``dropped`` and still reaches the totals. ``drain()`` returns the spans,
the counters and the summary recorded since the last drain and empties
them; ``summary()`` gives each span name's calls, total and self time (its
duration minus the part its child spans cover) and the counters.

Counters are named in ``COUNTERS``. ``host_sync.<site>`` counts host reads of
a device value, and blocking copies to the device (``count_copies``; none on
the CPU), at one call site: the syncs torch's sync-debug mode reports.
Device counters are int32 slots a kernel adds to (``device_counter``);
``drain`` and ``summary`` read each once and zero it, under the names
``DEVICE_COUNTERS`` gives its slots.

The CLI's ``--trace PATH`` turns the tracer on for its run and writes
``summary()`` there.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

SPAN_PREFIX = "hgs/"
DEFAULT_CAPACITY = 1 << 16

# every counter the program bumps, with what it counts ("host_sync" stands
# for its sites: host_sync.<site>)
COUNTERS = {
    "host_sync": "host reads of a device value, and blocking copies to the device (not counted on the CPU, "
                 "where none is made), at one call site",
    "lm_iterations": "passes of lm_loop (per-frame scan matching: GICP, the loop detector's sequential path)",
    "lm_reassociations": "gated re-associations in lm_loop (the refreshes after the first association)",
    "lm_iterations_batched": "passes of lm_loop_batched (the loop matcher's candidate batches, VGICP)",
    "graph_lm_iterations": "passes of the pose-graph LM, frozen passes after done included, eager or replayed",
    "graph_lm_captures": "CUDA graphs captured from a pose-graph solve's steps (graph/solver.py, once per shape key "
                         "and step)",
    "graph_lm_replayed": "passes of the pose-graph LM run by a CUDA graph's replay (of graph_lm_iterations)",
    "keyframes_admitted": "keyframes an optimize cycle took from the queue into the graph",
    "loop_candidates": "candidate keyframes the loop detector aligned",
    "loops_matched": "candidates that converged within fitness_score_thresh",
    "loops_added": "loop edges added to the graph (the best match of a new keyframe)",
    "radius_count_tiles_full": "radius_count_kernel's (query, target) tile pairs counted in full",
    "radius_count_tiles_point": "radius_count_kernel's tile pairs tested against one point",
    "radius_count_wait_expired": "radius_count_kernel lanes whose wait for a tile's stamp ran out, "
                                 "so they computed the tile's boxes themselves",
}

# device counters: each slot's counter name
DEVICE_COUNTERS = {
    "radius_count": ("radius_count_tiles_full", "radius_count_tiles_point", "radius_count_wait_expired"),
}


class _Off:
    """The shared no-op span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One open span; recorded when it closes."""

    __slots__ = ("tracer", "name", "rid", "sid", "parent", "stack", "t0", "child_ns", "rf")

    def __init__(self, tracer: "StageTimer", name: str, rid):
        self.tracer, self.name, self.rid = tracer, name, rid

    def __enter__(self):
        tr = self.tracer
        self.stack = stack = tr._stack()
        self.parent = stack[-1] if stack else None
        if self.rid is None and self.parent is not None:
            self.rid = self.parent.rid
        self.sid = next(tr._ids)
        self.child_ns = 0
        self.rf = tr._record_function(SPAN_PREFIX + self.name)
        self.rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self.tracer
        self.stack.pop()
        self.rf.__exit__(*exc)
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        tr._close(self.name, dur, dur - self.child_ns,
                  (self.sid, None if parent is None else parent.sid, self.name, self.rid,
                   threading.get_ident(), self.t0, t1))
        return False


class StageTimer:
    """Spans and counters, recorded while ``on``."""

    def __init__(self):
        self.on = False
        self.capacity = DEFAULT_CAPACITY
        self.totals: Dict[str, float] = defaultdict(float)  # seconds a span name
        self.self_totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.dropped = 0
        self._spans: list = []
        self._device: dict = {}  # (name, device) -> int32 slots
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._record_function = None

    # -- switching ---------------------------------------------------------

    def enable(self, capacity: int = DEFAULT_CAPACITY) -> None:
        """Forget what was recorded and record up to ``capacity`` spans."""
        import torch

        # the profiler's range without torch.profiler.record_function's
        # Python wrapper (the same range on the same clock, ~20x cheaper)
        self._record_function = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
        self.reset()
        self.capacity = int(capacity)
        self.on = True

    def disable(self) -> None:
        """Stop recording (what was recorded stays until drained or reset)."""
        self.on = False

    def reset(self) -> None:
        """Forget every span and counter recorded so far."""
        with self._lock:
            self._clear()
        for t in self._device.values():
            t.zero_()

    def _clear(self) -> None:
        """Empty the records and totals (the lock held)."""
        self.totals.clear()
        self.self_totals.clear()
        self.counts.clear()
        self.counters.clear()
        self.dropped = 0
        self._spans = []

    # -- recording ---------------------------------------------------------

    def span(self, name: str, rid: Optional[int] = None):
        """A context that records one span of ``name`` (request ``rid``, or
        the parent's) while the tracer is on."""
        if not self.on:
            return _OFF
        return _Span(self, name, rid)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` while the tracer is on."""
        if not self.on:
            return
        with self._lock:
            self.counters[name] += n

    def count_copies(self, site: str, dst, n: int = 1) -> None:
        """Add ``n`` blocking copies into ``dst`` (a tensor, or its device)
        at ``site`` (counter ``host_sync.<site>``) while the tracer is on.
        On the CPU, or into an empty tensor, no copy is made and nothing is
        counted."""
        if not self.on:
            return
        if hasattr(dst, "numel"):
            if dst.numel() == 0:
                return
            dst = dst.device
        if getattr(dst, "type", dst) == "cpu":
            return
        with self._lock:
            self.counters["host_sync." + site] += n

    def device_counter(self, name: str, device):
        """The persistent int32 slots of device counter ``name`` on
        ``device`` (DEVICE_COUNTERS names them), zero when made."""
        key = (name, str(device))
        t = self._device.get(key)
        if t is None:
            import torch

            with self._lock:
                t = self._device.setdefault(key, torch.zeros(len(DEVICE_COUNTERS[name]), dtype=torch.int32,
                                                             device=device))
        return t

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, name: str, dur_ns: int, self_ns: int, record: tuple) -> None:
        with self._lock:
            self.totals[name] += dur_ns * 1e-9
            self.self_totals[name] += self_ns * 1e-9
            self.counts[name] += 1
            if len(self._spans) < self.capacity:
                self._spans.append(record)
            else:
                self.dropped += 1

    def _read_device(self) -> None:
        """Add each device counter's slots to the counters and zero them
        (one host read a counter)."""
        for (name, _), t in list(self._device.items()):
            values = t.tolist()
            t.zero_()
            with self._lock:
                for slot, value in zip(DEVICE_COUNTERS[name], values):
                    self.counters[slot] += value

    # -- reading -----------------------------------------------------------

    def summary(self) -> dict:
        """Per span name its calls, total and self seconds and mean ms; the
        counters; the spans dropped from a full buffer."""
        self._read_device()
        with self._lock:
            spans = {
                name: {
                    "count": self.counts[name],
                    "total_s": round(self.totals[name], 6),
                    "self_s": round(self.self_totals[name], 6),
                    "mean_ms": round(1e3 * self.totals[name] / max(1, self.counts[name]), 3),
                }
                for name in sorted(self.totals)
            }
            return {"spans": spans, "counters": dict(sorted(self.counters.items())), "dropped": self.dropped}

    def drain(self) -> dict:
        """The spans (dicts in the order they closed: id, parent id, name,
        request id, thread, start and end in ns), the counters and the
        summary recorded since the last drain; all of it is then emptied."""
        summary = self.summary()
        with self._lock:
            records = self._spans
            self._clear()
        keys = ("id", "parent", "name", "rid", "thread", "t0_ns", "t1_ns")
        return {"spans": [dict(zip(keys, r)) for r in records], "counters": summary["counters"],
                "dropped": summary["dropped"], "summary": summary["spans"]}

    def dump_summary(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def tracing(capacity: int = DEFAULT_CAPACITY):
    """GLOBAL_TIMER on (what it held forgotten) for the enclosed block, off after."""
    GLOBAL_TIMER.enable(capacity)
    try:
        yield GLOBAL_TIMER
    finally:
        GLOBAL_TIMER.disable()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace (CPU and, when present, CUDA activity) of the
    enclosed block, written to ``logdir`` as a Chrome trace file. With the
    tracer on, the program's spans (``hgs/<name>``) lie in it beside the
    kernels."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
