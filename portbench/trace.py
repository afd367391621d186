"""The benchmark's own instrumentation, around calls into the program's
layers (the program carries no spans of its own yet).

- ``Spans``: wraps a method so that each call is a named span, marked for
  the profiler and, when asked, closed by a device synchronisation, so its
  wall time is the layer's time on the card.
- ``count_syncs``: the host syncs a call makes, from torch's sync-debug
  warnings (the counts repeat exactly).
- ``Launches``: records the shapes of each search, radius-count and GICP
  launch the program makes, for the roofline bounds (``roofline.py``).
- ``reduce_profile``: device busy time (the union of the device intervals),
  device operations, each kernel's device time and calls, the top device
  operations and the idle gaps by the host span open at their start.
"""

from __future__ import annotations

import contextlib
import functools
import time
import warnings
from collections import defaultdict

import torch

from . import roofline

SPAN_PREFIX = "pb/"
VALID_ABS = 1.0e5


class Spans:
    """Named spans around wrapped methods; ``sync`` spans end in a device
    synchronisation. Totals, counts and each call's wall time are kept."""

    def __init__(self):
        self.walls = defaultdict(list)
        self.results = defaultdict(list)
        self._undo = []

    def wrap(self, owner, attr: str, name: str, sync: bool = False, keep=None):
        orig = getattr(owner, attr)
        spans = self

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN_PREFIX + name):
                out = orig(*args, **kwargs)
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
            spans.walls[name].append(time.perf_counter() - t0)
            if keep is not None:
                spans.results[name].append(keep(out))
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []


@contextlib.contextmanager
def count_syncs(box: list, device):
    """Append to ``box`` the host syncs made inside the block (None off CUDA)."""
    if torch.device(device).type != "cuda":
        yield
        box.append(None)
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    box.append(sum("synchroniz" in str(w.message) for w in caught))


def valid_rows(x) -> int:
    """Rows of a padded cloud (.., n, 3) that hold a point: the program pads
    with a 1e6 sentinel, and takes a row whose coordinates all lie within
    1e5 of the origin as a point."""
    return int((x.abs() < VALID_ABS).all(-1).sum())


class Launches:
    """Records the program's search, radius and GICP launches while active:
    per kernel group, the byte/operation bound of each call (seconds at the
    published peaks), from the rows that hold points, not the padded
    capacity. The inputs are kept and counted by ``finish``, after the
    traced slice, so that counting adds nothing to it. ``device_types``:
    the devices whose calls are recorded (the card's; the tests add the
    CPU's)."""

    def __init__(self, device_types=("cuda",)):
        self.device_types = device_types
        self.calls = defaultdict(int)
        self.bound_s = defaultdict(float)
        self._searches = []  # (group, query, target, k)
        self._gicp = []  # (form, batch, rows, idx, d2, src mask, tgt mask, max_d2, found)
        self._assoc = {}  # id of an association's idx -> its record
        self._undo = []

    def install(self):
        from hdl_graph_slam_tpu_torch.ops import knn
        from hdl_graph_slam_tpu_torch.registration import gicp

        rec = self

        def wrap(owner, attr, fn):
            orig = getattr(owner, attr)
            setattr(owner, attr, fn(orig))
            self._undo.append((owner, attr, orig))

        def search(orig):
            @functools.wraps(orig)  # keeps the wrapper's launch counters
            def call(query, target, *a, **kw):
                out = orig(query, target, *a, **kw)
                if query.device.type in rec.device_types:
                    rec._searches.append(("search", query, target, a[0] if a else kw.get("k", 1)))
                return out
            return call

        for name in ("nn1", "nn1_batched", "knn_select", "knn_select_batched"):
            wrap(knn, name, search)

        def radius(orig):
            @functools.wraps(orig)
            def call(query, target, r):
                out = orig(query, target, r)
                if query.device.type in rec.device_types:
                    rec._searches.append(("radius_count", query, target, None))
                return out
            return call

        wrap(knn, "radius_count", radius)

        def launch(orig):
            def call(prep, form, T, idx, flags, Mw, num, out, name):
                orig(prep, form, T, idx, flags, Mw, num, out, name)
                rec._record_gicp(prep, form, idx, flags)
            return call

        wrap(gicp.Prepared, "_launch", launch)
        return self

    def _record_gicp(self, prep, form, idx, flags):
        found = prep.tgt_mask is None
        if flags is not None:  # an associating form: its gate inputs name the valid rows
            r = (form, prep.b, prep.n, idx, flags, prep.src.mask, prep.tgt_mask, prep.max_corr_dist ** 2, found)
            self._assoc[id(idx)] = r
        else:  # carried correspondences: the association that made idx
            a = self._assoc.get(id(idx))
            r = (form, prep.b, prep.n) + (a[3:] if a is not None else (idx, None, None, None, None, found))
        self._gicp.append(r)

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def finish(self):
        """Count the kept calls' valid rows (and the GICP calls' named
        target rows) and add their bounds."""
        for group, query, target, k in self._searches:
            n, m = valid_rows(query), valid_rows(target)
            nbytes = roofline.search_bytes(n, m, k) if group == "search" else roofline.radius_count_bytes(n, m)
            self.calls[group] += 1
            self.bound_s[group] += nbytes / roofline.HBM_BYTES_PER_S
        self._searches = []
        for form, b, n, idx, flags, smask, tmask, max_d2, found in self._gicp:
            w = dict(batch=b, rows=b * n, valid=0, named=0, named_valid=0)
            if flags is not None:
                idx2 = idx.reshape(b, -1).long()
                if found:
                    valid = flags.reshape(b, -1) & smask.reshape(b, -1)
                else:
                    valid = (smask.reshape(b, -1) & tmask[idx2] & (flags.reshape(b, -1) < max_d2))
                w["valid"] = int(valid.sum())
                w["named"] = sum(int(torch.unique(i).numel()) for i in idx2)
                w["named_valid"] = sum(int(torch.unique(i[v]).numel()) for i, v in zip(idx2, valid))
            nbytes, ops = roofline.gicp_step_work(form, w, found)
            self.calls["gicp_step"] += 1
            self.bound_s["gicp_step"] += roofline.bound_s(nbytes, ops)
        self._gicp, self._assoc = [], {}


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


KERNEL_GROUPS = {"search": ("nn1_kernel", "knn_select_kernel"), "radius_count": ("radius_count_kernel",),
                 "gicp_step": ("gicp_step_kernel",)}


def reduce_profile(prof, wall_s: float, frames: int) -> dict:
    """What the metric readers take from a torch.profiler run over
    ``frames`` frames and ``wall_s`` seconds of host wall time."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN_PREFIX)]
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX)]
    merged = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_us = sum(b - a for a, b in merged)
    per_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        per_name[e.name][0] += 1
        per_name[e.name][1] += (e.time_range.end - e.time_range.start) * 1e-6
    groups = {}
    for g, names in KERNEL_GROUPS.items():
        hits = [v for k, v in per_name.items() if any(n in k for n in names)]
        groups[g] = {"calls": sum(v[0] for v in hits), "seconds": sum(v[1] for v in hits)}
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]
    # idle gaps between merged device intervals, by the innermost host span
    # open at the gap's start: one sweep over span opens, closes and gaps
    marks = []
    for i, e in enumerate(host):
        marks.append((e.time_range.start, 0, i))
        marks.append((e.time_range.end, 2, i))
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        marks.append((a1, 1, b0 - a1))
    gaps = defaultdict(float)
    stack, closed = [], set()
    for _, kind, x in sorted(marks, key=lambda m: (m[0], m[1])):
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            closed.add(x)
            while stack and stack[-1] in closed:
                stack.pop()
        else:
            name = host[stack[-1]].name[len(SPAN_PREFIX):] if stack else "outside any span"
            gaps[name] += x * 1e-6
    return {
        "frames": frames,
        "wall_s": wall_s,
        "busy_s": busy_us * 1e-6,
        "device_ops": len(dev),
        "groups": groups,
        "device_ops_top": [[k[:120], v[1]] for k, v in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
    }
