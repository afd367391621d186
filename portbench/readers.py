"""Arithmetic the per-layer metric readers share. Each takes the ``ctx`` a
traced run recorded and returns None where it finds nothing to read."""

from __future__ import annotations

import numpy as np

from . import roofline


def profile(ctx: dict):
    return ctx.get("profile")


def per_frame(ctx: dict, key: str):
    """A profiled-slice count over its frames."""
    p = profile(ctx)
    if not p or not p["frames"]:
        return None
    return p[key] / p["frames"]


def idle_share(ctx: dict):
    """1 - device busy time (the union of device intervals) / slice wall time."""
    p = profile(ctx)
    if not p or p["wall_s"] <= 0 or p["device_ops"] == 0:
        return None
    return 1.0 - p["busy_s"] / p["wall_s"]


def kernel_roofline(ctx: dict, group: str):
    """Σ bound / Σ device time of one kernel group in the profiled slice, in
    %; None where the group did not run, or where the trace holds another
    number of its launches than the program made (a trace that lost events)."""
    p = profile(ctx)
    if not p:
        return None
    calls = p["launch_calls"].get(group, 0)
    g = p["groups"][group]
    if calls == 0 or g["calls"] != calls:
        return None
    return roofline.share_pct(p["bound_s"][group], g["seconds"])


def span_p95_ms(ctx: dict, name: str):
    walls = (ctx.get("spans") or {}).get(name)
    if not walls:
        return None
    return float(np.percentile(np.asarray(walls), 95)) * 1e3
