"""Synchronised optimize_cycle spans over the wall time of the spanned window."""


def read(ctx):
    s = ctx.get("spans")
    if not s or s["window_s"] <= 0:
        return None
    return sum(s["optimize_cycle"]) / s["window_s"]
