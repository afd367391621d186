"""Host syncs a frame over one window of frames, from torch's sync-debug count."""


def read(ctx):
    s = ctx.get("syncs")
    return None if not s or s["count"] is None or not s["frames"] else s["count"] / s["frames"]
