"""Synchronised graph solve wall time over the LM iterations the solves report."""


def read(ctx):
    s = ctx.get("spans")
    if not s or not sum(s["graph_iterations"]):
        return None
    return 1e3 * sum(s["graph_optimize"]) / sum(s["graph_iterations"])
