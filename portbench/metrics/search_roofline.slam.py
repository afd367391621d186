"""nn1 and knn_select (single and batched): Σ bytes-once bound / Σ device time, in %."""
from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "search")
