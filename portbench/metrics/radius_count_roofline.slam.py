"""radius_count_kernel: Σ bytes-once bound / Σ device time, in %."""
from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "radius_count")
