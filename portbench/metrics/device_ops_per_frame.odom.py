"""Device operations (kernels, copies, sets) a frame in the profiled window slice."""
from portbench import readers


def read(ctx):
    return readers.per_frame(ctx, "device_ops")
