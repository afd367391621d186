"""95th percentile of every process_frame wall time after the profiled slice,
each span ending in a device synchronisation."""
from portbench import readers


def read(ctx):
    return readers.span_p95_ms(ctx, "frame")
