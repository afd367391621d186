"""1 - the union of device intervals / the profiled slice's wall time."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
