"""Share of the profiled jobs in which the device ran nothing."""
from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
