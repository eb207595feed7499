"""Counted histogram bytes at the HBM peak over the histogram kernels' profiled device time, per job."""
from portbench import readers


def read(ctx):
    return readers.roofline_pct(ctx, "histogram", "hist")
