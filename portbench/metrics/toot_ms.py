"""Synchronised host ms of ``sweep`` per job in the window (tuning layer)."""
from portbench import readers


def read(ctx):
    return readers.span_mean_ms(ctx, "sweep")
