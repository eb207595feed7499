"""Profiled device ms of the split-scan kernel per job (selection layer)."""
from portbench import readers


def read(ctx):
    return readers.kernel_ms_per_round(ctx, "split_scan")
