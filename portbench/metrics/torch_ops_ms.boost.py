"""Profiled device ms per round of every operation that is not one of the port's own kernels (ensembles layer)."""
from portbench import readers


def read(ctx):
    return readers.other_ops_ms_per_round(ctx)
