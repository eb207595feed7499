"""MB the program copied between host and device per profiled job, both ways (transfers layer)."""
from portbench import inside


def read(ctx):
    return inside.counted_per_round(ctx, ("h2d_bytes", "d2h_bytes"), scale=1e-6)
