"""Host syncs the program made per profiled round (level loop layer)."""
from portbench import inside


def read(ctx):
    return inside.counted_per_round(ctx, ("host_syncs",))
