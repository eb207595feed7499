"""Device idle ms inside the program's ``tree.level`` spans per profiled round (level loop layer)."""
from portbench import inside


def read(ctx):
    return inside.idle_in_spans_ms(ctx, "tree.level")
