"""A round's counted work at the card's peaks over its time in the window."""
from portbench import readers


def read(ctx):
    return readers.mfu_pct(ctx)
