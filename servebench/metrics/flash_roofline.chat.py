"""Flash attention's least time for the true prompts over its device time."""

from servebench import readers


def read(ctx):
    return readers.roofline(ctx, "flash")
