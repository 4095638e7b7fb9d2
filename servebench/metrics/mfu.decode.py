"""The true tokens' model FLOPs over the traced window at the bf16 peak."""

from servebench import readers


def read(ctx):
    return readers.mfu(ctx)
