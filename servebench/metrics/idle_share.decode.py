"""Share of the traced window with no operation on the device."""

from servebench import readers


def read(ctx):
    return readers.idle_share(ctx)
