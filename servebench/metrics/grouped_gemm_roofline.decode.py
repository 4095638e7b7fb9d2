"""The grouped expert GEMM's least time for the true tokens over its device time."""

from servebench import readers


def read(ctx):
    return readers.roofline(ctx, "grouped")
