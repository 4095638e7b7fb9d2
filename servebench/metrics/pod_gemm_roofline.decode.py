"""The NN pod GEMM's least time for the true tokens over its device time."""

from servebench import readers


def read(ctx):
    return readers.roofline(ctx, "pod_nn")
