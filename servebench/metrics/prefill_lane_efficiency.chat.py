"""True prompt tokens over the rows the prefill calls computed (engine spans)."""

from servebench import readers


def read(ctx):
    return readers.prefill_lane_efficiency(ctx, ctx.mix["serving"]["slots"])
