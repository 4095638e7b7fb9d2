"""Decode chunks' wall milliseconds per decode step (engine spans)."""

from servebench import readers


def read(ctx):
    return readers.decode_step_ms(ctx)
