"""Prefill calls' share of the window, in the reasoning cells (engine spans)."""

from servebench import readers


def read(ctx):
    return readers.prefill_share(ctx)
