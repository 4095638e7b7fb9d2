"""Training: so far only `fault.py`, the port's copy of
repro/train/fault.py (its `Ewma` feeds the serving controls)."""
