"""Plain float32 PyTorch references of the served families, one file per
family. They import nothing of the program: they read the configuration's
file and the run's weight tensors (the inputs both sides are handed) and
work out everything else again: rope, masks, caches, routing."""

from __future__ import annotations


def family(name: str):
    """The reference module of a configuration's family."""
    if name == "dense":
        from . import dense
        return dense
    if name == "moe":
        from . import moe
        return moe
    raise KeyError(f"no plain reference for family {name!r}")
