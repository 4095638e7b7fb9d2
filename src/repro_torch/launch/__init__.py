"""Launchers (the ports of repro/launch): `serve.py`, `train.py` and the
mesh builders of `mesh.py`."""
