"""Launchers: `serve.py`, the port of repro/launch/serve.py."""
