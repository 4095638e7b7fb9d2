"""Serving: the bucketed, fused-decode ServeEngine and its per-token oracle."""
