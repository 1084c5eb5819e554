"""Serving runtime of the port (prefill/decode steps, HeMT batching)."""
