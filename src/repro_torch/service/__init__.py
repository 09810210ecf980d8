"""Serving-side helpers of the port (the delta stream)."""
