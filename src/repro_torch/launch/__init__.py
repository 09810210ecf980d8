"""Serving entry points of the port (``repro.launch``)."""
