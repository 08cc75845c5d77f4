"""Serving runtime of the LM stack (port of ``repro.launch.serve``)."""
