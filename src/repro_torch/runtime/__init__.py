"""Fault-tolerant training loop (port of ``repro.runtime``)."""
