"""Checksummed, atomic, last-known-good checkpoints (port of ``repro.checkpoint``)."""
