"""Binarization math and the packed deployment form (port of ``repro.core``)."""
