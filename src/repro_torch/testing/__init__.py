"""Test and soak infrastructure that tools and the chip smoke import too
(port of ``repro.testing``): :mod:`repro_torch.testing.faults`."""
