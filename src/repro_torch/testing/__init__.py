"""Test and soak infrastructure that tools and the chip smoke import too
(port of ``repro.testing``): :mod:`repro_torch.testing.faults` (seeded
fault injection), :mod:`repro_torch.testing.soak` (the soak harness),
:mod:`repro_torch.testing.scenarios` (the four long-lived-surface soak
scenarios) and :mod:`repro_torch.testing.fuzz` (random legal networks)."""
