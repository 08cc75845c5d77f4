"""Static analysis of compiled programs (port of ``repro.analysis``).

  * :mod:`repro_torch.analysis.hopper_rules` — the rules the port's CUDA
    launchers and plan pickers enforce, as data (ids, severities);
  * :mod:`repro_torch.analysis.verify` — ``verify_program`` re-derives every
    instruction's geometry and plan and returns ERROR/WARN findings before
    any launch.

``deploy.compile(..., verify=True)``, ``deploy.load_program`` and
``deploy.load_latest_good`` run it.
"""
from repro_torch.analysis import hopper_rules
from repro_torch.analysis.verify import (Finding, ProgramVerificationError,
                                         assert_verified, summarize,
                                         verify_program)

__all__ = [
    "Finding", "ProgramVerificationError", "assert_verified", "hopper_rules",
    "summarize", "verify_program",
]
