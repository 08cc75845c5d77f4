"""Static analysis of compiled programs (port of ``repro.analysis``).

  * :mod:`repro_torch.analysis.hopper_rules` — the rules the port's CUDA
    launchers and plan pickers enforce, as data (ids, severities);
  * :mod:`repro_torch.analysis.verify` — ``verify_program`` re-derives every
    instruction's geometry and plan and returns ERROR/WARN findings before
    any launch;
  * :mod:`repro_torch.analysis.trace_lint` — the aten ops of one
    ``deploy.execute`` call (no library conv or product, no plan pick, no
    float64) and repeated traffic (no new picks or libraries, one launch
    per instruction).

``deploy.compile(..., verify=True)``, ``deploy.load_program`` and
``deploy.load_latest_good`` run ``verify_program``.
"""
from repro_torch.analysis import hopper_rules, trace_lint
from repro_torch.analysis.verify import (Finding, ProgramVerificationError,
                                         assert_verified, summarize,
                                         verify_program)

__all__ = [
    "Finding", "ProgramVerificationError", "assert_verified", "hopper_rules",
    "summarize", "trace_lint", "verify_program",
]
