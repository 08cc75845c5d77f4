"""SLO-governed continuous-batching CNN inference over BinArrayPrograms.

Port of ``repro.serve_cnn``: bounded admission, per-request deadlines,
fixed-size batches into ``deploy.execute`` on the program's device, and
the paper's §IV-D runtime switch operated as the degradation policy —
under latency pressure the service serves fewer binary levels before it
sheds requests, and recovers to full-M when the pressure clears.
"""
from repro_torch.serve_cnn.service import (CNNService, ImageRequest,
                                           NonFiniteOutput, SHED_REASONS)
from repro_torch.serve_cnn.slo import (SLOConfig, SLOController, default_ladder,
                                       schedule_cost)

__all__ = [
    "CNNService", "ImageRequest", "NonFiniteOutput", "SHED_REASONS",
    "SLOConfig", "SLOController", "default_ladder", "schedule_cost",
]
