"""repro_torch.serve — continuous-batching request scheduler over one Engine.

The serving frontend for the PIM stack: admission-controlled request
queueing (:mod:`.request`), bit-exact per-sequence decode state
(:mod:`.sequence`), the dynamic-K continuous batcher whose scheduling
substrate is the engine's co-scheduled slot groups (:mod:`.batcher`),
seeded synthetic traffic (:mod:`.traffic`) and the closed-loop load
harness with SLO reporting (:mod:`.harness`). See the README "Serving"
section for the architecture walk-through.

The port's copy of ``repro.serve``: the scheduler runs on the port's
:class:`~repro_torch.engine.Engine`, so on the default backend every
crossbar pass it issues is a K1 launch on the card.
"""
from .batcher import ContinuousBatcher, StepStats
from .harness import LoadReport, compare_modes, run_load
from .request import PHASES, AdmissionController, Request, RequestQueue
from .sequence import (DECODE_ELEMS, SequenceState, reference_tokens,
                       token_stream, zero_operands)
from .traffic import TrafficConfig, generate

__all__ = [
    "AdmissionController", "ContinuousBatcher", "DECODE_ELEMS",
    "LoadReport", "PHASES", "Request", "RequestQueue", "SequenceState",
    "StepStats", "TrafficConfig", "compare_modes", "generate",
    "reference_tokens", "run_load", "token_stream", "zero_operands",
]
