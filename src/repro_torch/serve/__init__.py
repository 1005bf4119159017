"""Serving layer: the multi-tenant DSE service
(``repro_torch.serve.dse_service``) and its typed protocol
(``repro_torch.serve.protocol``), and the LM serving engine
(``repro_torch.serve.engine``: ``ServeLoop``, ``Request`` and the prefill
and decode steps), re-exported here."""
from repro_torch.serve.dse_service import DSEService, StudyHandle
from repro_torch.serve.engine import (Request, ServeLoop, build_decode_step,
                                      build_prefill_step)
from repro_torch.serve.protocol import (EVENT_KINDS, TERMINAL_EVENTS, Event,
                                        FrontierUpdate, Progress,
                                        StudyAccepted, StudyCompleted,
                                        StudyEvicted, StudyFailed,
                                        StudyRejected, StudyStarted,
                                        Submission, from_wire, is_terminal,
                                        to_wire)

__all__ = [
    "DSEService", "EVENT_KINDS", "Event", "FrontierUpdate", "Progress",
    "Request", "ServeLoop", "build_decode_step", "build_prefill_step",
    "StudyAccepted", "StudyCompleted", "StudyEvicted", "StudyFailed",
    "StudyHandle", "StudyRejected", "StudyStarted", "Submission",
    "TERMINAL_EVENTS", "from_wire", "is_terminal", "to_wire",
]
