"""Runtime fault tolerance (counterpart of ``repro.runtime``)."""

from repro_torch.runtime.fault import (
    TRANSIENT_ERRORS,
    Heartbeat,
    StepFailed,
    StragglerMonitor,
    is_transient,
    resilient_step,
)

__all__ = [
    "TRANSIENT_ERRORS",
    "Heartbeat",
    "StepFailed",
    "StragglerMonitor",
    "is_transient",
    "resilient_step",
]
