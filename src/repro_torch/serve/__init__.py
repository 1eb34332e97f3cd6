"""Serve an LM through the analog pipeline (counterpart of
``repro.serve``): program + calibrate (``analog_engine``), one-shot
batched decode (``decode_lm``), the continuous-batching runtime
(``runtime``), its paged-KV form with prefix sharing (``paged``, over
``kvpool``), and device-state management over time — drift, stuck-cell
faults and self-healing (``health``, ``age_pack``)."""

from repro_torch.serve.analog_engine import (
    age_pack,
    analog_eval_loss,
    analog_eval_metrics,
    calibrate_lm,
    decode_lm,
    hook_key,
    lm_hook_names,
    lm_program_codes,
    program_lm,
    program_lm_from_codes,
)
from repro_torch.serve.health import DriftClock, HealPolicy, PackManager
from repro_torch.serve.kvpool import PageAllocator, RadixCache
from repro_torch.serve.paged import PagedServeRuntime
from repro_torch.serve.runtime import (
    Completion,
    SamplerConfig,
    ServeRuntime,
    SlotState,
    request_key,
    sample_tokens,
)

__all__ = [
    "age_pack",
    "analog_eval_loss",
    "analog_eval_metrics",
    "calibrate_lm",
    "decode_lm",
    "hook_key",
    "lm_hook_names",
    "lm_program_codes",
    "program_lm",
    "program_lm_from_codes",
    "DriftClock",
    "HealPolicy",
    "PackManager",
    "PageAllocator",
    "PagedServeRuntime",
    "RadixCache",
    "Completion",
    "SamplerConfig",
    "ServeRuntime",
    "SlotState",
    "request_key",
    "sample_tokens",
]
