"""Static analysis for the port (counterpart of ``repro.analysis``).

Two layers:

* **lint** — AST passes over ``src/repro_torch`` for the hazard classes
  the port has shipped or guards against: a draw from torch's global
  generator, literal seeds, host syncs reachable from the decode,
  prefill, probe and sweep-point bodies, a tensor divided by a Python
  number (CUDA multiplies by the rounded reciprocal), a TF32 switch
  turned on, bare asserts / silent ``except: pass``; and one token pass
  over ``csrc/`` holding the analog kernels to their ``__f*_rn``
  arithmetic.  See ``repro_torch.analysis.rules`` and ``.csrc``.
* **contracts** — :class:`CompileContract` declarations checked
  statically against the sweep executor's compile-group partition and,
  at trace level, against what the port really builds and launches:
  ``nvcc`` runs, programmed-codes cache entries, and the kernels each
  decode step and prefill group launches.  The suite lives in
  ``repro_torch.analysis.repo_contracts``.

Two reference rules have no counterpart.  ``spmd-concat`` guards XLA's
SPMD partitioner, and the port has none (item 12 of the roadmap revisits
it for DTensor).  ``pallas-tile`` guards Mosaic's tile rules, and the
port's CUDA kernels take any M, N and head dimension and mask their own
edges (``kernels/ops.py``).  The reference's jaxpr helpers
(``jaxpr_scalar_constants``, ``traced_constant_violations``) become
:func:`template_leak_violations`, and ``jit_cache_size`` becomes
:func:`programmed_cache_size` beside :class:`step_launches`.

``python -m repro_torch.analysis`` is the CLI; ``--ci`` gates on the
committed baseline (``repro_torch/analysis/baseline.json``, shipped
empty).
"""

from repro_torch.analysis.contracts import (
    CompileContract,
    TRACE_SENTINELS,
    check_contract,
    check_contracts,
    compile_counter,
    programmed_cache_size,
    step_launches,
    template_leak_violations,
)
from repro_torch.analysis.findings import (
    Baseline,
    Finding,
    apply_suppressions,
    suppressed_rules,
)
from repro_torch.analysis.report import (
    analyze_file,
    analyze_paths,
    analyze_source,
    render,
    rule_ids,
)

__all__ = [
    "Baseline",
    "CompileContract",
    "Finding",
    "TRACE_SENTINELS",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "apply_suppressions",
    "check_contract",
    "check_contracts",
    "compile_counter",
    "programmed_cache_size",
    "render",
    "rule_ids",
    "step_launches",
    "suppressed_rules",
    "template_leak_violations",
]
