"""Each cell at a size a CPU test holds: the configuration's family and
design with the smoke widths the port's tests use, and the traffic's
batches, grid and loop cut down.  Only the tests run these."""

from __future__ import annotations

import copy

from harness import common

SMOKE_MODEL = {"d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 96,
               "vocab": 128, "n_layers": 2, "dtype": "float32"}

#: limits at this size, where the port and the reference agree to the
#: bit: below the control's readings (loss 0.002-0.08) and one decode
#: token in six
SMOKE_LIMITS = {"loss_diff": 1e-3, "tokens_diff": 0.1}

SWEEP = {"calibration": {"rows": 2, "length": 8},
         "eval": {"rows": 4, "length": 8},
         "prompts": {"rows": 2, "length": 4}, "decode_new": 3}


def cell(name: str, **model) -> common.Cell:
    """The named cell at smoke size; ``model`` overrides smoke widths."""
    c = copy.deepcopy(common.Cell.named(name))
    c.config["model"].update(SMOKE_MODEL, **model)
    c.workload["limits"] = dict(SMOKE_LIMITS)
    c.traffic.update(copy.deepcopy(SWEEP))
    if c.traffic.get("test_n"):
        c.traffic["test_n"] = 2
    for axis in c.traffic.get("axes", []):
        axis["values"] = axis["values"][:2]
    return c
