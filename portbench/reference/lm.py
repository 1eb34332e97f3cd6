"""The reference's entry points for the harness: a design point worked
out trial by trial from the weights, tokens and seeds the port was
given, with nothing the port made.

``sweep_point`` programs the chip of each trial (its noise drawn from
the trial's seed), calibrates it on the calibration tokens, evaluates
the teacher-forced loss and top-1 on the eval tokens, and decodes the
prompts greedily; ``decode_match`` is the share of those tokens that the
digital model decodes too.  ``lower=True`` is the control: the same
computation with the arrays' operands rounded to TF32."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from reference import analog as A
from reference import model as M

config = M.config
init_params = M.init_params
analog_weight_count = M.analog_weight_count
design = A.design


def trial_seeds(seed: int, trials: int) -> List[int]:
    """The chips of a point: trial ``t`` is programmed from
    ``fold(seed, t)``."""
    return [A.fold(seed, t) for t in range(trials)]


def digital_tokens(cfg: M.Config, params: dict, prompts: torch.Tensor,
                   decode_new: int) -> torch.Tensor:
    """The digital model's greedy tokens."""
    return M.greedy(cfg, params, prompts, decode_new)


@torch.no_grad()
def sweep_point(cfg: M.Config, params: dict, d: A.Design, seed: int,
                trials: int, calib: torch.Tensor, tokens: torch.Tensor,
                targets: torch.Tensor, prompts: torch.Tensor,
                decode_new: int, *, lower: bool = False,
                digital: Optional[torch.Tensor] = None
                ) -> List[Dict[str, Any]]:
    """``loss``, ``top1``, ``decode_match`` and the greedy ``tokens`` of
    each trial of a design point."""
    if digital is None:
        digital = digital_tokens(cfg, params, prompts, decode_new)
    out = []
    for s in trial_seeds(seed, trials):
        chip = M.Analog(cfg, params, d, s, lower=lower)
        chip.calibrate(params, calib)
        m = M.eval_metrics(cfg, params, chip, tokens, targets)
        toks = M.greedy(cfg, params, prompts, decode_new, chip)
        m["decode_match"] = float((toks == digital).float().mean())
        m["tokens"] = toks
        out.append(m)
        del chip
    return out
