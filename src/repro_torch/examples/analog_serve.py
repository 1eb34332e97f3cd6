"""Serve a trained LM through the analog pipeline: program -> calibrate ->
generate, comparing digital and analog generations and perplexity across
hardware design points (the paper's Table 4 on an LM; port of
``examples/analog_serve.py``).

Run: PYTHONPATH=src python -m repro_torch.examples.analog_serve [--device cpu]
"""

from __future__ import annotations

import torch

from repro_torch.core import analog as A
from repro_torch.core import errors as E
from repro_torch.examples import parser, train_smoke_lm
from repro_torch.serve.analog_engine import (
    analog_eval_loss, calibrate_lm, decode_lm, program_lm)
from repro_torch.train.step import loss_fn

PROGRAM_SEED = 7


def designs():
    return {
        "A  diff/unsliced/analog-accum + SONOS": A.design_a(error=E.sonos()),
        "A' diff/unsliced, no errors": A.design_a(),
        "E  offset/2b/digital-accum + SONOS": A.design_e(error=E.sonos()),
    }


def train(device):
    """The smoke gemma-2b trained 120 steps on 8 x 64 tokens: (cfg,
    dataset, params, final loss)."""
    return train_smoke_lm("gemma-2b", 64, 120, device=device)


def program(cfg, params, spec, ds):
    """``spec``'s pack, programmed with seed 7 and calibrated on the batch
    of step 499."""
    pack = program_lm(cfg, params, spec, PROGRAM_SEED)
    return calibrate_lm(cfg, params, pack, ds.batch(499)["tokens"])


def analog_loss(cfg, params, pack, batch) -> float:
    return float(analog_eval_loss(cfg, params, pack, batch["tokens"],
                                  batch["targets"]))


def serve(cfg, params, pack, prompts, n_new: int = 8):
    """Greedy continuations of ``prompts`` through ``pack`` and digitally,
    and the share of tokens on which they agree."""
    analog_toks = decode_lm(cfg, params, prompts, n_new, pack=pack)
    digital_toks = decode_lm(cfg, params, prompts, n_new, pack=None)
    match = float(torch.mean((analog_toks == digital_toks).float()))
    return analog_toks, digital_toks, match


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    cfg, ds, params, loss = train(args.device)
    print(f"trained tiny gemma-style LM to loss {loss:.3f}")

    batch = ds.batch(500)
    dig = float(loss_fn(cfg, params, batch)[0])
    print(f"digital eval loss: {dig:.4f}")
    losses = {}
    for name, spec in designs().items():
        al = analog_loss(cfg, params, program(cfg, params, spec, ds), batch)
        losses[name] = al
        print(f"{name:42s} analog loss {al:.4f} (delta {al-dig:+.4f})")

    # batched greedy serving through the analog path: one prefill + a
    # decode loop per request batch (repro_torch.serve.decode_lm)
    pack = program(cfg, params, A.design_a(error=E.sonos()), ds)
    analog_toks, _, match = serve(cfg, params, pack,
                                  batch["tokens"][:4, :8])
    print("analog greedy continuations:", analog_toks.tolist())
    print(f"agreement with digital serving: {match:.0%}")
    return {"digital": dig, "losses": losses, "tokens": analog_toks,
            "agreement": match}


if __name__ == "__main__":
    main()
