"""Heterogeneous per-site hardware: serve one LM with 8-bit-ADC attention
arrays, 6-bit-ADC MLP arrays, and a digital lm_head (port of
``examples/hetero_profile.py``).

``repro_torch.hw.Profile`` resolves every analog matmul site (hook name)
to its own AnalogSpec via pattern rules — the paper's "match the
precision of the hardware to the needs of the algorithm", made concrete.
The same ``program_lm -> calibrate_lm -> decode_lm`` pipeline serves the
mixed pack unchanged, and ``core.energy`` prices each site class on its
own spec and array shape.

Run: PYTHONPATH=src python -m repro_torch.examples.hetero_profile [--device cpu]
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import analog as A
from repro_torch.core import energy as en
from repro_torch.core import errors as E
from repro_torch.examples import parser, train_smoke_lm
from repro_torch.hw import DIGITAL, Profile, site_class
from repro_torch.serve.analog_engine import (
    analog_eval_loss, calibrate_lm, decode_lm, program_lm)
from repro_torch.train.step import loss_fn

PROGRAM_SEED = 7


def profile() -> Profile:
    """8-bit-ADC attention, 6-bit-ADC MLP, the head digital."""
    attn_spec = A.design_a(error=E.state_proportional(0.05))      # 8-bit ADC
    mlp_spec = dataclasses.replace(
        attn_spec, adc=dataclasses.replace(attn_spec.adc, bits=6))
    return Profile.by_class(attn=attn_spec, mlp=mlp_spec, head=DIGITAL)


def train(device):
    """The smoke qwen1.5-4b trained 60 steps: (cfg, dataset, params,
    final loss)."""
    return train_smoke_lm("qwen1.5-4b", 32, 60, device=device)


def program(cfg, params, ds):
    """The profile's pack, programmed with seed 7 and calibrated on the
    batch of step 998."""
    pack = program_lm(cfg, params, profile(), PROGRAM_SEED)
    return calibrate_lm(cfg, params, pack, ds.batch(998)["tokens"])


def evaluate(cfg, params, pack, batch):
    """(digital loss, analog loss, 6 greedy tokens for the first 2
    prompts' first 8 tokens through the pack) on ``batch``."""
    dig = float(loss_fn(cfg, params, batch)[0])
    al = float(analog_eval_loss(cfg, params, pack, batch["tokens"],
                                batch["targets"]))
    toks = decode_lm(cfg, params, batch["tokens"][:2, :8], 6, pack=pack)
    return dig, al, toks


def energy_table(pack):
    """Per-site ADC energy under each site's own resolved spec and shape:
    [(site, class, "KxN", adc bits, conversions, pJ per MVM)]."""
    rows = []
    for name, aw in sorted(pack.layer_weights.items()):
        spec = pack.site_spec(name)
        k, n = aw.k, aw.n
        rows.append((name, site_class(name), f"{k}x{n}", spec.adc.bits,
                     spec.adc_conversions_per_mvm(k, n),
                     en.adc_energy(spec, k, n)))
    return rows


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    cfg, ds, params, loss = train(args.device)
    print(f"trained smoke LM to loss {loss:.3f}")

    pack = program(cfg, params, ds)
    if pack.head is not None:
        raise RuntimeError("the head should stay off-array (digital)")

    dig, al, toks = evaluate(cfg, params, pack, ds.batch(999))
    print(f"digital loss {dig:.4f} | 8b-attn/6b-mlp/digital-head analog "
          f"loss {al:.4f} (delta {al - dig:+.4f})")
    print(f"served 2 prompts through the mixed pack: {toks.cpu().numpy()}")

    # the 6-bit MLP class converts at a quarter of the 8-bit energy
    print(f"{'site':<10} {'class':<6} {'shape':<12} {'adc bits':<9} "
          f"{'conversions':<12} adc energy")
    rows = energy_table(pack)
    for name, cls, shape, bits, conv, e in rows:
        print(f"{name:<10} {cls:<6} {shape:<12} {bits:<9} {conv:<12} "
              f"{e:8.1f} pJ/MVM")
    return {"pack": pack, "losses": (dig, al), "tokens": toks,
            "energy": rows}


if __name__ == "__main__":
    main()
