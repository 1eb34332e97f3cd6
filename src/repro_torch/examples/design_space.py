"""Design-space exploration: sweep the analog core design axes and print
the accuracy / energy / area frontier (the paper's Sec. 9 case study;
port of ``examples/design_space.py``).

Demonstrates the ``repro_torch.sweep`` engine end to end: the five named
designs are an explicit-point :class:`~repro_torch.sweep.SweepSpec`,
accuracy comes from :class:`~repro_torch.sweep.ClassifierEvaluator`
(results cached and resumable under ``build/examples``), and the
energy/area columns reuse the same design points through
``repro_torch.core.energy``.

Run: PYTHONPATH=src python -m repro_torch.examples.design_space [--device cpu]
"""

from __future__ import annotations

from repro_torch.core import energy as en
from repro_torch.core.adc import ADCConfig
from repro_torch.core.analog import AnalogSpec
from repro_torch.core.errors import SONOS_ON_OFF, sonos
from repro_torch.core.mapping import MappingConfig
from repro_torch.examples import BUILD, parser
from repro_torch.examples.classifier import (digital_accuracy, eval_data,
                                             train_mlp)
from repro_torch.sweep import (ClassifierEvaluator, SweepSpec, run_sweep,
                               sweep_mesh)

#: (scheme, bits per cell, rows, input accumulation, mean conductance)
DESIGNS = [
    ("differential", None, 1152, "analog", 0.02),
    ("differential", 1, 1152, "analog", 0.08),
    ("differential", None, 144, "analog", 0.02),
    ("differential", None, 1152, "digital", 0.02),
    ("offset", 2, 72, "digital", 0.5),
]


def name_of(scheme, bpc, rows, accum) -> str:
    return f"{scheme}/bpc={bpc}/rows={rows}/{accum}"


def sweep(designs=DESIGNS, **kw) -> SweepSpec:
    """``designs`` (the five by default) as explicit points, 3 trials each
    (``kw`` goes to the spec: ``trials``, ``test_n``)."""
    return SweepSpec.from_points(
        "example_design_space",
        [
            (name_of(scheme, bpc, rows, accum), AnalogSpec(
                mapping=MappingConfig(scheme=scheme, bits_per_cell=bpc,
                                      on_off_ratio=SONOS_ON_OFF),
                adc=ADCConfig(style="calibrated", bits=8),
                error=sonos(), input_accum=accum, max_rows=rows))
            for scheme, bpc, rows, accum, _ in designs
        ],
        **{"trials": 3, **kw},
    )


def evaluate(evaluator, spec: SweepSpec, *, designs=DESIGNS,
             cache_dir=BUILD):
    """[(tag, mean accuracy, its std over the trials, fJ/op, mm^2)] of the
    points of ``sweep(designs)``, their accuracies from ``evaluator`` and
    cached under ``cache_dir`` (None: no cache)."""
    res = run_sweep(spec, evaluator, cache_dir=cache_dir, mesh=sweep_mesh(),
                    verbose=True)
    rows = []
    for (_, _, _, _, g_avg), r in zip(designs, res):
        c = en.core_costs(spec.explicit[r.index][1], g_avg=g_avg)
        rows.append((r.tag, r.mean, r.std, c.energy_fj_per_op, c.area_mm2))
    return rows


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    params = train_mlp(device=args.device)
    base = digital_accuracy(params)
    print(f"digital 8-bit baseline: {base:.4f}\n")
    print(f"{'design':<44}{'acc':>8}{'fJ/op':>10}{'mm^2':>8}")
    xca, _, xte, yte = eval_data(args.device)
    ev = ClassifierEvaluator(params, xca, xte, yte, device=args.device)
    rows = evaluate(ev, sweep())
    for tag, acc, _, fj, mm2 in rows:
        print(f"{tag:<44}{acc:>8.4f}{fj:>10.1f}{mm2:>8.2f}")
    return {"digital": base, "rows": rows}


if __name__ == "__main__":
    main()
