"""Quickstart: the paper's contribution in a few lines (port of
``examples/quickstart.py``).

Programs a weight matrix onto simulated analog arrays under the paper's
recommended design (differential cells, unsliced weights, analog input
accumulation, calibrated 8-bit ADC) and the ISAAC-like offset baseline,
injects SONOS-measured programming errors, and compares dot-product error.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import analog as A
from repro_torch.core import errors as E
from repro_torch.core.adc import ADCConfig
from repro_torch.core.mapping import MappingConfig
from repro_torch.examples import parser

K, N, M = 1152, 256, 64
#: the programming-noise seed of both designs
PROGRAM_SEED = 42


def designs():
    """(name, spec) of the two designs compared."""
    return [
        ("design A (differential, unsliced, analog-accum)",
         A.design_a(error=E.sonos())),
        ("design E (offset, 2b slices, digital-accum)",
         A.AnalogSpec(mapping=MappingConfig(scheme="offset", bits_per_cell=2),
                      adc=ADCConfig(style="calibrated", bits=8),
                      error=E.sonos(), input_accum="digital", max_rows=72)),
    ]


def laplace(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Laplace draws, as ``jax.random.laplace`` makes them from a
    uniform on (-1, 1)."""
    u = torch.rand(shape, generator=gen) * 2.0 - 1.0
    u = torch.clamp(u, -1.0 + 2.0 ** -24, 1.0 - 2.0 ** -24)
    return -torch.sign(u) * torch.log1p(-u.abs())


def inputs(device, seeds=(0, 1, 2)):
    """(w, x, xc): zero-peaked (K, N) weights, and the evaluated and
    calibration batches of ReLU'd normals, from ``seeds``."""
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    w = laplace((K, N), gens[0]) * 0.02
    x, xc = (torch.relu(torch.randn((M, K), generator=g)) for g in gens[1:])
    return w.to(device), x.to(device), xc.to(device)


def ideal_output(w, x):
    """``x @ w`` through the ADC-free, error-free Design A: the quantized
    dot products every design is compared against."""
    spec0 = dataclasses.replace(A.design_a(), adc=ADCConfig(style="none"))
    return A.analog_matmul(x, A.program(w, spec0), spec0)


def calibrated_output(aw, spec, x, xc):
    """``x`` through the programmed ``aw``, its ADC range calibrated on
    the held-out batch ``xc`` (Sec. 6.2)."""
    _, stats = A.analog_matmul(xc, aw, spec, collect=True)
    return A.analog_matmul(x, aw, spec, adc_lo=stats[:, 0],
                           adc_hi=stats[:, 1])


def relative_error(y, ideal) -> float:
    """RMS error over the ideal output's (population) standard deviation."""
    return float(torch.sqrt(torch.mean((y - ideal) ** 2))
                 / torch.std(ideal, correction=0))


def run(device, seed: int = PROGRAM_SEED):
    """[(design name, relative dot-product error)] with programming seed
    ``seed``."""
    w, x, xc = inputs(device)
    ideal = ideal_output(w, x)
    return [(name, relative_error(
        calibrated_output(A.program(w, spec, seed), spec, x, xc), ideal))
        for name, spec in designs()]


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    errs = run(args.device)
    for name, err in errs:
        print(f"{name}\n  relative dot-product error: {err:.4f}")
    print("\nproportional mapping wins — see benchmarks/ for the full study")
    return errs


if __name__ == "__main__":
    main()
