"""Sweep evaluators: the trial pipeline and its serial reference
(counterpart of ``repro.sweep.evaluate``).

The paper's metric loop (program -> calibrate -> evaluate, averaged over
programming trials, Sec. 5) appears here exactly once, in
:func:`trial_accuracy`.  Around it:

* :class:`ClassifierEvaluator` — the executor backend for a feed-forward
  classifier.  The deterministic half of programming (quantize + integer
  code mapping) is cached per mapping signature
  (:func:`mapping_signature`) via
  :func:`repro_torch.core.analog.program_codes`, so per-trial work is
  only conductance conversion + perturb + matmul + ADC.
* :func:`serial_accuracy` — the one-point-at-a-time loop the executor is
  held against (same seeds in, same accuracies out).
* :class:`FunctionEvaluator` — generic per-point metrics (conductance
  averages, energy models, SNR probes), optionally per trial.

Departures from the reference:

* **Trials and points loop in Python.**  The reference ``vmap``s trials
  over PRNG keys and a compile group's points over traced scalars inside
  one ``jit``.  The port's kernels are ``ctypes`` calls, which
  ``torch.func.vmap`` cannot batch, so ``evaluate_group`` evaluates each
  (point, trial) in turn.  A compile group still shares one template and
  one programmed-codes entry; each point's dynamic fields are set to its
  own values (Python floats, where the reference traces float32
  scalars), so the executor equals :func:`serial_accuracy` exactly.
* **Seeds are integers.**  :func:`trial_keys` folds the sweep seed with
  ``core.errors.fold_seed`` (the port's ``fold_in``), and layer ``i`` of
  a trial programs from ``fold_seed(trial_seed, i)``.  ``torch.Generator``
  cannot replay ``jax.random``, so noisy accuracies are held against the
  reference by statistics, or on the reference's injected conductances.
* **Cache signatures carry a port tag** (``classifier/torch-v1/...``,
  ``function/<name>/torch-v1/...``): results differ from the reference's
  by their random draws, so a shared cache never mixes them.  Tensors
  are hashed by content, as bytes on the CPU.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.analog import (
    AnalogSpec,
    ProgrammedMatrix,
    analog_matmul,
    program,
    program_codes,
    program_from_codes,
)
from repro_torch.core.calibrate import constrain_power_of_two
from repro_torch.core.errors import fold_seed
from repro_torch.core.quant import calibrate_act_range
from repro_torch.sweep.dispatch import (gather_point_trial,
                                        shard_point_trial_batch)
from repro_torch.sweep.spec import set_field


def trial_keys(seed: int, trials: int) -> List[int]:
    """The per-trial seeds: ``fold_seed(seed, t)`` for each trial ``t``."""
    return [fold_seed(seed, t) for t in range(trials)]


def materialize(template: AnalogSpec, assignments: Dict[str, Any]) -> AnalogSpec:
    """Substitute a point's dynamic values into a template spec."""
    spec = template
    for path, value in assignments.items():
        spec = set_field(spec, path, value)
    return spec


def tensor_bytes(t) -> bytes:
    """A tensor's (or array's) content as bytes, for cache signatures."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


def trial_accuracy(
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    spec: AnalogSpec,
    trial_seed: int,
    xca: torch.Tensor,
    xte: torch.Tensor,
    yte: torch.Tensor,
    *,
    act_fn: Callable = torch.relu,
    pms: Optional[Sequence[ProgrammedMatrix]] = None,
) -> torch.Tensor:
    """One programming trial of the analog classifier (paper Sec. 5).

    Per layer: program (or reuse cached codes), calibrate the activation
    clip on the calibration split, run the collect pass for calibrated
    ADC ranges (power-of-two constrained when sliced, Sec. 6.2), then
    evaluate test and calibration batches through the analog pipeline.
    Layer ``i`` programs from ``fold_seed(trial_seed, i)``.
    """
    h_te, h_ca = xte, xca
    for i, (w, b) in enumerate(layers):
        layer_seed = fold_seed(trial_seed, i)
        if pms is None:
            aw = program(w, spec, layer_seed)
        else:
            aw = program_from_codes(pms[i], spec, layer_seed)
        _, act_hi = calibrate_act_range(h_ca, spec.input_bits)
        if spec.adc.style == "calibrated":
            _, stats = analog_matmul(h_ca, aw, spec, act_hi=act_hi,
                                     collect=True)
            lo, hi = stats[:, 0], stats[:, 1]
            if spec.mapping.sliced:
                lo, hi = constrain_power_of_two(lo, hi)
            kw = dict(adc_lo=lo, adc_hi=hi)
        else:
            kw = {}
        y_te = analog_matmul(h_te, aw, spec, act_hi=act_hi, **kw) + b
        y_ca = analog_matmul(h_ca, aw, spec, act_hi=act_hi, **kw) + b
        if i < len(layers) - 1:
            h_te, h_ca = act_fn(y_te), act_fn(y_ca)
        else:
            h_te = y_te
    return (torch.argmax(h_te, dim=-1) == yte).float().mean()


def serial_accuracy(
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    spec: AnalogSpec,
    xca: torch.Tensor,
    xte: torch.Tensor,
    yte: torch.Tensor,
    *,
    trials: int = 5,
    seed: int = 1234,
    act_fn: Callable = torch.relu,
) -> Tuple[float, float, List[float]]:
    """The per-point serial loop: one trial at a time, programming each
    layer from its weights (no codes cache)."""
    accs = [float(trial_accuracy(layers, spec, s, xca, xte, yte,
                                 act_fn=act_fn))
            for s in trial_keys(seed, trials)]
    return float(np.mean(accs)), float(np.std(accs)), accs


def dynamic_fields_for(spec) -> Dict[str, float]:
    """The spec fields a compile group may vary for ``spec``.

    Shared by every accuracy evaluator (``ClassifierEvaluator``,
    ``ServeEvaluator``), with the reference's exclusion rules, so the
    port groups every grid as the reference does:

    * ``error.alpha`` — only for sampled error kinds;
    * ``mapping.on_off_ratio`` — excluded under the FPG ADC, whose range
      snapping consumes ``g_min`` in Python ``math.floor``;
    * ``r_hat`` — only while parasitics are *on*; the on/off bit is a
      static program property (``AnalogSpec.parasitics_on``), which is
      what collapses a Fig. 19 axis into one compile group.
    * ``drift.nu`` / ``drift.t`` — only under power-law drift, and
      ``fault.rate`` / ``fault.t`` — only with stuck faults (kind is
      static, ``AnalogSpec.aging_on``).

    ``spec`` may also be a :class:`repro_torch.hw.Profile`: each analog
    rule's dynamic fields are prefixed with its selector
    (``"attn:error.alpha"``), matching the profile spelling of
    ``set_field``.  A selector shared by several rules (layer bands) stays
    dynamic only if the rules agree on the value (``with_field`` sets all
    of them at once).
    """
    from repro_torch.hw.profile import Profile

    if isinstance(spec, Profile):
        seen: Dict[str, List[float]] = {}
        for selector, sp in spec.selectors():
            for path, v in dynamic_fields_for(sp).items():
                seen.setdefault(f"{selector}:{path}", []).append(v)
        return {name: vals[0] for name, vals in seen.items()
                if len(set(vals)) == 1}
    dyn: Dict[str, float] = {}
    if spec.error.kind in ("state_independent", "state_proportional"):
        dyn["error.alpha"] = float(spec.error.alpha)
    if spec.adc.style != "fpg":
        dyn["mapping.on_off_ratio"] = float(spec.mapping.on_off_ratio)
    if spec.parasitics_on:
        dyn["r_hat"] = float(spec.r_hat)
    if spec.drift.kind == "power_law":
        dyn["drift.nu"] = float(spec.drift.nu)
        dyn["drift.t"] = float(spec.drift.t)
    if spec.fault.kind == "stuck":
        dyn["fault.rate"] = float(spec.fault.rate)
        dyn["fault.t"] = float(spec.fault.t)
    return dyn


def mapping_signature(spec: AnalogSpec) -> str:
    """The fields :func:`program_codes` depends on (g_min-independent).

    Shared key of the programmed-codes caches: per-network code stacks are
    identical across all design points agreeing on these fields
    (``ClassifierEvaluator._programmed``, ``ServeEvaluator._codes``).
    """
    m = spec.mapping
    return f"{m.scheme}|{m.weight_bits}|{m.bits_per_cell}|{m.unit_column}"


def on_device(a, device) -> torch.Tensor:
    """``a`` (a tensor, array or list) as a tensor on ``device``; arrays
    are copied, so a read-only array is never aliased."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.array(a), device=device)


class ClassifierEvaluator:
    """Analog accuracy of a feed-forward classifier, per design point and
    trial.

    One instance owns the network weights and the calibration/test splits
    (moved to ``device``, the card unless the caller asks for the CPU);
    the executor hands it compile groups and it returns per-(point,
    trial) accuracies.
    """

    def __init__(
        self,
        layers: Sequence[Tuple[Any, Any]],
        xca,
        xte,
        yte,
        *,
        act_fn: Callable = torch.relu,
        version: str = "v1",
        device="cuda",
    ):
        self.layers = [(on_device(w, device), on_device(b, device))
                       for w, b in layers]
        self.xca, self.xte, self.yte = (on_device(a, device)
                                        for a in (xca, xte, yte))
        self.act_fn = act_fn
        h = hashlib.sha256()
        for w, b in self.layers:
            h.update(tensor_bytes(w))
            h.update(tensor_bytes(b))
        for a in (self.xca, self.xte, self.yte):
            h.update(tensor_bytes(a))
        self._sig = (f"classifier/torch-{version}/{act_fn.__name__}/"
                     f"{h.hexdigest()[:16]}")
        self._pm_cache: Dict[str, List[ProgrammedMatrix]] = {}

    # -- executor protocol -------------------------------------------------
    def signature(self) -> str:
        return self._sig

    def dynamic_fields(self, spec: AnalogSpec) -> Dict[str, float]:
        return dynamic_fields_for(spec)

    def evaluate_group(
        self,
        template: AnalogSpec,
        dyn_names: Tuple[str, ...],
        dyn_rows: Sequence[Tuple[float, ...]],
        trials: int,
        seed: int,
        test_n: Optional[int],
        mesh=None,
    ) -> List[List[float]]:
        """Evaluate every (point, trial) of one compile group in turn."""
        rows, seeds, axis = shard_point_trial_batch(
            dyn_rows, trial_keys(seed, trials), mesh)
        pms = self._programmed(template)
        xte = self.xte if test_n is None else self.xte[:test_n]
        yte = self.yte if test_n is None else self.yte[:test_n]
        out = []
        for row in rows:
            spec = materialize(template, dict(zip(dyn_names, row)))
            out.append([
                float(trial_accuracy(self.layers, spec, s, self.xca, xte, yte,
                                     act_fn=self.act_fn, pms=pms))
                for s in seeds])
        return gather_point_trial(out, mesh, axis)

    # -- caches ------------------------------------------------------------
    def _programmed(self, template: AnalogSpec) -> List[ProgrammedMatrix]:
        """Programmed-codes cache keyed by the mapping signature (the
        weights are the instance's)."""
        key = mapping_signature(template)
        if key not in self._pm_cache:
            self._pm_cache[key] = [
                program_codes(w, template) for w, _ in self.layers]
        return self._pm_cache[key]


def _to_py(v):
    """JSON-able form of a metric value."""
    if isinstance(v, dict):
        return {k: _to_py(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_py(x) for x in v]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return float(v) if v.ndim == 0 else v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return float(v)
    return v


class FunctionEvaluator:
    """Generic per-point metric for non-accuracy sweeps.

    ``fn(spec)`` for deterministic metrics (conductance averages, energy
    models); ``fn(spec, seed)`` with ``takes_key=True`` for Monte-Carlo
    metrics, called once per trial with that trial's integer seed
    (:func:`trial_keys`) where the reference passes a PRNG key.

    ``data`` MUST name everything ``fn`` closes over that can change
    between runs (weight matrices, calibration batches, model-fit
    constants): it is hashed into the cache signature, and omitting it
    lets the on-disk sweep cache serve results computed from stale
    inputs.  Pass tensors or arrays directly — they are hashed by content.
    """

    def __init__(
        self,
        fn: Callable,
        *,
        name: str,
        version: str = "v1",
        takes_key: bool = False,
        data: Sequence[Any] = (),
    ):
        self.fn = fn
        self.takes_key = takes_key
        h = hashlib.sha256()
        for item in data:
            if isinstance(item, (torch.Tensor, np.ndarray)):
                h.update(tensor_bytes(item))
            else:
                h.update(repr(item).encode())
        self._sig = f"function/{name}/torch-{version}/{h.hexdigest()[:16]}"

    def signature(self) -> str:
        return self._sig

    def dynamic_fields(self, spec: AnalogSpec) -> Dict[str, float]:
        return {}

    def evaluate_group(self, template, dyn_names, dyn_rows, trials, seed,
                       test_n, mesh=None) -> List[List[Any]]:
        if dyn_names:
            raise ValueError(
                f"FunctionEvaluator declares no dynamic fields but the "
                f"executor passed {dyn_names!r}")
        rows, seeds, axis = shard_point_trial_batch(
            dyn_rows, trial_keys(seed, trials), mesh)
        if self.takes_key:
            vals = [_to_py(self.fn(template, s)) for s in seeds]
        else:
            vals = [_to_py(self.fn(template))]
        return gather_point_trial([list(vals) for _ in rows], mesh,
                                  axis)
