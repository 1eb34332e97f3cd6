"""Self-healing analog serving: device-state management over time
(counterpart of ``repro.serve.health``).

A programmed pack ages: conductances drift (power-law retention decay)
and cells fail (stuck-at faults), the processes of
``repro_torch.core.errors.DriftModel`` / ``FaultModel``.  This module
owns the serving side:

* :class:`DriftClock` — maps the runtime's decode-step counter to a device
  age ``t`` (in units of the programming-reference time t0);
* :class:`HealPolicy` — how often to probe health, the probe-loss
  threshold, and the per-scheduler-step reprogram budget;
* :class:`PackManager` — a pack's full device state: the programmed
  integer codes, per-band reprogram epochs (which seed the re-drawn
  programming noise), each band's aging clock, recalibration, and the
  calibration-probe loss against the fresh pack's.

Everything replays.  Aging seeds fold from stable hook-name hashes
(``analog_engine.age_pack``); reprogram epoch ``e`` uses
``fold_seed(fold_seed(seed, _REPROGRAM_FOLD), e)``, epoch 0 being the
original programming seed, so a new manager's pack equals ``program_lm`` +
``calibrate_lm`` with the same seed, and reprogramming a band at epoch 0
gives the same rows as the fresh program.

Per band ``b`` programmed at age ``t_p``:

* programming noise is re-drawn per epoch (a reprogram is a new write);
* drift runs on relative age, ``g * (t / t_p)^-nu_cell``: reprogramming
  resets the decay clock, which is what makes healing work;
* faults run on absolute age, seeded apart from epochs: a stuck cell stays
  stuck across reprogramming.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.analog import AnalogSpec, AnalogWeights
from repro_torch.core.errors import fold_seed
from repro_torch.hw.profile import Profile, as_profile
from repro_torch.models.transformer import AnalogPack
from repro_torch.serve.analog_engine import (
    HEAD,
    _age_weights,
    _layer_codes,
    _stack_layers,
    age_pack,
    analog_eval_metrics,
    calibrate_lm,
    hook_key,
    lm_program_codes,
    program_from_codes,
    program_lm_from_codes,
)

#: fold tag separating reprogram-epoch seeds from the programming seed
#: (epoch 0 *is* the programming seed — see :meth:`PackManager.epoch_seed`)
_REPROGRAM_FOLD = 0x72657067  # "repg"

#: fold tag deriving the default aging seed from the programming seed
_AGE_KEY_FOLD = 0x64726674  # "drft"

#: the head's slot in a heal queue (bands are integer indices)
HEAD_BAND = "head"


@dataclasses.dataclass(frozen=True)
class DriftClock:
    """Decode-step counter -> device age ``t`` (t0 units, 1.0 = fresh).

    ``update_every``: a runtime with a clock but no :class:`HealPolicy`
    refreshes its served pack every this many decode steps (the unhealed
    baseline healing is measured against).
    """

    dt_per_step: float = 0.0
    update_every: int = 16

    def __post_init__(self):
        if self.dt_per_step < 0:
            raise ValueError(
                f"DriftClock.dt_per_step must be >= 0, got {self.dt_per_step}")
        if self.update_every < 1:
            raise ValueError(
                f"DriftClock.update_every must be >= 1, got "
                f"{self.update_every}")

    def at(self, step: int) -> float:
        return 1.0 + self.dt_per_step * step


@dataclasses.dataclass(frozen=True)
class HealPolicy:
    """Step-budgeted self-healing of a ``ServeRuntime``.

    Every ``check_every`` decode steps the runtime re-ages its pack and
    measures the calibration-probe loss; above ``ref * loss_mult +
    loss_add`` (against the fresh pack's) a heal event queues every aging
    band for reprogramming, drained ``bands_per_step`` per scheduler step
    between decode steps, then one recalibration once the queue is empty.
    Reprogramming runs through ``repro_torch.runtime.fault.resilient_step``
    with ``max_retries``/``backoff_s``.  ``loss_mult=0, loss_add=-1``
    heals on every probe.
    """

    check_every: int = 16
    loss_mult: float = 1.35
    loss_add: float = 0.2
    recalibrate: bool = True
    reprogram: bool = True
    bands_per_step: int = 1
    max_retries: int = 3
    backoff_s: float = 0.01

    def __post_init__(self):
        if self.check_every < 1:
            raise ValueError(
                f"HealPolicy.check_every must be >= 1, got {self.check_every}")
        if self.bands_per_step < 1:
            raise ValueError(
                f"HealPolicy.bands_per_step must be >= 1, got "
                f"{self.bands_per_step}")


class PackManager:
    """Owns one served pack's device state over its life.

    Built like ``program_lm`` + ``calibrate_lm`` (and equal to them at
    construction); :meth:`aged` derives the pack at any absolute age,
    :meth:`reprogram_band` rewrites one band from the cached integer codes
    under a new epoch seed (resetting its drift clock), and
    :meth:`recalibrate` re-fits ADC ranges and activation clips.  Tensors
    live on the parameters' device.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        spec: Union[AnalogSpec, Profile],
        seed: int,
        *,
        calib_tokens,
        include_head: bool = True,
        age_seed: Optional[int] = None,
    ):
        profile = as_profile(spec)
        for selector, sp in profile.selectors():
            if float(sp.drift.t) != 1.0 or float(sp.fault.t) != 1.0:
                raise ValueError(
                    f"PackManager owns the aging clock: spec of selector "
                    f"{selector!r} must be at the fresh age (drift.t == "
                    f"fault.t == 1.0), got drift.t={sp.drift.t} "
                    f"fault.t={sp.fault.t}")
        self.cfg, self.params, self.profile = cfg, params, profile
        self.seed = int(seed)
        self.age_seed = (fold_seed(self.seed, _AGE_KEY_FOLD)
                         if age_seed is None else int(age_seed))
        if not isinstance(calib_tokens, torch.Tensor):
            calib_tokens = torch.tensor(calib_tokens)      # numpy, a copy
        self.calib_tokens = calib_tokens.to(params["embed"].device)
        self.codes = lm_program_codes(cfg, params, profile,
                                      include_head=include_head)
        pack = program_lm_from_codes(cfg, self.codes, profile, self.seed)
        pack = calibrate_lm(cfg, params, pack, self.calib_tokens)
        self._fresh = pack
        self._base = pack                      # current-epoch conductances
        n_bands = len(pack.bands)
        self._epoch: List[int] = [0] * n_bands
        self._t_prog: List[float] = [1.0] * n_bands
        self._head_epoch, self._head_t = 0, 1.0
        self.ref_loss = self.probe_loss(pack)

    # -- health -----------------------------------------------------------

    def probe_loss(self, pack: AnalogPack) -> float:
        """Teacher-forced loss on the calibration batch: the health
        probe."""
        return float(self._probe(pack))

    def _probe(self, pack: AnalogPack) -> torch.Tensor:
        """The probe's device half (the reference's jitted ``_probe_fn``):
        the loss as a tensor, read by :meth:`probe_loss`."""
        x = self.calib_tokens[:, :-1]
        y = self.calib_tokens[:, 1:]
        return analog_eval_metrics(self.cfg, self.params, pack, x, y)["loss"]

    @property
    def fresh_pack(self) -> AnalogPack:
        """The as-built pack (epoch-0 conductances, fresh calibration)."""
        return self._fresh

    @property
    def band_epochs(self) -> List[int]:
        return list(self._epoch)

    # -- aging ------------------------------------------------------------

    def aged(self, t: float) -> AnalogPack:
        """The served pack at absolute age ``t``: drift relative to each
        band's reprogram age, faults at absolute ``t`` on the current
        epoch's conductances."""
        bands = self._base.bands
        td = [max(float(t) / tp, 1.0) for tp in self._t_prog]
        tf = [float(t)] * len(bands)
        pack = age_pack(self._base, t, self.age_seed,
                        t_drift_by_band=td, t_fault_by_band=tf)
        return self._age_head(pack, t)

    def _age_head(self, pack: AnalogPack, t: float) -> AnalogPack:
        # age_pack aged the head at the uniform t; redo it relative to the
        # head's own reprogram age once it has been reprogrammed
        if (pack.head is None or not pack.head_spec.aging_on
                or self._head_t == 1.0):
            return pack
        t_rel = max(float(t) / self._head_t, 1.0)
        head = _age_weights(self._base.head, pack.head_spec, t_rel, t,
                            hook_key(self.age_seed, HEAD))
        return dataclasses.replace(pack, head=head)

    # -- reprogramming ----------------------------------------------------

    def epoch_seed(self, epoch: int) -> int:
        """Programming seed of reprogram generation ``epoch`` (0 = the
        original build seed, exactly)."""
        if epoch == 0:
            return self.seed
        return fold_seed(fold_seed(self.seed, _REPROGRAM_FOLD), epoch)

    def program_band(self, b: int, seed: int) -> Dict[str, AnalogWeights]:
        """Freshly program band ``b``'s layers for every analog site, stacked
        over the band's layers: the same rows as a full
        ``program_lm_from_codes`` with ``seed`` (the same ``fold_seed(
        hook_key(seed, name), absolute layer)`` schedule)."""
        lo, hi = self._base.bands[b]
        out: Dict[str, AnalogWeights] = {}
        for name in self._base.layer_weights:
            sp = self._base.band_specs[b].get(name)
            spec_b = sp if sp is not None else self._base.site_spec(name)
            site_seed = hook_key(seed, name)
            out[name] = _stack_layers(
                (program_from_codes(_layer_codes(self.codes[name], i), spec_b,
                                    fold_seed(site_seed, i))
                 for i in range(lo, hi)), hi - lo)
        return out

    def reprogram_band(self, b: int, *, t_now: float) -> None:
        """Rewrite band ``b`` under the next epoch seed and reset its drift
        clock to ``t_now``.  The band's rows are written into the current
        stacks in place (copied once from the fresh pack's, which stay as
        built), so a pack :meth:`aged` returned earlier sees the rewrite
        at the sites that do not age (it shares their stacks).  Callers
        wanting retry/backoff wrap this in
        ``repro_torch.runtime.fault.resilient_step`` (the runtime does)."""
        e = self._epoch[b] + 1
        weights = self.program_band(b, self.epoch_seed(e))
        lo, hi = self._base.bands[b]
        if self._base.layer_weights is self._fresh.layer_weights:
            self._base = dataclasses.replace(
                self._base, layer_weights={
                    name: _clone_lines(aw)
                    for name, aw in self._base.layer_weights.items()})
        for name, aw in self._base.layer_weights.items():
            part = weights[name]
            for field in ("g_pos", "g_neg", "g_unit", "w_scale"):
                full = getattr(aw, field)
                if full is not None:
                    full[lo:hi] = getattr(part, field)
        self._epoch[b] = e
        self._t_prog[b] = float(t_now)

    def reprogram_head(self, *, t_now: float) -> None:
        """Rewrite the head projection under its next epoch seed."""
        if self._base.head is None:
            raise ValueError("this pack has no analog head to reprogram")
        e = self._head_epoch + 1
        head = program_from_codes(
            self.codes[HEAD], self._base.head_spec,
            hook_key(self.epoch_seed(e), HEAD))
        self._base = dataclasses.replace(self._base, head=head)
        self._head_epoch = e
        self._head_t = float(t_now)

    def heal_targets(self) -> List[Any]:
        """The reprogram queue of one heal event: every band with at least
        one aging site, then the head if it ages."""
        targets: List[Any] = []
        for b, ss in enumerate(self._base.band_specs):
            if any(sp.aging_on for _, sp in ss.items):
                targets.append(b)
        if (self._base.head is not None
                and self._base.head_spec.aging_on):
            targets.append(HEAD_BAND)
        return targets

    # -- recalibration ----------------------------------------------------

    def recalibrate(self, pack: AnalogPack) -> AnalogPack:
        """Re-fit activation clips and ADC ranges to the aged device state
        (the same two collect passes as the original calibration)."""
        return calibrate_lm(self.cfg, self.params, pack, self.calib_tokens)


def _clone_lines(aw: AnalogWeights) -> AnalogWeights:
    """``aw`` with its own copy of every stacked tensor."""
    return dataclasses.replace(
        aw, g_pos=aw.g_pos.clone(),
        g_neg=None if aw.g_neg is None else aw.g_neg.clone(),
        g_unit=None if aw.g_unit is None else aw.g_unit.clone(),
        w_scale=aw.w_scale.clone())
