"""Cell programming-error models (paper Sec. 5.1, Fig. 7; Sec. 9.1,
Fig. 20); counterpart of ``repro.core.errors``.

Zero-mean Gaussian perturbations of normalized conductances, drawn once
per programmed chip from an explicit ``torch.Generator``.  It cannot
replay ``jax.random``, so the port is held to the reference by the
statistics of these draws, and downstream stages by loading the
reference's programmed conductances (``repro_torch.interop``).

Device state is also time-dependent: :class:`DriftModel` decays programmed
conductances by the retention power law and :class:`FaultModel` pins
stuck-at cells arriving as a Poisson process.  Both are off by default,
seeded like programming errors, and exactly the identity at the fresh age
``t = 1``.  A seed replays on one device only: CPU and CUDA generators
draw different streams, so only the statistics of the draws cross devices
(and cross to ``jax.random``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch

SONOS_SAT = 0.05 / 1.6
SONOS_KNEE = SONOS_SAT / 0.06
#: the SONOS cell's on/off ratio (the reference's ``SONOS_ON_OFF``)
SONOS_ON_OFF = 1.0e4


def fold_seed(seed: int, data) -> int:
    """Derive an independent 63-bit seed from ``seed`` and ``data`` (the
    port's counterpart of ``jax.random.fold_in``: a stable hash, so a
    stream never depends on how many other streams were drawn)."""
    blob = f"{int(seed)}/{data}".encode()
    h = hashlib.blake2s(blob, digest_size=8).digest()
    return int.from_bytes(h, "big") & 0x7FFFFFFFFFFFFFFF


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``.

    The meta device has no generator of its own: there it is a CPU one,
    which ``torch.randn(..., device="meta")`` accepts and never draws
    from, so ``init_params``, ``init_cache`` and ``make_train_state`` build
    shape-only trees on ``device="meta"`` (the port's ``jax.eval_shape``).
    """
    if torch.device(device).type == "meta":
        return torch.Generator().manual_seed(int(seed))
    return torch.Generator(device=device).manual_seed(int(seed))


@dataclasses.dataclass(frozen=True)
class ErrorModel:
    """Parameterized cell-error model; ``kind = 'none'`` disables it.
    ``clip_at_zero`` rectifies negative conductances (off by default, the
    paper's symmetric model)."""

    kind: str = "none"          # none | state_independent | state_proportional | sonos
    alpha: float = 0.0
    clip_at_zero: bool = False

    def __post_init__(self):
        kinds = ("none", "state_independent", "state_proportional", "sonos")
        if self.kind not in kinds:
            raise ValueError(
                f"ErrorModel.kind must be one of {kinds}, got {self.kind!r}")

    def sigma(self, g: torch.Tensor) -> torch.Tensor:
        """Std-dev of the programming error at conductance ``g``."""
        if self.kind == "none":
            return torch.zeros_like(g)
        if self.kind == "state_independent":
            return torch.full_like(g, self.alpha)
        if self.kind == "state_proportional":
            return self.alpha * g
        return SONOS_SAT * (1.0 - torch.exp(-g / SONOS_KNEE))

    def perturb(self, g: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Sample programmed conductances around their targets."""
        if self.kind == "none" or generator is None:
            return g
        noise = torch.randn(g.shape, generator=generator, dtype=g.dtype,
                            device=g.device)
        out = g + self.sigma(g) * noise
        if self.clip_at_zero:
            out = torch.clamp(out, min=0.0)
        return out


@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Time-dependent conductance decay; ``kind = 'none'`` disables it.

    ``power_law``: ``g(t) = g0 * t^-nu_cell`` with the per-cell exponent
    ``nu_cell = nu * exp(sigma_nu * z)``, ``z ~ N(0, 1)``, drawn once per
    device from the seed (lognormal around the median ``nu``, so
    conductance only decays).  ``t`` is the age in units of the
    programming-reference time (``t = 1`` is fresh), where the factor is
    exactly ``1.0 ** -nu_cell == 1.0``.
    """

    kind: str = "none"          # none | power_law
    nu: float = 0.0             # median drift exponent
    sigma_nu: float = 0.0       # lognormal spread of the per-cell exponent
    t: float = 1.0              # evaluation age in t0 units (1.0 = fresh)

    def __post_init__(self):
        kinds = ("none", "power_law")
        if self.kind not in kinds:
            raise ValueError(
                f"DriftModel.kind must be one of {kinds}, got {self.kind!r}")

    def exponents(self, shape, generator: torch.Generator,
                  dtype=torch.float32) -> torch.Tensor:
        """Per-cell drift exponents (a fixed device property per seed),
        on the generator's device."""
        z = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return z.mul_(self.sigma_nu).exp_().mul_(self.nu)   # one buffer

    def factor(self, shape, t, generator: torch.Generator,
               dtype=torch.float32) -> torch.Tensor:
        """Per-cell decay factor ``t^-nu_cell``, the age clamped to >= 1
        (a retention model, not one of the programming transient)."""
        tc = torch.clamp(torch.as_tensor(t, dtype=dtype,
                                         device=generator.device), min=1.0)
        return torch.pow(tc, self.exponents(shape, generator, dtype).neg_())

    def apply(self, g: torch.Tensor, t,
              seed: Optional[int]) -> torch.Tensor:
        """Decay programmed conductances from age 1 to age ``t``."""
        if self.kind == "none" or seed is None:
            return g
        return self.factor(g.shape, t, generator(seed, g.device),
                           g.dtype).mul_(g)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Stuck-at cell faults arriving as a seeded Poisson process.

    A cell fails at ``rate`` per unit of age, so by age ``t`` it is stuck
    with probability ``1 - exp(-rate * (t - 1))``; a stuck cell reads
    ``g_hi`` with probability ``p_hi``, else ``g_lo``.  The arrival
    threshold and the high/low choice are drawn once per cell from two
    streams of the seed, whatever ``t``: the same seed and age give the
    same mask, and the stuck set at ``t1`` is a subset of the stuck set at
    any ``t2 > t1``.
    """

    kind: str = "none"          # none | stuck
    rate: float = 0.0           # expected failures per cell per t0 of age
    p_hi: float = 0.5           # fraction of stuck cells stuck at G_max
    t: float = 1.0              # evaluation age in t0 units (1.0 = fresh)

    def __post_init__(self):
        kinds = ("none", "stuck")
        if self.kind not in kinds:
            raise ValueError(
                f"FaultModel.kind must be one of {kinds}, got {self.kind!r}")
        if not 0.0 <= self.p_hi <= 1.0:
            raise ValueError(
                f"FaultModel.p_hi must sit in [0, 1], got {self.p_hi}")

    def stuck_prob(self, t, dtype=torch.float32,
                   device="cpu") -> torch.Tensor:
        """P(cell has failed by age ``t``) under Poisson arrivals."""
        dt = torch.clamp(torch.as_tensor(t, dtype=dtype, device=device),
                         min=1.0) - 1.0
        return -torch.expm1(-self.rate * dt)

    def apply(self, g: torch.Tensor, t, seed: Optional[int], *,
              g_lo=0.0, g_hi=1.0) -> torch.Tensor:
        """Pin failed cells to ``g_lo``/``g_hi`` (normalized G_min/G_max)."""
        if self.kind == "none" or seed is None:
            return g
        u = torch.rand(g.shape, generator=generator(fold_seed(seed, 0),
                                                    g.device),
                       dtype=g.dtype, device=g.device)
        stuck = u < self.stuck_prob(t, g.dtype, g.device)
        hi = torch.rand(g.shape, generator=generator(fold_seed(seed, 1),
                                                     g.device),
                        dtype=g.dtype, device=g.device) < self.p_hi
        like = dict(dtype=g.dtype, device=g.device)
        val = torch.where(hi, torch.as_tensor(g_hi, **like),
                          torch.as_tensor(g_lo, **like))
        return torch.where(stuck, val, g)


def state_independent(alpha: float) -> ErrorModel:
    return ErrorModel(kind="state_independent", alpha=alpha)


def state_proportional(alpha: float) -> ErrorModel:
    return ErrorModel(kind="state_proportional", alpha=alpha)


def sonos() -> ErrorModel:
    return ErrorModel(kind="sonos")


def none() -> ErrorModel:
    return ErrorModel(kind="none")


def power_law_drift(nu: float, sigma_nu: float = 0.0,
                    t: float = 1.0) -> DriftModel:
    return DriftModel(kind="power_law", nu=nu, sigma_nu=sigma_nu, t=t)


def stuck_faults(rate: float, p_hi: float = 0.5,
                 t: float = 1.0) -> FaultModel:
    return FaultModel(kind="stuck", rate=rate, p_hi=p_hi, t=t)
