"""Cell programming-error models (paper Sec. 5.1, Fig. 7; Sec. 9.1,
Fig. 20); counterpart of ``repro.core.errors``.

Zero-mean Gaussian perturbations of normalized conductances, drawn once
per programmed chip from an explicit ``torch.Generator``.  It cannot
replay ``jax.random``, so the port is held to the reference by the
statistics of these draws, and downstream stages by loading the
reference's programmed conductances (``repro_torch.interop``).  Drift and
stuck-cell faults are a later slice: :class:`DriftModel` and
:class:`FaultModel` keep the spec's fields but accept only ``"none"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch

SONOS_SAT = 0.05 / 1.6
SONOS_KNEE = SONOS_SAT / 0.06

_AGING_ITEM = "ROADMAP queue A item 8 (drift and healing)"


def fold_seed(seed: int, data) -> int:
    """Derive an independent 63-bit seed from ``seed`` and ``data`` (the
    port's counterpart of ``jax.random.fold_in``: a stable hash, so a
    stream never depends on how many other streams were drawn)."""
    blob = f"{int(seed)}/{data}".encode()
    h = hashlib.blake2s(blob, digest_size=8).digest()
    return int.from_bytes(h, "big") & 0x7FFFFFFFFFFFFFFF


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
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


def _only_none(model: str, kind: str, kinds) -> None:
    if kind not in kinds:
        raise ValueError(f"{model}.kind must be one of {kinds}, got {kind!r}")
    if kind != "none":
        raise NotImplementedError(
            f"{model}(kind={kind!r}) is not ported yet; see {_AGING_ITEM}")


@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Retention drift; only ``kind="none"`` is ported so far."""

    kind: str = "none"          # none | power_law
    nu: float = 0.0
    sigma_nu: float = 0.0
    t: float = 1.0

    def __post_init__(self):
        _only_none("DriftModel", self.kind, ("none", "power_law"))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Stuck-at cell faults; only ``kind="none"`` is ported so far."""

    kind: str = "none"          # none | stuck
    rate: float = 0.0
    p_hi: float = 0.5
    t: float = 1.0

    def __post_init__(self):
        _only_none("FaultModel", self.kind, ("none", "stuck"))


def state_independent(alpha: float) -> ErrorModel:
    return ErrorModel(kind="state_independent", alpha=alpha)


def state_proportional(alpha: float) -> ErrorModel:
    return ErrorModel(kind="state_proportional", alpha=alpha)


def sonos() -> ErrorModel:
    return ErrorModel(kind="sonos")


def none() -> ErrorModel:
    return ErrorModel(kind="none")
