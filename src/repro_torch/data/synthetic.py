"""Deterministic synthetic data pipeline (counterpart of
``repro.data.synthetic``).

Every batch is a pure function of ``(seed, step)``: restart at step *k*
replays exactly the batches a failed run would have seen, with no
iterator state beyond the step index.  The draws come from a CPU
``torch.Generator`` seeded with ``core.errors.fold_seed(seed, step)`` and
the batch is then moved to ``device``, so a dataset asked for the card
gives the same bits as one on the CPU.  The streams cannot equal
``jax.random``'s; they are held to the reference by their statistics.

Two token streams:

* ``lm``: an affine-congruential token process, ``(start + mult * i) %
  vocab`` with ``mult`` in ``31 + 2 * {0..7}``, a ``noise`` fraction of
  positions replaced by uniform tokens — enough structure that a few
  hundred training steps measurably reduce loss;
* ``uniform``: i.i.d. tokens (throughput benchmarking).

Frontend families also get ``prefix_embeds``, ``0.02 * N(0, 1)`` of
shape ``(B, n_frontend_tokens, d_model)``, from a generator of its own
(``fold_seed(step seed, 7)``, as the reference folds 7 into its key).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core.errors import fold_seed


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "lm"            # "lm" | "uniform"
    noise: float = 0.1
    device: str = "cuda"

    def batch(self, step) -> Dict[str, torch.Tensor]:
        """Global batch for ``step`` (host-shardable by row)."""
        key = fold_seed(self.seed, int(step))
        gen = torch.Generator().manual_seed(key)
        b, s, v = self.global_batch, self.seq_len, self.cfg.vocab
        if self.mode == "uniform":
            tokens = torch.randint(0, v, (b, s), generator=gen)
        else:
            start = torch.randint(0, v, (b, 1), generator=gen)
            mult = 31 + 2 * torch.randint(0, 8, (b, 1), generator=gen)
            tokens = (start + mult * torch.arange(s)[None, :]) % v
            noise_mask = torch.rand((b, s), generator=gen) < self.noise
            rand = torch.randint(0, v, (b, s), generator=gen)
            tokens = torch.where(noise_mask, rand, tokens)
        tokens = tokens.to(torch.int32)
        out = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
        if self.cfg.frontend:
            gp = torch.Generator().manual_seed(fold_seed(key, 7))
            out["prefix_embeds"] = 0.02 * torch.randn(
                (b, self.cfg.n_frontend_tokens, self.cfg.d_model),
                generator=gp, dtype=torch.float32)
        return {k: t.to(self.device) for k, t in out.items()}

    def state(self, step: int) -> dict:
        """Checkpointable pipeline state — the step index is everything."""
        return {"seed": self.seed, "step": int(step), "mode": self.mode}


def for_shape(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
              mode: str = "lm", *, device: str = "cuda") -> SyntheticLM:
    return SyntheticLM(cfg=cfg, seq_len=shape.seq_len,
                       global_batch=shape.global_batch, seed=seed, mode=mode,
                       device=device)
