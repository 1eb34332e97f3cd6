"""Known-bad: tensors divided by Python numbers."""
import dataclasses

import torch


@dataclasses.dataclass
class Sampler:
    temperature: float = 1.0


def temper(logits: torch.Tensor, sampler: Sampler):
    return logits.to(torch.float32) / sampler.temperature


def freqs(x, theta):
    hd = x.shape[-1]
    half = hd // 2
    idx = torch.arange(hd)
    return theta ** (-(idx % half).to(torch.float32) / half)


def frac(topi: torch.Tensor, n: int):
    c = torch.bincount(topi).float()
    c /= 3
    return torch.div(c, n), c / 0.7
