"""Known-good: every draw names its generator."""
import torch

from repro_torch.core.errors import generator


def perturb(g, alpha, seed):
    gen = generator(seed, g.device)
    noise = torch.randn(g.shape, generator=gen)
    mask = torch.rand(g.shape, generator=gen) < 0.5
    g.normal_(0.0, alpha, generator=gen)
    return g + noise * mask
