"""Known-bad: draws from torch's global generator."""
import torch


def perturb(g, alpha):
    noise = torch.randn(g.shape)
    mask = torch.rand_like(g) < 0.5
    g.normal_(0.0, alpha)
    return g + noise * mask


def ok(g, gen):
    return g + torch.randn(g.shape, generator=gen)
