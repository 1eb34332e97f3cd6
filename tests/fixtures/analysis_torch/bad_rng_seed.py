"""Known-bad: literal seeds in library code."""
import numpy as np
import torch

from repro_torch.core import errors as E


def draw(shape):
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1234)
    rng = np.random.default_rng(7)
    g2 = E.generator(3, "cpu")
    return torch.randn(shape, generator=gen), rng, g2
