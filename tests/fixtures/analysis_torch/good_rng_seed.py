"""Known-good: seeds are parameters; a meta generator draws nothing."""
import numpy as np
import torch

from repro_torch.core import errors as E


def draw(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed + 1)
    meta = torch.Generator(device="meta").manual_seed(0)
    return torch.randn(shape, generator=gen), rng, E.generator(seed, "cpu"), meta
