"""Known-good: divisions the rule leaves alone."""
import torch

from repro_torch.core.quant import div_as_compiled, true_div


def fine(x: torch.Tensor, scale, n: int, cfg):
    a = x / 2.0
    b = x / 0.25
    c = x / float(1 << 24)
    d = true_div(x, 3.0)
    e = div_as_compiled(x, n)
    f = x / torch.full((), 3.0)
    g = x / scale
    h = x / cfg.d_model
    i = n / 3
    j = torch.div(x, n, rounding_mode="floor")
    return a, b, c, d, e, f, g, h, i, j
