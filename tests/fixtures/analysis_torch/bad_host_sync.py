"""Known-bad: host syncs reachable from hot roots."""
import numpy as np
import torch


class Runtime:
    def _run_decode(self, logits: torch.Tensor):  # repro: hot
        tok = torch.argmax(logits, dim=-1)
        n = int(tok.sum())
        return self._bookkeep(tok) + n

    def _bookkeep(self, tok):
        done = tok.cpu()
        torch.cuda.synchronize()
        return np.asarray(done).sum() + tok.max().item()


def step(x: torch.Tensor):  # repro: hot
    y = x * 2
    return float(y.mean()), y.tolist()


def cold(x: torch.Tensor):
    return x.item()
