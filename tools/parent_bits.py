#!/usr/bin/env python3
"""Hold the port's plain-tensor outputs of two checkouts to the bit, on the
CPU.

    PYTHONPATH=src python3 tools/parent_bits.py --tree build/parent

after ``git archive <parent> | tar -x -C build/parent``.  Each checkout
runs in its own process (``kernel_tree.use_tree``) and writes, for the
smoke configs, rwkv6-3b's, zamba2-7b's, whisper-large-v3's,
arctic-480b's and qwen3-moe-235b-a22b's prefill logits over 4 x 16
tokens, three greedy decode steps' logits and the forward's logits, and
arctic-480b's, qwen3-moe-235b-a22b's and rwkv6-3b's loss and gradients
of one batch and the state and loss after a train step of 2
microbatches.  The tool
prints how many tensors differ in value and in bits (every float
compared as its integer bit pattern) and exits non-zero if any does.
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def dump(path: str) -> None:
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_model
    from repro_torch.pytree import flatten_with_path
    from repro_torch.train import step as TS

    out = {}
    g = torch.Generator().manual_seed(1)
    for arch in ("rwkv6-3b", "zamba2-7b", "whisper-large-v3",
                 "arctic-480b", "qwen3-moe-235b-a22b"):
        cfg = get_smoke_config(arch)
        api = get_model(cfg)
        params = api.init_params(cfg, 0, device="cpu")
        toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
        kw = {}
        if cfg.frontend:
            kw["prefix_embeds"] = torch.randn(
                (4, cfg.n_frontend_tokens, cfg.d_model), generator=g)
        logits, cache = api.prefill(cfg, params, toks, 24, **kw)
        out[f"{arch}/prefill"] = logits
        t = logits[:, -1].argmax(-1)[:, None]
        for i in range(3):
            logits, cache = api.decode_step(cfg, params, t, cache)
            out[f"{arch}/decode{i}"] = logits
            t = logits[:, -1].argmax(-1)[:, None]
        out[f"{arch}/forward"] = api.forward(cfg, params, toks, **kw)[0]
    for arch in ("arctic-480b", "qwen3-moe-235b-a22b", "rwkv6-3b"):
        cfg = get_smoke_config(arch)
        batch = SyntheticLM(cfg, 32, 8, seed=0, device="cpu").batch(0)
        state = TS.make_train_state(cfg, 0, device="cpu")
        loss, _, grads = TS.loss_and_grads(cfg, state.params, batch)
        out[f"{arch}/loss"] = loss
        out.update({f"{arch}/grad/{n}": x
                    for n, x in flatten_with_path(grads)})
        new, metrics = TS.train_step_fn(cfg, microbatches=2)(state, batch)
        out[f"{arch}/step_loss"] = metrics["loss"]
        out.update({f"{arch}/state/{n}": x
                    for n, x in flatten_with_path(new)})
    with open(path, "wb") as fh:
        pickle.dump({k: v.detach().clone() for k, v in out.items()}, fh)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        import kernel_tree as kt

        kt.use_tree(args.tree)
        dump(args.dump)
        return 0

    import torch

    with tempfile.TemporaryDirectory(dir=HERE / "build" if (
            HERE / "build").is_dir() else None) as tmp:
        paths = []
        for tree in (args.tree, HERE):
            path = os.path.join(tmp, f"{len(paths)}.pkl")
            subprocess.run([sys.executable, __file__, "--tree",
                            str(Path(tree).resolve()),
                            "--dump", path], check=True,
                           cwd=HERE / "tools")
            paths.append(path)
        parent, change = (pickle.load(open(p, "rb")) for p in paths)

    def bits(t):
        t = t.contiguous()
        if t.is_floating_point():
            return t.view({8: torch.int64, 4: torch.int32,
                           2: torch.int16}[t.element_size()])
        return t

    if parent.keys() != change.keys():
        print("the two checkouts wrote different tensors")
        return 1
    value = [k for k in parent if not torch.equal(parent[k], change[k])]
    bitwise = [k for k in parent
               if not torch.equal(bits(parent[k]), bits(change[k]))]
    print(f"{len(parent)} tensors: {len(value)} differ in value, "
          f"{len(bitwise)} in bits {bitwise[:10]}")
    return 1 if bitwise else 0


if __name__ == "__main__":
    sys.exit(main())
