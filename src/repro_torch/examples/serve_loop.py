"""Serve a stream of mixed-length requests through the continuous-batching
analog runtime: train a tiny LM, program + calibrate it onto the analog
substrate (Design A + state-proportional errors), then drain a request
trace with top-k sampling — watching completions stream out as slots
free up and refill (port of ``examples/serve_loop.py``).

Run: PYTHONPATH=src python -m repro_torch.examples.serve_loop [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import analog as A
from repro_torch.core import errors as E
from repro_torch.examples import parser, train_smoke_lm
from repro_torch.serve import (SamplerConfig, ServeRuntime, calibrate_lm,
                               program_lm)

PROGRAM_SEED = 7
N_REQUESTS = 10


def train(device):
    """The smoke qwen1.5-4b trained 120 steps: (cfg, dataset, params,
    final loss)."""
    return train_smoke_lm("qwen1.5-4b", 32, 120, device=device)


def program(cfg, params, ds):
    """One analog design point, programmed with seed 7 and calibrated on
    the batch of step 499; the running server is then a valid sweep
    point (alpha / r_hat ride in the pack's spec)."""
    spec = A.design_a(error=E.state_proportional(0.05))
    pack = program_lm(cfg, params, spec, PROGRAM_SEED)
    return calibrate_lm(cfg, params, pack, ds.batch(499)["tokens"])


def trace(vocab: int, seed: int = 0):
    """The mixed trace: [(uid, prompt, generation budget)], variable
    prompt lengths and budgets from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_REQUESTS):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, 15)))
        out.append((i, prompt, int(rng.integers(4, 17))))
    return out


def runtime(cfg, params, pack) -> ServeRuntime:
    return ServeRuntime(
        cfg, params, pack=pack, max_slots=4, max_len=48, buckets=(8, 16),
        sampler=SamplerConfig(kind="top_k", top_k=8, temperature=0.9),
        seed=0)


def serve(rt: ServeRuntime, requests, *, log=print):
    """Submit ``requests`` and step ``rt`` until it is idle; the
    completions in the order they finished."""
    for uid, prompt, budget in requests:
        rt.submit(prompt, max_new_tokens=budget, uid=uid)
    done = []
    while not rt.idle:
        for c in rt.step():
            done.append(c)
            log(f"  request {c.uid}: prompt[{c.prompt_len}] -> "
                f"{c.tokens.tolist()}  (ttft {1e3 * c.ttft_s:.0f} ms)")
    return done


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    cfg, ds, params, loss = train(args.device)
    print(f"trained tiny qwen-style LM to loss {loss:.3f}")

    rt = runtime(cfg, params, program(cfg, params, ds))
    print(f"\nserving {N_REQUESTS} requests on {rt.max_slots} slots "
          f"(continuous batching, top-k sampling):")
    done = serve(rt, trace(cfg.vocab))

    s = rt.stats
    print(f"\n{s['tokens_out']} tokens in {s['decode_steps']} decode steps "
          f"+ {s['prefill_calls']} prefill calls; "
          f"slot occupancy {s['occupancy']:.0%}, "
          f"mean ttft {1e3 * np.mean(s['ttft_s']):.0f} ms")
    return {"completions": done, "stats": s}


if __name__ == "__main__":
    main()
