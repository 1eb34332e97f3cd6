"""Multi-process gloo jobs of the port's sharded path on the CPU.

A job is one ``python -c`` process per rank, importing only the port, in
a ``gloo`` group over a ``file://`` store (``init_process_group(timeout=
STORE_TIMEOUT_S)``), under its own wall limit after which every rank is
killed, so a mismatched collective fails the job instead of hanging its
caller.  Rank 0 prints one ``RESULT`` line of JSON (:func:`result`).
:class:`Runner` starts jobs on threads, at most ``max_ranks`` processes
at once.

:func:`arch_body` is the job that holds one arch's sharded steps
(``launch.steps.build_step``: train, prefill, decode) against the
unsharded path; :func:`arch_departures` lists what of its result lies
outside :data:`REL` and :data:`PARAM_ATOL`.  Both
``tests/test_torch_distribution.py`` and ``chip_smoke.py``'s phase DR4v
(on the card's machine, whose torch plans DTensor ops otherwise) run it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

#: the ``src`` directory the ranks import the port from
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STORE_TIMEOUT_S = 60       # init_process_group(timeout=...)
REL = 1e-5                 # logits, loss and grad norm, relative
PARAM_ATOL = 5e-3          # the reference's bound on parameters

PRELUDE = f"""
import json, os, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WS = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", init_method="file://" + os.environ["INIT_FILE"], rank=RANK,
    world_size=WS, timeout=timedelta(seconds={STORE_TIMEOUT_S}))


MESH_DIMS = (2, 2)   # the models' ("data", "model") mesh, unless a job says
ROWS = 8             # the rows of every batch, unless a job says


def report(**kw):
    if RANK == 0:
        print("RESULT " + json.dumps(kw), flush=True)
"""

EPILOGUE = """
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
if bad:
    raise SystemExit(f"the port loaded {bad[:4]}")
dist.barrier()
dist.destroy_process_group()
"""

MODEL_HELPERS = """
import copy
from torch.distributed.tensor import DTensor
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models.registry import get_model
from repro_torch.pytree import flatten_with_path
from repro_torch.sharding import rules
from repro_torch.train.step import make_train_state, train_step_fn

MESH = make_debug_mesh(*MESH_DIMS, "cpu")
B, S = ROWS, 32


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def rel(a, b):
    a, b = full(a).double(), full(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def tree_rel(got, want):
    w = dict(flatten_with_path(want))
    return max((rel(g, w[n]) for n, g in flatten_with_path(got)
                if w[n].dtype.is_floating_point), default=0.0)


def placed_as_rules(tree, specs):
    want = rules.spec_leaves(specs, tree)
    return all(tuple(x.placements) == rules.to_placements(want[n], MESH)
               for n, x in flatten_with_path(tree))


def inputs(cfg, b=B, s=S, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g)
    kw = {}
    if cfg.frontend:
        kw["prefix_embeds"] = torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=g)
    return toks, kw


def train_case(cfg, microbatches=2):
    shape = ShapeConfig("train", S, B, "train")
    batch = SyntheticLM(cfg, S, B, seed=0, device="cpu").batch(0)
    _, kw = inputs(cfg)
    batch.update(kw)
    step = train_step_fn(cfg, microbatches=microbatches)
    s1, m1 = step(make_train_state(cfg, 0, device="cpu"), batch)
    fn, _ = build_step(cfg, MESH, shape, microbatches=microbatches)
    s2, m2 = fn(make_train_state(cfg, 0, device="cpu"), batch)
    p1, p2 = dict(flatten_with_path(s1)), dict(flatten_with_path(s2))
    worst = max(float((full(p2[n]).double() - p1[n].double()).abs().max())
                for n in p1 if n.startswith("params/"))
    return {"loss_rel": rel(m2["loss"], m1["loss"]),
            "gnorm_rel": rel(m2["grad_norm"], m1["grad_norm"]),
            "lr_equal": float(full(m2["lr"])) == float(m1["lr"]),
            "param_worst": worst, "loss": float(m1["loss"])}


def prefill_case(cfg):
    api = get_model(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    toks, kw = inputs(cfg)
    l1, c1 = api.prefill(cfg, params, toks, S, **kw)
    fn, _ = build_step(cfg, MESH, ShapeConfig("prefill", S, B, "prefill"))
    l2, c2 = fn(params, {"tokens": toks, **kw})
    return {"logits_rel": rel(l2, l1), "cache_rel": tree_rel(c2, c1),
            "tokens_equal": bool(torch.equal(full(l2).argmax(-1),
                                             l1.argmax(-1)))}


def decode_case(cfg, n_steps=2):
    api = get_model(cfg)
    params = api.init_params(cfg, 0, device="cpu")
    toks, kw = inputs(cfg)
    _, c1 = api.prefill(cfg, params, toks[:, :S // 2], S, **kw)
    c2 = copy.deepcopy(c1)
    fn, _ = build_step(cfg, MESH, ShapeConfig("decode", S, B, "decode"))
    worst, cache_worst, same = 0.0, 0.0, True
    t1 = t2 = toks[:, S // 2:S // 2 + 1]
    for _ in range(n_steps):
        l1, c1 = api.decode_step(cfg, params, t1, c1)
        l2, c2 = fn(params, {"token": t2, "cache": c2})
        worst = max(worst, rel(l2, l1))
        cache_worst = max(cache_worst, tree_rel(c2, c1))
        t1 = l1[:, -1].argmax(-1)[:, None]
        t2 = full(l2)[:, -1].argmax(-1)[:, None]
        same &= bool(torch.equal(t1, t2))
    return {"logits_rel": worst, "cache_rel": cache_worst,
            "tokens_equal": same}
"""


def arch_body(arch: str, dims=(2, 2), rows=8, microbatches=2,
              **fields) -> str:
    """One arch's smoke config (with ``fields`` replaced) on a ``dims``
    mesh, ``rows`` rows a batch: train (in ``microbatches``), prefill and
    decode against the unsharded path."""
    return (f"MESH_DIMS = {dims!r}\nROWS = {rows!r}\n" + MODEL_HELPERS
            + textwrap.dedent(f"""
        import dataclasses
        cfg = dataclasses.replace(get_smoke_config({arch!r}), **{fields!r})
        report(train=train_case(cfg, {microbatches!r}),
               prefill=prefill_case(cfg), decode=decode_case(cfg))
        """))


def arch_departures(r: dict) -> list:
    """What of an :func:`arch_body` job's result lies outside its bounds:
    train's loss and grad norm within :data:`REL` relative, every
    parameter within :data:`PARAM_ATOL`, the learning rate equal; prefill's
    and decode's logits and caches within :data:`REL`, greedy tokens
    equal.  Each entry is ``(kind, field, value)``."""
    t = r["train"]
    out = [("train", k, t[k]) for k in ("loss_rel", "gnorm_rel")
           if not t[k] <= REL]
    if not t["param_worst"] < PARAM_ATOL:
        out.append(("train", "param_worst", t["param_worst"]))
    if not t["lr_equal"]:
        out.append(("train", "lr_equal", t["lr_equal"]))
    for kind in ("prefill", "decode"):
        k = r[kind]
        out += [(kind, f, k[f]) for f in ("logits_rel", "cache_rel")
                if not k[f] <= REL]
        if not k["tokens_equal"]:
            out.append((kind, "tokens_equal", k["tokens_equal"]))
    return out


def result(stdout: str):
    """The JSON of the last ``RESULT`` line of ``stdout``."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    if not lines:
        raise AssertionError(f"no RESULT line in:\n{stdout[-2000:]}")
    return json.loads(lines[-1][len("RESULT "):])


class Job:
    """``body`` (between :data:`PRELUDE` and :data:`EPILOGUE`) run on
    ``ranks`` processes under a wall limit of ``wall_s`` seconds.  ``env``
    adds to the ranks' environment."""

    def __init__(self, name: str, body: str, ranks: int, wall_s: float,
                 env=None):
        self.name, self.body, self.ranks, self.wall_s = \
            name, body, ranks, wall_s
        self.env = dict(env or {})
        self.done = threading.Event()
        self.outs = None
        self.seconds = None
        self.procs = []
        self.stopped = False

    def run(self) -> None:
        code = PRELUDE + self.body + EPILOGUE
        tmp = tempfile.mkdtemp(prefix=f"gloo_{self.name}_")
        env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE=str(self.ranks),
                   INIT_FILE=os.path.join(tmp, "store"), OMP_NUM_THREADS="1",
                   **self.env)
        env.pop("XLA_FLAGS", None)
        t0 = time.perf_counter()
        procs = self.procs
        for r in range(self.ranks):
            if self.stopped:
                break
            log = [open(os.path.join(tmp, f"{r}.{s}"), "w+")
                   for s in ("out", "err")]
            procs.append((subprocess.Popen(
                [sys.executable, "-c", code], env=dict(env, RANK=str(r)),
                stdout=log[0], stderr=log[1], text=True), log))
        deadline = t0 + self.wall_s
        for p, _ in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 0.1))
            except subprocess.TimeoutExpired:
                break
        self.outs = []
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            texts = []
            for f in log:
                f.seek(0)
                texts.append(f.read())
                f.close()
            self.outs.append((p.returncode, *texts))
        self.seconds = time.perf_counter() - t0
        self.done.set()

    def stop(self) -> None:
        """Kill every rank still alive; a job not yet started starts
        none (its ranks then count as failed)."""
        self.stopped = True
        for p, _ in list(self.procs):
            if p.poll() is None:
                p.kill()

    def result(self):
        """Rank 0's result once every rank has exited; raises with the
        first failed rank's output."""
        self.done.wait()
        if len(self.outs) < self.ranks:
            raise AssertionError(f"job {self.name}: stopped")
        for rank, (rc, out, err) in enumerate(self.outs):
            if rc != 0:
                raise AssertionError(
                    f"job {self.name}: rank {rank} exited {rc} after "
                    f"{self.seconds:.1f} s (wall limit {self.wall_s} s)\n"
                    f"stdout tail:\n{out[-2000:]}\nstderr tail:\n"
                    f"{err[-4000:]}")
        print(f"job {self.name}: {self.ranks} ranks, {self.seconds:.1f} s")
        return result(self.outs[0][1])


class Runner:
    """Starts every job on a thread, in the order given, keeping at most
    ``max_ranks`` processes alive."""

    def __init__(self, jobs, max_ranks: int):
        self.jobs = {j.name: j for j in jobs}
        self._slots = threading.Semaphore(max_ranks)
        threading.Thread(target=self._start_all, daemon=True).start()

    def _start_all(self):
        for job in self.jobs.values():
            for _ in range(job.ranks):
                self._slots.acquire()
            if job.stopped:
                job.outs, job.seconds = [], 0.0
                job.done.set()
                continue
            threading.Thread(target=self._run, args=(job,),
                             daemon=True).start()

    def _run(self, job):
        try:
            job.run()
        finally:
            for _ in range(job.ranks):
                self._slots.release()

    def __getitem__(self, name):
        return self.jobs[name].result()

    def wait(self) -> None:
        """Until every job has ended (each ends by its wall limit)."""
        for job in self.jobs.values():
            job.done.wait()

    def stop(self) -> None:
        """Kill every job's live ranks and start no other; returns once
        every job has ended."""
        for job in self.jobs.values():
            job.stop()
        self.wait()
