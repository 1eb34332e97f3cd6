"""Sweep cells: design points through ``repro_torch.sweep.run_sweep`` over
one ``ServeEvaluator``, point after point until the window closes.

Set-up makes the weights and token batches from the seed, builds the
evaluator (its digital decode tokens) and runs one warm point, which
builds the programmed-codes cache and every kernel and shape the points
use.  The window then runs the grid's points in order, each as a
one-point sweep with ``trials`` trials, cycling the grid with new trial
seeds.  A point is started only if, as long as the last one took, it
ends inside the window, and counted only if it does.  Every point is
computed: the results cache lives under the run's temporary directory
and every call forces.  The greedy tokens each programmed model decodes
are kept (a wrapper on ``serve_eval.decode_lm``).

``correct``: a point drawn from the seed among those completed is worked
out again by the plain reference, trial by trial from the same weights,
tokens and trial seeds; each number the cell's limits name (the widest
difference of a metric over the trials, or the widest share of a
trial's tokens that differ) is compared with its limit."""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from harness import common, traffic
from harness import trace as tr

#: the metrics a point reports, each read as its widest difference from
#: the reference's over the point's trials; ``tokens_diff`` besides is the
#: widest share of a trial's greedy tokens that differ from the
#: reference's.  The cell's limits name the ones compared.
COMPARED = ("loss", "top1", "decode_match")


def _batches(mix, vocab: int, seed: int, device):
    """Calibration tokens, eval tokens and targets (shifted by one), and
    the decode prompts (the first eval rows' first tokens)."""
    gen = torch.Generator(device=device).manual_seed(common.fold(seed, "tokens"))
    c, e, p = mix["calibration"], mix["eval"], mix["prompts"]
    calib = torch.randint(0, vocab, (c["rows"], c["length"]), generator=gen,
                          device=device)
    tokens = torch.randint(0, vocab, (e["rows"], e["length"]), generator=gen,
                           device=device)
    targets = torch.roll(tokens, -1, dims=1)
    prompts = tokens[:p["rows"], :p["length"]].clone()
    return calib, tokens, targets, prompts


def _point_flops(mix, cfg, n_weights: int) -> int:
    """Model flops of one point: 2 per analog weight per token through
    the arrays (calibration's two collect passes, the eval pass, the
    decode's prefill and steps), and attention's."""
    c, e, p = mix["calibration"], mix["eval"], mix["prompts"]
    test_n = mix.get("test_n") or e["rows"]
    new = mix["decode_new"]
    attn = (lambda q, before=0: 0) if cfg.rwkv else (
        lambda q, before=0: _attn(cfg, q, before))
    calib = 2 * (2 * n_weights * c["rows"] * c["length"]
                 + c["rows"] * attn(c["length"]))
    ev = 2 * n_weights * test_n * e["length"] + test_n * attn(e["length"])
    dec = p["rows"] * (2 * n_weights * (p["length"] + new - 1)
                       + attn(p["length"])
                       + sum(attn(1, p["length"] + j) for j in range(new - 1)))
    return mix["trials"] * (calib + ev + dec)


def _attn(cfg, q: int, before: int) -> int:
    from harness import work

    return work.attention_flops(cfg.n_layers, cfg.n_heads, cfg.hd, q, before)


def run(cell: common.Cell, seed: int, seconds: float, do_trace: bool,
        device: torch.device, t_start: float, control: bool = False,
        warm: bool = True, lower_too: bool = False):
    """One run of a sweep cell: (result line without ``check``, the
    compared numbers, the record the metrics read).  ``warm=False`` skips
    the warm point (a process that has run the cell before);
    ``lower_too`` also reads the control on the compared point, into the
    record's ``control``."""
    from reference import lm as R
    from repro_torch import sweep as S
    from repro_torch.config import ModelConfig
    from repro_torch.kernels import ops
    from repro_torch.sweep import serve_eval

    log = common.Log(t_start)
    log("imported")
    mix = cell.traffic
    rcfg = R.config(cell.config["model"])
    pcfg = ModelConfig(**cell.config["model"])
    params = R.init_params(rcfg, common.fold(seed, "weights"), device)
    calib, tokens, targets, prompts = _batches(mix, rcfg.vocab, seed, device)
    log("weights and tokens made")
    points = traffic.grid(mix)
    trials, test_n = int(mix["trials"]), mix.get("test_n")
    ev = S.ServeEvaluator(pcfg, params, calib, tokens, targets,
                          prompts=prompts, decode_new=mix["decode_new"])
    log("evaluator built (signature, digital decode tokens)")
    pspecs = {tag: port_spec(d) for tag, d in points}
    cache_dir = os.path.join(tempfile.gettempdir(), "portbench-sweeps")

    spans = tr.Spans(do_trace)
    kwork = tr.KernelWork(ops) if do_trace else None
    dtrace = (tr.DeviceTrace(kwork) if do_trace and device.type == "cuda"
              else None)
    orig = {n: getattr(serve_eval, n) for n in
            ("calibrate_lm", "analog_eval_metrics", "decode_lm")}

    served: List[torch.Tensor] = []

    def run_point(tag: str, trial_seed: int) -> List[Dict[str, Any]]:
        """The point's trials' metrics, each with the greedy tokens that
        its programmed model decoded."""
        served.clear()
        one = S.SweepSpec.from_points(cell.name, [(tag, pspecs[tag])],
                                      trials=trials, seed=trial_seed,
                                      test_n=test_n)
        vals = S.run_sweep(one, ev, cache_dir=cache_dir,
                           force=True)[tag].values
        return [dict(v, tokens=t) for v, t in zip(vals, served)]

    try:
        if warm and not control:
            run_point(points[0][0], common.fold(seed, "warm"))
        if dtrace is not None:
            dtrace.prime()
        tr.sync()
        setup_s = time.perf_counter() - t_start
        log("warm point done: set-up ends")
        if do_trace:
            for name, span in (("calibrate_lm", "calibrate"),
                               ("analog_eval_metrics", "eval"),
                               ("decode_lm", "eval")):
                setattr(serve_eval, name, _spanned(spans, span, orig[name]))
        setattr(serve_eval, "decode_lm",
                _keeping(served, serve_eval.decode_lm))

        done: List[Tuple[str, int, List[Dict[str, Any]]]] = []
        started = 0
        t0 = time.perf_counter()
        t_last = t_point = 0.0
        for cycle in range(10 ** 6 if not control else 0):
            trial_seed = common.fold(seed, f"cycle{cycle}")
            for tag, _ in points:
                # a point is started only if it can end inside the window,
                # as long as the last one took
                if time.perf_counter() - t0 + t_point > seconds:
                    break
                started += 1
                spans.open_unit()
                traced = dtrace is not None and len(done) == 0
                if traced:
                    t0 += dtrace.start()
                t_begin = time.perf_counter() - t0
                vals = run_point(tag, trial_seed)
                if traced:
                    t0 += dtrace.stop()
                t_end = time.perf_counter() - t0
                t_point = t_end - t_begin
                if t_end <= seconds:
                    done.append((tag, trial_seed, vals))
                    t_last = t_end
            else:
                continue
            break
        tr.sync()
        log(f"window closed: {len(done)} of {started} points counted, the "
            f"last at {t_last:.3f} s")
        dev_info = common.device_info(device)
    finally:
        for name, fn in orig.items():
            setattr(serve_eval, name, fn)
        if kwork is not None:
            kwork.close()
    del ev
    gc.collect()
    if dtrace is not None:
        dtrace.read()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, lower = _check(R, rcfg, params, mix, points, done, seed, calib,
                            tokens, targets, prompts, control, lower_too)
    log(f"reference check done: {numbers}")
    result: Dict[str, Any] = {
        "attempted": started, "failed": 0, "device": dev_info}
    n_weights = R.analog_weight_count(rcfg, params)
    record = {
        "end_to_end": {
            "setup_s": setup_s,
            "point_s": t_last / len(done) if done else None,
        },
        "spans": spans.units,
        "trace": dtrace,
        "kernel_work": kwork,
        "points_done": len(done),
        "window_to_last_s": t_last,
        "point_flops": _point_flops(mix, rcfg, n_weights),
        "control": lower,
    }
    return result, numbers, record


def port_spec(desc: Dict[str, Any]):
    """The port's AnalogSpec of a traffic file's design object::

        {"preset": "design_a", "error": {"kind": ..., "alpha": ...},
         "fields": {"fused": "kernel", "adc.bits": 6, ...}}"""
    from repro_torch.core import analog, errors
    from repro_torch.sweep.spec import set_field

    err = desc.get("error")
    em = errors.ErrorModel() if err is None else errors.ErrorModel(**err)
    spec = getattr(analog, desc.get("preset", "design_a"))(error=em)
    for path, value in desc.get("fields", {}).items():
        spec = set_field(spec, path, value)
    return spec


def _keeping(out: list, decode):
    """``decode`` that also keeps the tokens of each programmed model (a
    call with a pack) in ``out``."""
    def call(*a, **kw):
        toks = decode(*a, **kw)
        if kw.get("pack") is not None:
            out.append(toks)
        return toks
    return call


def _spanned(spans, name, fn):
    def call(*a, **kw):
        with spans(name):
            return fn(*a, **kw)
    return call


def _check(R, rcfg, params, mix, points, done, seed, calib, tokens,
           targets, prompts, control: bool, lower_too: bool = False):
    """The widest difference, over the sampled point's trials, of each
    compared metric: the port's against the reference's, or, for the
    control, the reference under the lower precision against the
    reference.  With ``lower_too`` the control's differences on the same
    point come second (else None)."""
    rng = np.random.default_rng(common.fold(seed, "check"))
    n_check = int(mix["check"]["points"])
    test_n = mix.get("test_n") or tokens.shape[0]
    args = (calib, tokens[:test_n], targets[:test_n], prompts,
            mix["decode_new"])
    if control:
        # the grid's points as a run would draw them, first cycle's seeds
        pool = [(tag, common.fold(seed, "cycle0"), None) for tag, _ in points]
    else:
        pool = done
    if not pool:
        return {}, None
    picks = rng.choice(len(pool), size=min(n_check, len(pool)),
                       replace=False)
    descs = dict(points)
    digital = R.digital_tokens(rcfg, params, prompts, mix["decode_new"])
    worst = {f"{k}_diff": 0.0 for k in COMPARED + ("tokens",)}
    worst_lower = dict(worst) if lower_too else None

    def widest(into, got, want):
        for g, w in zip(got, want):
            for k in COMPARED:
                diff = abs(float(g[k]) - float(w[k]))
                into[f"{k}_diff"] = max(into[f"{k}_diff"],
                                        diff if diff == diff else float("inf"))
            share = float((g["tokens"].to(w["tokens"].device).long()
                           != w["tokens"].long()).float().mean())
            into["tokens_diff"] = max(into["tokens_diff"], share)

    for i in sorted(picks):
        tag, trial_seed, got = pool[int(i)]
        d = R.design(descs[tag])
        trials = int(mix["trials"])
        want = R.sweep_point(rcfg, params, d, trial_seed, trials, *args,
                             digital=digital)
        if control or lower_too:
            low = R.sweep_point(rcfg, params, d, trial_seed, trials, *args,
                                digital=digital, lower=True)
            got = low if control else got
            if lower_too:
                widest(worst_lower, low, want)
        widest(worst, got, want)
    return worst, worst_lower
