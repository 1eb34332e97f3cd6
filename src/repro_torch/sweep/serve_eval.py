"""The LM serving evaluator: program → calibrate → serve, per design point
(counterpart of ``repro.sweep.serve_eval``).

The classifier vehicle (``evaluate.ClassifierEvaluator``) exercises the
analog pipeline on a small MLP; this module is the same executor protocol
at the paper's experiment scale — a full LM served through
``repro_torch.serve.analog_engine``.  Per (design point, trial):

1. **program**  — ``program_lm_from_codes`` converts and perturbs cached
   integer code stacks with the trial's seed.  The deterministic half
   (``lm_program_codes``: quantize + map every hook of the network) is
   cached per site mapping (:meth:`ServeEvaluator._codes_key`).
2. **calibrate** — the two collect passes of ``calibrate_lm`` (activation
   clips, then per-(layer, slice) ADC ranges).
3. **evaluate** — teacher-forced cross-entropy + top-1 next-token
   accuracy on held-out tokens, plus (optionally) ``decode_match``: the
   fraction of greedy KV-cached decode tokens agreeing with the digital
   model on a prompt batch.

:func:`serve_serial_reference` is the one-point-at-a-time loop the
evaluator is held against: it programs each trial with ``program_lm``
(no codes cache) on the same seeds and shares the rest.

Departures from the reference (see ``sweep.evaluate``): a compile group's
points and trials run in a Python loop (the reference ``vmap``s them in
one ``jit``); trial ``t`` hands ``trial_keys(seed, trials)[t]``, an
integer, to ``program_lm_from_codes``, whose per-hook seed schedule is the
port's; the signature reads ``serve/<model>/torch-v1/...``, so a shared
cache never mixes the two packages' results.  Everything runs on the
device of the parameters.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.analog import AnalogSpec
from repro_torch.hw.profile import HEAD, as_profile
from repro_torch.serve.analog_engine import (
    analog_eval_metrics,
    calibrate_lm,
    decode_lm,
    lm_hook_names,
    lm_program_codes,
    program_lm,
    program_lm_from_codes,
)
from repro_torch.sweep.dispatch import shard_point_trial_batch
from repro_torch.sweep.evaluate import (
    dynamic_fields_for,
    mapping_signature,
    materialize,
    on_device,
    tensor_bytes,
    trial_keys,
)


def _leaves(tree, path: str = ""):
    """``(keystr path, tensor)`` of a nested parameter dict."""
    for k, v in tree.items():
        p = f"{path}['{k}']"
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _hash_tree(h, tree) -> None:
    """Fold a nested dict of tensors into a hash, order-stable by path."""
    for path, leaf in sorted(_leaves(tree)):
        h.update(path.encode())
        h.update(tensor_bytes(leaf))


def _serve_point(cfg, params, pack, calib_tokens, tokens, targets,
                 prompts, decode_new, digital_toks) -> Dict[str, Any]:
    """calibrate → eval (→ decode_match) of one programmed pack, the
    metrics as tensors (the reference's jitted point function)."""
    pack = calibrate_lm(cfg, params, pack, calib_tokens)
    m = analog_eval_metrics(cfg, params, pack, tokens, targets)
    if prompts is not None:
        toks = decode_lm(cfg, params, prompts, decode_new, pack=pack)
        m["decode_match"] = (toks == digital_toks).float().mean()
    return m


def _serve_metrics(*args) -> Dict[str, float]:
    """:func:`_serve_point`'s metrics read to the host."""
    return {k: float(v) for k, v in sorted(_serve_point(*args).items())}


class ServeEvaluator:
    """End-to-end analog LM serving metrics for the executor.

    One instance owns an LM (``cfg`` + ``params``), a calibration token
    batch, and held-out eval tokens/targets, all on the parameters'
    device; the executor hands it compile groups and it returns
    per-(point, trial) metric dicts (``loss``, ``top1``, and
    ``decode_match`` when ``prompts`` given).

    ``test_n`` (from the sweep protocol) subsamples eval *rows* — the LM
    analogue of the classifier's test-subset trick.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        calib_tokens,
        eval_tokens,
        eval_targets,
        *,
        prompts=None,
        decode_new: int = 8,
        include_head: bool = True,
        version: str = "v1",
    ):
        dev = params["embed"].device
        self.cfg = cfg
        self.params = params
        self.calib_tokens = on_device(calib_tokens, dev)
        self.eval_tokens = on_device(eval_tokens, dev)
        self.eval_targets = on_device(eval_targets, dev)
        self.prompts = None if prompts is None else on_device(prompts, dev)
        self.decode_new = decode_new
        self.include_head = include_head

        h = hashlib.sha256()
        h.update(repr(cfg).encode())
        _hash_tree(h, params)
        for a in (self.calib_tokens, self.eval_tokens, self.eval_targets):
            h.update(tensor_bytes(a))
        if self.prompts is not None:
            h.update(tensor_bytes(self.prompts))
            h.update(str(decode_new).encode())
        h.update(str(include_head).encode())
        self._sig = f"serve/{cfg.name}/torch-{version}/{h.hexdigest()[:16]}"

        # digital greedy reference for decode_match, computed once
        self._digital_toks = None
        if self.prompts is not None:
            self._digital_toks = decode_lm(cfg, params, self.prompts,
                                           decode_new, pack=None)

        self._codes_cache: Dict[str, dict] = {}

    # -- executor protocol -------------------------------------------------
    def signature(self) -> str:
        return self._sig

    def dynamic_fields(self, spec: AnalogSpec) -> Dict[str, float]:
        return dynamic_fields_for(spec)

    def evaluate_group(
        self,
        template: AnalogSpec,
        dyn_names: Tuple[str, ...],
        dyn_rows: Sequence[Tuple[float, ...]],
        trials: int,
        seed: int,
        test_n: Optional[int],
        mesh=None,
    ) -> List[List[Dict[str, float]]]:
        """Evaluate every (point, trial) of one compile group in turn."""
        rows, seeds = shard_point_trial_batch(
            list(dyn_rows), trial_keys(seed, trials), mesh)
        codes = self._codes(template)
        tokens = self.eval_tokens if test_n is None \
            else self.eval_tokens[:test_n]
        targets = self.eval_targets if test_n is None \
            else self.eval_targets[:test_n]
        out = []
        for row in rows:
            spec = materialize(template, dict(zip(dyn_names, row)))
            out.append([
                _serve_metrics(
                    self.cfg, self.params,
                    program_lm_from_codes(self.cfg, codes, spec, s),
                    self.calib_tokens, tokens, targets, self.prompts,
                    self.decode_new, self._digital_toks)
                for s in seeds])
        return out

    # -- caches ------------------------------------------------------------
    def _codes_key(self, template) -> str:
        """Per-*site* mapping-signature key of the programmed-codes cache.

        Codes depend only on each site's mapping (g_min-independent), so
        design points agreeing on every site's mapping — including which
        sites are digital — share one cached code pack.  The head has no
        layer index: it is resolved at ``layer=None``, as
        ``lm_program_codes`` resolves it (band rules never match it).
        """
        profile = as_profile(template)
        parts = []
        for name in lm_hook_names(self.cfg):
            sp = profile.first_analog(name, self.cfg.n_layers)
            parts.append(
                f"{name}={'digital' if sp is None else mapping_signature(sp)}")
        if self.include_head:
            hs = profile.resolve(HEAD)
            parts.append(
                f"{HEAD}="
                f"{mapping_signature(hs) if isinstance(hs, AnalogSpec) else 'digital'}")
        return "|".join(parts)

    def _codes(self, template) -> dict:
        """Programmed-pack cache keyed by the per-site mapping signature
        (the parameters are the instance's)."""
        key = self._codes_key(template)
        if key not in self._codes_cache:
            self._codes_cache[key] = lm_program_codes(
                self.cfg, self.params, template,
                include_head=self.include_head)
        return self._codes_cache[key]


def _requests(requests):
    prompts = [np.asarray(p, np.int32).reshape(-1) for p, _ in requests]
    return prompts, [int(n) for _, n in requests]


def _agreement(ref: dict, got: dict) -> float:
    agree = total = 0
    for uid, r in ref.items():
        g = got[uid]
        total += max(r.size, g.size)
        agree += int(np.sum(r[:g.size] == g[:r.size]))
    return agree / max(total, 1)


def runtime_agreement(
    cfg: ModelConfig,
    params: dict,
    requests: Sequence[Tuple[Any, int]],
    *,
    pack=None,
    max_slots: int = 4,
    max_len: Optional[int] = None,
    buckets: Optional[Sequence[int]] = None,
    seed: int = 0,
) -> float:
    """``decode_match``'s runtime sibling: greedy token agreement between
    the continuous-batching runtime and per-request ``decode_lm``.

    ``requests`` is a list of ``(prompt tokens, max_new)`` pairs with
    arbitrary (mixed) prompt lengths, each served once through
    :class:`repro_torch.serve.ServeRuntime` and once through ``decode_lm``
    (exact-length prompt, dedicated batch).  Returns the fraction of
    generated tokens that agree; the contract value is 1.0.
    """
    from repro_torch.serve.runtime import ServeRuntime

    prompts, n_new = _requests(requests)
    if max_len is None:
        max_len = max(p.size + n for p, n in zip(prompts, n_new))
    rt = ServeRuntime(cfg, params, pack=pack, max_slots=max_slots,
                      max_len=max_len, buckets=buckets, seed=seed)
    uids = [rt.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    outs = rt.run()
    dev = params["embed"].device
    agree = total = 0
    for uid, p, n in zip(uids, prompts, n_new):
        ref = decode_lm(cfg, params, torch.as_tensor(p, device=dev)[None, :],
                        n, pack=pack)[0].cpu().numpy()
        got = outs[uid]
        total += n
        agree += int(np.sum(got[:ref.size] == ref[:got.size]))
    return agree / max(total, 1)


def pack_with_fused(pack, mode: str):
    """A copy of an :class:`AnalogPack` with every site spec's ``fused``
    field set to ``mode`` (``"off"`` | ``"kernel"`` | ``"oracle"``).

    Conductances, calibrated ranges and the rest are shared by reference,
    so the copies serve the *same device* through different lowerings.
    ``None`` passes through (digital serving has no pack to rewrite).
    """
    from repro_torch.hw.profile import SiteSpecs

    if pack is None:
        return None

    def rw(s):
        return (dataclasses.replace(s, fused=mode)
                if isinstance(s, AnalogSpec) else s)

    bands = tuple(
        SiteSpecs(items=tuple((n, rw(s)) for n, s in ss.items))
        for ss in pack.band_specs)
    profile = dataclasses.replace(
        pack.profile,
        rules=tuple(dataclasses.replace(r, spec=rw(r.spec))
                    for r in pack.profile.rules),
        default=rw(pack.profile.default))
    return dataclasses.replace(
        pack, band_specs=bands, profile=profile,
        head_spec=None if pack.head_spec is None else rw(pack.head_spec))


def fused_runtime_agreement(
    cfg: ModelConfig,
    params: dict,
    requests: Sequence[Tuple[Any, int]],
    *,
    pack=None,
    max_slots: int = 4,
    max_len: Optional[int] = None,
    sampler=None,
    seed: int = 0,
    modes: Tuple[str, str] = ("kernel", "oracle"),
    attn: Tuple[str, str] = ("flash", "flash_oracle"),
) -> float:
    """Token agreement between two fused lowerings of the same server.

    Serves every request twice through
    :class:`repro_torch.serve.ServeRuntime` at the same device state,
    sampler and seed — by default once on the CUDA kernels
    (``fused="kernel"`` + flash-decode attention) and once on their plain
    versions (``fused="oracle"`` + ``"flash_oracle"``).  ``modes``/``attn``
    select the two lowerings.
    """
    from repro_torch.serve.runtime import SamplerConfig, ServeRuntime

    prompts, n_new = _requests(requests)
    if max_len is None:
        max_len = max(p.size + n for p, n in zip(prompts, n_new))
    sampler = SamplerConfig() if sampler is None else sampler
    outs = []
    for mode, ab in zip(modes, attn):
        rt = ServeRuntime(cfg, params, pack=pack_with_fused(pack, mode),
                          max_slots=max_slots, max_len=max_len,
                          sampler=sampler, seed=seed, attn_backend=ab)
        for i, (p, n) in enumerate(zip(prompts, n_new)):
            rt.submit(p, max_new_tokens=n, uid=f"req-{i}")
        outs.append(rt.run())
    return _agreement(*outs)


def paged_runtime_agreement(
    cfg: ModelConfig,
    params: dict,
    requests: Sequence[Tuple[Any, int]],
    *,
    pack=None,
    max_slots: int = 4,
    max_len: Optional[int] = None,
    page_size: int = 8,
    num_pages: Optional[int] = None,
    sampler=None,
    seed: int = 0,
    backend: str = "gather",
) -> float:
    """Token agreement between the paged and dense serving runtimes.

    Every request is served twice at the same analog config and
    sampler/seed: through the dense :class:`repro_torch.serve.ServeRuntime`
    and through :class:`repro_torch.serve.PagedServeRuntime` (paged KV +
    prefix sharing, ``backend`` ``"gather"`` | ``"kernel"`` |
    ``"oracle"``).  ``max_len`` defaults to the tightest ``page_size``
    multiple covering the longest request.
    """
    from repro_torch.serve.paged import PagedServeRuntime
    from repro_torch.serve.runtime import SamplerConfig, ServeRuntime

    prompts, n_new = _requests(requests)
    if max_len is None:
        need = max(p.size + n for p, n in zip(prompts, n_new))
        max_len = -(-need // page_size) * page_size
    sampler = SamplerConfig() if sampler is None else sampler
    dense = ServeRuntime(cfg, params, pack=pack, max_slots=max_slots,
                         max_len=max_len, sampler=sampler, seed=seed)
    paged = PagedServeRuntime(cfg, params, pack=pack, max_slots=max_slots,
                              max_len=max_len, page_size=page_size,
                              num_pages=num_pages, sampler=sampler,
                              seed=seed, backend=backend)
    for rt in (dense, paged):
        for i, (p, n) in enumerate(zip(prompts, n_new)):
            rt.submit(p, max_new_tokens=n, uid=f"req-{i}")
    ref, got = dense.run(), paged.run()
    paged.check()
    return _agreement(ref, got)


def serve_serial_reference(
    cfg: ModelConfig,
    params: dict,
    spec: AnalogSpec,
    calib_tokens,
    eval_tokens,
    eval_targets,
    *,
    prompts=None,
    decode_new: int = 8,
    include_head: bool = True,
    trials: int = 5,
    seed: int = 1234,
) -> List[Dict[str, float]]:
    """One-point-at-a-time program → calibrate → eval reference: each
    trial programmed by ``program_lm`` from the weights on the executor's
    seeds.  Returns one metric dict per trial."""
    dev = params["embed"].device
    calib_tokens = on_device(calib_tokens, dev)
    digital_toks = None
    if prompts is not None:
        prompts = on_device(prompts, dev)
        digital_toks = decode_lm(cfg, params, prompts, decode_new, pack=None)
    return [
        _serve_metrics(cfg, params,
                       program_lm(cfg, params, spec, s,
                                  include_head=include_head),
                       calib_tokens, eval_tokens, eval_targets, prompts,
                       decode_new, digital_toks)
        for s in trial_keys(seed, trials)]
