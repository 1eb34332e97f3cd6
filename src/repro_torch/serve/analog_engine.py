"""Analog LM serving: program a trained LM onto simulated analog arrays,
calibrate its ADC ranges, and serve through the analog pipeline
(counterpart of ``repro.serve.analog_engine``).

1. ``program_lm`` — every weight-stationary projection of every layer is
   quantized, mapped and perturbed with program-time cell errors.  Seeds
   fold from a stable hash of the hook name (the reference's blake2s
   hash), then the absolute layer index, so a projection's noise never
   depends on which other projections exist or on band structure.
2. ``calibrate_lm`` — two collect passes over a calibration batch:
   activation clip ranges, then inner-99.98% pre-ADC ranges per
   (layer, slice) with those clips installed (Sec. 4.3, 6.2).
3. ``decode_lm`` — batched greedy serving through the pack.

Programming is split as in the reference: ``lm_program_codes`` (quantize
+ integer codes, deterministic) and ``program_lm_from_codes`` (conductance
conversion + noise).  ``program_lm`` runs both a layer at a time, so the
integer codes of a full-width model never sit in memory at once.

Every entry point takes one :class:`AnalogSpec` or a
:class:`repro_torch.hw.Profile`.  The unified transformer's families are
served: dense, moe and vlm program their attention and dense-MLP
projections (MoE experts stay digital), ssm (rwkv) its eight time- and
channel-mix projections (DESIGN.md §Arch-applicability).  The hybrid has
no analog hooks and the encoder-decoder no ``layers`` stack; both raise,
with the reference's reasons.  ``age_pack`` derives a pack's device
state at an age under each site's drift and stuck-cell fault models,
seeded like programming; ``repro_torch.serve.health`` manages that state
over a served pack's life.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import calibrate as cal
from repro_torch.core.analog import (
    AnalogSpec,
    AnalogWeights,
    ProgrammedMatrix,
    age_conductances,
    analog_matmul,
    program_codes,
    program_from_codes,
)
from repro_torch.core.errors import fold_seed
from repro_torch.core.mapping import ProgrammedCodes
from repro_torch.core.quant import calibrate_act_range
from repro_torch.hw.profile import (
    Profile,
    SiteSpecs,
    as_profile,
    check_band_geometry,
)
from repro_torch.models.registry import decode_loop_families, get_model
from repro_torch.models.transformer import AnalogPack, forward

SpecLike = Union[AnalogSpec, Profile]

#: weight leaves programmed to analog arrays, per family and parent block
DENSE_NAMES = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
}
RWKV_NAMES = {
    "rwkv": ("wr", "wk", "wv", "wg", "wo", "ck", "cv", "cr"),
}
#: analog hook names used inside the blocks (see models/*.py dense() calls)
HOOK_NAME = {
    ("attn", "wq"): "wq", ("attn", "wk"): "wk", ("attn", "wv"): "wv",
    ("attn", "wo"): "wo",
    ("mlp", "w_gate"): "w_gate", ("mlp", "w_up"): "w_up",
    ("mlp", "w_down"): "w_down",
    ("rwkv", "wr"): "rwkv_wr", ("rwkv", "wk"): "rwkv_wk",
    ("rwkv", "wv"): "rwkv_wv", ("rwkv", "wg"): "rwkv_wg",
    ("rwkv", "wo"): "rwkv_wo", ("rwkv", "ck"): "rwkv_ck",
    ("rwkv", "cv"): "rwkv_cv", ("rwkv", "cr"): "rwkv_cr",
}

#: the lm_head / tied-embedding projection in an ``lm_program_codes`` dict
HEAD = "head"


def hook_key(seed: int, name: str) -> int:
    """Fold a hook's programming seed from a stable hash of its name —
    the reference's blake2s name hash, folded into ``seed``."""
    h = hashlib.blake2s(name.encode(), digest_size=4).digest()
    return fold_seed(seed, int.from_bytes(h, "big") & 0x7FFFFFFF)


def _groups(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    return RWKV_NAMES if cfg.rwkv else DENSE_NAMES


def lm_hook_names(cfg: ModelConfig) -> List[str]:
    """Every potential analog layer-hook name of this family, in the
    stable programming order (head excluded)."""
    return [HOOK_NAME[(parent, leaf)]
            for parent, leaves in _groups(cfg).items() for leaf in leaves]


def _site_resolution(profile: Profile, sites: List[str], n_layers: int):
    """``(bands, {site: [spec-or-None per band]})`` with geometry checks."""
    bands = profile.layer_bands(sites, n_layers) if sites \
        else ((0, n_layers),)
    per_site: Dict[str, List[Optional[AnalogSpec]]] = {}
    for name in sites:
        specs = []
        for lo, _hi in bands:
            sp = profile.resolve(name, lo)
            specs.append(sp if isinstance(sp, AnalogSpec) else None)
        analog = [s for s in specs if s is not None]
        if analog:
            check_band_geometry(name, analog)
        per_site[name] = specs
    return bands, per_site


def _analog_leaves(cfg: ModelConfig, params: dict, profile: Profile):
    """``[(hook name, layer-stacked weight, geometry spec)]`` of the sites
    the profile puts on arrays; raises, with the reference's reasons, if
    the family has no layer stack or no analog hook, or if every site is
    digital."""
    groups = _groups(cfg)
    if "layers" not in params:
        raise ValueError(
            f"family {cfg.family!r} ({cfg.name}) has no 'layers' parameter "
            f"stack; lm_program_codes supports the unified transformer "
            f"families (dense / moe / vlm / ssm-rwkv) — see DESIGN.md "
            f"§Arch-applicability")
    out, n_digital = [], 0
    for parent, leaves in groups.items():
        for leaf in leaves:
            if leaf not in params["layers"].get(parent, {}):
                continue
            name = HOOK_NAME[(parent, leaf)]
            site_spec = profile.first_analog(name, cfg.n_layers)
            if site_spec is None:
                n_digital += 1
                continue
            out.append((name, params["layers"][parent][leaf], site_spec))
    if out:
        return out
    if n_digital:
        default = "analog" if isinstance(profile.default, AnalogSpec) \
            else "digital"
        raise ValueError(
            f"the profile resolves every projection hook of family "
            f"{cfg.family!r} ({cfg.name}) to 'digital'; at least one "
            f"site must be analog to program a pack (rules: "
            f"{[r.pattern for r in profile.rules]}, default {default})")
    raise ValueError(
        f"no analog hooks found for family {cfg.family!r} ({cfg.name}): "
        f"expected {'rwkv' if cfg.rwkv else 'attn/mlp'} projection leaves "
        f"{sorted(n for g in groups.values() for n in g)} under "
        f"params['layers']")


def _stack_codes(pms: List[ProgrammedMatrix]) -> ProgrammedMatrix:
    def stack(field):
        vals = [getattr(pm.codes, field) for pm in pms]
        return None if vals[0] is None else torch.stack(vals)
    return ProgrammedMatrix(
        codes=ProgrammedCodes(stack("c_pos"), stack("c_neg"), stack("c_unit")),
        w_scale=torch.stack([pm.w_scale for pm in pms]),
        k=pms[0].k, n=pms[0].n)


def _layer_codes(pm: ProgrammedMatrix, i: int) -> ProgrammedMatrix:
    def pick(t):
        return None if t is None else t[i]
    c = pm.codes
    return ProgrammedMatrix(
        codes=ProgrammedCodes(pick(c.c_pos), pick(c.c_neg), pick(c.c_unit)),
        w_scale=pm.w_scale[i], k=pm.k, n=pm.n)


def lm_program_codes(cfg: ModelConfig, params: dict, spec: SpecLike, *,
                     include_head: bool = True,
                     ) -> Dict[str, ProgrammedMatrix]:
    """Quantize + map every analog hook to integer code stacks (layer
    hooks stacked over layers; the head a plain 2-D matrix).  Sites the
    profile keeps digital at every layer are omitted."""
    profile = as_profile(spec)
    codes: Dict[str, ProgrammedMatrix] = {}
    for name, w_stack, site_spec in _analog_leaves(cfg, params, profile):
        codes[name] = _stack_codes([program_codes(w, site_spec)
                                    for w in w_stack])
    head_spec = profile.resolve(HEAD)
    if include_head and isinstance(head_spec, AnalogSpec):
        codes[HEAD] = program_codes(_head_weight(cfg, params), head_spec)
    return codes


def _head_weight(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


_LINES = ("g_pos", "g_neg", "g_unit")


def _stack_layers(layers: Iterable[AnalogWeights],
                  n_layers: int) -> AnalogWeights:
    """``n_layers`` per-layer weights stacked over a new leading axis, each
    written into its stack as it comes (one layer alive at a time)."""
    stacks: Dict[str, Optional[torch.Tensor]] = {}
    scales = []
    for i, aw in enumerate(layers):
        for field in _LINES:
            t = getattr(aw, field)
            if i == 0:
                stacks[field] = None if t is None else torch.empty(
                    (n_layers,) + tuple(t.shape), dtype=t.dtype,
                    device=t.device)
            if t is not None:
                stacks[field][i] = t
        scales.append(aw.w_scale)
    return AnalogWeights(g_pos=stacks["g_pos"], g_neg=stacks["g_neg"],
                         g_unit=stacks["g_unit"],
                         w_scale=torch.stack(scales), k=aw.k, n=aw.n)


def _program_site_stack(code_of_layer: Callable[[int], ProgrammedMatrix],
                        n_layers: int,
                        specs_per_band: List[Optional[AnalogSpec]],
                        bands: Tuple[Tuple[int, int], ...],
                        seed: int) -> AnalogWeights:
    """Program one site's layers into one layer-stacked AnalogWeights.
    Layer ``i`` draws its noise from ``fold_seed(seed, i)`` under its own
    band's spec; layers of a digital band are programmed with the site's
    geometry spec as filler (the model never routes them analog)."""
    geom = next(s for s in specs_per_band if s is not None)
    layer_spec = []
    for (lo, hi), sp in zip(bands, specs_per_band):
        layer_spec.extend([sp if sp is not None else geom] * (hi - lo))
    return _stack_layers(
        (program_from_codes(code_of_layer(i), layer_spec[i],
                            fold_seed(seed, i)) for i in range(n_layers)),
        n_layers)


def _age_weights(aw: AnalogWeights, spec: AnalogSpec, t_drift, t_fault,
                 seed: int) -> AnalogWeights:
    """Drift + fault one programmed matrix to the given ages."""
    g_pos, g_neg, g_unit = age_conductances(
        aw.g_pos, aw.g_neg, aw.g_unit, spec, seed,
        t_drift=t_drift, t_fault=t_fault)
    return dataclasses.replace(aw, g_pos=g_pos, g_neg=g_neg, g_unit=g_unit)


def _age_site_stack(aw: AnalogWeights,
                    specs_per_band: List[Optional[AnalogSpec]],
                    bands: Tuple[Tuple[int, int], ...],
                    seed: int,
                    t_drift_by_band: List[float],
                    t_fault_by_band: List[float]) -> AnalogWeights:
    """Age one site's layer stack, per band, on the programming seed
    schedule (``fold_seed(site seed, absolute layer)``), so aging does not
    depend on band structure and replays; layers of a band that does not
    age are copied as they are."""
    def layers():
        for (lo, hi), sp, td, tf in zip(bands, specs_per_band,
                                        t_drift_by_band, t_fault_by_band):
            for i in range(lo, hi):
                lay = aw.layer(i)
                if sp is not None and sp.aging_on:
                    lay = _age_weights(lay, sp, td, tf, fold_seed(seed, i))
                yield lay

    return _stack_layers(layers(), bands[-1][1])


def age_pack(pack: AnalogPack, t, seed: int, *,
             t_drift_by_band=None, t_fault_by_band=None) -> AnalogPack:
    """Device state of ``pack`` at age ``t`` (t0 units; ``t = 1`` fresh).

    Each site ages under its own band's drift and fault models; seeds fold
    as programming seeds do, ``fold_seed(hook_key(seed, name), absolute
    layer)``, so the same pack, ``t`` and seed give the same result.  With
    every model off it returns ``pack`` itself; at ``t = 1`` a pack equal
    to ``pack``, tensor for tensor.  ``t_drift_by_band`` /
    ``t_fault_by_band`` replace the uniform ``t`` per band (the healer's
    per-band reprogram ages); the head always ages at ``t``.
    """
    n_bands = len(pack.bands)
    td = list(t_drift_by_band) if t_drift_by_band is not None \
        else [t] * n_bands
    tf = list(t_fault_by_band) if t_fault_by_band is not None \
        else [t] * n_bands
    changed = False
    layer_weights = {}
    for name, aw in pack.layer_weights.items():
        specs = [ss.get(name) for ss in pack.band_specs]
        if not any(s is not None and s.aging_on for s in specs):
            layer_weights[name] = aw
            continue
        changed = True
        layer_weights[name] = _age_site_stack(
            aw, specs, pack.bands, hook_key(seed, name), td, tf)
    head = pack.head
    if head is not None and pack.head_spec.aging_on:
        changed = True
        head = _age_weights(head, pack.head_spec, t, t, hook_key(seed, HEAD))
    if not changed:
        return pack
    return dataclasses.replace(pack, layer_weights=layer_weights, head=head)


def pack_layout(profile: Profile, sites: List[str], n_layers: int):
    """``(bands, band_specs, per_site)`` of a pack over ``sites``: the
    profile's layer bands, the (site, spec) map of each band, and each
    site's spec (or ``None`` where digital) per band."""
    bands, per_site = _site_resolution(profile, sites, n_layers)
    band_specs = tuple(
        SiteSpecs(tuple((n, per_site[n][b]) for n in sites
                        if per_site[n][b] is not None))
        for b in range(len(bands)))
    return bands, band_specs, per_site


def _build_pack(cfg: ModelConfig, profile: Profile,
                site_codes: Dict[str, Callable[[int], ProgrammedMatrix]],
                head_codes: Optional[ProgrammedMatrix],
                seed: int) -> AnalogPack:
    sites = list(site_codes)
    l = cfg.n_layers
    bands, band_specs, per_site = pack_layout(profile, sites, l)
    layer_weights = {
        name: _program_site_stack(site_codes[name], l, per_site[name], bands,
                                  hook_key(seed, name))
        for name in sites}

    head, head_spec = None, None
    if head_codes is not None:
        hs = profile.resolve(HEAD)
        if not isinstance(hs, AnalogSpec):
            raise ValueError(
                "codes include the 'head' site but the profile resolves "
                "it to 'digital'; rebuild codes with this profile")
        head_spec = hs
        head = program_from_codes(head_codes, hs, hook_key(seed, HEAD))

    dev = next(iter(layer_weights.values())).g_pos.device

    def n_slices(name):
        return next(s for s in per_site[name] if s is not None) \
            .mapping.n_slices

    s_head = head_spec.mapping.n_slices if head_spec is not None else 1
    return AnalogPack(
        profile=profile, bands=bands, band_specs=band_specs,
        layer_weights=layer_weights,
        layer_lo={n: torch.zeros((l, n_slices(n)), device=dev)
                  for n in layer_weights},
        layer_hi={n: torch.ones((l, n_slices(n)), device=dev)
                  for n in layer_weights},
        layer_act={}, head=head,
        head_lo=torch.zeros((s_head,), device=dev),
        head_hi=torch.ones((s_head,), device=dev),
        head_act=None, head_spec=head_spec, collect=False,
    )


def program_lm_from_codes(cfg: ModelConfig,
                          codes: Dict[str, ProgrammedMatrix],
                          spec: SpecLike, seed: int) -> AnalogPack:
    """Conductance-convert + perturb cached code stacks into a pack.
    Seed schedule: ``fold_seed(hook_key(seed, name), layer)`` with
    absolute layer indices."""
    site_codes = {name: (lambda i, pm=pm: _layer_codes(pm, i))
                  for name, pm in codes.items() if name != HEAD}
    return _build_pack(cfg, as_profile(spec), site_codes, codes.get(HEAD),
                       seed)


def program_lm(cfg: ModelConfig, params: dict, spec: SpecLike, seed: int,
               *, include_head: bool = True) -> AnalogPack:
    """Program the LM's weight-stationary projections onto analog arrays
    (on the device the parameters live on).  Equal to
    ``program_lm_from_codes(cfg, lm_program_codes(...), spec, seed)``,
    computed a layer at a time."""
    profile = as_profile(spec)
    site_codes = {
        name: (lambda i, w=w_stack, sp=site_spec: program_codes(w[i], sp))
        for name, w_stack, site_spec in _analog_leaves(cfg, params, profile)}
    head_spec = profile.resolve(HEAD)
    head_codes = None
    if include_head and isinstance(head_spec, AnalogSpec):
        head_codes = program_codes(_head_weight(cfg, params), head_spec)
    return _build_pack(cfg, profile, site_codes, head_codes, seed)


def calibrate_lm(cfg: ModelConfig, params: dict, pack: AnalogPack,
                 calib_tokens, prefix_embeds=None) -> AnalogPack:
    """Two-phase range calibration; returns a serving-ready pack.
    Idempotent: calibration already on ``pack`` is stripped first."""
    api = get_model(cfg)
    kw = {} if prefix_embeds is None else {"prefix_embeds": prefix_embeds}
    pack = dataclasses.replace(pack, layer_lo={}, layer_hi={}, layer_act={},
                               head_lo=None, head_hi=None, head_act=None)
    # phase 1: activation clip ranges (ideal ADC, collect inputs)
    _, aux1 = api.forward(cfg, params, calib_tokens,
                          pack=dataclasses.replace(pack, collect=True), **kw)
    act = {k[len("act/"):]: v for k, v in aux1.items()
           if k.startswith("act/")}                    # (L,) per site
    pack2 = dataclasses.replace(pack, layer_act=act, collect=True)

    # phase 2: pre-ADC ranges with the activation clips installed
    _, aux2 = api.forward(cfg, params, calib_tokens, pack=pack2, **kw)
    lo, hi = {}, {}
    for k, v in aux2.items():
        if not k.startswith("adc/"):
            continue
        name = k[len("adc/"):]
        lo_s, hi_s = v[..., 0], v[..., 1]              # (L, S)
        if pack.site_spec(name).mapping.sliced:
            pairs = [cal.constrain_power_of_two(a, b)
                     for a, b in zip(lo_s, hi_s)]
            lo_s = torch.stack([a for a, _ in pairs])
            hi_s = torch.stack([b for _, b in pairs])
        lo[name], hi[name] = lo_s, hi_s

    # the head calibrates on the true final-norm hiddens under its own
    # spec
    head_lo, head_hi, head_act = pack.head_lo, pack.head_hi, None
    if pack.head is not None:
        x = aux2["final_hidden"].reshape(-1, cfg.d_model)
        _, head_act = calibrate_act_range(x, pack.head_spec.input_bits)
        _, stats = analog_matmul(x, pack.head, pack.head_spec,
                                 act_hi=head_act, collect=True)
        head_lo, head_hi = stats[:, 0], stats[:, 1]

    return dataclasses.replace(
        pack, layer_lo=lo, layer_hi=hi, layer_act=act,
        head_lo=head_lo, head_hi=head_hi, head_act=head_act, collect=False)


def analog_eval_metrics(cfg: ModelConfig, params: dict, pack: AnalogPack,
                        tokens, targets) -> Dict[str, torch.Tensor]:
    """Teacher-forced ``{"loss", "top1"}`` of the analog model."""
    logits, _ = forward(cfg, params, tokens, pack=pack)
    targets = torch.as_tensor(targets, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    top1 = (torch.argmax(logits, dim=-1) == targets).float().mean()
    return {"loss": (logz - gold).mean(), "top1": top1}


def analog_eval_loss(cfg: ModelConfig, params: dict, pack: AnalogPack,
                     tokens, targets) -> torch.Tensor:
    """Cross-entropy of the analog model (accuracy metric for sweeps)."""
    return analog_eval_metrics(cfg, params, pack, tokens, targets)["loss"]


def decode_lm(cfg: ModelConfig, params: dict, prompts, n_new: int, *,
              pack: Optional[AnalogPack] = None) -> torch.Tensor:
    """Batched greedy serving: prefill + ``n_new - 1`` decode steps;
    returns (B, n_new) tokens, every matmul through the pack if given."""
    api = get_model(cfg)
    if api.decode_loop is None:
        raise ValueError(
            f"family {cfg.family!r} ({cfg.name}) has no batched decode "
            f"loop; decode_lm serves families "
            f"{sorted(decode_loop_families())} (encoder-decoder needs "
            f"per-utterance encoder state, see repro_torch.models.encdec)")
    return api.decode_loop(cfg, params, prompts, n_new, pack=pack)
