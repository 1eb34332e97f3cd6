"""Carry weights and programmed device state into the port from numpy.

The JAX package saves parameters as npz files keyed by
``jax.tree_util.keystr`` paths (``['layers']['attn']['wq']``), and a
programmed pack can be exported to a nested dict of numpy arrays.  These
loaders turn both into the port's structures, so the two packages compute
on identical weights and identical programmed conductances — which is
how the stages downstream of random programming noise are held against
the reference (``torch.Generator`` cannot reproduce ``jax.random``).

Both loaders follow the tree they are given: the transformer families'
``layers`` stacks (``attn``/``mlp``, ``moe``, ``rwkv``), the hybrid's
``layers``/``shared`` and the encoder-decoder's ``encoder``/``decoder``
trees, and a pack's sites by name (``wq`` ... ``w_down``, ``rwkv_wr`` ...
``rwkv_cr``, ``head``).

This module uses numpy and torch only.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.analog import AnalogSpec, AnalogWeights
from repro_torch.hw.profile import Profile, as_profile
from repro_torch.models.transformer import AnalogPack

_KEY = re.compile(r"\['([^'\]]*)'\]")


def params_from_numpy(tree: Mapping, *, device="cuda") -> dict:
    """Nested dict of numpy arrays (shaped like the reference's
    ``init_params``, leading layer axis included) -> nested dict of
    tensors on ``device``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_numpy(v, device=device)
        else:
            out[k] = torch.as_tensor(np.array(v), device=device)
    return out


def load_params_npz(path, *, device="cuda") -> dict:
    """Read a keystr-named npz (e.g. ``benchmarks/_cache/lm_*.npz``) into
    the nested parameter dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = _KEY.findall(key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"{path}: key {key!r} is not a dict-keystr path")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return params_from_numpy(tree, device=device)


def _weights(d: Mapping, device) -> AnalogWeights:
    def t(name):
        v = d.get(name)
        return None if v is None else torch.as_tensor(np.array(v),
                                                      device=device)
    return AnalogWeights(g_pos=t("g_pos"), g_neg=t("g_neg"), g_unit=t("g_unit"),
                         w_scale=t("w_scale"), k=int(d["k"]), n=int(d["n"]))


def pack_from_numpy(arrays: Mapping,
                    spec_or_profile: Union[AnalogSpec, Profile],
                    cfg: ModelConfig, *, device="cuda") -> AnalogPack:
    """Build the port's :class:`AnalogPack` from a reference pack exported
    to numpy under the profile it was programmed with.

    ``arrays`` holds ``layer_weights`` (site -> ``g_pos``, ``g_neg``,
    ``g_unit`` or None, ``w_scale``, ``k``, ``n``; tensors stacked over
    layers), ``layer_lo``/``layer_hi`` (site -> (L, S)), ``layer_act``
    (site -> (L,)), and optionally ``head`` (the same fields, unstacked)
    with ``head_lo``/``head_hi`` (S,) and ``head_act`` (scalar).
    """
    from repro_torch.serve.analog_engine import HEAD, pack_layout

    profile = as_profile(spec_or_profile)
    sites = list(arrays["layer_weights"])
    bands, band_specs, _ = pack_layout(profile, sites, cfg.n_layers)

    def tensors(name) -> dict:
        return {k: torch.as_tensor(np.array(v), device=device)
                for k, v in (arrays.get(name) or {}).items()}

    def tensor(name) -> Optional[torch.Tensor]:
        v = arrays.get(name)
        return None if v is None else torch.as_tensor(np.array(v),
                                                      device=device)

    head, head_spec = None, None
    if arrays.get("head") is not None:
        head_spec = profile.resolve(HEAD)
        if not isinstance(head_spec, AnalogSpec):
            raise ValueError("the arrays carry a programmed head but the "
                             "profile resolves 'head' to digital")
        head = _weights(arrays["head"], device)
    return AnalogPack(
        profile=profile, bands=bands, band_specs=band_specs,
        layer_weights={n: _weights(d, device)
                       for n, d in arrays["layer_weights"].items()},
        layer_lo=tensors("layer_lo"), layer_hi=tensors("layer_hi"),
        layer_act=tensors("layer_act"),
        head=head, head_lo=tensor("head_lo"), head_hi=tensor("head_hi"),
        head_act=tensor("head_act"), head_spec=head_spec, collect=False)
