"""The port's dense LM and analog serving engine against the JAX reference,
on the committed smoke LM (``benchmarks/_cache/lm_qwen1_5-4b_0.npz``)
loaded into both packages.

* Digital: logits within 1e-5 relative, greedy ``decode_lm`` identical.
* Analog: a Design-A ``fused="oracle"`` pack programmed and calibrated by
  JAX is carried across with ``interop.pack_from_numpy``; every analog
  site within the fused bound of the reference oracle on its operands,
  logits within 2 ulp or 0.25 of the head's dequant grid step away from
  positions downstream of a rounding-edge case, greedy tokens identical
  except where JAX's top-2 logit gap at the first diverging step is under
  1e-4 of the logit scale (a near tie), and the port's own
  ``calibrate_lm`` on that pack gives ranges within 1e-5 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import analog as JA
from repro.core import errors as JE
from repro.models import transformer as JT
from repro.serve import calibrate_lm as j_calibrate
from repro.serve import decode_lm as j_decode
from repro.serve import program_lm as j_program
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import analog as TA
from repro_torch.core import errors as TE
from repro_torch.models import transformer as TT
from repro_torch.serve import calibrate_lm as t_calibrate
from repro_torch.serve import decode_lm as t_decode

NPZ = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                   "_cache", "lm_qwen1_5-4b_0.npz")


def _np_tree(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.strip("[]'").split("']['")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


@pytest.fixture(scope="module")
def lm():
    tree = _np_tree(NPZ)
    j_params = jax.tree.map(jnp.asarray, tree)
    t_params = interop.load_params_npz(NPZ, device="cpu")
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 128, size=(4, 16)).astype(np.int32)
    prompts = rng.integers(0, 128, size=(3, 7)).astype(np.int32)
    return j_smoke("qwen1.5-4b"), t_smoke("qwen1.5-4b"), j_params, t_params, \
        calib, prompts


def _export_pack(pack):
    """A reference AnalogPack as the nested numpy dict
    ``interop.pack_from_numpy`` reads."""
    def weights(aw):
        return {"g_pos": np.asarray(aw.g_pos),
                "g_neg": None if aw.g_neg is None else np.asarray(aw.g_neg),
                "g_unit": None if aw.g_unit is None else np.asarray(aw.g_unit),
                "w_scale": np.asarray(aw.w_scale), "k": aw.k, "n": aw.n}

    def arrays(d):
        return {k: np.asarray(v) for k, v in d.items()}

    return {
        "layer_weights": {n: weights(aw) for n, aw in pack.layer_weights.items()},
        "layer_lo": arrays(pack.layer_lo), "layer_hi": arrays(pack.layer_hi),
        "layer_act": arrays(pack.layer_act),
        "head": None if pack.head is None else weights(pack.head),
        "head_lo": np.asarray(pack.head_lo), "head_hi": np.asarray(pack.head_hi),
        "head_act": np.asarray(pack.head_act),
    }


@pytest.fixture(scope="module")
def packs(lm):
    j_cfg, t_cfg, j_params, _, calib, _ = lm
    j_spec = JA.design_a(error=JE.state_proportional(0.05), fused="oracle")
    t_spec = TA.design_a(error=TE.state_proportional(0.05), fused="oracle")
    j_pack = j_program(j_cfg, j_params, j_spec, jax.random.PRNGKey(7))
    # compiled as one program: the layer sites calibrate inside the
    # compiled layer scan anyway, and compiling the head too keeps its
    # float32 index and clip arithmetic the same as the layers'
    j_pack = jax.jit(lambda p, pk, c: j_calibrate(j_cfg, p, pk, c))(
        j_params, j_pack, jnp.asarray(calib))
    t_pack = interop.pack_from_numpy(_export_pack(j_pack), t_spec, t_cfg,
                                     device="cpu")
    return j_pack, t_pack


def test_params_load_identically(lm):
    _, _, j_params, t_params, _, _ = lm
    flat_j = jax.tree_util.tree_flatten_with_path(j_params)[0]
    assert len(flat_j) == 15
    for path, leaf in flat_j:
        node = t_params
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_digital_logits_and_greedy_tokens(lm):
    j_cfg, t_cfg, j_params, t_params, calib, prompts = lm
    lg_j = np.asarray(JT.forward(j_cfg, j_params, jnp.asarray(calib),
                                 remat=False)[0])
    lg_t = TT.forward(t_cfg, t_params, torch.as_tensor(calib))[0].numpy()
    scale = np.abs(lg_j).max()
    np.testing.assert_allclose(lg_t, lg_j, rtol=1e-5, atol=1e-5 * scale)
    tok_j = np.asarray(j_decode(j_cfg, j_params, jnp.asarray(prompts), 6))
    tok_t = t_decode(t_cfg, t_params, torch.as_tensor(prompts), 6).numpy()
    np.testing.assert_array_equal(tok_t, tok_j)


def _head_grid(pack):
    """Dequant grid step of the head's output: gain * w_scale * x_scale
    * lsb (the output is that times a sum of ADC code units)."""
    m = pack.head_spec.mapping
    gain = (m.levels_per_cell - 1) / (1.0 - m.g_min)
    x_scale = float(pack.head_act) / (2 ** (pack.head_spec.input_bits - 1) - 1)
    lsb = float(pack.head_hi[0] - pack.head_lo[0]) / (2 ** pack.head_spec.adc.bits - 1)
    return gain * float(pack.head.w_scale) * x_scale * lsb


def _record_reference_flips(monkeypatch, seq_len):
    """Wrap the port's plain fused MVM so that every call is also run
    through the reference's oracle on the same operands and held to the
    fused bound (``tolerance.fused_mvm_check``: 2 ulp or 0.25 code, one-code
    flips only next to an ADC rounding edge), and the activation quantizer
    so that it notes activations within 4 ulp of a rounding edge.  Returns
    the list that fills with the ``(batch row, position)`` of each."""
    from repro.kernels import ops as j_ops
    from repro_torch.core import analog as t_analog
    from repro_torch.kernels import ref as t_ref
    from repro_torch.kernels import tolerance

    flips = []
    plain = t_ref.fused_mvm_diff

    def recording(x_parts, g_pos, g_neg, adc_lo, adc_hi, scale, **kw):
        y = plain(x_parts, g_pos, g_neg, adc_lo, adc_hi, scale, **kw)
        args = [jnp.asarray(t.numpy()) for t in
                (x_parts, g_pos, g_neg, adc_lo, adc_hi, scale)]
        y_ref = jax.jit(lambda x, gp, gm, lo, hi, sc: j_ops.fused_mvm(
            x, gp, gm, adc_lo=lo, adc_hi=hi, scale=sc, backend="oracle",
            **kw))(*args)
        r = tolerance.fused_mvm_check(torch.as_tensor(np.array(y_ref)), y,
                                      x_parts, g_pos, g_neg, adc_lo, adc_hi,
                                      scale, **kw)
        assert r["ok"], r
        y_ref = np.asarray(y_ref)
        d = np.abs(y.numpy() - y_ref)
        tight = (d <= 2 * np.spacing(np.maximum(np.abs(y_ref), np.abs(
            y.numpy())))) | (d <= 0.25 * float(scale))
        for row in np.nonzero(~tight.all(axis=1))[0]:
            flips.append(divmod(int(row), seq_len))
        return y

    def quantize_recording(x, *args, **kw):
        q = quantize(x, *args, **kw)
        t = (x / q.scale).to(torch.float32)
        edge = torch.floor(t) + 0.5
        near = (t - edge).abs() <= 4 * tolerance._spacing(t.abs())
        for row in torch.nonzero(near.any(dim=-1))[:, 0].tolist():
            flips.append(divmod(int(row), seq_len))
        return q

    quantize = t_analog.quantize_acts
    monkeypatch.setattr(t_ref, "fused_mvm_diff", recording)
    monkeypatch.setattr(t_analog, "quantize_acts", quantize_recording)
    return flips


def test_analog_logits_on_reference_pack_within_bound(lm, packs,
                                                       monkeypatch):
    """Logits within 2 ulp or 0.25 of the head's dequant grid step — except
    at positions at or after one where a site's ADC flipped by one code
    next to a rounding edge (allowed by the fused bound, which every site
    is held to here) or an activation lies within 4 ulp of an input
    quantizer's rounding edge (where ulp-level differences upstream may
    round it either way): either moves every later position of its
    sequence."""
    j_cfg, t_cfg, j_params, t_params, calib, _ = lm
    j_pack, t_pack = packs
    flips = _record_reference_flips(monkeypatch, calib.shape[1])
    lg_j = np.asarray(JT.forward(j_cfg, j_params, jnp.asarray(calib),
                                 pack=j_pack, remat=False)[0])
    lg_t = TT.forward(t_cfg, t_params, torch.as_tensor(calib),
                      pack=t_pack)[0].numpy()
    d = np.abs(lg_t - lg_j)
    mag = np.maximum(np.abs(lg_t), np.abs(lg_j))
    ok = (d <= 2 * np.spacing(mag.astype(np.float32))) \
        | (d <= 0.25 * _head_grid(t_pack))
    for b, t in flips:
        ok[b, t:] = True
    assert len(flips) <= calib.size // 8, flips
    assert ok.all(), (f"{int((~ok).sum())} of {ok.size} logits outside the "
                      f"bound, max diff {d[~ok].max():.3e}; reference-"
                      f"rounding flips at {sorted(set(flips))}")


def test_analog_greedy_tokens_match_up_to_near_ties(lm, packs):
    j_cfg, t_cfg, j_params, t_params, _, prompts = lm
    j_pack, t_pack = packs
    n_new = 8
    tok_j = np.asarray(j_decode(j_cfg, j_params, jnp.asarray(prompts), n_new,
                                pack=j_pack))
    tok_t = t_decode(t_cfg, t_params, torch.as_tensor(prompts), n_new,
                     pack=t_pack).numpy()
    for row in range(prompts.shape[0]):
        diff = np.nonzero(tok_t[row] != tok_j[row])[0]
        if diff.size == 0:
            continue
        i = int(diff[0])
        seq = np.concatenate([prompts[row], tok_j[row, :i]])[None]
        lg = np.asarray(JT.forward(j_cfg, j_params, jnp.asarray(seq),
                                   pack=j_pack, remat=False)[0])[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < 1e-4 * np.abs(lg).max(), (
            f"row {row} leaves the reference at step {i} away from a near tie")


def test_port_calibration_matches_reference_ranges(lm, packs):
    _, t_cfg, _, t_params, calib, _ = lm
    j_pack, t_pack = packs
    recal = t_calibrate(t_cfg, t_params, t_pack, torch.as_tensor(calib))
    for name in j_pack.layer_lo:
        for field in ("layer_lo", "layer_hi", "layer_act"):
            np.testing.assert_allclose(
                getattr(recal, field)[name].numpy(),
                np.asarray(getattr(j_pack, field)[name]), rtol=1e-5,
                err_msg=f"{field}[{name}]")
    for field in ("head_lo", "head_hi", "head_act"):
        np.testing.assert_allclose(getattr(recal, field).numpy(),
                                   np.asarray(getattr(j_pack, field)),
                                   rtol=1e-5, err_msg=field)


def test_port_programming_codes_match_reference(lm):
    """program_lm's deterministic half (codes and weight scales) per site
    and layer, and its seed schedule: one site's noise never depends on
    which other sites are analog."""
    from repro.serve.analog_engine import lm_program_codes as j_codes
    from repro_torch.hw import Profile, Rule
    from repro_torch.serve import lm_program_codes as t_codes
    from repro_torch.serve import program_lm as t_program

    j_cfg, t_cfg, j_params, t_params, _, _ = lm
    jc = j_codes(j_cfg, j_params, JA.design_a())
    tc = t_codes(t_cfg, t_params, TA.design_a())
    assert sorted(jc) == sorted(tc)
    for name in jc:
        np.testing.assert_array_equal(tc[name].codes.c_pos.numpy(),
                                      np.asarray(jc[name].codes.c_pos))
        np.testing.assert_array_equal(tc[name].w_scale.numpy(),
                                      np.asarray(jc[name].w_scale))
    spec = TA.design_a(error=TE.state_proportional(0.05))
    full = t_program(t_cfg, t_params, spec, seed=3)
    attn_only = t_program(t_cfg, t_params,
                          Profile(rules=(Rule("attn.*", spec),)), seed=3,
                          include_head=False)
    for name in ("wq", "wk", "wv", "wo"):
        assert torch.equal(full.layer_weights[name].g_pos,
                           attn_only.layer_weights[name].g_pos)
    assert "w_up" not in attn_only.layer_weights
    assert dataclasses.replace(full, collect=True).collect
