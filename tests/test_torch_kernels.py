"""The port's serving kernels: plain PyTorch versions against the JAX
oracles, on the CPU (the CUDA kernels against the plain versions, on the
same grids, are ``tests/test_torch_cuda.py``).

Bounds (``repro_torch.kernels.tolerance``): the fused MVM within 2 ulp or
0.25 of a dequant grid step, one-code ADC flips only where the pre-ADC
value lies within 4 ulp of a rounding edge; flash decode within
``4 ulp + kv_len * eps * max|v|`` (any summation order of the softmax
terms lands there).  Inputs are the grids of ``tests/test_kernels.py``
(``tolerance.FUSED_GRID``, ``tolerance.FLASH_GRID``), drawn with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tolerance
from repro_torch.kernels.tolerance import (FLASH_GRID, FUSED_GRID, flash_case,
                                           fused_case, paged_case)
from test_torch_cuda import _ids


@pytest.mark.parametrize("m,p,s,rows,n,n_bits,cell_bits", FUSED_GRID,
                         ids=_ids(FUSED_GRID))
def test_plain_fused_mvm_matches_jax_oracle(m, p, s, rows, n, n_bits,
                                            cell_bits):
    arrs = fused_case(m, p, s, rows, n)
    kw = dict(adc_bits=8, cell_bits=cell_bits, n_bits=n_bits)
    scale = np.float32(3e-4)
    y_j = j_ops.fused_mvm(*(jnp.asarray(a) for a in arrs[:3]),
                          adc_lo=jnp.asarray(arrs[3]),
                          adc_hi=jnp.asarray(arrs[4]),
                          scale=jnp.float32(scale), backend="oracle", **kw)
    t = [torch.as_tensor(a) for a in arrs]
    y_t = t_ops.fused_mvm(*t[:3], adc_lo=t[3], adc_hi=t[4],
                          scale=torch.tensor(scale), **kw)
    assert y_t.shape == (m, n) and y_t.dtype == torch.float32
    r = tolerance.fused_mvm_check(torch.as_tensor(np.array(y_j)), y_t, *t,
                                  torch.tensor(scale), **kw)
    assert r["ok"], r


@pytest.mark.parametrize("b,s,kv,g,hd", FLASH_GRID, ids=_ids(FLASH_GRID))
def test_plain_flash_decode_matches_jax_oracle(b, s, kv, g, hd):
    q, k, v, fills = flash_case(b, s, kv, g, hd)
    want = j_ops.flash_attention_decode(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(fills),
                                        backend="oracle")
    got = t_ops.flash_attention_decode(*(torch.as_tensor(a)
                                         for a in (q, k, v, fills)))
    assert got.shape == (b, kv * g, hd)
    r = tolerance.flash_decode_check(torch.as_tensor(np.array(want)), got,
                                     torch.as_tensor(v),
                                     torch.as_tensor(fills))
    assert r["ok"], r


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_plain_decode_attention_empty_row_matches_jax_oracle(paged):
    """A row of fill 0: every logit is the mask value, so the reference
    averages v over the capacity (the dense cache zero-padded to its
    8-position blocks; the pool's NP * page_size positions, page_size 1
    included), and so does the plain version.  Bound: the flash-decode
    bound with the capacity in place of that row's fill."""
    if paged:
        cases = [paged_case(3, 4, 2, 8, ps, 5, seed=2) for ps in (4, 1)]
    else:
        q, k, v, fills = flash_case(3, 13, 2, 2, 8, seed=1)
        cases = [(q, k, v, fills)]
    for case in cases:
        case[-1][1] = 0
        t = [torch.as_tensor(a) for a in case]
        if paged:
            got = t_ops.paged_attention(*t)
            wants = [j_ops.paged_attention(*(jnp.asarray(a) for a in case)),
                     j_ref.paged_attention_decode(*(jnp.asarray(a)
                                                    for a in case))]
            cap = case[3].shape[1] * case[1].shape[1]
        else:
            got = t_ops.flash_attention_decode(*t)
            wants = [j_ops.flash_attention_decode(
                *(jnp.asarray(a) for a in case), backend="oracle")]
            cap = case[1].shape[1]
        lens = t[-1].clone()
        lens[1] = cap
        assert float(got[1].abs().max()) > 0
        for want in wants:
            want = torch.as_tensor(np.array(want))
            r = (tolerance.paged_attention_check(want, got, t[2], t[3], lens)
                 if paged else
                 tolerance.flash_decode_check(want, got, t[2], lens))
            assert r["ok"], r


@pytest.mark.parametrize("drop", [0, tolerance.ATTN_CHUNK, 32768 // 8],
                         ids=["none", "chunk", "span"])
def test_attention_f64_check_holds_plain_and_catches_dropped_positions(drop):
    """``tolerance.attention_f64_check`` at 32768 positions (the full row of
    ``ATTN_EDGE_GRID``'s hd-64 case), where the flash-decode bound exceeds a
    typical output: the JAX oracle's and the plain version's results lie
    within it, and a result that left out one chunk of 256 positions, or
    one CTA's span of an eighth of them, has most elements outside it."""
    case = next(c for c in tolerance.ATTN_EDGE_GRID
                if c[0] == 32768 and c[3] == 64)
    q, k, v, lens = tolerance.attn_edge_case(*case, device="cpu")[:4]
    q, k, v, lens = q[-1:], k[-1:], v[-1:], lens[-1:]
    n = int(lens[0])
    assert n == 32768
    if drop:
        keep = torch.cat([torch.arange(drop), torch.arange(2 * drop, n)])
        got = t_ops.flash_attention_decode(q, k[:, keep], v[:, keep],
                                           lens - drop)
        r = tolerance.attention_f64_check(got, q, k, v, lens)
        assert r["bad"] > got.numel() // 2, r
        return
    want = j_ops.flash_attention_decode(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        jnp.asarray(lens.numpy()), backend="oracle")
    for out in (torch.as_tensor(np.array(want)),
                t_ops.flash_attention_decode(q, k, v, lens)):
        r = tolerance.attention_f64_check(out, q, k, v, lens)
        assert r["ok"], r


def test_plain_flash_decode_ignores_cache_tail():
    """Positions at or beyond kv_len contribute exact zeros."""
    q, k, v, fills = (torch.as_tensor(a) for a in flash_case(3, 16, 2, 2, 8, seed=9))
    base = t_ops.flash_attention_decode(q, k, v, fills)
    kg, vg = k.clone(), v.clone()
    for i, n in enumerate(fills.tolist()):
        kg[i, n:] = 1e9
        vg[i, n:] = -1e9
    assert torch.equal(base, t_ops.flash_attention_decode(q, kg, vg, fills))


def test_wrappers_refuse_bad_backends_and_shapes():
    x, gp, gm, lo, hi = (torch.as_tensor(a)
                         for a in fused_case(2, 1, 1, 8, 4, seed=0))
    with pytest.raises(ValueError, match="backend"):
        t_ops.fused_mvm(x, gp, gm, adc_lo=lo, adc_hi=hi, adc_bits=8,
                        cell_bits=7, n_bits=None, scale=1.0, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.fused_mvm_cuda(x, gp, gm, lo, hi, torch.tensor(1.0),
                               adc_bits=8, cell_bits=7, n_bits=None)
    q, k, v, fills = (torch.as_tensor(a) for a in flash_case(1, 8, 2, 1, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.flash_decode_cuda(q, k, v, fills)


@pytest.mark.parametrize("n_bits", [None, 7])
def test_plain_fused_mvm_is_batch_invariant(n_bits):
    """Each output row is the same bits whichever rows share the call (the
    rows are summed in a fixed order, as in the CUDA kernel), which is what
    holds ServeRuntime == decode_lm under any batching."""
    x, gp, gm, lo, hi = (torch.as_tensor(a)
                         for a in fused_case(8, 2, 2, 96, 40, seed=3))
    kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=2, n_bits=n_bits,
              scale=torch.tensor(3e-4))
    full = t_ops.fused_mvm(x, gp, gm, **kw)
    for i in range(x.shape[0]):
        assert torch.equal(t_ops.fused_mvm(x[i:i + 1], gp, gm, **kw),
                           full[i:i + 1])
    assert torch.equal(t_ops.fused_mvm(x[2:7], gp, gm, **kw), full[2:7])
