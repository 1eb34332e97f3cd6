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
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tolerance
from repro_torch.kernels.tolerance import (FLASH_GRID, FUSED_GRID, flash_case,
                                           fused_case)
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
