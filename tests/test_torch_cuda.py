"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is ``cuda``-marked and skips without a CUDA device;
on a machine with one (and nvcc) run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports torch and the port only, so it runs where JAX is not
installed.  Bounds (``repro_torch.kernels.tolerance``): the fused MVM
within 2 ulp or 0.25 of a dequant grid step, one-code ADC flips only where
the pre-ADC value lies within 4 ulp of a rounding edge; flash decode within
``4 ulp + kv_len * eps * max|v|``.  The grids (``tolerance.FUSED_GRID``,
``tolerance.FLASH_GRID``) are those of ``tests/test_kernels.py``, shared with
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import pytest
import torch

from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tolerance
from repro_torch.kernels.tolerance import (FLASH_GRID, FUSED_GRID, flash_case,
                                           fused_case)


def _ids(grid):
    return ["-".join(str(a) for a in case) for case in grid]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for "
                    "sm_90a and run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,s,rows,n,n_bits,cell_bits", FUSED_GRID,
                         ids=_ids(FUSED_GRID))
def test_fused_mvm_kernel_matches_plain(cuda_device, m, p, s, rows, n, n_bits,
                                        cell_bits):
    t = [torch.as_tensor(a, device=cuda_device)
         for a in fused_case(m, p, s, rows, n)]
    kw = dict(adc_lo=t[3], adc_hi=t[4], adc_bits=8, cell_bits=cell_bits,
              n_bits=n_bits, scale=torch.tensor(3e-4, device=cuda_device))
    before = t_fused.LAUNCHES["fused_mvm"]
    y = t_ops.fused_mvm(*t[:3], backend="kernel", **kw)
    y_ref = t_ops.fused_mvm(*t[:3], backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["fused_mvm"] == before + 1
    r = tolerance.fused_mvm_check(y, y_ref, *t, kw["scale"], adc_bits=8,
                                  cell_bits=cell_bits, n_bits=n_bits)
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,kv,g,hd", FLASH_GRID, ids=_ids(FLASH_GRID))
def test_flash_decode_kernel_matches_plain(cuda_device, b, s, kv, g, hd,
                                           dtype):
    q, k, v, fills = (torch.as_tensor(a, device=cuda_device)
                      for a in flash_case(b, s, kv, g, hd))
    k, v = k.to(getattr(torch, dtype)), v.to(getattr(torch, dtype))
    before = t_fused.LAUNCHES["flash_decode"]
    out = t_ops.flash_attention_decode(q, k, v, fills, backend="kernel")
    ref = t_ops.flash_attention_decode(q, k, v, fills, backend="oracle")
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["flash_decode"] == before + 1
    r = tolerance.flash_decode_check(out, ref, v, fills)
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits", [None, 7])
def test_fused_mvm_kernel_is_batch_invariant(cuda_device, n_bits):
    """Each output row is the same bits whichever rows share the launch,
    across the kernel's row tiles (M = 40 spans three 16-row tiles)."""
    x, gp, gm, lo, hi = (torch.as_tensor(a, device=cuda_device)
                         for a in fused_case(40, 2, 2, 96, 70, seed=3))
    kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=2, n_bits=n_bits,
              scale=torch.tensor(3e-4, device=cuda_device), backend="kernel")
    full = t_ops.fused_mvm(x, gp, gm, **kw)
    for i in (0, 15, 16, 39):
        assert torch.equal(t_ops.fused_mvm(x[i:i + 1], gp, gm, **kw),
                           full[i:i + 1])
    assert torch.equal(t_ops.fused_mvm(x[5:21], gp, gm, **kw), full[5:21])
