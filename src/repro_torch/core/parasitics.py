"""Bit-line parasitic resistance model (paper Sec. 8, Fig. 19); counterpart
of ``repro.core.parasitics``.

Every cell is a linear resistor of normalized conductance ``g`` from the
supply to its bit-line node, gated by the input bit; adjacent nodes are
separated by the normalized parasitic resistance ``r = R_p * G_max`` and the
bottom node is held at virtual ground.  KCL at node ``i`` (0 = top)::

    (v_{i-1} - v_i)/r * [i>0] + (v_{i+1} - v_i)/r + a_i g_i (s_i - v_i) = 0

with ``a_i = |x_i|`` the gate bit and ``s_i = x_i`` the signed source.  The
system is tridiagonal; the column current is the current through the
bottom segment, ``I = v_{K-1} / r``, which only needs the Thomas forward
sweep (``d'_{K-1}`` *is* ``v_{K-1}``).  In the limit ``r -> 0`` it reduces
to ``I = sum_i x_i g_i``.

The reference builds the (M, K, N) coefficient arrays before its scan; at
a full-width lm_head that is tens of GB per plane.  Here each row's
coefficients are formed inside the row loop, and the sweep runs over
column chunks when the systems would not fit in :data:`MAX_ELEMS` floats.
The per-element arithmetic is the reference's, and every product that
feeds an add is exact (``a`` in {0, 1}, ``x`` in {-1, 0, +1}), so the
sweep does not depend on whether a compiler contracts it into FMAs:
``grr = g*r``, ``gr = a*grr``, ``rhs = x*grr``, ``denom = (base + gr) +
c'``, ``c' = -1/denom``, ``d' = (rhs + d')/denom``, ``I = d'_{K-1} / r``.
``r`` is a float32 tensor: PyTorch's CUDA kernels divide by a Python
scalar as a multiply by its reciprocal.
"""

from __future__ import annotations

import torch

#: most floats one sweep keeps per temporary before it chunks over columns
MAX_ELEMS = 1 << 26


def parasitics_off(r_hat) -> bool:
    """True iff ``r_hat`` is a zero in any scalar form (Python number,
    numpy scalar, 0-d tensor): the ideal-matmul short-circuit, since the
    sweep at ``r = 0`` divides by zero."""
    try:
        return float(r_hat) == 0.0
    except TypeError:
        return False


def _as_r(r_hat, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(r_hat, dtype=torch.float32).to(like.device) \
        .reshape(())


def bottom_current(plane: torch.Tensor, g: torch.Tensor,
                   r_hat) -> torch.Tensor:
    """Bottom-node currents of signed planes through line stacks: ``plane``
    (..., M, K) and ``g`` (..., K, N) with broadcastable leading dimensions
    give (..., M, N) float32.  The Thomas forward sweep over the K rows, in
    the reference's arithmetic (see the module docstring)."""
    plane = plane.to(torch.float32)
    g = g.to(torch.float32)
    r = _as_r(r_hat, g)
    k, n = g.shape[-2], g.shape[-1]
    lead = torch.broadcast_shapes(plane.shape[:-2], g.shape[:-2])
    m = plane.shape[-2]
    per_col = max(1, m * int(torch.Size(lead).numel()))
    step = max(1, min(n, MAX_ELEMS // per_col))
    if step < n:
        return torch.cat([bottom_current(plane, g[..., j:j + step], r)
                          for j in range(0, n, step)], dim=-1)
    a = plane.abs()
    neg_one = torch.full((), -1.0, dtype=torch.float32, device=g.device)
    c = torch.zeros(lead + (m, n), dtype=torch.float32, device=g.device)
    d = torch.zeros_like(c)
    for i in range(k):
        grr = g[..., i:i + 1, :] * r                        # (..., 1, N)
        denom = (a[..., :, i:i + 1] * grr).add_(1.0 if i == 0 else 2.0) \
            .add_(c)
        c = torch.div(neg_one, denom)
        d = (plane[..., :, i:i + 1] * grr).add_(d).div_(denom)
    return d / r


def bitline_currents(g: torch.Tensor, x: torch.Tensor, r_hat) -> torch.Tensor:
    """Output currents (M, N) of the N bit lines of ``g`` (K, N) driven by
    the signed plane ``x`` (M, K) under parasitic resistance ``r_hat``; a
    zero ``r_hat`` is the ideal ``x @ g``."""
    if parasitics_off(r_hat):
        return x @ g
    return bottom_current(x, g, r_hat)


def bitline_voltages_dense(g_col: torch.Tensor, x: torch.Tensor,
                           r_hat: float) -> torch.Tensor:
    """Node voltages (K,) of one column by a dense solve (test oracle)."""
    k = g_col.shape[0]
    gr = x.abs() * g_col * r_hat
    diag = 2.0 + gr
    diag[0] = 1.0 + gr[0]
    ones = torch.ones(k - 1, dtype=g_col.dtype, device=g_col.device)
    mat = torch.diag(diag) - torch.diag(ones, 1) - torch.diag(ones, -1)
    return torch.linalg.solve(mat, x * g_col * r_hat)


def injected_current(g_col: torch.Tensor, x: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Sum of cell currents given node voltages (Kirchhoff check)."""
    return torch.sum(x.abs() * g_col * (torch.sign(x) - v) * (x.abs() > 0))
