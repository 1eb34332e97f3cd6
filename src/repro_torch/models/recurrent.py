"""Linear-recurrence substrate for the SSM / RWKV blocks (counterpart of
``repro.models.recurrent``).

The shared primitive is the gated-decay state recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: (dk, dv) per head)
    y_t = r_t @ S_{t-1} + (r_t * u) . k_t * v_t  (rwkv: current-token bonus)
    y_t = r_t @ S_t                              (mamba: current included)

computed in chunks: within a chunk the pairwise decay factors are taken in
log space with non-positive exponents, across chunks ``launch.op_stats.scan``
carries the state (the reference's ``lax.scan``: a Python loop over every
chunk, which the dry-run counts from a first, a middle and a last chunk on
fake tensors).  RWKV6's per-channel decay and Mamba2's per-head scalar
decay (broadcast over dk) share the code path.  On a mesh the models call
it through ``sharding.perf.local_recurrence``, each rank on its own rows
and heads.

Every contraction of three operands is written out as explicit pairwise
products summed over the contracted axis, so its order does not depend on
``torch.einsum``'s choice of path; contractions of two operands are
matrix products.  The recurrence has no TPU kernel in the reference and
stays plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.op_stats import scan


def _bonus(r: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """The rwkv current-token term ``((r * u) . k) v``: r/k (..., H, dk),
    u (H, dk), v (..., H, dv)."""
    return ((r * u) * k).sum(-1)[..., None] * v


def chunked_decay_recurrence(
    r: torch.Tensor,               # (B, S, H, dk)
    k: torch.Tensor,               # (B, S, H, dk)
    v: torch.Tensor,               # (B, S, H, dv)
    log_w: torch.Tensor,           # (B, S, H, dk) log-decay, <= 0
    s0: Optional[torch.Tensor] = None,  # (B, H, dk, dv) initial state
    *,
    u: Optional[torch.Tensor] = None,   # (H, dk) rwkv bonus; None: mamba
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, H, dv) in ``r``'s dtype, final state (B, H, dk,
    dv) float32)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    include_current = u is None

    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        r, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, log_w))
    n_chunks = (s + pad) // chunk

    def chunks(a):
        return a.reshape(b, n_chunks, chunk, h, a.shape[-1]).to(torch.float32)

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(log_w)
    dev = r.device
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev), -1)        # strict lower
    mask = tri | torch.eye(chunk, dtype=torch.bool, device=dev) \
        if include_current else tri
    mask = mask[None, :, :, None]                        # (1, Ct, Cs, 1)
    uf = None if u is None else u.to(torch.float32)

    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev) \
        if s0 is None else s0

    def body(state, xs, consts):
        rj, kj, vj, lwj = xs
        uf, = consts
        le = torch.cumsum(lwj, dim=1)                    # inclusive
        le_q = le if include_current else le - lwj       # queries' reference
        # pairwise decay W_t(ref) / W_s = exp(le_q_t - le_s) <= 1 for s <= t
        diff = le_q[:, :, None] - le[:, None]            # (B, Ct, Cs, H, dk)
        decay = torch.exp(torch.clamp(diff, max=0.0))
        a = ((rj[:, :, None] * kj[:, None]) * decay).sum(-1)   # (B,Ct,Cs,H)
        a = a * mask
        y = torch.einsum("btsh,bshv->bthv", a, vj)
        if uf is not None:
            y = y + _bonus(rj, uf, kj, vj)
        # carry-in: r_t decayed to the chunk's start
        y = y + torch.einsum("bthd,bhdv->bthv", rj * torch.exp(le_q), state)
        # state at the chunk's end: token s enters decayed by exp(le_end -
        # le_s), exclusive of step s itself
        le_end = le[:, -1:]                              # (B, 1, H, dk)
        k_dec = kj * torch.exp(le_end - le)
        state = state * torch.exp(le_end[:, 0, :, :, None]) \
            + torch.einsum("bshd,bshv->bhdv", k_dec, vj)
        return state, y

    state, y = scan(body, state, (rc, kc, vc, lwc), (uf,))
    y = y[:, :s]
    return y.to(r.dtype), state


def _step(rt, kt, vt, wt, state, uf):
    kv = kt[..., :, None] * vt[..., None, :]             # (B, H, dk, dv)
    if uf is None:
        new = state * wt[..., None] + kv
        y = torch.einsum("bhd,bhdv->bhv", rt, new)
    else:
        y = torch.einsum("bhd,bhdv->bhv", rt, state) + _bonus(rt, uf, kt, vt)
        new = state * wt[..., None] + kv
    return y, new


def decay_recurrence_naive(r, k, v, log_w, *, u=None, s0=None):
    """Step-by-step plain version (the tests' oracle): returns (y in
    ``r``'s dtype, final float32 state)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                        device=r.device) if s0 is None else s0
    rf, kf, vf = (a.to(torch.float32) for a in (r, k, v))
    wf = torch.exp(log_w.to(torch.float32))
    uf = None if u is None else u.to(torch.float32)
    ys = []
    for t in range(s):
        y, state = _step(rf[:, t], kf[:, t], vf[:, t], wf[:, t], state, uf)
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), state


def decay_step(r, k, v, log_w, state, *, u=None):
    """One decode step.  r/k/v: (B, H, dk|dv); state (B, H, dk, dv)."""
    rf, kf, vf = (a.to(torch.float32) for a in (r, k, v))
    w = torch.exp(log_w.to(torch.float32))
    uf = None if u is None else u.to(torch.float32)
    y, new = _step(rf, kf, vf, w, state, uf)
    return y.to(r.dtype), new
