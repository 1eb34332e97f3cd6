"""Plain forward passes of the two model families the cells run, with
every weight-stationary projection and the lm_head through the arrays of
:mod:`reference.analog`, and greedy decoding.

* ``dense``: a pre-norm decoder.  RMS norm (eps 1e-6, gain ``1 +
  scale``), q/k/v projections with bias, rotary embedding (rotate-half,
  ``theta``), causal softmax attention, output projection; a SwiGLU MLP.
* ``rwkv``: RWKV-6 (Finch).  Token shift with static mixes; r, k, v, g
  projections; decay ``exp(-exp(clamp(w_base + tanh(x W_a) W_b, -8,
  2)))`` from a digital low-rank MLP; the recurrence ``y_t = r_t S +
  ((r_t u) . k_t) v_t``, ``S <- diag(w_t) S + k_t v_t^T`` per head;
  group norm per head (eps 64e-5), SiLU gate, output projection; channel
  mix ``sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)``.

Activations are in the configuration's dtype; norms, attention, the
recurrence and the arrays compute in float32.  Layers may carry a state
(keys and values seen, or the recurrent state and the shifts), so decode
feeds one token at a time.

The analog sites are named as the port names its hooks, since a site's
name seeds its programming noise (``analog.site_seed``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference import analog as A

#: analog sites per family: (parameter group, leaf, site name)
SITES = {
    "dense": (("attn", "wq", "wq"), ("attn", "wk", "wk"), ("attn", "wv", "wv"),
              ("attn", "wo", "wo"), ("mlp", "w_gate", "w_gate"),
              ("mlp", "w_up", "w_up"), ("mlp", "w_down", "w_down")),
    "rwkv": tuple(("rwkv", leaf, "rwkv_" + leaf) for leaf in
                  ("wr", "wk", "wv", "wg", "wo", "ck", "cv", "cr")),
}
HEAD = "head"
NEG_INF = -1e30
LORA = 64                        # width of RWKV-6's decay MLP


@dataclasses.dataclass(frozen=True)
class Config:
    """A configuration file's ``model`` object, as far as the reference
    reads it."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    rwkv: bool = False
    dtype: str = "bfloat16"
    head_dim: Optional[int] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kind(self) -> str:
        return "rwkv" if self.rwkv else "dense"

    @property
    def dt(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def config(model: Dict) -> Config:
    """The Config of a configuration file's ``model`` object; refuses a
    key the reference does not model."""
    names = {f.name for f in dataclasses.fields(Config)}
    unknown = set(model) - names
    if unknown:
        raise ValueError(f"the reference does not model {sorted(unknown)}")
    cfg = Config(**model)
    if cfg.norm != "rmsnorm" or (not cfg.rwkv and cfg.act != "swiglu"):
        raise ValueError("the reference models RMS norm and SwiGLU only")
    return cfg


# ---------------------------------------------------------------------------
# weights: the benchmark's, handed to the port and the reference alike
# ---------------------------------------------------------------------------

def _leaves(cfg: Config):
    """(group, leaf, shape, how) of every parameter: ``how`` is a float,
    the scale of a standard normal draw, or ("fill", value)."""
    d, l, v, ff = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.d_ff
    out = [(None, "embed", (v, d), d ** -0.5)]
    if not cfg.tie_embeddings:
        out.append((None, "lm_head", (d, v), d ** -0.5))
    out.append(("final_norm", "scale", (d,), ("fill", 0.0)))
    for n in ("norm1", "norm2"):
        out.append((n, "scale", (l, d), ("fill", 0.0)))
    if cfg.rwkv:
        h = cfg.n_heads
        hd = d // h
        g = "rwkv"
        out += [(g, leaf, (l, d, d), d ** -0.5)
                for leaf in ("wr", "wk", "wv", "wg", "wo", "cr")]
        out += [(g, "ck", (l, d, ff), d ** -0.5),
                (g, "cv", (l, ff, d), ff ** -0.5),
                (g, "w_lora_a", (l, d, LORA), d ** -0.5),
                (g, "w_lora_b", (l, LORA, d), LORA ** -0.5),
                (g, "u", (l, h, hd), 0.3),
                (g, "mix", (l, 5, d), ("fill", 0.5)),
                (g, "cmix", (l, 2, d), ("fill", 0.5)),
                (g, "w_base", (l, d), ("fill", -6.0)),
                (g, "ln_x_scale", (l, d), ("fill", 1.0)),
                (g, "ln_x_bias", (l, d), ("fill", 0.0))]
        return out
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    out += [("attn", "wq", (l, d, hq), d ** -0.5),
            ("attn", "wk", (l, d, hkv), d ** -0.5),
            ("attn", "wv", (l, d, hkv), d ** -0.5),
            ("attn", "wo", (l, hq, d), hq ** -0.5),
            ("mlp", "w_gate", (l, d, ff), d ** -0.5),
            ("mlp", "w_up", (l, d, ff), d ** -0.5),
            ("mlp", "w_down", (l, ff, d), ff ** -0.5)]
    if cfg.qkv_bias:
        out += [("attn", "b" + x, (l, n), ("fill", 0.0))
                for x, n in (("q", hq), ("k", hkv), ("v", hkv))]
    return out


def init_params(cfg: Config, seed: int, device) -> dict:
    """float32 weights from ``seed``: one standard normal draw on
    ``device`` for every random leaf, cut into the leaves and scaled in
    place.  The tree is laid out as the port reads it: ``embed`` (V, d),
    ``lm_head`` (d, V), layer leaves stacked over a leading layer axis,
    projections as (in, out)."""
    leaves = _leaves(cfg)
    n = sum(torch.Size(s).numel() for *_, s, how in leaves
            if not isinstance(how, tuple))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    p: Dict[str, object] = {"layers": {}}
    at = 0
    for group, leaf, shape, how in leaves:
        if isinstance(how, tuple):
            t = torch.full(shape, how[1], dtype=torch.float32, device=device)
        else:
            k = torch.Size(shape).numel()
            t = flat[at:at + k].view(shape).mul_(how)
            at += k
        if group is None:
            p[leaf] = t
        elif group == "final_norm":
            p.setdefault(group, {})[leaf] = t
        else:
            p["layers"].setdefault(group, {})[leaf] = t
    return p


def head_weight(cfg: Config, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def analog_weight_count(cfg: Config, params: dict) -> int:
    """Weights on arrays: every site of every layer, and the lm_head."""
    n = sum(params["layers"][g][leaf].numel() for g, leaf, _ in
            SITES[cfg.kind])
    return n + head_weight(cfg, params).numel()


# ---------------------------------------------------------------------------
# the programmed model
# ---------------------------------------------------------------------------

class Analog:
    """A model's projections programmed onto arrays, with their clips and
    ADC limits once calibrated.

    ``mode`` is ``"clip"`` (the first calibration pass: inputs quantized
    against their own max, the ADC bypassed, each input's L1-optimal clip
    recorded), ``"range"`` (the second: the clips installed, each array's
    pre-ADC range recorded) or ``"serve"``."""

    def __init__(self, cfg: Config, params: dict, d: A.Design, seed: int,
                 lower: bool = False):
        self.cfg, self.d, self.lower = cfg, d, lower
        self.arrays: Dict[Tuple[str, int], A.Array] = {}
        for group, leaf, name in SITES[cfg.kind]:
            s = A.site_seed(seed, name)
            for i, w in enumerate(params["layers"][group][leaf]):
                self.arrays[name, i] = A.program(w, d, A.fold(s, i))
        self.arrays[HEAD, 0] = A.program(head_weight(cfg, params), d,
                                         A.site_seed(seed, HEAD))
        self.clip: Dict[Tuple[str, int], torch.Tensor] = {}
        self.range: Dict[Tuple[str, int], Tuple[torch.Tensor,
                                                torch.Tensor]] = {}
        self.mode = "serve"

    def __call__(self, x: torch.Tensor, key: Tuple[str, int]) -> torch.Tensor:
        arr = self.arrays[key]
        if self.mode == "serve":
            lo, hi = self.range[key]
            return A.matmul(x, arr, self.d, clip=self.clip[key], lo=lo,
                            hi=hi, lower=self.lower)
        clip = self.clip.get(key) if self.mode == "range" else None
        y, v = A.matmul(x, arr, self.d, clip=clip, lower=self.lower)
        if self.mode == "clip":
            self.clip[key] = A.act_clip(x, self.d.input_bits)
        else:
            self.range[key] = A.adc_range(v)
        return y

    def calibrate(self, params: dict, tokens: torch.Tensor) -> None:
        """The two calibration passes over ``tokens``; the head's clip and
        range come from the second pass's final hiddens."""
        self.mode = "clip"
        forward(self.cfg, params, tokens, self, head=False)
        self.mode = "range"
        _, hidden, _ = forward(self.cfg, params, tokens, self, head=False)
        key = (HEAD, 0)
        self.clip[key] = A.act_clip(hidden, self.d.input_bits)
        self(hidden, key)
        self.mode = "serve"


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(x.dtype).float())).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated by positions ``pos`` (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    i = torch.arange(hd, device=x.device) % half
    freqs = theta ** (-i.float() / half)
    ang = pos.float()[:, None] * freqs                       # (S, hd)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


Mm = Callable[[torch.Tensor, torch.Tensor, str, int], torch.Tensor]


def digital(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activations' dtype, over the flattened rows."""
    y = x.reshape(-1, x.shape[-1]) @ w.to(x.dtype)
    return y.reshape(*x.shape[:-1], -1)


def _mm(analog: Optional[Analog]) -> Mm:
    """``x @ w`` of site ``name`` at layer ``i``: through the arrays when
    ``analog`` is given, else digitally."""
    def mm(x, w, name, i):
        if analog is None:
            return digital(x, w)
        return analog(x, (name, i)).to(x.dtype)
    return mm


def _attention(cfg, p, x, i, mm, pos0: int, cache):
    """Attention of ``x``'s positions ``pos0 + [0, S)``; ``cache`` (keys,
    values), each (B, S_max, KV, hd), holds the earlier positions and
    takes these.  Softmax as ``exp(s - max) / sum`` over the visible
    keys, masked ones at -1e30."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype

    def proj(w, name, bias):
        y = mm(x, p[w][i], name, i)
        return y if bias not in p else y + p[bias][i].to(dt)

    pos = torch.arange(pos0, pos0 + s, device=x.device)
    q = rope(proj("wq", "wq", "bq").view(b, s, h, hd), pos, cfg.rope_theta)
    k = rope(proj("wk", "wk", "bk").view(b, s, kv, hd), pos, cfg.rope_theta)
    v = proj("wv", "wv", "bv").view(b, s, kv, hd)
    if cache is not None:
        cache[0][:, pos0:pos0 + s] = k
        cache[1][:, pos0:pos0 + s] = v
        k, v = cache
    qg = q.reshape(b, s, kv, h // kv, hd).float() * hd ** -0.5
    sc = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float())
    k_pos = torch.arange(k.shape[1], device=x.device)
    sc = sc.masked_fill(k_pos[None, :] > pos[:, None], NEG_INF)
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bkgqc,bckd->bkgqd", e, v.float())
    out = (acc / e.sum(dim=-1)[..., None]).permute(0, 3, 1, 2, 4)
    out = mm(out.reshape(b, s, h * hd).to(dt), p["wo"][i], "wo", i)
    return out, cache


def _dense_layer(cfg, params, x, i, mm, pos0, state):
    L = params["layers"]
    h, kv = _attention(cfg, L["attn"], rms_norm(x, L["norm1"]["scale"][i]),
                       i, mm, pos0, state)
    x = x + h
    y = rms_norm(x, L["norm2"]["scale"][i])
    p = L["mlp"]
    g = F.silu(mm(y, p["w_gate"][i], "w_gate", i))
    u = mm(y, p["w_up"][i], "w_up", i)
    return x + mm(g * u, p["w_down"][i], "w_down", i), kv


def _shift(x, prev):
    """x_{t-1} for every position, ``prev`` (B, 1, d) before the first."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1), x[:, -1:]


def _wkv_step(r, k, v, w, u, st):
    """One token of the recurrence: ``y = r S + ((r u) . k) v``, then
    ``S <- diag(w) S + k v^T``; r, k, v, w (B, H, hd), S (B, H, hd, hd)."""
    y = torch.einsum("bhd,bhdv->bhv", r, st) \
        + ((r * u) * k).sum(-1)[..., None] * v
    return y, st * w[..., None] + k[..., :, None] * v[..., None, :]


def _wkv_chunked(r, k, v, log_w, u, chunk: int = 32):
    """The recurrence over a prompt from a zero state, in its chunk form:
    within a chunk, token s reaches token t > s through the decay
    ``exp(L_{t-1} - L_s)`` (L the running sum of the log-decays), plus the
    current token's bonus; the state carries from chunk to chunk.  The
    same numbers as the token-by-token form, up to rounding; this is the
    order of operations the model's prompt pass takes.  (B, S, H, hd)
    float32 inputs; returns y (B, S, H, hd) and the final state."""
    b, s, h, dk = r.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        r, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, log_w))
    n = (s + pad) // chunk
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), -1)[None, :, :, None]
    st = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                     device=r.device)
    ys = []
    for j in range(n):
        rj, kj, vj, lw = (a[:, j * chunk:(j + 1) * chunk].float()
                          for a in (r, k, v, log_w))
        le = torch.cumsum(lw, dim=1)
        le_q = le - lw
        decay = torch.exp(torch.clamp(le_q[:, :, None] - le[:, None],
                                      max=0.0))
        a = ((rj[:, :, None] * kj[:, None]) * decay).sum(-1) * mask
        y = torch.einsum("btsh,bshv->bthv", a, vj)
        y = y + ((rj * u) * kj).sum(-1)[..., None] * vj
        y = y + torch.einsum("bthd,bhdv->bthv", rj * torch.exp(le_q), st)
        le_end = le[:, -1:]
        k_dec = kj * torch.exp(le_end - le)
        st = st * torch.exp(le_end[:, 0, :, :, None]) \
            + torch.einsum("bshd,bshv->bhdv", k_dec, vj)
        ys.append(y)
    return torch.cat(ys, 1)[:, :s], st


def _rwkv_layer(cfg, params, x, i, mm, pos0, state):
    L = params["layers"]
    p = L["rwkv"]
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    dt = x.dtype
    wkv, sh_t, sh_c = (None, None, None) if state is None else state

    # time mix
    xn = rms_norm(x, L["norm1"]["scale"][i])
    xs, last_t = _shift(xn, sh_t)
    mixes = p["mix"][i].to(dt)

    def mix(j):
        return xn * mixes[j] + xs * (1.0 - mixes[j])

    r = mm(mix(0), p["wr"][i], "rwkv_wr", i).view(b, s, h, hd).float()
    k = mm(mix(1), p["wk"][i], "rwkv_wk", i).view(b, s, h, hd).float()
    v = mm(mix(2), p["wv"][i], "rwkv_wv", i).view(b, s, h, hd).float()
    g = mm(mix(3), p["wg"][i], "rwkv_wg", i)
    lora = digital(torch.tanh(digital(mix(4), p["w_lora_a"][i])),
                   p["w_lora_b"][i])
    log_w = -torch.exp(torch.clamp(
        p["w_base"][i].float() + lora.float(), -8.0, 2.0)).view(b, s, h, hd)
    u = p["u"][i].float()
    if wkv is None:
        y, st = _wkv_chunked(r, k, v, log_w, u)
    else:
        y, st = _wkv_step(r[:, 0], k[:, 0], v[:, 0], torch.exp(log_w[:, 0]),
                          u, wkv)
        y = y[:, None]
    y = y.to(dt).float()                                     # (B, S, H, hd)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d).to(dt)
    y = y * p["ln_x_scale"][i].to(dt) + p["ln_x_bias"][i].to(dt)
    x = x + mm(y * F.silu(g), p["wo"][i], "rwkv_wo", i)

    # channel mix
    xn = rms_norm(x, L["norm2"]["scale"][i])
    xs, last_c = _shift(xn, sh_c)
    cm = p["cmix"][i].to(dt)
    xk = xn * cm[0] + xs * (1.0 - cm[0])
    xr = xn * cm[1] + xs * (1.0 - cm[1])
    kk = torch.square(F.relu(mm(xk, p["ck"][i], "rwkv_ck", i)))
    rr = torch.sigmoid(mm(xr, p["cr"][i], "rwkv_cr", i))
    x = x + rr * mm(kk, p["cv"][i], "rwkv_cv", i)
    return x, (st, last_t, last_c)


def forward(cfg: Config, params: dict, tokens: torch.Tensor,
            analog: Optional[Analog] = None, *, state=None, pos0: int = 0,
            head: bool = True, last: bool = False):
    """(float32 logits or None, final-norm hiddens, new state) of
    ``tokens`` (B, S) after ``pos0`` earlier positions held in
    ``state``.  ``last`` takes the logits of the last position only."""
    mm = _mm(analog)
    layer = _rwkv_layer if cfg.rwkv else _dense_layer
    x = params["embed"][tokens].to(cfg.dt)
    new: List[object] = []
    for i in range(cfg.n_layers):
        x, st = layer(cfg, params, x, i, mm, pos0,
                      None if state is None else state[i])
        new.append(st)
    hidden = rms_norm(x, params["final_norm"]["scale"])
    if not head:
        return None, hidden, new
    if last:
        hidden = hidden[:, -1:]
    if analog is None:
        logits = mm(hidden, head_weight(cfg, params), HEAD, 0)
    else:
        logits = analog(hidden, (HEAD, 0))
    return logits.float(), hidden, new


def greedy(cfg: Config, params: dict, prompts: torch.Tensor, n_new: int,
           analog: Optional[Analog] = None) -> torch.Tensor:
    """(B, n_new) greedy tokens after ``prompts`` (B, S), one token a
    step over the layers' state: for attention, key and value caches of
    every position the decode reaches."""
    b, s = prompts.shape
    state = None
    if not cfg.rwkv:
        shape = (b, s + n_new - 1, cfg.n_kv_heads, cfg.hd)
        state = [tuple(torch.zeros(shape, dtype=cfg.dt,
                                   device=prompts.device) for _ in range(2))
                 for _ in range(cfg.n_layers)]
    logits, _, state = forward(cfg, params, prompts, analog, state=state,
                               last=True)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    for j in range(n_new - 1):
        logits, _, state = forward(cfg, params, tok[:, None], analog,
                                   state=state, pos0=s + j, last=True)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1)


def eval_metrics(cfg: Config, params: dict, analog: Analog,
                 tokens: torch.Tensor, targets: torch.Tensor
                 ) -> Dict[str, float]:
    """Teacher-forced mean cross-entropy and top-1 accuracy."""
    logits, _, _ = forward(cfg, params, tokens, analog)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = (torch.logsumexp(logits, dim=-1) - gold).mean()
    top1 = (torch.argmax(logits, dim=-1) == targets).float().mean()
    return {"loss": float(loss), "top1": float(top1)}
