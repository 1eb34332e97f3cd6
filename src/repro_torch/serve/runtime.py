"""Continuous-batching serving runtime over the programmed analog LM
(counterpart of ``repro.serve.runtime``).

A slot-based scheduler in the style of iteration-level batching:

* a fixed ``max_slots`` decode batch runs one ``decode_step`` over the
  whole slot state per scheduler step;
* requests with variable-length prompts queue up and are admitted into
  free slots through a bucketed ragged prefill
  (``transformer.prefill_ragged`` + ``cache_slot_insert``), prompt
  buckets and admission-group sizes rounded to powers of two;
* each slot carries its own KV fill, stop condition (EOS or
  ``max_new_tokens``) and sampling key;
* every matmul serves through the :class:`AnalogPack` when one is given.

The contract, as in the reference: scheduling never changes what the
model says — greedy streams equal per-request ``decode_lm`` token for
token.  The fused MVM kernel sums every output in a fixed order whatever
the batch, which is what lets that hold on the card.

Sampling keys fold from a stable hash of the request uid
(:func:`request_key`), never from admission order.  ``torch`` has no
splittable counter-based generator, so :func:`sample_tokens` draws its
Gumbel noise from a counter hash of (key, vocabulary index) on the
device: streams are reproducible per key and differ from the reference's
``jax.random`` streams.

``gang=True`` degrades the scheduler to static batching (the baseline).
With a ``manager`` (``repro_torch.serve.health.PackManager``) the runtime
owns a pack's device state over time: under a ``clock`` the served pack
ages as decode steps accumulate, and under a ``heal`` policy the runtime
probes its own health and heals itself (band-by-band reprogramming and
recalibration), swapping the new pack in between decode steps while
in-flight requests keep serving.

The paged runtime (``serve.paged.PagedServeRuntime``) overrides the
reference's hooks: :meth:`ServeRuntime._init_layers` (the KV layout),
:meth:`ServeRuntime._reserve` (admission resources of the queue head),
:meth:`ServeRuntime._group_key` (prefill groups, dispatched in ascending
key order), :meth:`ServeRuntime._prefill_group`,
:meth:`ServeRuntime._decode_model` (the model half of a decode step) and
:meth:`ServeRuntime._free_slot`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import NEG_INF
from repro_torch.models.registry import families_with, get_model
from repro_torch.models.transformer import AnalogPack
from repro_torch.runtime.fault import resilient_step
from repro_torch.serve.health import HEAD_BAND

_MASK32 = 0xFFFFFFFF
_MASK63 = 0x7FFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Per-token sampling policy applied identically to every slot.
    ``greedy`` ignores keys (the configuration the runtime-vs-
    ``decode_lm`` contract is pinned in)."""

    kind: str = "greedy"                 # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        kinds = ("greedy", "temperature", "top_k")
        if self.kind not in kinds:
            raise ValueError(
                f"unknown sampler kind {self.kind!r}; choose from {kinds}")
        if self.temperature <= 0.0:
            raise ValueError(f"temperature must be > 0, got {self.temperature}")
        if self.kind == "top_k" and self.top_k < 1:
            raise ValueError(f"top_k sampling needs top_k >= 1, got {self.top_k}")


def request_key(seed: int, uid) -> int:
    """A request's sampling key: the same stable fold as
    ``analog_engine.hook_key``, applied to ``str(uid)``."""
    from repro_torch.serve.analog_engine import hook_key

    return hook_key(seed, str(uid))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer mixer on int64 tensors holding values < 2**32 (the
    multipliers are below 2**31, so no product overflows)."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _MASK32
    return x ^ (x >> 16)


def _uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) uniforms in (0, 1) from per-row int64 keys."""
    idx = torch.arange(n, device=keys.device, dtype=torch.int64)[None, :]
    lo, hi = (keys & _MASK32)[:, None], (keys >> 32)[:, None]
    h = _mix32(_mix32(idx ^ lo) ^ hi)
    return ((h >> 8).to(torch.float64) + 0.5) / float(1 << 24)


def _advance(keys: torch.Tensor) -> torch.Tensor:
    lo = _mix32((keys & _MASK32) ^ 0x9E3779B9)
    hi = _mix32(((keys >> 32) + 1) & _MASK32)
    return ((hi << 32) | lo) & _MASK63


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  sampler: SamplerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token per row: (B, V) logits + (B,) int64 keys -> ((B,) tokens,
    advanced keys).  Greedy leaves keys untouched."""
    if sampler.kind == "greedy":
        return torch.argmax(logits, dim=-1), keys
    lg = logits.to(torch.float32) / sampler.temperature
    if sampler.kind == "top_k":
        kth = torch.topk(lg, sampler.top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    gumbel = -torch.log(-torch.log(_uniform(keys, lg.shape[-1])))
    return torch.argmax(lg.double() + gumbel, dim=-1), _advance(keys)


# ---------------------------------------------------------------------------
# slot state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotState:
    """The whole scheduler state: the slot cache and per-slot vectors."""

    layers: Any            # slot-batched cache tree, leaves (L, B, S_max, ...)
    length: torch.Tensor   # (B,)  per-slot KV fill
    tok: torch.Tensor      # (B,)  last sampled token (next decode input)
    active: torch.Tensor   # (B,)  bool: slot holds a live request
    emitted: torch.Tensor  # (B,)  tokens generated so far
    max_new: torch.Tensor  # (B,)  per-request generation budget
    out: torch.Tensor      # (B, cap) generated-token buffer
    key: torch.Tensor      # (B,)  per-slot sampling key (int64)


@dataclasses.dataclass
class _Pending:
    uid: Any
    prompt: np.ndarray
    max_new: int
    submit_t: float
    ttft_s: Optional[float] = None
    # decode-step count at which this request retires (exact when EOS
    # stopping is off), so _collect can skip device syncs
    done_step: int = 0


@dataclasses.dataclass(frozen=True)
class Completion:
    """One finished request plus scheduling telemetry."""

    uid: Any
    tokens: np.ndarray          # (n_generated,) int32
    prompt_len: int
    ttft_s: float


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ServeRuntime:
    """Slot-scheduled continuous-batching server over one (cfg, params[,
    pack]); the slot cache lives on the parameters' device.

    ``attn_backend``: ``"stream"`` (online-softmax attention),
    ``"flash"`` (the flash-decode CUDA kernel over the dense slot cache)
    or ``"flash_oracle"`` (its plain PyTorch version).  Prefill always
    streams.  ``manager`` (a ``PackManager``, exclusive with ``pack``),
    ``clock`` (a ``DriftClock``) and ``heal`` (a ``HealPolicy``) manage the
    served pack's device state; ``clock`` and ``heal`` need ``manager``.
    Other parameters are the reference's.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        pack: Optional[AnalogPack] = None,
        max_slots: int = 8,
        max_len: int = 64,
        buckets: Optional[Sequence[int]] = None,
        sampler: SamplerConfig = SamplerConfig(),
        eos_id: Optional[int] = None,
        seed: int = 0,
        gang: bool = False,
        measure_ttft: bool = False,
        attn_backend: str = "stream",
        manager=None,
        clock=None,
        heal=None,
    ):
        api = get_model(cfg)
        if attn_backend not in ("stream", "flash", "flash_oracle"):
            raise ValueError(f"unknown attn_backend {attn_backend!r}")
        if attn_backend != "stream" and cfg.sliding_window is not None:
            raise ValueError(
                "the flash-decode kernel has no sliding-window mask; "
                "serve windowed configs with attn_backend='stream'")
        if manager is not None and pack is not None:
            raise ValueError(
                "pass either pack= (a static AnalogPack) or manager= (a "
                "PackManager owning the pack's device state), not both")
        if (clock is not None or heal is not None) and manager is None:
            raise ValueError(
                "clock=/heal= need a manager= (repro_torch.serve.health."
                "PackManager) to derive aged packs and reprogram bands")
        self._manager, self._clock, self._heal = manager, clock, heal
        if manager is not None:
            pack = manager.aged(clock.at(0) if clock is not None else 1.0)
        if api.prefill_ragged is None or api.cache_slot_insert is None:
            raise ValueError(
                f"family {cfg.family!r} has no continuous-batching support "
                f"(needs ModelApi.prefill_ragged + cache_slot_insert); "
                f"families with it: {sorted(families_with('prefill_ragged'))} "
                f"(rwkv and MoE configs excluded)")
        if cfg.rwkv:
            raise ValueError(
                "continuous batching does not support the rwkv family: "
                "ragged right-padded prefill would fold pad tokens into "
                "the recurrent state (DESIGN.md §Serving-runtime)")
        if cfg.n_experts:
            raise ValueError(
                "continuous batching does not support MoE configs: "
                "capacity-based expert routing computes token keep/drop "
                "from a batch-wide cumsum, so co-batched rows and pad "
                "tokens would change a request's output — the scheduling-"
                "never-changes-outputs contract cannot hold "
                "(DESIGN.md §Serving-runtime)")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if buckets is None:
            buckets = tuple(b for b in (8, 16, 32, 64, 128, 256, 512, 1024)
                            if b < max_len) + (max_len,)
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1 or buckets[-1] > max_len:
            raise ValueError(
                f"buckets must sit in [1, max_len={max_len}], got {buckets}")
        self.attn_backend = attn_backend
        self.cfg, self.params, self.pack = cfg, params, pack
        self.device = params["embed"].device
        self.max_slots, self.max_len = int(max_slots), int(max_len)
        self.buckets, self.sampler, self.gang = buckets, sampler, gang
        self.measure_ttft = measure_ttft
        self._api = api
        self._eos_enabled = eos_id is not None
        self._eos = -1 if eos_id is None else int(eos_id)
        self._seed = int(seed)
        self._next_uid = 0
        self.reset()

    # -- state / bookkeeping ----------------------------------------------

    def reset(self) -> None:
        """Drop all queued/active requests and zero the slot state."""
        b, dev = self.max_slots, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._state = SlotState(
            layers=self._init_layers(),
            length=zeros(b), tok=zeros(b, dtype=torch.int64),
            active=zeros(b, dtype=torch.bool), emitted=zeros(b),
            max_new=torch.ones((b,), dtype=torch.int32, device=dev),
            out=zeros(b, self.max_len), key=zeros(b, dtype=torch.int64))
        self._queue: Deque[_Pending] = deque()
        self._slots: List[Optional[_Pending]] = [None] * b
        self._early: List[Completion] = []
        self._live_uids: set = set()
        self._heal_queue: Deque[Any] = deque()
        self._last_health = 0
        self._stats = {"decode_steps": 0, "prefill_calls": 0,
                       "occupancy_sum": 0, "tokens_out": 0, "ttft_s": [],
                       "heal_events": 0, "bands_reprogrammed": 0,
                       "recalibrations": 0, "probe_losses": []}

    def _init_layers(self):
        """The slot-batched cache tree this runtime decodes over (hook: the
        paged runtime swaps in a global page pool)."""
        return self._api.init_cache(self.cfg, self.max_slots, self.max_len,
                                    device=self.device)["layers"]

    @property
    def stats(self) -> Dict[str, Any]:
        """``decode_steps``, ``prefill_calls``, mean ``occupancy``,
        ``tokens_out``, the per-request ``ttft_s`` list, and the healer's
        ``heal_events``, ``bands_reprogrammed``, ``recalibrations`` and
        ``probe_losses``."""
        s = dict(self._stats)
        s["ttft_s"] = list(s["ttft_s"])
        s["probe_losses"] = list(s["probe_losses"])
        steps = max(s["decode_steps"], 1)
        s["occupancy"] = s.pop("occupancy_sum") / (steps * self.max_slots)
        return s

    # -- request API -------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int, uid=None):
        """Queue one request; returns its uid (auto-assigned if None)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise ValueError(
                f"prompt tokens must sit in [0, vocab={self.cfg.vocab}); "
                f"got range [{prompt.min()}, {prompt.max()}]")
        if prompt.size > self.buckets[-1]:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the largest bucket "
                f"{self.buckets[-1]}; raise max_len/buckets")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the per-slot KV capacity max_len={self.max_len}")
        if uid is None:
            while str(self._next_uid) in self._live_uids:
                self._next_uid += 1
            uid, self._next_uid = self._next_uid, self._next_uid + 1
        if str(uid) in self._live_uids:
            raise ValueError(f"request uid {uid!r} is already in flight")
        self._live_uids.add(str(uid))
        self._queue.append(_Pending(uid, prompt, int(max_new_tokens),
                                    time.perf_counter()))
        return uid

    @property
    def idle(self) -> bool:
        return not self._queue and all(p is None for p in self._slots)

    def run(self) -> Dict[Any, np.ndarray]:
        """Drain the queue to completion; returns {uid: generated tokens}."""
        done: Dict[Any, np.ndarray] = {}
        while not self.idle:
            for c in self.step():
                done[c.uid] = c.tokens
        while self._heal_queue:      # finish healing that started late
            self._maintain()
        return done

    # -- scheduler ---------------------------------------------------------

    def step(self) -> List[Completion]:
        """One scheduler iteration: maintain -> admit -> decode -> collect."""
        self._maintain()
        self._admit()
        early, self._early = self._early, []
        t = self._stats["decode_steps"]
        live = sum(p is not None and p.done_step > t for p in self._slots)
        if live:
            self._run_decode()
            self._stats["decode_steps"] += 1
            self._stats["occupancy_sum"] += live
        return early + self._collect()

    def _maintain(self) -> None:
        """Device-state upkeep between decode steps (nothing without a
        manager).  Drains the heal queue ``bands_per_step`` targets a call
        through ``resilient_step``, recalibrating once it is empty;
        otherwise every ``check_every`` steps (``update_every`` without a
        policy) re-ages the served pack and, under a policy, probes its
        health and queues a heal when the probe loss passes the
        threshold.  Slot state is untouched: the next decode step simply
        reads the new pack."""
        m = self._manager
        if m is None:
            return
        hp = self._heal
        steps = self._stats["decode_steps"]
        t = self._clock.at(steps) if self._clock is not None else 1.0
        if self._heal_queue:
            for _ in range(min(hp.bands_per_step, len(self._heal_queue))):
                target = self._heal_queue.popleft()
                if target == HEAD_BAND:
                    resilient_step(m.reprogram_head, t_now=t,
                                   max_retries=hp.max_retries,
                                   backoff_s=hp.backoff_s)
                else:
                    resilient_step(m.reprogram_band, target, t_now=t,
                                   max_retries=hp.max_retries,
                                   backoff_s=hp.backoff_s)
                self._stats["bands_reprogrammed"] += 1
            self.pack = m.aged(t)
            if not self._heal_queue and hp.recalibrate:
                self.pack = m.recalibrate(self.pack)
                self._stats["recalibrations"] += 1
            return
        every = (hp.check_every if hp is not None
                 else (self._clock.update_every
                       if self._clock is not None else 0))
        if not every or (steps - self._last_health) < every:
            return
        self._last_health = steps
        if self._clock is not None:
            self.pack = m.aged(t)
        if hp is None:
            return
        loss = m.probe_loss(self.pack)
        self._stats["probe_losses"].append(loss)
        if loss > m.ref_loss * hp.loss_mult + hp.loss_add:
            self._stats["heal_events"] += 1
            if hp.reprogram:
                self._heal_queue.extend(m.heal_targets())
            elif hp.recalibrate:
                self.pack = m.recalibrate(self.pack)
                self._stats["recalibrations"] += 1

    def _admit(self) -> None:
        """Admit queued requests until slots or queue run dry; lanes that
        retire at prefill free their slot for re-admission at once."""
        while self._admit_batch():
            if not self._queue:
                return
            t = self._stats["decode_steps"]
            may_retire = any(p is not None and p.done_step <= t
                             for p in self._slots)
            if not (may_retire or self._eos_enabled):
                return
            done = self._collect()
            if not done:
                return
            self._early.extend(done)

    def _admit_batch(self) -> bool:
        free = [i for i, p in enumerate(self._slots) if p is None]
        if not free or not self._queue:
            return False
        if self.gang and len(free) < self.max_slots:
            return False                # static batching: wait for a full drain
        take: List[_Pending] = []
        while self._queue and len(take) < len(free):
            if not self._reserve(self._queue[0]):
                break                   # backpressure: keep FIFO order intact
            take.append(self._queue.popleft())
        if not take:
            return False
        groups: Dict[Tuple, List[Tuple[_Pending, int]]] = {}
        if self.gang:
            bucket = self._bucket_for(max(r.prompt.size for r in take))
            groups[(bucket,)] = [(r, free.pop(0)) for r in take]
        else:
            for r in take:
                groups.setdefault(self._group_key(r), []).append(
                    (r, free.pop(0)))
        # ascending key order: the paged runtime's keys sort by cached-prefix
        # length, so a prefix donor's prefill writes its pages before any
        # same-batch borrower gathers them
        for key in sorted(groups):
            self._prefill_group(key, groups[key])
        return True

    def _reserve(self, req: _Pending) -> bool:
        """Claim admission resources for the queue head (hook); False leaves
        it queued (the paged runtime's pool is full)."""
        return True

    def _group_key(self, req: _Pending) -> Tuple:
        """Prefill-group key of an admitted request (hook); the last element
        is always the padded prompt bucket."""
        return (self._bucket_for(req.prompt.size),)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError(n)         # unreachable: submit() validates

    def _prefill_group(self, key: Tuple,
                       items: List[Tuple[_Pending, int]]) -> None:
        bucket = key[-1]
        g = min(_pow2_at_least(len(items)), self.max_slots)
        prompts = np.zeros((g, bucket), np.int64)
        true_lens = np.ones((g,), np.int32)
        slots = np.full((g,), self.max_slots, np.int64)    # dummy -> dropped
        max_new = np.ones((g,), np.int32)
        keys = np.zeros((g,), np.int64)
        for j, (req, slot) in enumerate(items):
            prompts[j, :req.prompt.size] = req.prompt
            true_lens[j] = req.prompt.size
            slots[j] = slot
            max_new[j] = req.max_new
            keys[j] = request_key(self._seed, req.uid)
            self._slots[slot] = req
        self._prefill(*(torch.as_tensor(a, device=self.device)
                        for a in (prompts, true_lens, slots, max_new, keys)),
                      n_real=len(items))
        self._admitted(items)

    def _admitted(self, items: List[Tuple[_Pending, int]]) -> None:
        """Bookkeeping after a group's prefill: counts, TTFT, and the decode
        step at which each request retires."""
        self._stats["prefill_calls"] += 1
        if self.measure_ttft and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        for req, _ in items:
            req.ttft_s = now - req.submit_t
            req.done_step = self._stats["decode_steps"] + req.max_new - 1
            self._stats["ttft_s"].append(req.ttft_s)

    def _prefill(self, prompts, true_lens, slots, max_new, keys, *,
                 n_real: int) -> None:
        st = self._state
        logits, pcache = self._api.prefill_ragged(
            self.cfg, self.params, prompts, true_lens=true_lens,
            pack=self.pack)
        self._api.cache_slot_insert({"layers": st.layers, "len": st.length},
                                    pcache, slots)
        self._start_rows(logits, keys, slots, max_new, n_real)

    def _start_rows(self, logits, keys, slots, max_new, n_real: int) -> None:
        """Sample the first token of freshly prefilled rows from their
        (G, 1, V) ``logits`` and set their slot state; the first ``n_real``
        rows are real requests, the rest padding."""
        st = self._state
        first, keys = sample_tokens(logits[:, -1], keys, self.sampler)
        rows = slots[:n_real]
        first, keys, max_new = first[:n_real], keys[:n_real], max_new[:n_real]
        live = (max_new > 1) & (first != self._eos)       # 1-token budgets
        st.tok[rows] = first                              # finish at prefill
        st.active[rows] = live
        st.emitted[rows] = 1
        st.max_new[rows] = max_new
        st.out[rows] = 0
        st.out[rows, 0] = first.to(st.out.dtype)
        st.key[rows] = keys

    def _decode_model(self, st: SlotState):
        """The model half of a decode step over every slot (hook, the
        reference's ``_make_decode_model``): (last-token logits, new cache
        layers, new lengths)."""
        logits, cache = self._api.decode_step(
            self.cfg, self.params, st.tok[:, None],
            {"layers": st.layers, "len": st.length}, pack=self.pack,
            attn_backend=self.attn_backend)
        return logits[:, -1], cache["layers"], cache["len"]

    def _run_decode(self) -> None:
        """One decode step over every slot, then sampling and bookkeeping
        (finished/free slots ride along masked)."""
        st = self._state
        logits, layers, length = self._decode_model(st)
        nxt, keys = sample_tokens(logits, st.key, self.sampler)
        act = st.active
        cap = st.out.shape[1]
        hit = (torch.arange(cap, device=self.device)[None, :]
               == st.emitted[:, None]) & act[:, None]
        out = torch.where(hit, nxt[:, None].to(st.out.dtype), st.out)
        emitted = st.emitted + act.to(st.emitted.dtype)
        done = act & ((emitted >= st.max_new) | (nxt == self._eos))
        self._state = SlotState(
            layers=layers,
            length=torch.where(act, length, st.length),
            tok=torch.where(act, nxt, st.tok),
            active=act & ~done,
            emitted=emitted,
            max_new=st.max_new,
            out=out,
            key=torch.where(act, keys, st.key),
        )

    def _collect(self) -> List[Completion]:
        busy = [p for p in self._slots if p is not None]
        if not busy:
            return []
        if not self._eos_enabled:
            # the budget is the only stop condition: skip the device sync
            # on steps where no slot can retire
            t = self._stats["decode_steps"]
            if all(p.done_step > t for p in busy):
                return []
        active = self._state.active.cpu().numpy()
        finished = [i for i, p in enumerate(self._slots)
                    if p is not None and not active[i]]
        if not finished:
            return []
        out = self._state.out.cpu().numpy()
        emitted = self._state.emitted.cpu().numpy()
        done = []
        for i in finished:
            req = self._slots[i]
            self._free_slot(i)
            self._live_uids.discard(str(req.uid))
            toks = out[i, :emitted[i]].astype(np.int32)
            self._stats["tokens_out"] += int(emitted[i])
            done.append(Completion(uid=req.uid, tokens=toks,
                                   prompt_len=int(req.prompt.size),
                                   ttft_s=req.ttft_s))
        return done

    def _free_slot(self, i: int) -> None:
        """Return slot ``i`` to the free list (hook: the paged runtime also
        releases the slot's pages and points its block-table row at the
        sink)."""
        self._slots[i] = None
