"""What a traced run reads besides the host clock: the device's busy time
and each kernel's time from ``torch.profiler`` over a stated part of the
window, the bound time of the kernels launched in it, and the spans of
the layers the benchmark times from its own files.

Nothing here runs in an untraced run."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

from harness import work

#: kernels whose rooflines the benchmark reads: key -> (the port's op in
#: ``repro_torch.kernels.ops`` that launches it, the CUDA function's name)
KERNELS = {
    "b1": ("fused_mvm", "mvm_stream_kernel"),
    "b5": ("bitline_mvm", "bitline_mvm_kernel"),
    "b6": ("analog_mvm_parasitic", "parasitic_fold_kernel"),
}


def _b1(x_parts, g_pos, g_neg, *a, n_bits=None, **kw):
    m, p, rows = x_parts.shape
    s, _, _, n = g_pos.shape
    return work.b1_work(m, p, rows, s, n, 1 if n_bits is None else n_bits)


def _b5(g, x, r_hat, *a, **kw):
    if g.ndim == 2:
        (k, n), (m, _) = g.shape, x.shape
        return work.b5_work(1, k, n, 1, m)
    (n_g, k, n), (n_x, m, _) = g.shape, x.shape
    return work.b5_work(n_g, k, n, n_x, m)


def _b6(x_parts, g_pos, g_neg, *a, n_bits, **kw):
    m = x_parts.shape[0]
    p, rows, n = g_pos.shape[-3:]
    return work.b6_work(m, p, rows, n, n_bits)


_WORK = {"b1": _b1, "b5": _b5, "b6": _b6}


class KernelWork:
    """While on, adds the bound seconds of every kernel launch of the
    port's ops (shapes read from each call's operands) by kernel key.
    Installs wrappers on ``ops`` and takes them off in :meth:`close`."""

    def __init__(self, ops):
        self.ops = ops
        self.on = False
        self.bound_s: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.Counter()
        self._orig = {}
        for key, (op, _) in KERNELS.items():
            fn = getattr(ops, op)
            self._orig[op] = fn
            setattr(ops, op, self._wrap(key, fn))

    def _wrap(self, key, fn):
        def call(*a, **kw):
            first = a[0] if a else None
            if (self.on and kw.get("backend", "kernel") == "kernel"
                    and isinstance(first, torch.Tensor) and first.is_cuda):
                n_bytes, n_flops = _WORK[key](*a, **kw)
                self.bound_s[key] += work.bound_s(n_bytes, n_flops)
                self.calls[key] += 1
            return fn(*a, **kw)
        return call

    def close(self) -> None:
        for op, fn in self._orig.items():
            setattr(self.ops, op, fn)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class DeviceTrace:
    """``torch.profiler`` over the part of the window between
    :meth:`start` and :meth:`stop`, each ended by a synchronize."""

    def __init__(self, kernel_work: Optional[KernelWork] = None):
        self.work = kernel_work
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernel_s: Dict[str, float] = {}
        self.breakdown: Dict[str, list] = {}
        self._prof = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def prime(self) -> None:
        """Start and stop the profiler once on nothing, in set-up, so the
        window does not pay its first start."""
        with self._profile():
            sync()

    def start(self) -> float:
        """Start tracing; returns the seconds the start itself took."""
        t = time.perf_counter()
        sync()
        self._prof = self._profile()
        self._prof.__enter__()
        if self.work is not None:
            self.work.on = True
        self._t0 = time.perf_counter()
        return self._t0 - t

    def stop(self) -> float:
        """Stop tracing; returns the seconds the stop itself took, which
        the caller leaves out of its window.  The events are read later,
        by :meth:`read`."""
        sync()
        t = time.perf_counter()
        self.window_s = t - self._t0
        if self.work is not None:
            self.work.on = False
        self._prof.__exit__(None, None, None)
        return time.perf_counter() - t

    def read(self) -> None:
        """Read the stopped trace's events (after the window)."""
        if self._prof is not None:
            self._read(self._prof.events())
            self._prof = None

    def _read(self, events) -> None:
        dev, host = [], []
        for e in events:
            span = (e.time_range.start / 1e6, e.time_range.end / 1e6)
            if e.device_type.name == "CUDA":
                dev.append((span, e.name))
            else:
                host.append((span, e.name))
        busy = _union([s for s, _ in dev])
        self.busy_s = sum(e - s for s, e in busy)
        by_name: Dict[str, float] = collections.defaultdict(float)
        for (s, e), name in dev:
            by_name[name] += e - s
        self.kernel_s = {key: sum(t for nm, t in by_name.items() if fn in nm)
                         for key, (_, fn) in KERNELS.items()}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(busy, busy[1:])), reverse=True)[:10]
        self.breakdown = {
            "device_ops": [[nm[:120], t] for nm, t in top],
            "idle_gaps": [[_host_label(host, (s + e) / 2), g]
                          for g, s, e in gaps],
        }


def _host_label(host, t: float) -> str:
    """The innermost host event running at ``t``, or the Python between
    them."""
    best = None
    for (s, e), name in host:
        if s <= t < e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return "host: " + (best[1][:100] if best else "python between ops")


def sync() -> None:
    """Wait for the card, where the run uses one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Spans:
    """Seconds of the layers the benchmark times from its own files:
    ``with spans("calibrate"):`` adds the block's seconds, each end
    synchronized, to the open unit (a design point).  Off, it adds
    nothing and does not synchronize."""

    def __init__(self, on: bool):
        self.on = on
        self.units: List[Dict[str, float]] = []

    def open_unit(self) -> None:
        if self.on:
            self.units.append(collections.defaultdict(float))

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        sync()
        t = time.perf_counter()
        try:
            yield
        finally:
            sync()
            self.units[-1][name] += time.perf_counter() - t


def roofline_share(record, key: str):
    """Percent of its roofline that kernel ``key`` (of :data:`KERNELS`)
    reached in the traced part of the window: the bound seconds of its
    launches there (``harness.work``) over its device time by name; None
    where it did not run there."""
    trace, kw = record.get("trace"), record.get("kernel_work")
    if trace is None or kw is None:
        return None
    t = trace.kernel_s.get(key, 0.0)
    if t <= 0.0 or kw.calls.get(key, 0) == 0:
        return None
    return 100.0 * kw.bound_s[key] / t


def idle_share(record):
    """Percent of the traced part of the window in which no operation ran
    on the device; None without a device trace."""
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0.0 or trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def span_mean(record, name: str):
    """Mean seconds of span ``name`` over the window's completed points;
    None where no point completed."""
    units = (record.get("spans") or [])[:record.get("points_done", 0)]
    if not units:
        return None
    return sum(u.get(name, 0.0) for u in units) / len(units)
