"""Fault tolerance and straggler mitigation (counterpart of
``repro.runtime.fault``; plain Python, unchanged from the reference).

* ``resilient_step`` — retries a step on transient errors with exponential
  backoff; non-transient (deterministic) errors re-raise at once.  After
  ``max_retries`` it raises ``StepFailed``.  What counts as transient is
  deliberately narrow (:func:`is_transient`): connection and timeout
  errors, plus XLA runtime errors whose message carries a transient RPC
  status.  That allowlist matches by type name, so it matches no torch
  error: a ``RuntimeError`` or ``torch.AcceleratorError`` from a failed
  CUDA launch re-raises at once, never retried — in the serving heal path
  (``repro_torch.serve.runtime``) a retry would hide a broken kernel.
* ``StragglerMonitor`` — tracks per-step wall times, flags ``> mean +
  k*std`` outliers, and calls an eviction hook.
* ``Heartbeat`` — a daemon-thread liveness file (mtime = last heartbeat),
  the signal an external supervisor watches.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
from typing import Callable, List, Optional, Tuple

#: exception types that are transient *by construction* — lost
#: connections and timeouts get retried, everything else re-raises.
#: (``OSError``/``RuntimeError`` wholesale would swallow deterministic
#: failures: FileNotFoundError is an OSError, XLA shape errors are
#: RuntimeErrors.)
TRANSIENT_ERRORS = (
    ConnectionError,
    TimeoutError,
    InterruptedError,
)

#: RPC status fragments marking a jaxlib ``XlaRuntimeError`` (a
#: RuntimeError subclass with no stable taxonomy of its own) as
#: transient: gRPC/absl status codes of retryable distributed-runtime
#: failures, plus device-side transfer hiccups.
TRANSIENT_XLA_MESSAGES = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "DEADLINE EXCEEDED",
    "ABORTED",
    "RESOURCE_EXHAUSTED",
    "RESOURCE EXHAUSTED",
    "failed to transfer",
    "connection reset",
)


class StepFailed(RuntimeError):
    pass


def is_transient(e: BaseException) -> bool:
    """Is ``e`` worth retrying?  Explicit transient types, or an XLA
    runtime error whose status string is on the transient allowlist."""
    if isinstance(e, TRANSIENT_ERRORS):
        return True
    if type(e).__name__ == "XlaRuntimeError":
        msg = str(e).upper()
        return any(frag.upper() in msg for frag in TRANSIENT_XLA_MESSAGES)
    return False


def resilient_step(
    fn: Callable,
    *args,
    max_retries: int = 3,
    backoff_s: float = 0.05,
    transient: Optional[Tuple] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            retryable = (is_transient(e) if transient is None
                         else isinstance(e, transient))
            if not retryable:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt > max_retries:
                raise StepFailed(
                    f"step failed after {max_retries} retries: {e!r}"
                ) from e
            time.sleep(backoff_s * (2 ** (attempt - 1)))


class StragglerMonitor:
    def __init__(self, *, k_sigma: float = 3.0, window: int = 50,
                 min_samples: int = 10,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.k = k_sigma
        self.window = window
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.flagged: List[Tuple[int, float]] = []
        self._step = 0

    def record(self, dt: float) -> bool:
        """Record one step duration; returns True if flagged."""
        self._step += 1
        hist = self.times[-self.window:]
        flagged = False
        if len(hist) >= self.min_samples:
            mu = statistics.fmean(hist)
            sd = statistics.pstdev(hist) or 1e-9
            if dt > mu + self.k * sd:
                flagged = True
                self.flagged.append((self._step, dt))
                if self.on_straggler is not None:
                    self.on_straggler(self._step, dt)
        self.times.append(dt)
        return flagged

    def timed(self, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.record(time.perf_counter() - t0)
        return out


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 5.0):
        self.path = path
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        def beat():
            while not self._stop.wait(self.interval):
                self._touch()

        self._touch()
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()

    def _touch(self):
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join()

    def age(self) -> float:
        return time.time() - os.path.getmtime(self.path)
