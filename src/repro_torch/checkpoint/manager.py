"""Asynchronous, elastic checkpointing (counterpart of
``repro.checkpoint.manager``), in the reference's on-disk format.

Layout: ``<dir>/step_<n:09d>/`` with one ``.npy`` per leaf, named by its
path with ``/`` turned into ``__`` (``params__layers__attn__wq.npy``),
plus ``manifest.json`` (``step``, ``extra``, and per leaf its file,
shape, dtype and ``shard: null``).  Leaves are named and ordered as
``jax.tree_util`` names a ``TrainState`` (``repro_torch.pytree``: sorted
dict keys, dataclass fields in order), so either package restores what
the other wrote.  Writes go to ``step_<n>.tmp`` and are renamed at the
end: a crashed write never corrupts the latest checkpoint.
``save_async`` copies every leaf to host memory at once (the caller may
go on changing its tensors) and serializes on a daemon thread.

Elasticity: the manifest stores global shapes only.  ``restore``
rebuilds the template's structure and places each leaf where
``placement_fn(name, shape)`` says (a device, or ``None`` for the default
``device``), the counterpart of the reference's ``sharding_fn``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.pytree import flatten_with_path, map_with_path, unflatten_into


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place writes cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Synchronous save."""
        self._write(step, map_with_path(lambda _, x: _to_host(x), tree),
                    extra or {})

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Asynchronous save: the device-to-host copy happens now,
        serialization on a daemon thread."""
        self.wait()
        host = map_with_path(lambda _, x: _to_host(x), tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree, extra: dict):
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for name, arr in flatten_with_path(host_tree):
            arr = np.asarray(arr)
            fname = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][name] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "shard": None,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        template: Any,
        step: Optional[int] = None,
        *,
        placement_fn: Optional[Callable[[str, tuple], Any]] = None,
        device="cuda",
    ):
        """Restore into the structure of ``template`` (leaves become
        tensors).  ``placement_fn(leaf_name, shape)`` may return a device
        per leaf — the elastic hook: the checkpoint knows nothing of
        placement, which is decided entirely here; ``None`` means
        ``device``.  Returns (tree, step, extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.dir!r}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        values = {}
        for name, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            dev = None if placement_fn is None \
                else placement_fn(name, tuple(meta["shape"]))
            values[name] = torch.from_numpy(arr).to(
                device if dev is None else dev)
        return unflatten_into(template, values), step, manifest["extra"]
