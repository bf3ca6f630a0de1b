"""Fault-tolerant checkpointing: async, atomic, restore onto any device.

The reference's on-disk layout:
  - every leaf is written whole into ``arrays.npz``, keyed by its flattened
    path with ``|`` for ``/``, beside ``manifest.json`` (step, shapes,
    dtypes);
  - a save goes to ``<dir>/step_<n>.tmp`` and is renamed to ``step_<n>``
    with ``os.replace``, so a crash mid-write never corrupts the latest
    checkpoint;
  - ``Checkpointer.save_async`` copies the tree to host memory on the
    caller's thread and writes the files on a worker thread;
  - a retention window of ``keep`` checkpoints bounds disk use.

numpy has no bfloat16: a bfloat16 leaf goes to disk as its 16-bit pattern
(a ``uint16`` view) and comes back as bfloat16 because the manifest says
so.  The reference's own bfloat16 leaves (stored as ``|V2``) are read the
same way.  ``restore_pytree(..., device=)`` places the leaves on one device
or on a tree of devices matching the template, the one-process counterpart
of the reference's ``shardings`` tree.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.tree import map_leaves

_BF16 = "bfloat16"
_JOIN_S = 60.0                     # close() gives the writer this long to finish its queue


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}/{k}") for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}/#{i}") for i, v in enumerate(template)]
        return type(template)(vals)
    return flat[prefix]


def _host_copy(leaf):
    """A host copy of one leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _to_disk(leaf) -> tuple[np.ndarray, str]:
    """(the array written to disk, the dtype the manifest names)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(leaf)
    if a.dtype.name == _BF16:                       # an ml_dtypes array
        return a.view(np.uint16), _BF16
    return a, str(a.dtype)


def _from_disk(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.dtype(dtype), copy=False))


def _steps(directory: Path) -> list[int]:
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if not p.name.endswith(".tmp"))


def save_pytree(tree, directory: Path, step: int) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "keys": {}}
    for k, v in _flatten(tree).items():
        a, dtype = _to_disk(v)
        arrays[k.replace("/", "|")] = a
        manifest["keys"][k] = {"shape": list(a.shape), "dtype": dtype}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def restore_pytree(directory: Path, step: int | None = None, template=None, device=None):
    """Restore the checkpoint at ``step`` (the latest if ``None``) as a tree
    of tensors shaped like ``template`` (a flat ``{path: tensor}`` dict
    without one).  ``device``: ``None`` leaves the tensors in host memory;
    a device places every leaf there; a tree of devices matching the
    template places each leaf on its own.  Returns (tree, step)."""
    directory = Path(directory)
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    final = directory / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    with np.load(final / "arrays.npz") as z:
        flat = {}
        for name in z.files:
            k = name.replace("|", "/")
            flat[k] = _from_disk(z[name], manifest["keys"][k]["dtype"])
    if device is not None:
        if isinstance(device, (dict, list, tuple)):
            where = _flatten(device)
            flat = {k: v.to(where[k]) if k in where else v for k, v in flat.items()}
        else:
            flat = {k: v.to(device) for k, v in flat.items()}
    tree = flat if template is None else _unflatten_into(template, flat)
    return tree, manifest["step"]


class Checkpointer:
    """Async checkpointer with retention.  ``wait()`` blocks until every
    queued save is on disk and raises the writer's error if one failed;
    ``close()`` stops and joins the writer."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._done = threading.Condition()
        self._pending = 0
        self._error: BaseException | None = None
        self.saved_steps: list[int] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, step = item
            try:
                save_pytree(tree, self.directory, step)
                self.saved_steps.append(step)
                self._gc()
            except Exception as e:  # noqa: BLE001 — raised again by wait()
                with self._done:
                    self._error = self._error or e
            finally:
                with self._done:
                    self._pending -= 1
                    self._done.notify_all()

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def save_async(self, tree, step: int):
        host = map_leaves(_host_copy, tree)          # synchronous snapshot
        with self._done:
            self._pending += 1
        self._q.put((host, step))

    def wait(self):
        with self._done:
            while self._pending:
                self._done.wait()
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("an asynchronous checkpoint save failed") from err

    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def close(self):
        if self._worker.is_alive():
            self._q.put(None)
            self._worker.join(timeout=_JOIN_S)
        if self._worker.is_alive():
            raise RuntimeError("the checkpoint writer did not stop")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
