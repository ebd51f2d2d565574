"""On-disk checkpointing: npz shards + JSON manifest, with async writes
(port of ``repro/checkpoint/disk.py``).

The manifest carries the LARK metadata (regime, logical clocks) so a restart
can verify it restores the latest committed state — the disk layer is the
durable tier beneath the LARK-replicated in-memory tier.

numpy has no bfloat16 (and the port needs no ``ml_dtypes``), so a bf16
tensor is stored as its raw 16-bit words (``view(torch.int16)``), and the
manifest's ``dtypes`` names every leaf's dtype; ``load_pytree`` restores
each leaf bit for bit, as a tensor where it was one.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as _tree

#: tensors stored as the raw words of another numpy dtype
_RAW = {torch.bfloat16: torch.int16}


def _to_numpy(leaf):
    """(array, dtype name): a tensor's bits as numpy (bf16 as int16),
    else np.asarray of the leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "torch:")
        if t.dtype in _RAW:
            t = t.view(_RAW[t.dtype])
        return t.numpy(), name
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(a, name):
    if not name.startswith("torch:"):
        return a
    dtype = getattr(torch, name.split(":", 1)[1])
    t = torch.from_numpy(np.array(a, copy=True))
    return t.view(dtype) if dtype in _RAW else t


def save_pytree(path: str | Path, tree, *, step: int, regime: int = 0):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    names, dtypes, arrays = [], [], {}
    for i, (p, leaf) in enumerate(_tree.leaves_with_paths(tree)):
        a, dtype = _to_numpy(leaf)
        names.append(_tree.path_name(p))
        dtypes.append(dtype)
        arrays[f"leaf_{i:05d}"] = a
    np.savez(path / f"shards_{step:08d}.npz", **arrays)
    manifest = {"step": step, "regime": regime, "paths": names,
                "dtypes": dtypes, "time": time.time()}
    (path / f"manifest_{step:08d}.json").write_text(json.dumps(manifest))
    (path / "latest").write_text(str(step))


def load_pytree(path: str | Path, like, step: Optional[int] = None):
    """(a tree of `like`'s structure with the stored leaves, the
    manifest); tensor leaves come back on the CPU in their stored dtype,
    bit for bit."""
    path = Path(path)
    if step is None:
        step = int((path / "latest").read_text())
    manifest = json.loads((path / f"manifest_{step:08d}.json").read_text())
    with np.load(path / f"shards_{step:08d}.npz") as data:
        leaves = [_from_numpy(data[f"leaf_{i:05d}"], name)
                  for i, name in enumerate(manifest["dtypes"])]
    return _tree.unflatten(like, leaves), manifest


class AsyncCheckpointer:
    """Background-thread writer: training never blocks on checkpoint I/O."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.q: "queue.Queue" = queue.Queue(maxsize=2)
        self.errors: list = []
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            tree, step, regime = item
            try:
                save_pytree(self.path, tree, step=step, regime=regime)
            except Exception as e:  # pragma: no cover
                self.errors.append(e)

    def save(self, tree, *, step: int, regime: int = 0):
        # snapshot off the device before queueing
        host_tree = _tree.map_leaves(
            lambda t: t.detach().to("cpu", copy=True) if torch.is_tensor(t)
            else np.asarray(t), tree)
        self.q.put((host_tree, step, regime))

    def close(self):
        self.q.put(None)
        self._t.join(timeout=30)
