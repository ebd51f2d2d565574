"""Per-step operation analysis: FLOPs, bytes and collective bytes of one
eager step (the counterpart of ``repro/launch/hlo_analysis.py``, which
walks XLA's compiled HLO).

``analyze(fn, *args)`` runs ``fn`` once under a dispatch mode and counts
every aten op that runs:

* flops: ``torch.utils.flop_counter.FlopCounterMode``'s count (2·M·N·K
  per matmul, and its rules for convolutions and attention).
* bytes: the sum of each op's tensor input and output bytes.  Views move
  nothing and are skipped.  This is an eager, unfused upper bound on
  memory traffic: XLA's fusions, which the reference's model sees, keep
  intermediates out of memory, and eager ops do not.
* collectives: the input bytes and the count of each ``c10d`` op (the
  payload each rank sends), by op name.

The step runs eagerly, so a loop counts once per iteration it runs —
what the reference's trip-count multipliers give its while bodies.  Meta
tensors work: the step's shapes are all that is counted, so the dry run
analyzes models that could not be allocated.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll = defaultdict(lambda: {"bytes": 0, "count": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            c = self.coll[func.__name__.split(".")[0]]
            c["bytes"] += _bytes((args, kwargs))
            c["count"] += 1
        elif not func.is_view:
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def analyze(fn, *args, **kwargs) -> Dict:
    """{"flops", "bytes", "collectives", "collective_bytes_total"} of one
    call of fn(*args, **kwargs)."""
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter()
    with flops, counter:
        fn(*args, **kwargs)
    coll = {k: dict(v) for k, v in counter.coll.items()}
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes),
            "collectives": coll,
            "collective_bytes_total": float(sum(v["bytes"]
                                                for v in coll.values()))}
