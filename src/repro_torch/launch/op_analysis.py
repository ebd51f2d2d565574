"""Per-step operation analysis: FLOPs, bytes and collective bytes of one
rank's eager step (the counterpart of ``repro/launch/hlo_analysis.py``,
which walks XLA's compiled HLO after SPMD partitioning, so per device).

``analyze(fn, *args)`` runs ``fn`` once under a dispatch mode and counts
every aten op that runs, on one rank:

* flops: ``torch.utils.flop_counter``'s formulas (2·M·N·K per matmul,
  and its rules for convolutions and attention), an op outside its
  registry decomposed as ``FlopCounterMode`` decomposes it.
* bytes: the sum of each op's tensor input and output bytes.  Views move
  nothing and are skipped.  This is an eager, unfused upper bound on
  memory traffic: XLA's fusions, which the reference's model sees, keep
  intermediates out of memory, and eager ops do not.
* collectives: the payload this rank sends (the input tensor's bytes)
  and the count of each communicating ``c10d`` or ``_c10d_functional``
  op, by op name; waits and autograd wrappers are not collectives.  The
  same again by process group name (``collectives_by_group``), which the
  dry run maps to mesh axes.

A DTensor op is seen once, at the DTensor level (DTensor's own dispatch
runs its local op beneath the mode), so it is counted on the operands'
and results' local shards: what one rank computes and moves.  Its
redistributions run as functional collectives on the local shards and
are counted as such.

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
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

#: communicating ops -> the position of the argument that holds this
#: rank's payload (c10d's out-of-place ops take the output buffer first)
_COLLECTIVES = {
    ("c10d", "allreduce_"): 0, ("c10d", "allgather_"): 1,
    ("c10d", "_allgather_base_"): 1, ("c10d", "reduce_scatter_"): 1,
    ("c10d", "_reduce_scatter_base_"): 1, ("c10d", "alltoall_base_"): 1,
    ("c10d", "alltoall_"): 1, ("c10d", "broadcast_"): 0,
    ("c10d", "reduce_"): 0, ("c10d", "gather_"): 1, ("c10d", "scatter_"): 1,
    ("_c10d_functional", "all_reduce"): 0,
    ("_c10d_functional", "all_reduce_"): 0,
    ("_c10d_functional", "all_reduce_coalesced"): 0,
    ("_c10d_functional", "all_gather_into_tensor"): 0,
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): 0,
    ("_c10d_functional", "reduce_scatter_tensor"): 0,
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): 0,
    ("_c10d_functional", "all_to_all_single"): 0,
    ("_c10d_functional", "broadcast"): 0,
}
#: ops FlopCounterMode lets pass without counting (metadata queries)
_SKIP = {torch.ops.aten.sym_is_contiguous.default,
         torch.ops.aten.is_contiguous.default,
         torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.is_strides_like_format.default,
         torch.ops.aten.is_non_overlapping_and_dense.default,
         torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
         torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
         torch.ops.aten.storage_offset.default,
         torch.ops.aten.sym_storage_offset.default,
         torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
         torch.ops.aten.dim.default, torch.ops.prim.layout.default}


def _flat(tree) -> list:
    """The tensors of an op's arguments or result (nested one level in
    lists and tuples, as aten's are)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple, type({}.values()))):
        return [t for x in tree for t in _flat(x)]
    return []


def _local(tensors) -> list:
    """`tensors` with every DTensor replaced by its local shard."""
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tensors]


def _shard_of(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _group_name(func, args) -> str:
    """The process group name of a collective's arguments ("?" when it
    names none)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).group_name
    if func.namespace == "_c10d_functional":
        names = [a for a in args if isinstance(a, str)]
        if names:
            return names[-1]
    return "?"


def _tally():
    return defaultdict(lambda: {"bytes": 0, "count": 0})


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = _tally()
        self.by_group = defaultdict(_tally)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        where = _COLLECTIVES.get((func.namespace, name))
        if where is not None:
            payload = _bytes(_local(_flat(args[where])))
            for c in (self.coll[name],
                      self.by_group[_group_name(func, args)][name]):
                c["bytes"] += payload
                c["count"] += 1
        elif func.namespace in ("c10d", "_c10d_functional"):
            pass                          # waits, autograd wrappers
        else:
            ins, outs = _flat((args, kwargs)), _flat(out)
            dt = any(type(t) is not torch.Tensor for t in ins + outs)
            if dt:
                ins, outs = _local(ins), _local(outs)
            if packet in flop_registry:
                fa, fk, fo = tree_map(_shard_of, (args, kwargs, out)) \
                    if dt else (args, kwargs, out)
                self.flops += flop_registry[packet](*fa, **fk, out_val=fo)
            if not func.is_view:
                self.bytes += _bytes(ins) + _bytes(outs)
        return out


def analyze(fn, *args, **kwargs) -> Dict:
    """{"flops", "bytes", "collectives", "collective_bytes_total",
    "collectives_by_group"} of one call of fn(*args, **kwargs) on this
    rank."""
    counter = _Counter()
    with counter:
        fn(*args, **kwargs)
    coll = {k: dict(v) for k, v in counter.coll.items()}
    return {"flops": float(counter.flops),
            "bytes": float(counter.bytes),
            "collectives": coll,
            "collective_bytes_total": float(sum(v["bytes"]
                                                for v in coll.values())),
            "collectives_by_group": {
                g: {k: dict(v) for k, v in ops.items()}
                for g, ops in counter.by_group.items()}}
