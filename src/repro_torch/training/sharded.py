"""Steps on a device mesh with tensor or sequence parallelism: the local
layouts a step computes in, and the conversions from and to the layouts
its DTensors are stored in (the reference's specs, ``launch/shardings``).

* Parameters: stored under ``param_shardings`` (``model`` on head, ff,
  vocab, expert and RG-LRU width dims; FSDP adds ``data`` on a free dim);
  computed with only their ``model`` shards (an FSDP shard is gathered
  over ``data`` for the step).
* Gradients: computed as the parameters are, then reduce-scattered over
  the batch axes into their blocks under ``grad_shardings`` (ZeRO: the
  parameters' ``model`` shards with ``data``, and for a non-TP arch
  ``model`` too, on free dims; the parameters' own specs without it).
  The update runs on those blocks, with the parameters cut to them and
  each moment converted from the placement it is stored in to the one
  ``opt.state_specs`` computes it in; the new blocks are all-gathered
  into the parameters' placement and the moments converted back.
* The batch: the rows of this rank's index over the batch axes, and
  under sequence parallelism its block of the sequence
  (``batch_shardings``); a whole batch (the same on every rank) or
  DTensors.
* Decode state: stored under ``state_shardings``.  Attention caches are
  computed as stored at decode (their sequence sharded, ``tp.Context.kv``)
  and made whole at prefill, then cut; recurrent leaves are computed
  with the step's batch rows and, for a tensor-parallel arch, the
  ``model`` shard of their width: a storage layout that shards more
  (long_500k's data x model) is gathered before the block and cut after.

A leaf that arrives as a plain tensor is replicated, and leaves as one.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tp
from repro_torch.launch.shardings import (NamedSharding, placements,
                                          spec_of, state_shardings)

#: attention cache leaves: (B, T, ...) with the sequence at dim 1
CACHES = ("k", "v", "c_kv", "k_pe")
#: the batch leaf whose dims 0 and 1 are the rows and the sequence
MAIN_INPUTS = ("tokens", "embeds")


def unwrap(t) -> Tuple[torch.Tensor, tuple]:
    """(local tensor, spec): a DTensor's local shard and placements, or a
    plain tensor, replicated."""
    return (t.to_local(), spec_of(t)) if is_dtensor(t) else (t, ())


def wrap(like, local, mesh, spec=None, shape=None):
    """`local` stored as `like` is (a DTensor of its placements and global
    shape; `local` itself where `like` is plain), or under `spec` with
    global `shape` when given."""
    from torch.distributed.tensor import DTensor
    if spec is None:
        if not is_dtensor(like):
            return local
        spec, shape = spec_of(like), like.shape
    shape = torch.Size(shape)
    return DTensor.from_local(
        local, mesh, placements(spec, mesh), run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def model_only(spec) -> tuple:
    """A parameter's compute layout: its ``model`` shards only."""
    return tuple("model" if "model" in tp.entry_axes(spec, d) else None
                 for d in range(len(spec)))


def mesh_of(t):
    """The mesh of the first DTensor leaf of `t`, or None."""
    return next((x.device_mesh for x in tree.leaves(t) if is_dtensor(x)), None)


def context(cfg: ModelConfig, mesh, rows=(), sp=(), kv=()) -> tp.Context:
    """The step's layout: tensor parallelism over ``model`` for a
    tensor-parallel arch, the sequence over `sp`, the caches' sequence
    over `kv`, and batch statistics over the `rows` and `sp` axes."""
    tp_ax = tp.axis(mesh, ("model",)) if cfg.tensor_parallel else tp.ONE
    return tp.Context(tp=tp_ax, sp=tp.axis(mesh, sp), kv=tp.axis(mesh, kv),
                      rows=tp.axis(mesh, union(mesh, rows, sp)))


def compute_params(params, mesh):
    """(this rank's parameters in their compute layout, each leaf's
    storage spec, in flattening order)."""
    out, specs = [], []
    for p in tree.leaves(params):
        local, spec = unwrap(p)
        out.append(tp.to_spec(local, spec, model_only(spec), mesh))
        specs.append(spec)
    return tree.unflatten(params, out), specs


def batch_specs(cfg: ModelConfig, mesh, batch, batch_shardings=None):
    """{name: spec} of a batch (from `batch_shardings`, else the
    reference's rules for its rows)."""
    if batch_shardings is None:
        from repro_torch.launch.shardings import batch_shardings as rules
        rows = next(iter(batch.values())).shape[0]
        batch_shardings = rules(cfg, mesh, batch, rows)
    return {k: (s.spec if isinstance(s, NamedSharding) else s)
            for k, s in batch_shardings.items()}


def local_batch(batch, specs, mesh):
    """This rank's block of every batch leaf (whole tensors cut by their
    spec; DTensors their local shard)."""
    return {k: (v.to_local() if is_dtensor(v) else
                tp.local_shard(v, specs[k], mesh)) for k, v in batch.items()}


def main_spec(specs) -> tuple:
    return next(specs[k] for k in MAIN_INPUTS if k in specs)


def layer_state_specs(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The decode state's storage specs per layer (``state_shardings``'
    rules, which take the reference's stacked layout, on a stack of one,
    the stacked dim's entry dropped)."""
    from repro_torch.models import build_model
    shapes = build_model(cfg)["decode_state_shape"](batch, max_len)
    stacked = _map_specs(lambda sd: torch.empty((1,) + tuple(sd[0]),
                                                device="meta"), shapes)
    sh = state_shardings(cfg, mesh, stacked, batch)
    return tree.map_leaves(lambda x, s: s.spec[1:], stacked, sh), \
        _map_specs(lambda sd: tuple(sd[0]), shapes)


def _map_specs(fn, t):
    """fn over the (shape, dtype) leaves of a state-shape tree."""
    if isinstance(t, dict):
        return {k: _map_specs(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_map_specs(fn, v) for v in t]
    return fn(t)


def state_compute_spec(cfg: ModelConfig, path, spec, ndim: int, mode: str,
                       rows) -> tuple:
    """The layout a decode-state leaf is computed in (see the module
    doc); `rows` the step's batch-row entry."""
    leaf = path[-1]
    if leaf == "pos" or ndim == 0:
        return ()
    out = [None] * ndim
    out[0] = rows
    if leaf in CACHES:
        if mode == "decode":
            out[1] = spec[1] if len(spec) > 1 else None
    elif leaf not in ("ck", "cv") and cfg.tensor_parallel and \
            "model" in tp.entry_axes(spec, ndim - 1):
        out[-1] = "model"
    return tuple(out)


def kv_axes(specs) -> Tuple[str, ...]:
    """The axes the attention caches' sequence dim is sharded over."""
    for path, spec in spec_leaves(specs):
        if path[-1] in CACHES:
            return tp.entry_axes(spec, 1)
    return ()


def rows_entry(specs):
    """The batch-row entry of a state's storage specs."""
    for path, spec in spec_leaves(specs):
        if path[-1] != "pos" and len(spec):
            return spec[0]
    return None


def spec_leaves(specs):
    """[(path, spec)] of a per-layer tree whose leaves are spec tuples."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (f"[{i}]",))
        else:
            out.append((path, t))
    walk(specs, ())
    return out


def convert_state(state, src, dst, mesh):
    """Every leaf of a per-layer state from specs `src` to `dst`."""
    flat = [tp.to_spec(x, s, d, mesh) for x, (_, s), (_, d) in
            zip(tree.leaves(state), spec_leaves(src), spec_leaves(dst))]
    return tree.unflatten(state, flat)


def state_layouts(cfg: ModelConfig, storage, shapes, mode: str, rows):
    """The compute specs of a state whose storage specs are `storage`."""
    comp = [state_compute_spec(cfg, p, s, len(shape), mode, rows)
            for (p, s), (_, shape) in zip(spec_leaves(storage),
                                          spec_leaves(shapes))]
    return rebuild(storage, comp)


def rebuild(like, flat):
    """A tree of `like`'s structure with `flat` at its leaves, in
    ``spec_leaves``' order (``tree.unflatten`` for trees whose leaves may
    be tuples: specs, shapes)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def union(mesh, *axes_lists) -> Tuple[str, ...]:
    """The named axes of the lists, in mesh order."""
    names = set(a for axes in axes_lists for a in axes)
    return tuple(n for n in mesh.mesh_dim_names if n in names)


def microbatches(rows: int, nmb: int) -> int:
    """The microbatches a rank's rows split into: `nmb`, or where its rows
    are fewer than or do not split into them, their greatest common
    divisor (one row a microbatch at fewest)."""
    return math.gcd(rows, nmb)


def shards_of(spec, mesh) -> Dict[int, tp.Axis]:
    """{tensor dim: its tp.Axis} of a storage spec's sharded dims."""
    out = {}
    for d in range(len(spec)):
        ax = tp.axis(mesh, tp.entry_axes(spec, d))
        if ax.size > 1:
            out[d] = ax
    return out
