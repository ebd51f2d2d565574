"""Sharding rules: parameter, gradient, optimizer-state, batch and
decode-state specs per (arch x shape x mesh) (port of
``repro/launch/shardings.py``).

Parallelism scheme, as the reference's:
  * batch dim   -> ("pod","data") [+ "model" for non-TP archs]; axes are
                   dropped right-first until they divide B.
  * TP (tensor) -> "model" on head/ff/vocab/expert dims for archs with
                   cfg.tensor_parallel (embedding vocab-sharded,
                   up-projections column-, down-projections row-sharded,
                   MoE expert dim sharded).
  * SP          -> long-context decode (B = 1): KV and recurrent state
                   shard sequence or feature dims over "data" (+"model").
  * ZeRO        -> gradient accumulators and optimizer moments add a
                   "data" (+"model") shard on a free dim.

A spec is the reference's ``PartitionSpec`` as a tuple with one entry
per leading tensor dim: ``None``, a mesh-axis name, or a tuple of names
(the reference's spec, value for value).  Each function returns, per
leaf, a ``NamedSharding(mesh, spec)``; ``placements(spec, mesh)`` turns a
spec into DTensor ``Shard``/``Replicate`` placements.

The rules key on leaf *names* (``_COL``/``_ROW``, a ``"moe"`` path part,
the ``embedding``/``unembed``/``lam``/``wkv_a`` leaves) and on shapes, so
they take trees in the reference's layout: the per-layer blocks stacked
into segments with a leading repeat dim (``launch/dryrun.py``:
``abstract_params``, ``abstract_state``), with anything that has
``.shape`` at the leaves, such as meta tensors.  Adafactor's factored
moments are matched to a parameter by shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch import tree
from repro_torch.configs.base import ModelConfig

# param leaf names whose LAST dim is the parallel (output) dim
_COL = {"wq", "wk", "wv", "wi_gate", "wi_up", "w_up", "w_x", "w_gate",
        "wu_g", "wu", "wq_b", "wk_b", "wv_b", "wq_a", "w_rg", "w_ig", "conv"}
# param leaf names whose FIRST-of-last-two dim is parallel (input/row dim)
_ROW = {"wo", "w_down", "wd", "w_out"}

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a device mesh (the reference's ``NamedSharding``): one
    leaf of a sharding tree."""
    mesh: Any
    spec: Spec


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _ndim(leaf) -> int:
    return len(leaf.shape)


def has_pod(mesh) -> bool:
    return "pod" in mesh.mesh_dim_names


def batch_axes(cfg: ModelConfig, mesh, global_batch: int) -> Tuple[str, ...]:
    axes = (("pod",) if has_pod(mesh) else ()) + ("data",)
    if not cfg.tensor_parallel:
        axes = axes + ("model",)
    sizes = _sizes(mesh)
    while axes and global_batch % math.prod(sizes[a] for a in axes):
        axes = axes[:-1]
    return axes


def _spec_for_param(cfg: ModelConfig, names: Tuple[str, ...], shape,
                    msize: int) -> Spec:
    """Divisibility-aware TP rules (the mesh `model` axis has msize ways)."""
    if not cfg.tensor_parallel:
        return ()
    leaf = names[-1]
    ndim = len(shape)

    def div(i):
        return shape[i] % msize == 0

    trailing: Tuple = ()
    if "moe" in names:
        if leaf == "router":
            trailing = ()
        elif ndim >= 3 and shape[-3] % msize == 0:
            trailing = ("model", None, None)     # expert-parallel
        elif leaf in ("wi_gate", "wi_up") and div(ndim - 1):
            trailing = (None, None, "model")     # few experts: TP the ff dim
        elif leaf == "wo" and div(ndim - 2):
            trailing = (None, "model", None)
    elif leaf == "embedding":
        # prefer vocab-parallel; odd vocab sizes fall back to d_model
        trailing = ("model", None) if div(ndim - 2) else \
            ((None, "model") if div(ndim - 1) else ())
    elif leaf == "unembed":
        trailing = (None, "model") if div(ndim - 1) else ()
    elif leaf == "wkv_a":          # MLA latent projection feeds the cache
        trailing = ()
    elif leaf in _COL:
        trailing = (None, "model") if div(ndim - 1) else ()
    elif leaf in _ROW:
        trailing = ("model", None) if div(ndim - 2) else ()
    elif leaf == "lam":
        trailing = ("model",) if div(ndim - 1) else ()
    pad = ndim - len(trailing)
    if pad < 0:
        return ()
    return (None,) * pad + tuple(trailing)


def _add_axis(spec: Spec, shape, axis: str, size: int) -> Spec:
    """ZeRO/FSDP: place `axis` on the largest free, divisible dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    free = [i for i in range(len(shape))
            if entries[i] is None and shape[i] % size == 0
            and shape[i] >= size]
    if not free:
        return tuple(entries)
    i = max(free, key=lambda j: shape[j])
    entries[i] = axis
    return tuple(entries)


def _map(fn, tree_):
    """fn(path, leaf) over every leaf, in a tree of tree_'s structure."""
    pairs = tree.leaves_with_paths(tree_)
    return tree.unflatten(tree_, [fn(p, leaf) for p, leaf in pairs])


def param_shardings(cfg: ModelConfig, mesh, params_tree,
                    fsdp: Optional[bool] = None):
    """TP over `model` + (where cfg.fsdp) FSDP over `data` on a free
    dim."""
    sizes = _sizes(mesh)
    msize = sizes["model"]
    use_fsdp = cfg.fsdp if fsdp is None else fsdp

    def spec(path, leaf):
        s = _spec_for_param(cfg, path, leaf.shape, msize)
        if use_fsdp and cfg.tensor_parallel and _ndim(leaf) >= 2:
            s = _add_axis(s, leaf.shape, "data", sizes["data"])
        return NamedSharding(mesh, s)
    return _map(spec, params_tree)


def grad_shardings(cfg: ModelConfig, mesh, params_tree):
    """float32 gradient-accumulator specs: param specs + ZeRO over
    data(/model)."""
    sizes = _sizes(mesh)
    msize = sizes["model"]

    def spec(path, leaf):
        s = _spec_for_param(cfg, path, leaf.shape, msize)
        s = _add_axis(s, leaf.shape, "data", sizes["data"])
        if not cfg.tensor_parallel:
            s = _add_axis(s, leaf.shape, "model", msize)
        return NamedSharding(mesh, s)
    return _map(spec, params_tree)


def opt_state_shardings(cfg: ModelConfig, mesh, params_tree, opt_state_tree):
    """Moments mirror param specs; Adafactor's factored moments drop a
    dim."""
    sizes = _sizes(mesh)
    by_shape: Dict[tuple, Spec] = {}
    for path, leaf in tree.leaves_with_paths(params_tree):
        by_shape.setdefault(tuple(leaf.shape), _spec_for_param(
            cfg, path, leaf.shape, sizes["model"]))

    def zero(spec: Spec, shape) -> Spec:
        """ZeRO: moments are elementwise -> also shard over data(+model)."""
        spec = _add_axis(spec, shape, "data", sizes["data"])
        if not cfg.tensor_parallel:
            spec = _add_axis(spec, shape, "model", sizes["model"])
        return spec

    def spec_for(_path, leaf):
        shape = tuple(leaf.shape)
        if shape in by_shape:
            return NamedSharding(mesh, zero(by_shape[shape], shape))
        # factored moments: a param shape with one trailing dim removed
        for pshape, spec in by_shape.items():
            if shape == pshape[:-1] and len(pshape) >= 1:
                return NamedSharding(mesh, zero(spec[:-1], shape)) \
                    if len(spec) else NamedSharding(mesh, zero((), shape))
            if shape == pshape[:-2] + pshape[-1:] and len(spec) >= 2:
                return NamedSharding(
                    mesh, zero(spec[:-2] + spec[-1:], shape))
        return NamedSharding(mesh, ())

    return _map(spec_for, opt_state_tree)


def batch_shardings(cfg: ModelConfig, mesh, specs, global_batch: int):
    baxes = batch_axes(cfg, mesh, global_batch)
    # one axis is its bare name, as PartitionSpec normalizes it
    bspec = (baxes[0] if len(baxes) == 1 else baxes) if baxes else None
    sizes = _sizes(mesh)
    # sequence parallelism: non-TP attention archs whose batch does not
    # cover the model axis shard the sequence dim over it instead
    recurrent = any(k in ("mlstm", "slstm", "rglru")
                    for k in cfg.block_pattern)
    use_sp = (not cfg.tensor_parallel) and ("model" not in baxes) \
        and not recurrent

    def spec(path, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return NamedSharding(mesh, ())
        entries = [bspec] + [None] * (nd - 1)
        if use_sp:
            sdim = 2 if path and path[-1] == "positions" else 1
            if nd > sdim and leaf.shape[sdim] % sizes["model"] == 0 \
                    and leaf.shape[sdim] >= sizes["model"]:
                entries[sdim] = "model"
        return NamedSharding(mesh, tuple(entries))

    return _map(spec, specs)


def state_shardings(cfg: ModelConfig, mesh, state_tree, global_batch: int):
    """Decode-state specs.  Leaves have a leading segment-stack dim R."""
    baxes = batch_axes(cfg, mesh, global_batch)
    sizes = _sizes(mesh)

    def sanitize(spec: Spec, shape) -> Spec:
        """Drop axis assignments that do not divide the dimension."""
        out = []
        for i, entry in enumerate(spec):
            if entry is None:
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            keep = []
            for a in axes:
                if shape[i] % (math.prod(sizes[x] for x in keep)
                               * sizes[a]) == 0:
                    keep.append(a)
            out.append(tuple(keep) if len(keep) > 1
                       else (keep[0] if keep else None))
        return tuple(out)

    # KV caches shard their *sequence* dim over "model" (flash-decode
    # style); sharding kv-heads instead would pad 1-8 heads up to 16
    baxes_nm = tuple(a for a in baxes if a != "model")
    bspec = baxes_nm if baxes_nm else None
    tp = "model" if cfg.tensor_parallel else None
    seq_par = global_batch == 1          # long-context: shard the state
    dm = ("data", "model")

    def raw_spec(names, nd) -> Spec:
        leaf_name = names[-1]
        if leaf_name == "pos":
            return ()
        if leaf_name in ("ck", "cv"):                # (R,B,enc,KV,dh)
            return (None, bspec, None, None, None)
        if leaf_name in ("k", "v"):                  # (R,B,T,KV,dh)
            if seq_par:
                return (None, None, dm, None, None)
            return (None, bspec, "model", None, None)
        if leaf_name in ("c_kv", "k_pe"):            # (R,B,T,r) MLA latent
            if seq_par:
                return (None, None, dm, None)
            return (None, bspec, "model", None)
        if leaf_name == "C":                          # (R,B,H,dq,dv) mLSTM
            if seq_par:
                return (None, None, None, "data", "model")
            return (None, bspec, None, tp, None)
        if leaf_name == "n" and nd == 4:              # (R,B,H,dq)
            if seq_par:
                return (None, None, None, dm)
            return (None, bspec, None, tp)
        if leaf_name == "conv":                       # (R,B,cw-1,ch)
            if seq_par:
                return (None, None, None, dm)
            return (None, bspec, None, tp)
        if leaf_name == "h" and nd == 3:              # (R,B,w) rglru
            if seq_par:
                return (None, None, dm)
            return (None, bspec, tp)
        if nd == 3:                                   # (R,B,d) slstm
            if seq_par:
                return (None, None, dm)
            return (None, bspec, None)
        if nd >= 2:
            return (None, bspec) + (None,) * (nd - 2)
        return ()

    def spec(path, leaf):
        return NamedSharding(mesh, sanitize(raw_spec(path, _ndim(leaf)),
                                            leaf.shape))

    return _map(spec, state_tree)


def with_shardings(struct_tree, sharding_tree):
    """[(leaf, sharding)] pairs of a shape tree and its shardings, in
    flattening order (the reference attaches them to ShapeDtypeStructs
    for its dry run; the port's dry run reads them as pairs)."""
    return list(zip(tree.leaves(struct_tree),
                    tree.flatten_up_to(struct_tree, sharding_tree)))


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shape of a `shape` tensor under `spec` (the reference's
    ``NamedSharding.shard_shape``); every named axis must divide its
    dim."""
    sizes = _sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        ways = math.prod(sizes[a] for a in
                         (entry if isinstance(entry, tuple) else (entry,)))
        if out[i] % ways:
            raise ValueError(f"{ways} ways do not divide dim {i} of "
                             f"{tuple(shape)} under {spec}")
        out[i] //= ways
    return tuple(out)


def distribute(tree_, shardings, mesh):
    """Whole tensors, the same on every rank, as DTensors placed by their
    NamedShardings (or bare specs) on `mesh`: each rank keeps its own
    block, with no communication.  Meta tensors give meta DTensors (the
    dry run's abstract shards)."""
    from torch.distributed.tensor import DTensor
    from .tp import local_shard

    def one(x, sh):
        spec = sh.spec if isinstance(sh, NamedSharding) else sh
        return DTensor.from_local(
            local_shard(x, spec, mesh).contiguous(), mesh,
            placements(spec, mesh), run_check=False, shape=x.shape,
            stride=x.stride())
    return tree.map_leaves(one, tree_, shardings)


def spec_of(dt, mesh=None) -> Spec:
    """The spec of a DTensor's placements (the inverse of ``placements``;
    a plain tensor is replicated: ``()``)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(dt, DTensor):
        return ()
    names = dt.device_mesh.mesh_dim_names
    out = [[] for _ in range(dt.dim())]
    for name, p in zip(names, dt.placements):
        if isinstance(p, Shard):
            out[p.dim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in out)


def placements(spec: Spec, mesh):
    """DTensor placements of `spec` on `mesh`: per mesh dim, ``Shard(d)``
    for the tensor dim d whose entry names it, else ``Replicate()``.  A
    tensor dim sharded over several axes names them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} names {axes} out of mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)
