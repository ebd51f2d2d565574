"""Tensor- and sequence-parallel execution: the layout a step runs in and
the collectives its model code calls.

A step on a ``DeviceMesh`` holds its parameters, gradients, optimizer
moments and decode state as DTensors placed by the reference's specs
(``shardings.placements``, ``shardings.distribute``).  Inside the step each
rank computes on its local shards as plain tensors, Megatron style: the
model code reads the active ``Context`` and calls the collectives below
where its shards meet.

* ``tp``: tensor parallelism over the mesh's ``model`` axis (an arch with
  ``cfg.tensor_parallel``): attention heads, feed-forward and expert
  widths, the vocabulary and the RG-LRU width are sharded, as the specs
  shard the weights that produce them.
* ``sp``: sequence parallelism (a non-TP arch whose batch does not cover
  the ``model`` axis): the activations' sequence dim is sharded, and
  attention gathers its keys and values along it.
* ``kv``: the axes the attention caches' sequence dim is sharded over
  (decode): each rank scores its own slots, and the softmax's max, sum
  and weighted values are combined across ranks, flash-decode style.
* ``rows``: the batch axes (with ``sp``'s): a statistic over the whole
  batch, such as the MoE load-balancing loss's means, is taken across
  them (``global_mean``).

Outside a step, or on an axis of one rank, every collective is the
identity and the model runs its single-process code.

Gradient convention (Megatron's): a replicated activation carries its
whole gradient on every rank.  ``copy`` enters rank-specific compute
(identity forward, all-reduce backward), ``reduce`` leaves it (all-reduce
forward, identity backward), ``gather`` turns a sharded activation into a
replicated one (all-gather forward; backward the rank's chunk, or with
``scatter=True``, for a gathered value that feeds rank-specific compute,
a reduce-scatter), and ``split`` takes the rank's chunk (all-gather
backward).  Collectives run on the tensors' own device: gloo carries CUDA
tensors through the host, and the fake group of the dry run carries meta
tensors.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One or more mesh axes as one ordered group of ranks: its size,
    this rank's index in it (row-major over the axes, in mesh order), and
    its process group (None for one rank)."""
    size: int = 1
    rank: int = 0
    group: Any = field(default=None, compare=False)


ONE = Axis()


@dataclass(frozen=True)
class Context:
    """The layout a step's model code runs in (see the module doc)."""
    tp: Axis = ONE
    sp: Axis = ONE
    kv: Axis = ONE
    rows: Axis = ONE


_STACK = [Context()]


def current() -> Context:
    return _STACK[-1]


@contextlib.contextmanager
def use(ctx: Context):
    """Within: the model code runs in layout `ctx`."""
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


def group(mesh, names):
    """The process group of `mesh`'s axes `names` (in mesh order): the
    axis's own for one, the flattened mesh's for more (``DeviceMesh``
    keeps each flattened mesh, so its group is made once)."""
    names = tuple(names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def axis(mesh, names) -> Axis:
    """The Axis of `mesh`'s axes `names` (in mesh order; empty: ONE)."""
    names = tuple(names)
    if not names:
        return ONE
    dims = list(mesh.mesh_dim_names)
    if [dims.index(n) for n in names] != sorted(dims.index(n)
                                                for n in names):
        raise ValueError(f"axes {names} out of mesh order {tuple(dims)}")
    sizes = dict(zip(dims, mesh.mesh.shape))
    coord = dict(zip(dims, mesh.get_coordinate()))
    size = math.prod(sizes[n] for n in names)
    rank = 0
    for n in names:
        rank = rank * sizes[n] + coord[n]
    if size == 1:
        return ONE
    return Axis(size, rank, group(mesh, names))


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------

def all_gather(x, dim: int, ax: Axis):
    """The ranks' `x` concatenated along `dim` in rank order."""
    if ax.size == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((ax.size * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=ax.group)
    return out.movedim(0, dim)


def reduce_scatter(x, dim: int, ax: Axis):
    """The sum over the ranks of `x`, this rank's chunk along `dim`."""
    if ax.size == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // ax.size,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=ax.group)
    return out.movedim(0, dim)


def all_reduce(x, ax: Axis, op=dist.ReduceOp.SUM):
    """The reduction of `x` over the ranks, in a new tensor."""
    if ax.size == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=ax.group)
    return out


def all_max(x, ax: Axis):
    """The elementwise max of `x` over the ranks, in a new tensor."""
    return all_reduce(x, ax, dist.ReduceOp.MAX)


def global_mean(x, ax: Axis):
    """The mean of `x` over the ranks, with this rank's gradient passed as
    it is: the step averages every rank's gradients over the batch axes,
    which takes each rank's share of the mean once."""
    if ax.size == 1:
        return x
    return x + (all_reduce(x.detach(), ax) / ax.size - x.detach())


def chunk(x, dim: int, ax: Axis):
    """This rank's chunk of `x` along `dim` (a view)."""
    if ax.size == 1:
        return x
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"{ax.size} ranks do not divide dim {dim} of "
                         f"{tuple(x.shape)}")
    step = n // ax.size
    return x.narrow(dim, ax.rank * step, step)


# ---------------------------------------------------------------------------
# autograd-aware collectives
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, scatter):
        ctx.dim, ctx.ax, ctx.scatter = dim, ax, scatter
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            return reduce_scatter(g, ctx.dim, ctx.ax), None, None, None
        return chunk(g, ctx.dim, ctx.ax).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return chunk(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


def copy(x, ax: Axis):
    """Identity forward; the gradient all-reduced (a replicated value
    entering rank-specific compute)."""
    return x if ax.size == 1 else _Copy.apply(x, ax)


def reduce(x, ax: Axis):
    """The sum over the ranks (partial sums leaving rank-specific
    compute); the gradient passes as it is."""
    return x if ax.size == 1 else _Reduce.apply(x, ax)


def gather(x, dim: int, ax: Axis, scatter: bool = False):
    """The ranks' shards concatenated along `dim`.  Backward: this rank's
    chunk of the gradient, or with `scatter` (the gathered value feeds
    rank-specific compute) the reduce-scatter of the ranks' gradients."""
    return x if ax.size == 1 else _Gather.apply(x, dim, ax, scatter)


def split(x, dim: int, ax: Axis):
    """This rank's chunk along `dim`; the gradient all-gathered."""
    return x if ax.size == 1 else _Split.apply(x, dim, ax)


# ---------------------------------------------------------------------------
# head-sharded projections
# ---------------------------------------------------------------------------

def span(total: int, ax: Axis) -> Tuple[int, int]:
    """[lo, hi): this rank's contiguous 1/size of `total` columns."""
    step = total // ax.size
    return ax.rank * step, (ax.rank + 1) * step


def heads_of(lo: int, hi: int, hd: int) -> Tuple[int, int]:
    """The heads [h0, h1) of width `hd` that columns [lo, hi) touch."""
    return lo // hd, -(-hi // hd)


def head_cols(t, n_heads: int, hd: int, h0: int, h1: int, ax: Axis,
              sharded: bool):
    """Columns [h0·hd, h1·hd) of the last dim of `t`: this rank's block
    of the n_heads·hd columns when `sharded` (else all of them).  The
    local block when it is exactly those heads; else the gathered whole
    (its gradient reduce-scattered), cut."""
    if sharded:
        lo, hi = span(n_heads * hd, ax)
        if (lo, hi) == (h0 * hd, h1 * hd):
            return t
        t = gather(t, -1, ax, scatter=True)
    if (h0, h1) == (0, n_heads):
        return t
    return t[..., h0 * hd:h1 * hd]


# ---------------------------------------------------------------------------
# local layouts of a spec
# ---------------------------------------------------------------------------

def entry_axes(spec, d: int) -> Tuple[str, ...]:
    """The mesh axes that `spec` names for tensor dim `d`."""
    if d >= len(spec) or spec[d] is None:
        return ()
    e = spec[d]
    return tuple(e) if isinstance(e, tuple) else (e,)


def local_shard(x, spec, mesh):
    """This rank's block of the whole tensor `x` under `spec` (a view)."""
    for d in range(x.dim()):
        x = chunk(x, d, axis(mesh, entry_axes(spec, d)))
    return x


def to_spec(x, src, dst, mesh):
    """A local tensor under spec `src` as its local tensor under `dst`
    (no gradient): per dim, a further cut where `dst` refines `src`'s
    axes, else an all-gather over `src`'s axes and a cut by `dst`'s."""
    for d in range(x.dim()):
        f, t = entry_axes(src, d), entry_axes(dst, d)
        if f == t:
            continue
        if t[:len(f)] == f:
            x = chunk(x, d, axis(mesh, t[len(f):]))
        else:
            x = chunk(all_gather(x, d, axis(mesh, f)), d, axis(mesh, t))
    return x
