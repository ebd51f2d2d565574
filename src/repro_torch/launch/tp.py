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

The ZeRO step's collectives take many leaves at once:
``reduce_scatter_leaves`` sums the gradients over the batch axes into
each rank's block of its spec and ``all_gather_leaves`` gathers the
updated blocks back, one flat collective for the leaves of one dtype
and placement, each leaf's blocks laid out rank-major (gloo carries a
CUDA tensor through the host, and a collective per leaf would pay that
round trip per leaf).  ``to_spec`` converts a local
tensor between specs; where an axis moves between dims (a moment stored
in another leaf's placement) one all-to-all sends each rank only the
blocks it lacks.

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
    axes, else an all-gather over `src`'s axes and a cut by `dst`'s.
    Where an axis moves from one dim to another (a moment stored in
    another leaf's placement), one all-to-all over the axes that change
    sends each rank only the blocks it lacks (``_exchange``)."""
    sizes = _sizes(mesh)
    at_src, at_dst = ({a: d for d in range(x.dim()) for a in
                       entry_axes(s, d) if sizes[a] > 1} for s in (src, dst))
    if any(at_dst.get(a, d) != d for a, d in at_src.items()):
        changed = {a for d in range(x.dim())
                   if entry_axes(src, d) != entry_axes(dst, d)
                   for a in entry_axes(src, d) + entry_axes(dst, d)
                   if sizes[a] > 1}
        return _exchange(x, src, dst, mesh, _mesh_order(mesh, changed))
    plan = []
    for d in range(x.dim()):
        f, t = entry_axes(src, d), entry_axes(dst, d)
        if f == t:
            continue
        if t[:len(f)] == f:
            plan.append((d, t[len(f):]))
        else:
            x = all_gather(x, d, axis(mesh, f))
            plan.append((d, t))
    for d, names in plan:
        x = chunk(x, d, axis(mesh, names))
    return x


def _block(entry, coord, sizes) -> Tuple[int, int]:
    """(this block's index, the count of blocks) of a dim cut by the
    mesh axes `entry` (row-major), at mesh coordinates `coord`."""
    index, count = 0, 1
    for a in entry:
        index = index * sizes[a] + coord[a]
        count *= sizes[a]
    return index, count


def _exchange(x, src, dst, mesh, names):
    """`x`, local under `src`, as its local tensor under `dst`, the two
    specs differing only in the axes `names`: each rank sends every other
    rank of their group the part of its block that the other's block
    under `dst` holds, in one all-to-all."""
    sizes = _sizes(mesh)
    me = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    ax = axis(mesh, names)
    shape = [n * _block(entry_axes(src, d), me, sizes)[1]
             for d, n in enumerate(x.shape)]

    def box(spec, coord):
        out = []
        for d, n in enumerate(shape):
            i, k = _block(entry_axes(spec, d), coord, sizes)
            out.append((i * (n // k), (i + 1) * (n // k)))
        return out

    def meet(a, b):
        out = [(max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in
               zip(a, b)]
        return out if all(lo < hi for lo, hi in out) else None

    def within(part, outer):
        return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                     zip(part, outer))

    mine_src, mine_dst = box(src, me), box(dst, me)
    send, send_n, recv, recv_n = [], [], [], []
    for r in range(ax.size):
        peer = dict(me)
        for a in reversed(names):
            peer[a], r = r % sizes[a], r // sizes[a]
        part = meet(mine_src, box(dst, peer))
        if part is not None:
            send.append(x[within(part, mine_src)].reshape(-1))
        send_n.append(0 if part is None else send[-1].numel())
        part = meet(box(src, peer), mine_dst)
        recv.append(part)
        recv_n.append(0 if part is None else
                      math.prod(hi - lo for lo, hi in part))
    buf = torch.cat(send) if send else x.new_empty(0)
    got = x.new_empty(sum(recv_n))
    dist.all_to_all_single(got, buf.contiguous(), recv_n, send_n,
                           group=ax.group)
    out = x.new_empty([hi - lo for lo, hi in mine_dst])
    at = 0
    for part, n in zip(recv, recv_n):
        if part is not None:
            out[within(part, mine_dst)] = got[at:at + n].view(
                [hi - lo for lo, hi in part])
            at += n
    return out


# ---------------------------------------------------------------------------
# bucketed collectives of many leaves (the ZeRO step)
# ---------------------------------------------------------------------------

#: the most elements a flat collective moves from one rank (1 GiB of
#: float32): a larger bucket goes in pieces, each a flat collective
CHUNK = 1 << 28


def _sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _pieces(n: int, step: int):
    """[lo, hi) of `n` elements in pieces of at most `step`."""
    return [(lo, min(lo + step, n)) for lo in range(0, n, max(step, 1))]


def _all_reduce_flat(x, ax: Axis):
    """The sum over `ax`'s ranks of the flat tensor `x`, in a new tensor,
    in pieces of at most CHUNK elements."""
    if ax.size == 1:
        return x
    out = x.clone()
    for lo, hi in _pieces(out.numel(), CHUNK):
        dist.all_reduce(out[lo:hi], group=ax.group)
    return out


def _factored(shape, coarse, fine, mesh):
    """The blocks of a tensor of `shape` under spec `coarse` that spec
    `fine` cuts it into: (each dim split into one factor per axis of
    more than one rank that `fine` adds to it, in the entry's order,
    then the block's own length; {axis: its factor's position}; the
    block's shape).  `fine` must refine `coarse` on every dim."""
    sizes = _sizes(mesh)
    split, where, block = [], {}, []
    for d, n in enumerate(shape):
        f, t = entry_axes(coarse, d), entry_axes(fine, d)
        if t[:len(f)] != f:
            raise ValueError(f"{fine} does not refine {coarse} on dim {d}")
        for a in t[len(f):]:
            if sizes[a] > 1:
                if n % sizes[a]:
                    raise ValueError(f"{sizes[a]} ranks of {a!r} do not "
                                     f"divide dim {d} of {tuple(shape)}")
                where[a] = len(split)
                split.append(sizes[a])
                n //= sizes[a]
        split.append(n)
        block.append(n)
    return split, where, tuple(block)


def _mesh_order(mesh, names):
    return tuple(n for n in mesh.mesh_dim_names if n in names)


def _buckets(keys):
    """{key: [leaf indices]} in order of first appearance."""
    out = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return out


def reduce_scatter_leaves(xs, src, dst, axes, mesh):
    """The sums over the ranks of mesh `axes` of the leaves `xs`, local
    tensors under specs `src`, each rank keeping its block under `dst`
    (a refinement of its `src`).  Per leaf, the axes that `dst` adds and
    `axes` names are reduce-scattered, the rest of `axes` all-reduced
    after; an axis that `dst` adds and `axes` lacks (its ranks hold the
    same sum) is a local cut.  The leaves of one dtype, scattered and
    all-reduced over the same axes, go in one flat reduce-scatter (each
    leaf's blocks laid out rank-major: the buffer's row r is rank r's
    blocks) and one all-reduce, in pieces of at most CHUNK elements."""
    axes = set(axes)
    plans, keys = [], []
    for x, s, t in zip(xs, src, dst):
        cut = axes & {a for d in range(x.dim()) for a in entry_axes(s, d)}
        if cut:
            raise ValueError(f"a sum over {sorted(cut)}, which cut the "
                             f"leaf's {s}")
        split, where, block = _factored(x.shape, s, t, mesh)
        scat = _mesh_order(mesh, [a for a in where if a in axes])
        rest = _mesh_order(mesh, axes - set(scat))
        plans.append((split, where, block, scat))
        keys.append((x.dtype, scat, rest))
    out = [None] * len(xs)
    for (dtype, scat, rest), idx in _buckets(keys).items():
        ax = axis(mesh, scat)
        for group in _groups(idx, [xs[i].numel() for i in idx]):
            rows = []
            for i in group:
                split, where, block, _ = plans[i]
                y = xs[i].reshape(split)
                for a, at in where.items():   # cut locally, as chunk does
                    if a not in scat:
                        y = y.narrow(at, axis(mesh, (a,)).rank, 1)
                lead = [where[a] for a in scat]
                y = y.permute(lead + [j for j in range(y.dim())
                                      if j not in lead])
                rows.append(y.reshape(ax.size, -1))
            buf = torch.cat(rows, dim=1) if len(rows) > 1 else rows[0]
            del rows
            if ax.size > 1:
                got = buf.new_empty(buf.shape[1])
                for lo, hi in _pieces(buf.shape[1], CHUNK // ax.size):
                    dist.reduce_scatter_tensor(
                        got[lo:hi], buf[:, lo:hi].contiguous().reshape(-1),
                        group=ax.group)
            else:
                got = buf.reshape(-1)
            del buf
            got = _all_reduce_flat(got, axis(mesh, rest))
            at = 0
            for i in group:
                block = plans[i][2]
                n = math.prod(block)
                out[i] = got[at:at + n].view(block)
                at += n
    return out


def _groups(idx, sizes):
    """`idx` in runs of consecutive leaves of at most CHUNK elements in
    all (a larger leaf alone), so a bucket's flat buffer stays small."""
    out, run, total = [], [], 0
    for i, n in zip(idx, sizes):
        if run and total + n > CHUNK:
            out.append(run)
            run, total = [], 0
        run.append(i)
        total += n
    return out + [run] if run else out


def all_gather_leaves(xs, src, dst, mesh):
    """Each leaf of `xs`, a local tensor under spec `src`, as its local
    tensor under `dst`, which `src` refines: gathered over the axes that
    `src` adds.  The leaves of one dtype gathered over the same axes go
    in one flat all-gather (in pieces of at most CHUNK elements a rank),
    each leaf's block laid out rank-major."""
    plans, keys = [], []
    for x, s, t in zip(xs, src, dst):
        whole = [n * math.prod(_sizes(mesh)[a] for a in entry_axes(s, d)
                               if a not in entry_axes(t, d))
                 for d, n in enumerate(x.shape)]
        split, where, _ = _factored(whole, t, s, mesh)
        plans.append((whole, split, where))
        keys.append((x.dtype, _mesh_order(mesh, where)))
    out = list(xs)
    for (dtype, names), idx in _buckets(keys).items():
        ax = axis(mesh, names)
        if ax.size == 1:
            continue
        flat = torch.cat([xs[i].reshape(-1) for i in idx]) \
            if len(idx) > 1 else xs[idx[0]].reshape(-1)
        flat = flat.contiguous()
        pieces = _pieces(flat.shape[0], CHUNK // ax.size)
        got = flat.new_empty(ax.size, flat.shape[0])
        for lo, hi in pieces:
            part = got if len(pieces) == 1 else \
                flat.new_empty(ax.size, hi - lo)
            dist.all_gather_into_tensor(part.view(-1), flat[lo:hi],
                                        group=ax.group)
            if len(pieces) > 1:
                got[:, lo:hi] = part
        at = 0
        for i in idx:
            whole, split, where = plans[i]
            x = xs[i]
            y = got[:, at:at + x.numel()].reshape(
                [_sizes(mesh)[a] for a in names] + list(x.shape))
            at += x.numel()
            # y's dims are the factored layout's, the gathered axes first
            lead = [where[a] for a in names]
            order = lead + [j for j in range(len(split)) if j not in lead]
            out[i] = y.permute(sorted(range(len(order)),
                                      key=order.__getitem__)).reshape(whole)
    return out
