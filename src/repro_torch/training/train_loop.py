"""Training and serving step factories (port of
``repro/training/train_loop.py``).

``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: gradient accumulation over
``cfg.microbatches_train`` microbatches (the batch's rows cut into that
many consecutive blocks) in float32 accumulators, the mean over the
microbatches, global-norm clipping, the optimizer's update added to the
parameters in their own dtype, and metrics {"loss", "grad_norm"} (loss:
the loss function's total, averaged over the microbatches, as the
reference reports it).  ``make_serve_steps`` wraps the model's prefill
and decode steps.

The reference's sharding arguments (trees of
``launch/shardings.NamedSharding``) take effect on their DeviceMesh.
Where every spec names only batch axes, as data parallelism: each rank
takes its rows of the global batch (its index over the batch axes,
``launch/shardings.batch_axes``; ranks on the other axes hold the same
rows), accumulates its microbatches as above, and all-reduce-averages
the gradients and the loss over the batch axes before clipping, so the
update is replicated.  On a mesh of one rank the step is the unsharded
step, bit for bit.

Where a spec names ``model`` outside the batch axes (a tensor-parallel
arch on a model axis above 1, or sequence parallelism), or the
parameters are DTensors, the step is sharded (``training/sharded.py``):
the parameters and optimizer state are DTensors
(``launch/shardings.distribute`` of ``param_shardings``; ``opt.init`` of
those), each rank computes on its shards under a
``launch/tp.Context``, the gradients of sharded leaves stay shards, the
batch-axis average (summed over the sequence ranks too) applies to every
leaf, the global norm sums every shard's squares, and the update runs on
each rank's shards; the parameters come back as DTensors placed as they
went in.  A rank whose rows do not split into the configured
microbatches takes their greatest common divisor (``sharded.
microbatches``; the reference splits the global batch first and pads).
The moments follow the parameters' placements: the reference's ZeRO
placement of the accumulator and moments (``grad_shardings``' and
``opt_state_shardings``' extra data shard) is ROADMAP Queue 1 item 22.

``make_serve_steps(cfg, mesh)`` serves on a mesh likewise: DTensor
parameters, the batch cut by ``batch_shardings``, the decode state as
DTensors under ``state_shardings``, and logits as DTensors whose rows
are sharded as the step's batch rows.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shardings import NamedSharding, batch_axes
from repro_torch.models import build_model
from repro_torch.launch import tp
from repro_torch.optim import clip_by_global_norm, make_optimizer
from . import sharded as SH


def accumulate_grads(loss_fn, params, batch, nmb: int = 1):
    """(loss, grads): the loss function's total and its gradient with
    respect to every parameter leaf, each averaged over `nmb`
    microbatches (the batch's rows in `nmb` consecutive blocks), the
    gradients float32 (a leaf no path reaches gets zeros)."""
    flat = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, flat)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in flat]
    loss_sum = None
    for i in range(nmb):
        if nmb == 1:
            micro = batch
        else:
            micro = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
                     for k, v in batch.items()}
        total, _ = loss_fn(live, micro)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a += g.to(torch.float32)
        total = total.detach().to(torch.float32)
        loss_sum = total if loss_sum is None else loss_sum + total
    if nmb > 1:
        acc = [a / nmb for a in acc]
        loss_sum = loss_sum / nmb
    return loss_sum, tree.unflatten(params, acc)


class _DataParallel:
    """This rank's rows of the batch and the gradient average over the
    batch axes of `mesh`."""

    def __init__(self, mesh, axes):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the step's mesh")
        at = dict(zip(mesh.mesh_dim_names, coord))
        self.ways = math.prod(sizes[a] for a in axes)
        self.index = 0
        for a in axes:
            self.index = self.index * sizes[a] + at[a]
        self.axis = tp.axis(mesh, axes)

    def rows(self, batch, nmb: int):
        """This rank's rows of the global batch; they must split into
        `nmb` microbatches."""
        B = next(iter(batch.values())).shape[0]
        if B % (self.ways * nmb):
            raise ValueError(f"{self.ways} batch shards of {nmb} "
                             f"microbatches do not divide the batch's {B} "
                             "rows")
        lo = self.index * (B // self.ways)
        return {k: v[lo:lo + B // self.ways] for k, v in batch.items()}

    def average(self, loss, grads):
        """(loss, grads) averaged over the batch axes' ranks."""
        return _flat_average(loss, grads, self.axis, self.ways)


def _flat_average(loss, grads, ax, ways: int, loss_ranks: int = 1):
    """(loss, grads) summed over `ax`'s ranks in one all-reduce of a flat
    float32 buffer and divided by `ways`; the loss first divided by
    `loss_ranks`, the ranks of `ax` that hold the same loss."""
    if ax.size == 1:
        return loss, grads
    flat = tree.leaves(grads)
    buf = torch.cat([g.reshape(-1) for g in flat] +
                    [(loss / loss_ranks if loss_ranks > 1 else loss)
                     .reshape(1)])
    dist.all_reduce(buf, group=ax.group)
    buf = buf / ways
    out, at = [], 0
    for g in flat:
        out.append(buf[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return buf[at].reshape(()), tree.unflatten(grads, out)


def _mesh_and_axes(grad_shardings, batch_shardings):
    """(mesh, batch axes) of the sharding arguments: the batch axes are
    the first entry of a batch spec (None without batch shardings:
    ``batch_axes`` of the first step's batch)."""
    leaves = [x for t in (batch_shardings, grad_shardings) if t is not None
              for x in tree.leaves(t)]
    if not leaves or not all(isinstance(x, NamedSharding) for x in leaves):
        raise TypeError("grad_shardings / batch_shardings must be trees of "
                        "launch.shardings.NamedSharding")
    mesh = leaves[0].mesh
    if batch_shardings is None:
        return mesh, None
    spec = next(s.spec for s in tree.leaves(batch_shardings) if s.spec)
    axes = spec[0] or ()
    return mesh, (axes,) if isinstance(axes, str) else tuple(axes)


def _is_sharded(cfg, mesh, bspecs) -> bool:
    """Whether a step on `mesh` needs more than data parallelism: a
    tensor-parallel arch on a model axis above 1, or a batch spec naming
    an axis on a dim past the rows."""
    msize = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("model", 1)
    if cfg.tensor_parallel and msize > 1:
        return True
    return any(tp.entry_axes(s, d) for s in bspecs.values()
               for d in range(1, len(s)))


def _sharded_step(cfg, model, opt, nmb, clip_norm, mesh, bspecs, params,
                  opt_state, batch):
    """One step of the sharded path (the module doc)."""
    main = SH.main_spec(bspecs)
    rows_ax = tp.entry_axes(main, 0)
    seq_ax = tp.entry_axes(main, 1)
    ctx = SH.context(cfg, mesh, rows=rows_ax, sp=seq_ax)
    local, pspecs = SH.compute_params(params, mesh)
    lb = SH.local_batch(batch, bspecs, mesh)
    rows = next(iter(lb.values())).shape[0]
    with tp.use(ctx):
        loss, grads = accumulate_grads(model["loss_fn"], local, lb,
                                       SH.microbatches(rows, nmb))
    # the batch-axis average, summed over the sequence's ranks
    loss, grads = _flat_average(
        loss, grads, tp.axis(mesh, SH.union(mesh, rows_ax, seq_ax)),
        tp.axis(mesh, rows_ax).size, ctx.sp.size)
    flat = tree.leaves(grads)
    pflat = tree.leaves(params)
    gdt = [SH.wrap(p, tp.to_spec(g, SH.model_only(s), s, mesh), mesh)
           for p, g, s in zip(pflat, flat, pspecs)]
    gdt, gnorm = clip_by_global_norm(tree.unflatten(params, gdt), clip_norm)
    with torch.no_grad():
        plocal = tree.unflatten(params, [SH.unwrap(p)[0] for p in pflat])
        glocal = tree.map_leaves(lambda g: SH.unwrap(g)[0], gdt)
        slocal = tree.map_leaves(lambda x: SH.unwrap(x)[0], opt_state)
        updates, new_state = opt.update(
            glocal, slocal, plocal,
            shards=[SH.shards_of(s, mesh) for s in pspecs])
        new = [SH.wrap(p, pl + u.to(pl.dtype), mesh) for p, pl, u in
               zip(pflat, tree.leaves(plocal), tree.leaves(updates))]
        new_state = tree.map_leaves(lambda x, y: SH.wrap(x, y, mesh),
                                    opt_state, new_state)
    return tree.unflatten(params, new), new_state, {"loss": loss,
                                                    "grad_norm": gnorm}


def make_train_step(cfg: ModelConfig, peak_lr: float = 3e-4,
                    clip_norm: float = 1.0, grad_shardings=None,
                    batch_shardings=None) -> Tuple[Callable, Callable, Any]:
    """Returns (init_fn, step_fn, optimizer).  init_fn(gen) -> (params,
    opt_state) on gen's device; step_fn as documented above: with
    sharding arguments, every rank of their mesh calls it on the same
    global batch."""
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, peak_lr)
    nmb = max(1, cfg.microbatches_train)
    mesh = axes = None
    if grad_shardings is not None or batch_shardings is not None:
        mesh, axes = _mesh_and_axes(grad_shardings, batch_shardings)
    parallel = {}                     # batch axes -> _DataParallel

    def data_parallel(batch) -> _DataParallel:
        ax = axes if axes is not None else batch_axes(
            cfg, mesh, next(iter(batch.values())).shape[0])
        if ax not in parallel:
            parallel[ax] = _DataParallel(mesh, ax)
        return parallel[ax]

    def init_fn(gen: torch.Generator):
        params = model["init_params"](gen)
        return params, opt.init(params)

    def step_fn(params, opt_state, batch):
        par = None
        if mesh is not None:
            bspecs = SH.batch_specs(cfg, mesh, batch, batch_shardings)
            if _is_sharded(cfg, mesh, bspecs) or \
                    SH.mesh_of(params) is not None:
                return _sharded_step(cfg, model, opt, nmb, clip_norm, mesh,
                                     bspecs, params, opt_state, batch)
            par = data_parallel(batch)
            batch = par.rows(batch, nmb)
        loss, grads = accumulate_grads(model["loss_fn"], params, batch, nmb)
        if par is not None:
            loss, grads = par.average(loss, grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = tree.map_leaves(lambda p, u: p + u.to(p.dtype), params,
                                     updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return init_fn, step_fn, opt


def make_serve_steps(cfg: ModelConfig, mesh=None):
    """Returns (prefill_fn, decode_fn, model) for the inference cells.

    prefill_fn(params, batch, max_len) -> (last_logits, decode_state)
    decode_fn(params, state, tokens, pos) -> (logits, new_state)

    With a `mesh`, the steps are sharded (the module doc): the
    parameters are DTensors (or whole tensors, replicated), the batch
    and tokens whole or DTensors, and the logits and decode state come
    back as DTensors.
    """
    model = build_model(cfg)
    if mesh is not None:
        return (*_sharded_serve(cfg, model, mesh), model)

    def prefill_fn(params, batch, max_len: int):
        with torch.no_grad():
            return model["prefill"](params, batch, max_len)

    def decode_fn(params, state, tokens, pos, positions=None):
        with torch.no_grad():
            return model["decode_step"](params, state, tokens, pos,
                                        positions=positions)

    return prefill_fn, decode_fn, model


def _sharded_serve(cfg: ModelConfig, model, mesh):
    def logits_dt(local, rows, B):
        return SH.wrap(None, local, mesh, (rows, None),
                       (B, local.shape[-1]))

    def prefill_fn(params, batch, max_len: int):
        bspecs = SH.batch_specs(cfg, mesh, batch)
        main = SH.main_spec(bspecs)
        B = next(iter(batch.values())).shape[0]
        rows = main[0] if main else None
        ctx = SH.context(cfg, mesh, sp=tp.entry_axes(main, 1))
        local, _ = SH.compute_params(params, mesh)
        with torch.no_grad(), tp.use(ctx):
            logits, states = model["prefill"](
                local, SH.local_batch(batch, bspecs, mesh), max_len)
        store, shapes = SH.layer_state_specs(cfg, mesh, B, max_len)
        comp = SH.state_layouts(cfg, store, shapes, "prefill", rows)
        states = SH.convert_state(states, comp, store, mesh)
        flat = [SH.wrap(None, x, mesh, s, shape) for x, (_, s), (_, shape)
                in zip(tree.leaves(states), SH.spec_leaves(store),
                       SH.spec_leaves(shapes))]
        return logits_dt(logits, rows, B), tree.unflatten(states, flat)

    def decode_fn(params, state, tokens, pos, positions=None):
        B = tokens.shape[0]
        store = SH.rebuild(state, [SH.unwrap(x)[1] for x in
                                    tree.leaves(state)])
        shapes = SH.rebuild(state, [tuple(x.shape) for x in
                                     tree.leaves(state)])
        rows = SH.rows_entry(store)
        comp = SH.state_layouts(cfg, store, shapes, "decode", rows)
        local_state = SH.convert_state(
            tree.map_leaves(lambda x: SH.unwrap(x)[0], state), store, comp,
            mesh)
        want = (rows,)

        def cut(t):
            """This rank's rows of a whole or DTensor decode input."""
            if SH.is_dtensor(t):
                local, have = SH.unwrap(t)
                return tp.to_spec(local, have, want, mesh)
            return tp.local_shard(t, want, mesh)
        tok = cut(tokens)
        kw = {} if positions is None else {"positions": cut(positions)}
        ctx = SH.context(cfg, mesh, kv=SH.kv_axes(store))
        local, _ = SH.compute_params(params, mesh)
        with torch.no_grad(), tp.use(ctx):
            logits, new = model["decode_step"](local, local_state, tok, pos,
                                               **kw)
        new = SH.convert_state(new, comp, store, mesh)
        flat = [SH.wrap(x, y, mesh) for x, y in zip(tree.leaves(state),
                                                    tree.leaves(new))]
        return logits_dt(logits, rows, B), tree.unflatten(state, flat)

    return prefill_fn, decode_fn
