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
``launch/shardings.NamedSharding``) take effect on their DeviceMesh as
data parallelism: each rank takes its rows of the global batch (its
index over the batch axes, ``launch/shardings.batch_axes``; ranks on the
other axes hold the same rows), accumulates its microbatches as above,
and all-reduce-averages the gradients and the loss over the batch axes
before clipping, so the update is replicated.  On a mesh of one rank
the step is the unsharded step, bit for bit.  The reference's
placement of the accumulator and moments (ZeRO, ``grad_shardings``'s
extra shard, ROADMAP Queue 1 item 22) and tensor-parallel execution of
the ``model`` axis (item 21) are not ported: a tensor-parallel arch on
a ``model`` axis larger than 1 raises ``NotImplementedError``.
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
from repro_torch.optim import clip_by_global_norm, make_optimizer


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
        self.group = None
        if self.ways > 1:
            sub = mesh[axes[0]] if len(axes) == 1 else \
                mesh[tuple(axes)]._flatten()
            self.group = sub.get_group()

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
        """(loss, grads) summed over the batch axes' ranks in one
        all-reduce of a flat float32 buffer, then divided by their
        count."""
        if self.group is None:
            return loss, grads
        flat = tree.leaves(grads)
        buf = torch.cat([g.reshape(-1) for g in flat] + [loss.reshape(1)])
        dist.all_reduce(buf, group=self.group)
        buf = buf / self.ways
        out, at = [], 0
        for g in flat:
            out.append(buf[at:at + g.numel()].view(g.shape))
            at += g.numel()
        return buf[at].reshape(()), tree.unflatten(grads, out)


def _mesh_and_axes(cfg, grad_shardings, batch_shardings):
    """(mesh, batch axes) of the sharding arguments: the batch axes are
    the first entry of a batch spec (None without batch shardings:
    ``batch_axes`` of the first step's batch).  A tensor-parallel arch on
    a model axis larger than 1 raises."""
    leaves = [x for t in (batch_shardings, grad_shardings) if t is not None
              for x in tree.leaves(t)]
    if not leaves or not all(isinstance(x, NamedSharding) for x in leaves):
        raise TypeError("grad_shardings / batch_shardings must be trees of "
                        "launch.shardings.NamedSharding")
    mesh = leaves[0].mesh
    msize = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("model", 1)
    if cfg.tensor_parallel and msize > 1:
        raise NotImplementedError(
            f"{cfg.name} is tensor-parallel and the mesh's model axis has "
            f"{msize} ranks: tensor-parallel execution is not ported "
            "(ROADMAP Queue 1 item 21)")
    if batch_shardings is None:
        return mesh, None
    spec = next(s.spec for s in tree.leaves(batch_shardings) if s.spec)
    axes = spec[0] or ()
    return mesh, (axes,) if isinstance(axes, str) else tuple(axes)


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
        mesh, axes = _mesh_and_axes(cfg, grad_shardings, batch_shardings)
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


def make_serve_steps(cfg: ModelConfig):
    """Returns (prefill_fn, decode_fn, model) for the inference cells.

    prefill_fn(params, batch, max_len) -> (last_logits, decode_state)
    decode_fn(params, state, tokens, pos) -> (logits, new_state)
    """
    model = build_model(cfg)

    def prefill_fn(params, batch, max_len: int):
        with torch.no_grad():
            return model["prefill"](params, batch, max_len)

    def decode_fn(params, state, tokens, pos, positions=None):
        with torch.no_grad():
            return model["decode_step"](params, state, tokens, pos,
                                        positions=positions)

    return prefill_fn, decode_fn, model
