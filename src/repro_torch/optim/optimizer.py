"""Optimizers (port of ``repro/optim/optimizer.py``): AdamW and
Adafactor, the warmup-cosine schedule and global-norm clipping, over the
port's parameter trees (``repro_torch.tree``).

The interface is the reference's, optax-like: ``opt.init(params) ->
state`` and ``opt.update(grads, state, params) -> (updates, state)``,
where the updates are added to the parameters: the train step computes
``p + u.to(p.dtype)``, so bf16 parameters keep no float32 master copy,
as in the reference.  Moment dtypes are configurable (AdamW float32 by
default, Adafactor's momentum bf16).  The step count is a 0-d int32
tensor and every update is elementwise tensor arithmetic on the
parameters' device.

Across ranks (``training/train_loop.py``'s sharded step): ``init`` takes
DTensor parameters and gives moments placed as their parameters (an
Adafactor factor drops the parameter's dim it averages over);
``clip_by_global_norm`` takes DTensor gradients and sums each shard's
squares across the mesh axes that shard it, so a block held by several
ranks counts once; ``update`` runs on the local shards, and Adafactor's
means over a sharded dim (its factors, the update's RMS) are combined
across that dim's ranks (``shards``).  ``state_specs`` gives the layout
``update`` computes each moment in when the gradients are local under
given specs (the ZeRO step's ``grad_shardings``): a moment of the
parameter's shape in the gradient's spec, Adafactor's row factor in the
gradient's spec without its last dim and the column factor without its
second-to-last, so each rank holds the factor entries its gradient's
rows and columns need, whatever placement the moments are stored in.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.models.layers import DTYPES


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    #: (params, specs) -> the state's tree with, at each leaf, the spec
    #: its update computes it in when each gradient leaf is local under
    #: its entry of `specs` (flattening order)
    state_specs: Callable


def _full(spec, ndim: int) -> tuple:
    """`spec` with an entry for each of `ndim` dims."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def warmup_cosine(peak_lr: float, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1):
    """lr(step) (float32, a tensor when step is): linear warmup to
    peak_lr over `warmup` steps, then cosine to floor * peak_lr at
    `total`."""
    def lr(step):
        step = step.to(torch.float32) if torch.is_tensor(step) else \
            torch.tensor(float(step), dtype=torch.float32)
        warm = peak_lr * (step + 1) / warmup
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _rewrap(like, local):
    """`local` as a DTensor placed as `like` (`local` itself when `like`
    is a plain tensor)."""
    if not _is_dtensor(like):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, in their own
    dtypes; the global norm, float32 0-d).  A DTensor leaf adds its local
    squares, summed across the mesh axes that shard it (one all-reduce
    for all the leaves sharded alike)."""
    from repro_torch.launch import tp
    flat = tree.leaves(grads)
    parts = {}
    for g in flat:
        key, local = None, g
        if _is_dtensor(g):
            mesh = g.device_mesh
            names = tuple(n for n, p in zip(mesh.mesh_dim_names,
                                            g.placements) if p.is_shard())
            key, local = (mesh, names) if names else None, g.to_local()
        parts.setdefault(key, []).append(
            torch.sum(torch.square(local.to(torch.float32))))
    total = 0
    for key, sums in parts.items():
        s = sum(sums)
        total = total + (s if key is None else
                         tp.all_reduce(s, tp.axis(*key)))
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)

    def clip(g):
        local = g.to_local() if _is_dtensor(g) else g
        return _rewrap(g, (local.to(torch.float32) * scale).to(g.dtype))
    return tree.map_leaves(clip, grads), gn


def _zeros(p, dtype, drop=None):
    """Zeros of p's shape (dim `drop` removed) in `dtype`, placed as p
    (a dropped dim's shard replicated) when p is a DTensor."""
    shape = tuple(p.shape) if drop is None else \
        tuple(p.shape[:drop]) + tuple(p.shape[drop + 1:])
    if not _is_dtensor(p):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, placements, local = p.device_mesh, [], list(shape)
    for size, pl in zip(mesh.mesh.shape, p.placements):
        if pl.is_shard() and drop is not None:
            d = pl.dim % p.dim()
            pl = Replicate() if d == drop else Shard(d - (d > drop))
        if pl.is_shard():
            local[pl.dim] //= size
        placements.append(pl)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=p.to_local().device), mesh,
        placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _mean(x, dim: int, shards, pdim: int):
    """x.mean(dim), combined across the ranks of `shards[pdim]` (the
    parameter dim that `dim` of x stands for) where it is sharded."""
    out = x.mean(dim=dim)
    ax = shards.get(pdim) if shards else None
    if ax is None:
        return out
    from repro_torch.launch import tp
    return tp.all_reduce(out, ax) / ax.size


def _mean_all(x, shards):
    """The mean of every element of x, combined across every sharded
    dim's ranks."""
    out = torch.mean(x)
    from repro_torch.launch import tp
    for ax in (shards or {}).values():
        out = tp.all_reduce(out, ax) / ax.size
    return out



def adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype="float32") -> Optimizer:
    mdt = DTYPES[moment_dtype]

    def init(params):
        def zeros(p):
            return _zeros(p, mdt)
        dev = tree.leaves(params)[0].device
        return {"m": tree.map_leaves(zeros, params),
                "v": tree.map_leaves(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, shards=None):
        c = state["count"] + 1
        cf = c.to(torch.float32)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        step_lr = lr(c).to(cf.device)
        flat_p = tree.leaves(params)
        flat_g = tree.flatten_up_to(params, grads)
        flat_m = tree.flatten_up_to(params, state["m"])
        flat_v = tree.flatten_up_to(params, state["v"])
        us, ms, vs = [], [], []
        for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
            gf = g.to(torch.float32)
            m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
            v_new = b2 * v.to(torch.float32) + (1 - b2) * torch.square(gf)
            u = -step_lr * (m_new / bc1 / (torch.sqrt(v_new / bc2) + eps)
                            + weight_decay * p.to(torch.float32))
            us.append(u.to(p.dtype))
            ms.append(m_new.to(mdt))
            vs.append(v_new.to(mdt))
        return tree.unflatten(params, us), {
            "m": tree.unflatten(params, ms), "v": tree.unflatten(params, vs),
            "count": c}

    def state_specs(params, specs):
        moments = tree.unflatten(params, [
            _full(s, p.dim()) for p, s in zip(tree.leaves(params), specs)])
        return {"m": moments, "v": moments, "count": ()}

    return Optimizer(init, update, state_specs)


def adafactor(lr: Callable, *, eps=1e-30, clip_threshold=1.0, decay=0.8,
              momentum: Optional[float] = 0.9, momentum_dtype="bfloat16",
              weight_decay=0.0) -> Optimizer:
    """Factored second moments for >= 2-D parameters; optional bf16
    momentum.  The second-moment factors are a flat list aligned with
    ``tree.leaves(params)``, as in the reference."""
    mdt = DTYPES[momentum_dtype]

    def factored(p):
        return p.dim() >= 2

    def init(params):
        f32 = torch.float32
        vs = []
        for p in tree.leaves(params):
            if factored(p):
                vs.append({"vr": _zeros(p, f32, p.dim() - 1),
                           "vc": _zeros(p, f32, p.dim() - 2)})
            else:
                vs.append({"v": _zeros(p, f32)})
        dev = tree.leaves(params)[0].device
        st = {"v": vs, "count": torch.zeros((), dtype=torch.int32,
                                            device=dev)}
        if momentum is not None:
            st["m"] = tree.map_leaves(lambda p: _zeros(p, mdt), params)
        return st

    def update(grads, state, params, shards=None):
        """`shards`: per parameter leaf (flattening order), {dim: the
        tp.Axis sharding it} of the local shards given, or None."""
        c = state["count"] + 1
        cf = c.to(torch.float32)
        beta2 = 1.0 - cf ** (-decay)
        step_lr = lr(c).to(cf.device)
        flat_p = tree.leaves(params)
        flat_g = tree.flatten_up_to(params, grads)
        flat_m = tree.flatten_up_to(params, state["m"]) \
            if momentum is not None else [None] * len(flat_p)
        new_u, new_v, new_m = [], [], []
        shards = shards or [None] * len(flat_p)
        for g, v, p, m, sh in zip(flat_g, state["v"], flat_p, flat_m,
                                  shards):
            gf = torch.square(g.to(torch.float32)) + eps
            if factored(p):
                nd = p.dim()
                vr = beta2 * v["vr"] + (1 - beta2) * _mean(gf, -1, sh,
                                                           nd - 1)
                vc = beta2 * v["vc"] + (1 - beta2) * _mean(gf, -2, sh,
                                                           nd - 2)
                rfac = torch.rsqrt(vr / torch.clamp(
                    _mean(vr, -1, sh, nd - 2)[..., None], min=eps))[
                        ..., None]
                cfac = torch.rsqrt(vc)[..., None, :]
                u = g.to(torch.float32) * rfac * cfac
                v_out = {"vr": vr, "vc": vc}
            else:
                vv = beta2 * v["v"] + (1 - beta2) * gf
                u = g.to(torch.float32) * torch.rsqrt(vv)
                v_out = {"v": vv}
            rms_u = torch.sqrt(_mean_all(torch.square(u), sh) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if momentum is not None:
                u = momentum * m.to(torch.float32) + (1 - momentum) * u
                new_m.append(u.to(mdt))
            u = -step_lr * (u + weight_decay * p.to(torch.float32))
            new_u.append(u.to(p.dtype))
            new_v.append(v_out)
        new = {"v": new_v, "count": c}
        if momentum is not None:
            new["m"] = tree.unflatten(params, new_m)
        return tree.unflatten(params, new_u), new

    def state_specs(params, specs):
        vs = []
        for p, s in zip(tree.leaves(params), specs):
            s = _full(s, p.dim())
            vs.append({"vr": s[:-1], "vc": s[:-2] + s[-1:]} if factored(p)
                      else {"v": s})
        st = {"v": vs, "count": ()}
        if momentum is not None:
            st["m"] = tree.unflatten(params, [
                _full(s, p.dim()) for p, s in zip(tree.leaves(params),
                                                   specs)])
        return st

    return Optimizer(init, update, state_specs)


def make_optimizer(name: str, peak_lr: float = 3e-4, **kw) -> Optimizer:
    lr = warmup_cosine(peak_lr)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(name)
