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


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, in their own
    dtypes; the global norm, float32 0-d)."""
    flat = tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in flat))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree.map_leaves(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn



def adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          moment_dtype="float32") -> Optimizer:
    mdt = DTYPES[moment_dtype]

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)
        dev = tree.leaves(params)[0].device
        return {"m": tree.map_leaves(zeros, params),
                "v": tree.map_leaves(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
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

    return Optimizer(init, update)


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
                vs.append({"vr": torch.zeros(p.shape[:-1], dtype=f32,
                                             device=p.device),
                           "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             dtype=f32, device=p.device)})
            else:
                vs.append({"v": torch.zeros(p.shape, dtype=f32,
                                            device=p.device)})
        dev = tree.leaves(params)[0].device
        st = {"v": vs, "count": torch.zeros((), dtype=torch.int32,
                                            device=dev)}
        if momentum is not None:
            st["m"] = tree.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
                params)
        return st

    def update(grads, state, params):
        c = state["count"] + 1
        cf = c.to(torch.float32)
        beta2 = 1.0 - cf ** (-decay)
        step_lr = lr(c).to(cf.device)
        flat_p = tree.leaves(params)
        flat_g = tree.flatten_up_to(params, grads)
        flat_m = tree.flatten_up_to(params, state["m"]) \
            if momentum is not None else [None] * len(flat_p)
        new_u, new_v, new_m = [], [], []
        for g, v, p, m in zip(flat_g, state["v"], flat_p, flat_m):
            gf = torch.square(g.to(torch.float32)) + eps
            if factored(p):
                vr = beta2 * v["vr"] + (1 - beta2) * gf.mean(dim=-1)
                vc = beta2 * v["vc"] + (1 - beta2) * gf.mean(dim=-2)
                rfac = torch.rsqrt(vr / torch.clamp(
                    vr.mean(dim=-1, keepdim=True), min=eps))[..., None]
                cfac = torch.rsqrt(vc)[..., None, :]
                u = g.to(torch.float32) * rfac * cfac
                v_out = {"vr": vr, "vc": vc}
            else:
                vv = beta2 * v["v"] + (1 - beta2) * gf
                u = g.to(torch.float32) * torch.rsqrt(vv)
                v_out = {"v": vv}
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
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

    return Optimizer(init, update)


def make_optimizer(name: str, peak_lr: float = 3e-4, **kw) -> Optimizer:
    lr = warmup_cosine(peak_lr)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(name)
