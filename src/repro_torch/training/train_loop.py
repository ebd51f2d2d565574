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

The reference's sharding arguments place the accumulator and the
microbatches on a device mesh; that is the multi-device slice (ROADMAP
item 18b), and on one card both must be None.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
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


def make_train_step(cfg: ModelConfig, peak_lr: float = 3e-4,
                    clip_norm: float = 1.0, grad_shardings=None,
                    batch_shardings=None) -> Tuple[Callable, Callable, Any]:
    """Returns (init_fn, step_fn, optimizer).  init_fn(gen) -> (params,
    opt_state) on gen's device; step_fn as documented above."""
    if grad_shardings is not None or batch_shardings is not None:
        raise ValueError("grad_shardings and batch_shardings place the "
                         "step on a device mesh (the multi-device slice); "
                         "on one card both are None")
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, peak_lr)
    nmb = max(1, cfg.microbatches_train)

    def init_fn(gen: torch.Generator):
        params = model["init_params"](gen)
        return params, opt.init(params)

    def step_fn(params, opt_state, batch):
        loss, grads = accumulate_grads(model["loss_fn"], params, batch, nmb)
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
