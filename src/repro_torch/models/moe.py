"""Mixture-of-Experts (port of ``repro/models/moe.py``): a top-k router and
capacity-bounded scatter dispatch.

  1. route each token to its top-k experts (router in float32, softmax,
     the k weights renormalised to sum to 1),
  2. rank each slot within its (sequence row, expert) group by a one-hot
     cumsum,
  3. scatter tokens into a (B, E, C, d) buffer, C = ceil(S·K·cf / E);
     slots ranked C or more are dropped,
  4. the batched expert FFN over the E axis,
  5. gather back and combine with the routing weights.

``apply_moe`` returns a switch-style load-balancing aux loss beside the
output, as the reference does; serving ignores it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import dense_init, pdtype_of


def moe_init(cfg: ModelConfig, gen: torch.Generator):
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    pd = pdtype_of(cfg)
    scale = 1.0 / math.sqrt(d)
    return {"router": dense_init(gen, (d, e), torch.float32, scale=scale),
            "wi_gate": dense_init(gen, (e, d, ff), pd, scale=scale),
            "wi_up": dense_init(gen, (e, d, ff), pd, scale=scale),
            "wo": dense_init(gen, (e, ff, d), pd, scale=1.0 / math.sqrt(ff))}


_RANK_CHUNK = 8192


def _ranks_in_chunk(se, E: int, counts):
    """Ranks of the slots se (B, n) given the (B, E) counts before them;
    returns (ranks, counts after)."""
    oh = F.one_hot(se.long(), E).to(torch.int32)
    cs = torch.cumsum(oh, dim=1, dtype=torch.int32) + counts[:, None, :]
    ranks = torch.gather(cs, 2, se.long()[..., None])[..., 0] - 1
    return ranks, counts + oh.sum(dim=1, dtype=torch.int32)


def _slot_ranks(slot_e, E: int):
    """Rank (int32) of each slot within its (row, expert) group.

    Above _RANK_CHUNK slots the one-hot cumsum runs over blocks of
    _RANK_CHUNK slots carrying per-expert counts, so the (B, S·K, E)
    one-hot is never materialized whole."""
    B, SK = slot_e.shape
    counts = torch.zeros((B, E), dtype=torch.int32, device=slot_e.device)
    if SK <= _RANK_CHUNK:
        return _ranks_in_chunk(slot_e, E, counts)[0]
    out = []
    for c in range(0, SK, _RANK_CHUNK):
        ranks, counts = _ranks_in_chunk(slot_e[:, c:c + _RANK_CHUNK], E,
                                        counts)
        out.append(ranks)
    return torch.cat(out, dim=1)


def route(cfg: ModelConfig, params, x):
    """Router probabilities (B, S, E) and each token's top-k weights
    (renormalised) and experts (B, S, K), in descending order."""
    logits = x.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.moe.experts_per_token, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per (row, expert): ceil(S·K·cf / E), at least 1."""
    m = cfg.moe
    return max(1, int(math.ceil(S * m.experts_per_token * m.capacity_factor
                                / m.num_experts)))


def apply_moe(cfg: ModelConfig, params, x):
    """x (B, S, d) -> (out (B, S, d), aux_loss float32 scalar)."""
    B, S, d = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token
    C = capacity(cfg, S)
    probs, top_w, top_e = route(cfg, params, x)

    # aux loss: E * sum_e(frac_tokens_e * mean_prob_e)
    frac = F.one_hot(top_e, E).to(torch.float32).sum(dim=2) \
        .mean(dim=(0, 1)) / K
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))

    # --- slot ranking per sequence row ------------------------------------
    slot_e = top_e.reshape(B, S * K)
    slot_w = top_w.reshape(B, S * K)
    pos = _slot_ranks(slot_e, E)
    keep = pos < C
    pos_safe = torch.where(keep, pos, C)            # C: the dropped slot

    # --- scatter into expert buffers (slot C collects the dropped, cut) --
    xs = torch.repeat_interleave(x, K, dim=1)      # (B, SK, d)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf = torch.zeros((B, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, slot_e, pos_safe.long()),
                   torch.where(keep[..., None], xs, 0), accumulate=True)
    buf = buf[:, :, :C]

    # --- expert FFN ---------------------------------------------------------
    if cfg.mlp == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", buf, params["wi_gate"])) \
            * torch.einsum("becd,edf->becf", buf, params["wi_up"])
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", buf, params["wi_up"]),
                   approximate="tanh")
    out_buf = torch.einsum("becf,efd->becd", h, params["wo"])

    # --- gather + combine ---------------------------------------------------
    y = out_buf[bidx, slot_e, torch.clamp(pos_safe, max=C - 1).long()]
    y = torch.where(keep[..., None], y, 0) * slot_w[..., None].to(y.dtype)
    y = y.reshape(B, S, K, d).sum(dim=2)
    return y.to(x.dtype), aux
