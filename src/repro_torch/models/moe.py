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

Under tensor parallelism (``launch/tp.py``) the router and the slot
ranking run whole on every rank (the tokens are replicated across the
model axis).  Where the experts divide the axis (qwen3-moe: 128 over 16)
each rank owns a block of experts: its buffer holds only its experts'
slots, and the combine is one all-reduce of the weighted outputs; with
the tokens already on every rank, the dispatch is a local selection and
needs no all-to-all.  Where they do not (mixtral: 8 over 16) the expert
FFN is tensor-parallel on its hidden width, ``wo`` row-parallel, and the
expert outputs are all-reduced.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tp
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
    rows = tp.current().rows              # means over the whole batch
    frac = tp.global_mean(F.one_hot(top_e, E).to(torch.float32).sum(dim=2)
                          .mean(dim=(0, 1)), rows) / K
    aux = E * torch.sum(frac * tp.global_mean(probs.mean(dim=(0, 1)), rows))

    # --- slot ranking per sequence row ------------------------------------
    slot_e = top_e.reshape(B, S * K)
    slot_w = top_w.reshape(B, S * K)
    pos = _slot_ranks(slot_e, E)
    keep = pos < C
    pos_safe = torch.where(keep, pos, C)            # C: the dropped slot

    # --- this rank's experts (all of them outside expert parallelism) --
    ax = tp.current().tp
    el = params["wi_up"].shape[0]
    ep = ax.size > 1 and el < E                      # expert-parallel
    fp = ax.size > 1 and not ep and \
        params["wo"].shape[-2] < cfg.d_ff             # hidden-width parallel
    e0 = ax.rank * el if ep else 0
    mine = keep & (slot_e >= e0) & (slot_e < e0 + el) if ep else keep
    if ep or fp:
        x = tp.copy(x, ax)
    if ep:
        slot_w = tp.copy(slot_w, ax)

    # --- scatter into expert buffers (slot C collects the dropped, cut) --
    xs = torch.repeat_interleave(x, K, dim=1)      # (B, SK, d)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    le = torch.where(mine, slot_e - e0, 0) if ep else slot_e
    buf = torch.zeros((B, el, C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, le, torch.where(mine, pos_safe, C).long()),
                   torch.where(mine[..., None], xs, 0), accumulate=True)
    buf = buf[:, :, :C]

    # --- expert FFN ---------------------------------------------------------
    if cfg.mlp == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", buf, params["wi_gate"])) \
            * torch.einsum("becd,edf->becf", buf, params["wi_up"])
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", buf, params["wi_up"]),
                   approximate="tanh")
    out_buf = torch.einsum("becf,efd->becd", h, params["wo"])
    if fp:
        out_buf = tp.reduce(out_buf, ax)

    # --- gather + combine ---------------------------------------------------
    y = out_buf[bidx, le, torch.clamp(pos_safe, max=C - 1).long()]
    y = torch.where(mine[..., None], y, 0) * slot_w[..., None].to(y.dtype)
    y = y.reshape(B, S, K, d).sum(dim=2)
    if ep:
        y = tp.reduce(y, ax)
    return y.to(x.dtype), aux
