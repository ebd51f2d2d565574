"""Shared layers (port of ``repro/models/layers.py``): dtypes, the
truncated-normal initializer, norms in float32, rotary position
embeddings (plain and M-RoPE), whisper's sinusoidal positions, the
feed-forward blocks, embedding, the unembedding and the next-token
cross entropy.

Parameters are nested dicts of tensors, as the reference's pytrees.

Under a tensor-parallel layout (``launch/tp.py``) the feed-forward is
column- then row-parallel, the embedding vocab-parallel (or sharded on
d_model where the vocabulary does not divide), the logits vocab-parallel
and the cross entropy taken over them without gathering (B, S, V); under
sequence parallelism the cross entropy sums over every rank's positions.
Each rule applies where the weight at hand is sharded: a leaf whose dims
do not divide the model axis stays whole, and its layer runs whole.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tp

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.act_dtype]


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None):
    """Truncated-normal fan-in init (std = scale or 1/sqrt(fan_in)), drawn
    in float32 on the generator's device."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms (f32 internal accumulation)
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, device, width: Optional[int] = None):
    width = width or cfg.d_model
    p = {"scale": torch.ones((width,), dtype=pdtype_of(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((width,), dtype=pdtype_of(cfg), device=device)
    return p


def apply_norm(cfg: ModelConfig, params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].to(torch.float32) + \
            params["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_norm_headwise(x, scale, eps: float = 1e-6):
    """Per-head RMS norm over the last axis, in float32."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions, dim: int, theta: float):
    """cos/sin of shape positions.shape + (dim // 2,), in float32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D // 2), broadcast over heads.
    The two halves of the head dim rotate as pairs (concatenated, not
    interleaved), in float32."""
    d2 = x.shape[-1] // 2
    c = cos[..., None, :].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    x1, x2 = x[..., :d2].to(torch.float32), x[..., d2:].to(torch.float32)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mrope_angles(pos_thw, dim: int, theta: float, sections):
    """M-RoPE (qwen2-vl): pos_thw (B, 3, S); sections sum to dim // 2.
    Frequency slot f rotates by the (t|h|w) position row of its section.
    Returns cos/sin of shape (B, S, dim // 2), in float32."""
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {dim // 2}")
    dev = pos_thw.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=dev) / dim))
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=dev)   # (dim // 2,)
    pos = pos_thw.to(torch.float32)[:, sec_id, :]            # (B, dim//2, S)
    ang = pos.transpose(1, 2) * inv_freq                     # (B, S, dim//2)
    return torch.cos(ang), torch.sin(ang)


def sinusoidal_positions(positions, dim: int):
    """Whisper-style sinusoidal embeddings, sin before cos, frequencies
    spaced over ``half - 1``: positions (...,) -> (..., dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Feed-forward blocks
# ---------------------------------------------------------------------------

def mlp_init(cfg: ModelConfig, gen: torch.Generator,
             d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    pd = pdtype_of(cfg)
    if cfg.mlp in ("swiglu", "gelu_glu"):
        return {"wi_gate": dense_init(gen, (d, ff), pd),
                "wi_up": dense_init(gen, (d, ff), pd),
                "wo": dense_init(gen, (ff, d), pd)}
    return {"wi_up": dense_init(gen, (d, ff), pd),
            "wo": dense_init(gen, (ff, d), pd)}


def apply_mlp(cfg: ModelConfig, params, x):
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default
    (plain ``F.gelu`` is the erf form).  Tensor-parallel where the hidden
    width is sharded: column-parallel up-projections, a row-parallel
    ``wo`` and one all-reduce."""
    ax = tp.current().tp
    par = params["wo"].shape[-2] * ax.size == cfg.d_ff and ax.size > 1
    if par:
        x = tp.copy(x, ax)
    if cfg.mlp == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    elif cfg.mlp == "gelu_glu":
        h = F.gelu(x @ params["wi_gate"], approximate="tanh") * \
            (x @ params["wi_up"])
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(x @ params["wi_up"]))
    elif cfg.mlp == "gelu":
        h = F.gelu(x @ params["wi_up"], approximate="tanh")
    else:
        raise ValueError(cfg.mlp)
    out = h @ params["wo"]
    return tp.reduce(out, ax) if par else out


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(cfg: ModelConfig, gen: torch.Generator):
    pd = pdtype_of(cfg)
    p = {"embedding": dense_init(gen, (cfg.vocab_size, cfg.d_model), pd,
                                 scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), pd)
    return p


def embed_tokens(cfg: ModelConfig, params, tokens):
    """Vocab-parallel where the embedding's rows are sharded (each rank
    looks up its rows, zeros the rest, one all-reduce); d_model-sharded
    where its columns are (the columns gathered)."""
    table = params["embedding"]
    ax = tp.current().tp
    if ax.size > 1 and table.shape[0] < cfg.vocab_size:
        lo = ax.rank * table.shape[0]
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < table.shape[0])
        emb = table[torch.where(mine, ids, 0)]
        emb = tp.reduce(torch.where(mine[..., None], emb, 0), ax)
    elif ax.size > 1 and table.shape[1] < cfg.d_model:
        emb = tp.gather(table[tokens.long()], -1, ax)
    else:
        emb = table[tokens.long()]
    emb = emb.to(dtype_of(cfg))
    if cfg.scale_embeddings:
        emb = emb * math.sqrt(cfg.d_model)
    return emb


def unembed(cfg: ModelConfig, params, x):
    """The logits: under tensor parallelism this rank's vocabulary block
    (V / model ways) where the vocabulary is sharded, else whole (a
    d_model-sharded tied embedding contracts its block of x's columns and
    all-reduces)."""
    w = params["embedding"].T if cfg.tie_embeddings else params["unembed"]
    ax = tp.current().tp
    if ax.size > 1 and w.shape[0] < cfg.d_model:
        return tp.reduce(tp.split(x, -1, ax) @ w.to(x.dtype), ax)
    if ax.size > 1 and w.shape[1] < cfg.vocab_size:
        x = tp.copy(x, ax)
    return x @ w.to(x.dtype)


def full_logits(cfg: ModelConfig, logits):
    """Logits over the whole vocabulary (this rank's block gathered where
    ``unembed`` gave one); no gradient."""
    ax = tp.current().tp
    if logits.shape[-1] < cfg.vocab_size:
        return tp.all_gather(logits, -1, ax)
    return logits


def last_logits(cfg: ModelConfig, params, x):
    """Whole logits (B, V) of the last position of x (B, S, d): under
    sequence parallelism the last rank's last row; no gradient."""
    last = tp.all_gather(x[:, -1:], 1, tp.current().sp)[:, -1:]
    return full_logits(cfg, unembed(cfg, params, last))[:, 0]


def cross_entropy(logits, labels, mask=None, vocab: int = 0):
    """Mean next-token CE in float32 (``layers.py: cross_entropy``):
    logsumexp minus the gold logit, averaged over the positions, or over
    the mask's weight when a mask is given.  logits (..., V); labels
    (...) int.  Where `logits` hold this rank's block of a `vocab`-wide
    vocabulary (tensor parallelism), the max, the sum of exponentials and
    the gold logit are combined across the ranks; under sequence
    parallelism the sums and the count run over every rank's positions."""
    lf = logits.to(torch.float32)
    ctx = tp.current()
    if vocab and lf.shape[-1] < vocab:
        ax = ctx.tp
        lo = ax.rank * lf.shape[-1]
        with torch.no_grad():
            top = tp.all_max(lf.amax(dim=-1, keepdim=True), ax)
        lse = torch.log(tp.reduce(torch.exp(lf - top).sum(dim=-1), ax)) + \
            top[..., 0]
        ids = labels.long() - lo
        mine = (ids >= 0) & (ids < lf.shape[-1])
        gold = torch.gather(lf, -1, torch.where(mine, ids, 0)[..., None])
        gold = tp.reduce(torch.where(mine, gold[..., 0], 0.0), ax)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    sp = ctx.sp
    if sp.size > 1:
        weight = torch.ones_like(nll) if mask is None else mask
        total = tp.reduce((nll * weight).sum(), sp)
        count = tp.all_reduce(weight.sum().detach(), sp)
        return total / torch.clamp(count, min=1.0)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
