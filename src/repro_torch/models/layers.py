"""Shared layers (port of ``repro/models/layers.py``, the part the xLSTM
serve path uses): dtypes, the truncated-normal initializer, norms in
float32, embedding and the tied unembedding.

Parameters are nested dicts of tensors, as the reference's pytrees.  RoPE,
the MLPs and the loss come with the slices that use them (ROADMAP Queue 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

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
    emb = params["embedding"][tokens.long()].to(dtype_of(cfg))
    if cfg.scale_embeddings:
        emb = emb * math.sqrt(cfg.d_model)
    return emb


def unembed(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        return x @ params["embedding"].T.to(x.dtype)
    return x @ params["unembed"].to(x.dtype)
