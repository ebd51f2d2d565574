"""Attention (port of ``repro/models/attention.py``, the GQA/MQA path the
recurrentgemma serve slice uses): masked softmax attention over the
reference's (B, S, H, D) layout, dense or q-chunked, with full and ring
(sliding-window) KV caches.

Attention is computed as the reference computes it: one masked softmax
block when Sq * Sk <= 4096^2 (or Sq is not a multiple of 512), else
scanned over 512-row q chunks, each seeing only its trailing
``window + 512`` keys when a window allows.  No model path calls the
flash-attention kernel, in the reference or here
(``kernels/ops.py: flash_attention`` is its own entry point).

Cache layouts (per layer):
  full:  k/v (B, S_alloc, KV, D), decode writes at ``pos``;
  ring:  k/v (B, W, KV, D), W = min(max_len, window), global position p at
         slot p % W, plus the (W,) int32 slot -> position map ``pos``
         (-1 for an empty slot).
MLA, cross-attention and M-RoPE raise ``NotImplementedError`` naming
ROADMAP Queue 1 item 17.  Caches are updated out of place, as the
reference's are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import (apply_rope, dense_init, dtype_of, pdtype_of,
                     rms_norm_headwise, rope_angles)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# Chunk size for q-blocked attention; S x S materialization above this.
_QCHUNK = 512
_DENSE_LIMIT = 4096  # S_q*S_k <= limit^2 -> single dense block

_ITEM_17 = "ROADMAP Queue 1 item 17 (the other families)"


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet; see {_ITEM_17}")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_init(cfg: ModelConfig, gen: torch.Generator):
    if cfg.mla is not None:
        raise _unported("MLA attention")
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = pdtype_of(cfg)
    p = {"wq": dense_init(gen, (d, h * dh), pd),
         "wk": dense_init(gen, (d, kv * dh), pd),
         "wv": dense_init(gen, (d, kv * dh), pd),
         "wo": dense_init(gen, (h * dh, d), pd)}
    if cfg.qk_norm:
        p["q_scale"] = torch.ones((dh,), dtype=pd, device=gen.device)
        p["k_scale"] = torch.ones((dh,), dtype=pd, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Core masked GQA attention (dense block + q-chunked loop)
# ---------------------------------------------------------------------------

def _gqa_block(q, k, v, *, scale, q_pos, k_pos, causal, window):
    """q (B,Sq,H,D) k/v (B,Sk,KV,D); q_pos (Sq,), k_pos (Sk,) global
    indices."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qf = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k).to(torch.float32) * \
        scale
    mask = k_pos[None, :] >= 0       # ring-cache empty slots carry pos=-1
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def mha(q, k, v, *, scale=None, causal=True, window=0):
    """Sequence attention, q-chunked when large.  Shapes as in
    _gqa_block."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    k_pos = torch.arange(Sk, device=dev)
    if Sq * Sk <= _DENSE_LIMIT ** 2 or Sq % _QCHUNK:
        return _gqa_block(q, k, v, scale=scale,
                          q_pos=torch.arange(Sq, device=dev),
                          k_pos=k_pos, causal=causal, window=window)

    outs = []
    for i in range(Sq // _QCHUNK):
        qi = q[:, i * _QCHUNK:(i + 1) * _QCHUNK]
        qp = i * _QCHUNK + torch.arange(_QCHUNK, device=dev)
        if window and window + _QCHUNK < Sk:
            # local attention: each q-chunk only sees the trailing `window`
            # keys (the start clamped so the slice stays in bounds)
            span = window + _QCHUNK
            start = min(max(i * _QCHUNK - window, 0), Sk - span)
            outs.append(_gqa_block(
                qi, k[:, start:start + span], v[:, start:start + span],
                scale=scale, q_pos=qp,
                k_pos=start + torch.arange(span, device=dev),
                causal=causal, window=window))
        else:
            outs.append(_gqa_block(qi, k, v, scale=scale, q_pos=qp,
                                   k_pos=k_pos, causal=causal,
                                   window=window))
    return torch.cat(outs, dim=1)


def decode_mha(q, k_cache, v_cache, k_pos, *, scale=None, cur_pos=None,
               window=0):
    """One-step decode: q (B,1,H,D) vs cache (B,T,KV,D); k_pos (T,)
    globals."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    B = k_cache.shape[0]
    H, KV = q.shape[2], k_cache.shape[2]
    qf = q.reshape(B, 1, KV, H // KV, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache) \
        .to(torch.float32) * scale
    mask = (k_pos <= cur_pos) & (k_pos >= 0)
    if window:
        mask = mask & (k_pos > cur_pos - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, 1, H, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# Cache constructors
# ---------------------------------------------------------------------------

def kv_cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                   window: int = 0):
    """{leaf: (shape, dtype)} of one attention layer's cache."""
    if cfg.mla is not None:
        raise _unported("the MLA latent cache")
    alloc = min(max_len, window) if window else max_len
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    return {"k": ((batch, alloc, kv, dh), dt),
            "v": ((batch, alloc, kv, dh), dt),
            "pos": ((alloc,), torch.int32)}


def _cache_write(buf, val, slot: int):
    """A copy of buf (B, T, ...) with val (B, 1, ...) at index slot."""
    out = buf.clone()
    out[:, slot:slot + 1] = val.to(buf.dtype)
    return out


def _ring_fill_prefill(vals, alloc: int):
    """The trailing `alloc` positions of vals (B,S,...) ring-aligned:
    global position p at slot p % alloc."""
    S = vals.shape[1]
    if S <= alloc:
        return _pad_to(vals, alloc)
    # global position p lives at slot p % alloc: roll so slots line up
    return torch.roll(vals[:, S - alloc:], (S - alloc) % alloc, dims=1)


def _ring_positions(S: int, alloc: int, device="cpu"):
    """Global positions per slot after prefilling S tokens."""
    base = torch.arange(alloc, dtype=torch.int32, device=device)
    if S <= alloc:
        return torch.where(base < S, base, -1)
    # slot s holds the largest p < S with p % alloc == s
    last = S - 1
    return last - torch.remainder(last - base, alloc)


def _pad_to(arr, alloc: int):
    if arr.shape[1] > alloc:
        raise ValueError(f"a cache of {alloc} positions cannot hold "
                         f"{arr.shape[1]}; raise max_len")
    pad = [0, 0] * (arr.dim() - 2) + [0, alloc - arr.shape[1]]
    return F.pad(arr, pad)


# ---------------------------------------------------------------------------
# Full attention block apply (standard / GQA path)
# ---------------------------------------------------------------------------

def apply_attention(cfg: ModelConfig, params, x, *, mode: str,
                    window: int = 0, cache=None, pos=None,
                    max_len: int = 0, cross_kv=None, causal: bool = True):
    """Returns (out, new_cache).  mode in {train, prefill, decode}.

    pos: the current index (decode), an int or a 0-d integer tensor.
    max_len: the cache's length at prefill (the ring holds
    min(max_len, window) positions).
    """
    if cfg.mla is not None:
        raise _unported("MLA attention")
    if cross_kv is not None:
        raise _unported("cross-attention")
    if cfg.mrope_sections:
        raise _unported("M-RoPE")
    B, S, d = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, h, dh)
    k = (x @ params["wk"]).reshape(B, S, kv, dh)
    v = (x @ params["wv"]).reshape(B, S, kv, dh)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, params["q_scale"])
        k = rms_norm_headwise(k, params["k_scale"])
    if mode == "decode":
        pos = int(pos)

    if cfg.rope_theta:
        p = torch.arange(S, device=x.device) if mode != "decode" else \
            torch.full((1,), pos, device=x.device)
        cos, sin = rope_angles(p, dh, cfg.rope_theta)
        q = apply_rope(q, cos[None], sin[None])
        k = apply_rope(k, cos[None], sin[None])

    if mode == "decode":
        assert cache is not None
        alloc = cache["k"].shape[1]
        slot = pos % alloc if window else pos
        kpos = cache["pos"].clone()
        kpos[slot] = pos
        new_cache = {"k": _cache_write(cache["k"], k, slot),
                     "v": _cache_write(cache["v"], v, slot), "pos": kpos}
        out = decode_mha(q, new_cache["k"], new_cache["v"], kpos,
                         cur_pos=pos, window=window)
    else:
        out = mha(q, k, v, causal=causal, window=window)
        new_cache = None
        if mode == "prefill":
            alloc = min(max_len, window) if window else max_len
            if alloc < 1:
                raise ValueError("prefill of an attention layer needs "
                                 "max_len >= 1 (the cache's length)")
            if window:
                new_cache = {"k": _ring_fill_prefill(k, alloc),
                             "v": _ring_fill_prefill(v, alloc),
                             "pos": _ring_positions(S, alloc, x.device)}
            else:
                base = torch.arange(alloc, dtype=torch.int32,
                                    device=x.device)
                new_cache = {"k": _pad_to(k, alloc), "v": _pad_to(v, alloc),
                             "pos": torch.where(base < S, base, -1)}
    return out.reshape(B, S, h * dh) @ params["wo"], new_cache
