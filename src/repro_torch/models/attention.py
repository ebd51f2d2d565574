"""Attention (port of ``repro/models/attention.py``): GQA/MQA/MHA over the
reference's (B, S, H, D) layout (global, sliding-window and local, plain
RoPE or qwen2-vl's M-RoPE), cross-attention (whisper's decoder) and MLA
(minicpm3), with full, ring and latent KV caches.

Attention is computed as the reference computes it: one masked softmax
block when Sq * Sk <= 4096^2 (or Sq is not a multiple of 512), else
scanned over 512-row q chunks, each seeing only its trailing
``window + 512`` keys when a window allows.  Cross-attention is always
one block and has no mask.  No model path calls the flash-attention
kernel, in the reference or here (``kernels/ops.py: flash_attention`` is
its own entry point).

Cache layouts (per layer):
  full:  k/v (B, S_alloc, KV, D), decode writes at ``pos``;
  ring:  k/v (B, W, KV, D), W = min(max_len, window), global position p at
         slot p % W, plus the (W,) int32 slot -> position map ``pos``
         (-1 for an empty slot);
  mla:   c_kv (B, S_alloc, kv_rank) and k_pe (B, S_alloc, rope_dim), the
         latent cache, plus ``pos`` as the full cache's.
Caches are updated out of place, as the reference's are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import (apply_rope, dense_init, dtype_of, mrope_angles,
                     pdtype_of, rms_norm_headwise, rope_angles)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# Chunk size for q-blocked attention; S x S materialization above this.
_QCHUNK = 512
_DENSE_LIMIT = 4096  # S_q*S_k <= limit^2 -> single dense block


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_init(cfg: ModelConfig, gen: torch.Generator):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = pdtype_of(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq_a": dense_init(gen, (d, m.q_lora_rank), pd),
            "q_norm": torch.ones((m.q_lora_rank,), dtype=pd,
                                 device=gen.device),
            "wq_b": dense_init(gen, (m.q_lora_rank, h * qk_dim), pd),
            "wkv_a": dense_init(gen, (d, m.kv_lora_rank +
                                      m.qk_rope_head_dim), pd),
            "kv_norm": torch.ones((m.kv_lora_rank,), dtype=pd,
                                  device=gen.device),
            "wk_b": dense_init(gen, (m.kv_lora_rank,
                                     h * m.qk_nope_head_dim), pd),
            "wv_b": dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim), pd),
            "wo": dense_init(gen, (h * m.v_head_dim, d), pd)}
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

def _gqa_block(q, k, v, *, scale, q_pos, k_pos, causal, window,
               cross=False):
    """q (B,Sq,H,D) k/v (B,Sk,KV,D); q_pos (Sq,), k_pos (Sk,) global
    indices.  ``cross``: every query sees every key (no mask)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qf = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k).to(torch.float32) * \
        scale
    if not cross:
        mask = k_pos[None, :] >= 0   # ring-cache empty slots carry pos=-1
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def mha(q, k, v, *, scale=None, causal=True, window=0, cross=False):
    """Sequence attention, q-chunked when large (never for ``cross``).
    Shapes as in _gqa_block."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    k_pos = torch.arange(Sk, device=dev)
    if Sq * Sk <= _DENSE_LIMIT ** 2 or Sq % _QCHUNK or cross:
        return _gqa_block(q, k, v, scale=scale,
                          q_pos=torch.arange(Sq, device=dev),
                          k_pos=k_pos, causal=causal, window=window,
                          cross=cross)

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
    alloc = min(max_len, window) if window else max_len
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": ((batch, alloc, m.kv_lora_rank), dt),
                "k_pe": ((batch, alloc, m.qk_rope_head_dim), dt),
                "pos": ((alloc,), torch.int32)}
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
    if S <= alloc:
        return _full_positions(S, alloc, device)
    # slot s holds the largest p < S with p % alloc == s
    base = torch.arange(alloc, dtype=torch.int32, device=device)
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

def _positions(mode: str, S: int, pos, device):
    """The queries' positions: 0..S-1, or ``pos`` alone in decode."""
    if mode == "decode":
        return torch.full((1,), pos, device=device)
    return torch.arange(S, device=device)


def apply_attention(cfg: ModelConfig, params, x, *, mode: str,
                    window: int = 0, cache=None, pos=None, positions=None,
                    max_len: int = 0, cross_kv=None, causal: bool = True):
    """Returns (out, new_cache).  mode in {train, prefill, decode}.

    pos: the current index (decode), an int or a 0-d integer tensor.
    positions: (B, 3, S) M-RoPE ids when cfg.mrope_sections, else None
    (the ids then default to each query's position on all three rows).
    max_len: the cache's length at prefill (the ring holds
    min(max_len, window) positions).  cross_kv: (keys' input, values'
    input), each (B, Sk, d): unmasked attention to them, without RoPE
    and without a cache.
    """
    if mode == "decode":
        pos = int(pos)
    if cfg.mla is not None:
        return _apply_mla(cfg, params, x, mode=mode, cache=cache, pos=pos,
                          max_len=max_len)
    B, S, d = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, h, dh)
    if cross_kv is None:
        k = (x @ params["wk"]).reshape(B, S, kv, dh)
        v = (x @ params["wv"]).reshape(B, S, kv, dh)
    else:
        xk, xv = cross_kv
        k = (xk @ params["wk"]).reshape(B, xk.shape[1], kv, dh)
        v = (xv @ params["wv"]).reshape(B, xv.shape[1], kv, dh)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, params["q_scale"])
        k = rms_norm_headwise(k, params["k_scale"])

    if cfg.rope_theta and cross_kv is None:
        p = _positions(mode, S, pos, x.device)
        if cfg.mrope_sections:
            if positions is None:
                positions = p[None, None, :].expand(B, 3, S)
            cos, sin = mrope_angles(positions, dh, cfg.rope_theta,
                                    cfg.mrope_sections)
        else:
            cos, sin = rope_angles(p, dh, cfg.rope_theta)
            cos, sin = cos[None], sin[None]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

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
        out = mha(q, k, v, causal=causal and cross_kv is None, window=window,
                  cross=cross_kv is not None)
        new_cache = None
        if mode == "prefill" and cross_kv is None:
            alloc = min(max_len, window) if window else max_len
            if alloc < 1:
                raise ValueError("prefill of an attention layer needs "
                                 "max_len >= 1 (the cache's length)")
            if window:
                new_cache = {"k": _ring_fill_prefill(k, alloc),
                             "v": _ring_fill_prefill(v, alloc),
                             "pos": _ring_positions(S, alloc, x.device)}
            else:
                new_cache = {"k": _pad_to(k, alloc), "v": _pad_to(v, alloc),
                             "pos": _full_positions(S, alloc, x.device)}
    return out.reshape(B, S, h * dh) @ params["wo"], new_cache


def _full_positions(S: int, alloc: int, device):
    """A full cache's slot -> position map after prefilling S tokens."""
    base = torch.arange(alloc, dtype=torch.int32, device=device)
    return torch.where(base < S, base, -1)


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention): absorbed decode path
# ---------------------------------------------------------------------------

def _apply_mla(cfg: ModelConfig, params, x, *, mode, cache, pos, max_len):
    """Prefill and train expand the latent to every head's K and V (v's
    head dim may differ from q's); decode scores against the latent cache
    through ``wk_b`` and projects the result through ``wv_b``."""
    m = cfg.mla
    B, S, d = x.shape
    h = cfg.num_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(nope + rope)

    cq = rms_norm_headwise(x @ params["wq_a"], params["q_norm"])
    q = (cq @ params["wq_b"]).reshape(B, S, h, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    ckv_full = x @ params["wkv_a"]
    c_kv = rms_norm_headwise(ckv_full[..., :m.kv_lora_rank],
                             params["kv_norm"])
    k_pe = ckv_full[..., m.kv_lora_rank:]

    cos, sin = rope_angles(_positions(mode, S, pos, x.device), rope,
                           cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos[None], sin[None])
    k_pe = apply_rope(k_pe[:, :, None, :], cos[None], sin[None])[:, :, 0, :]

    if mode == "decode":
        kpos = cache["pos"].clone()
        kpos[pos] = pos
        new_cache = {"c_kv": _cache_write(cache["c_kv"], c_kv, pos),
                     "k_pe": _cache_write(cache["k_pe"], k_pe, pos),
                     "pos": kpos}
        # absorbed: q_nope' = q_nope @ Wk_b^T scores against the latent
        wk = params["wk_b"].reshape(m.kv_lora_rank, h, nope)
        q_lat = torch.einsum("bqhd,chd->bqhc", q_nope, wk)   # (B,1,h,rank)
        scores = (torch.einsum("bqhc,btc->bhqt", q_lat, new_cache["c_kv"])
                  + torch.einsum("bqhd,btd->bhqt", q_pe, new_cache["k_pe"]))
        scores = scores.to(torch.float32) * scale
        mask = (kpos <= pos) & (kpos >= 0)
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhqt,btc->bqhc", probs, new_cache["c_kv"])
        wv = params["wv_b"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bqhc,chv->bqhv", o_lat, wv)
    else:
        k_nope = (c_kv @ params["wk_b"]).reshape(B, S, h, nope)
        v = (c_kv @ params["wv_b"]).reshape(B, S, h, m.v_head_dim)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, h, rope)],
                      dim=-1)
        out = mha(torch.cat([q_nope, q_pe], dim=-1), k, v, scale=scale,
                  causal=True)
        new_cache = None
        if mode == "prefill":
            if max_len < 1:
                raise ValueError("prefill of an attention layer needs "
                                 "max_len >= 1 (the cache's length)")
            new_cache = {"c_kv": _pad_to(c_kv, max_len),
                         "k_pe": _pad_to(k_pe, max_len),
                         "pos": _full_positions(S, max_len, x.device)}
    return out.reshape(B, S, h * m.v_head_dim) @ params["wo"], new_cache
