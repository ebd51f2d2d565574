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

Under a tensor-parallel layout (``launch/tp.py``) a rank computes the
heads its block of ``wo``'s rows reads (its own when the heads divide the
model axis; the heads its block touches otherwise, MLA's 40 over 16),
with the key and value heads those read: the local projection block when
it is exactly those heads, else the gathered block, cut (recurrentgemma's
one KV head, internlm2's 8 over 16).  Under sequence parallelism the
queries are this rank's rows and the keys and values are gathered along
the sequence.  Prefill hands back whole caches, which the step cuts to
their storage layout; at decode a cache whose sequence is sharded
(``tp.current().kv``) is scored slot by slot on its owner, the softmax's
max, sum and weighted values combined across the ranks, and only the rank
that owns slot ``pos`` writes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tp
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


def mha(q, k, v, *, scale=None, causal=True, window=0, cross=False, q0=0):
    """Sequence attention, q-chunked when large (never for ``cross``).
    Shapes as in _gqa_block; the queries sit at positions q0 .. q0 + Sq
    (q0 > 0: this rank's rows of a sequence-parallel prefill)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    k_pos = torch.arange(Sk, device=dev)
    if Sq * Sk <= _DENSE_LIMIT ** 2 or Sq % _QCHUNK or cross:
        return _gqa_block(q, k, v, scale=scale,
                          q_pos=q0 + torch.arange(Sq, device=dev),
                          k_pos=k_pos, causal=causal, window=window,
                          cross=cross)

    outs = []
    for i in range(Sq // _QCHUNK):
        qi = q[:, i * _QCHUNK:(i + 1) * _QCHUNK]
        at = q0 + i * _QCHUNK
        qp = at + torch.arange(_QCHUNK, device=dev)
        if window and window + _QCHUNK < Sk:
            # local attention: each q-chunk only sees the trailing `window`
            # keys (the start clamped so the slice stays in bounds)
            span = window + _QCHUNK
            start = min(max(at - window, 0), Sk - span)
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
               window=0, sharded=True):
    """One-step decode: q (B,1,H,D) vs cache (B,T,KV,D); k_pos (T,)
    globals.  With the cache's sequence sharded (``tp.current().kv``;
    `sharded` False for a cache held whole, such as the cross-attention
    keys) the cache and k_pos are this rank's slots."""
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
    ax = tp.current().kv if sharded else tp.ONE
    if ax.size > 1:
        out = _combine(scores, mask, lambda p: torch.einsum(
            "bkgqs,bskd->bqkgd", p, v_cache.to(torch.float32)), ax)
        return out.to(v_cache.dtype).reshape(B, 1, H, v_cache.shape[-1])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, 1, H, v_cache.shape[-1])


def _combine(scores, mask, weigh, ax):
    """Softmax attention over slots sharded across `ax`'s ranks: scores
    (..., 1, T) float32 over this rank's slots, `mask` the live ones;
    weigh(p) the unnormalized p-weighted values (the reduced dims of
    scores moved as the einsum moves them).  The max, the sum and the
    weighted values are combined across the ranks (flash-decode)."""
    scores = torch.where(mask, scores, NEG_INF)
    top = tp.all_max(scores.amax(dim=-1, keepdim=True), ax)
    p = torch.where(mask, torch.exp(scores - top), 0.0)
    total = tp.all_reduce(p.sum(dim=-1), ax)              # (..., 1)
    o = tp.all_reduce(weigh(p), ax)
    # o holds the query dim where scores held it: move the sums there
    return o / _like(total, scores, o)


def _like(total, scores, o):
    """`total` (scores' dims without the slot dim) laid out as `o`: the
    two attention einsums here map (b, k, g, q) -> (b, q, k, g) and
    (b, h, q) -> (b, q, h), each with the value dim last."""
    if scores.dim() == 5:                        # (B, KV, g, 1)
        return total.permute(0, 3, 1, 2)[..., None]
    return total.permute(0, 2, 1)[..., None]     # (B, h, 1)


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
    """A copy of buf (B, T, ...) with val (B, 1, ...) at index slot.  With
    the cache's sequence sharded (``tp.current().kv``) buf holds this
    rank's T slots of the whole, and only the slot's owner writes."""
    ax = tp.current().kv
    out = buf.clone()
    if ax.size > 1:
        lo = ax.rank * buf.shape[1]
        if not lo <= slot < lo + buf.shape[1]:
            return out
        slot -= lo
    out[:, slot:slot + 1] = val.to(buf.dtype)
    return out


def _local_positions(kpos):
    """This rank's slots of the slot -> position map (the whole map when
    the cache's sequence is not sharded)."""
    return tp.chunk(kpos, 0, tp.current().kv)


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


def _rows(ax, total_heads: int, hd: int, wo):
    """(row-parallel, lo, hi, h0, h1): whether `wo` (total_heads·hd rows)
    is this rank's row block, the block's rows [lo, hi), and the heads
    [h0, h1) they read (all of them when wo is whole)."""
    width = total_heads * hd
    if ax.size > 1 and wo.shape[0] < width:
        lo, hi = tp.span(width, ax)
        return (True, lo, hi) + tp.heads_of(lo, hi, hd)
    return False, 0, width, 0, total_heads


def _out_proj(out, par, lo, hi, h0, vd, wo, ax):
    """(B, S, heads·vd) of heads [h0, ...) through wo: the columns of
    this rank's rows [lo, hi), row-parallel, all-reduced."""
    if not par:
        return out @ wo
    return tp.reduce(out[..., lo - h0 * vd:hi - h0 * vd] @ wo, ax)


def _kv_heads(k, v, h0, h1, k0, g):
    """k, v (B, S, KVn, D) of heads [k0, ...) for query heads [h0, h1)
    in groups of g: as they are when the queries fill whole groups or
    read one head, else one key and value head per query head."""
    if (h0 % g == 0 and h1 % g == 0) or k.shape[2] == 1:
        return k, v
    idx = torch.arange(h0, h1, device=k.device) // g - k0
    return k.index_select(2, idx), v.index_select(2, idx)


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
    ctx = tp.current()
    ax = ctx.tp
    qs = ax.size > 1 and params["wq"].shape[-1] < h * dh
    ks = ax.size > 1 and params["wk"].shape[-1] < kv * dh
    par, lo, hi, h0, h1 = _rows(ax, h, dh, params["wo"])
    if par:                    # the heads (and their K/V) are this rank's
        x = tp.copy(x, ax)
        if cross_kv is not None:
            cross_kv = tuple(tp.copy(t, ax) for t in cross_kv)
    if mode == "decode":
        h0, h1 = 0, h                  # every head scores this rank's slots
    g = h // kv
    k0, k1 = (0, kv) if mode != "train" else (h0 // g, (h1 - 1) // g + 1)
    q = tp.head_cols(x @ params["wq"], h, dh, h0, h1, ax, qs)
    q = q.reshape(B, S, h1 - h0, dh)
    xk, xv = (x, x) if cross_kv is None else cross_kv
    k = tp.head_cols(xk @ params["wk"], kv, dh, k0, k1, ax, ks)
    v = tp.head_cols(xv @ params["wv"], kv, dh, k0, k1, ax, ks)
    k = k.reshape(B, xk.shape[1], k1 - k0, dh)
    v = v.reshape(B, xv.shape[1], k1 - k0, dh)
    if cfg.qk_norm:                # replicated scales on this rank's heads
        scales = [params["q_scale"], params["k_scale"]]
        if par:
            scales = [tp.copy(t, ax) for t in scales]
        q = rms_norm_headwise(q, scales[0])
        k = rms_norm_headwise(k, scales[1])

    sp = ctx.sp if cross_kv is None else tp.ONE
    q0 = sp.rank * S
    if cfg.rope_theta and cross_kv is None:
        p = _positions(mode, S, pos, x.device) + q0
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
        alloc = cache["pos"].shape[0]
        slot = pos % alloc if window else pos
        kpos = cache["pos"].clone()
        kpos[slot] = pos
        new_cache = {"k": _cache_write(cache["k"], k, slot),
                     "v": _cache_write(cache["v"], v, slot), "pos": kpos}
        out = decode_mha(q, new_cache["k"], new_cache["v"],
                         _local_positions(kpos), cur_pos=pos, window=window)
    else:
        k = tp.gather(k, 1, sp, scatter=True)
        v = tp.gather(v, 1, sp, scatter=True)
        kq, vq = k[:, :, h0 // g - k0:(h1 - 1) // g + 1 - k0], \
            v[:, :, h0 // g - k0:(h1 - 1) // g + 1 - k0]
        kq, vq = _kv_heads(kq, vq, h0, h1, h0 // g, g)
        out = mha(q, kq, vq, causal=causal and cross_kv is None,
                  window=window, cross=cross_kv is not None, q0=q0)
        new_cache = None
        if mode == "prefill" and cross_kv is None:
            S = k.shape[1]
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
    out = out.reshape(B, q.shape[1], -1)
    return _out_proj(out, par, lo, hi, h0, dh, params["wo"], ax), new_cache


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
    through ``wk_b`` and projects the result through ``wv_b``.  The
    latent projection ``wkv_a`` is replicated under tensor parallelism;
    ``wq_a``'s output is gathered for its norm."""
    m = cfg.mla
    B, S, d = x.shape
    h = cfg.num_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    qk, vd = nope + rope, m.v_head_dim
    scale = 1.0 / math.sqrt(nope + rope)
    ax = tp.current().tp
    par, lo, hi, h0, h1 = _rows(ax, h, vd, params["wo"])
    if mode == "decode":
        h0, h1 = 0, h                  # every head scores this rank's slots
    wqa_s = ax.size > 1 and params["wq_a"].shape[-1] < m.q_lora_rank
    cq = (tp.copy(x, ax) if wqa_s else x) @ params["wq_a"]
    if wqa_s:
        cq = tp.gather(cq, -1, ax)
    cq = rms_norm_headwise(cq, params["q_norm"])
    qs = ax.size > 1 and params["wq_b"].shape[-1] < h * qk
    q = tp.head_cols((tp.copy(cq, ax) if par else cq) @ params["wq_b"], h,
                     qk, h0, h1, ax, qs).reshape(B, S, h1 - h0, qk)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    ckv_full = x @ params["wkv_a"]
    c_kv = rms_norm_headwise(ckv_full[..., :m.kv_lora_rank],
                             params["kv_norm"])
    k_pe = ckv_full[..., m.kv_lora_rank:]

    cos, sin = rope_angles(_positions(mode, S, pos, x.device), rope,
                           cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos[None], sin[None])
    k_pe = apply_rope(k_pe[:, :, None, :], cos[None], sin[None])[:, :, 0, :]
    ks = ax.size > 1 and params["wk_b"].shape[-1] < h * nope
    vs = ax.size > 1 and params["wv_b"].shape[-1] < h * vd

    if mode == "decode":
        kpos = cache["pos"].clone()
        kpos[pos] = pos
        new_cache = {"c_kv": _cache_write(cache["c_kv"], c_kv, pos),
                     "k_pe": _cache_write(cache["k_pe"], k_pe, pos),
                     "pos": kpos}
        # absorbed: q_nope' = q_nope @ Wk_b^T scores against the latent
        wk = tp.head_cols(params["wk_b"], h, nope, 0, h, ax, ks)
        wk = wk.reshape(m.kv_lora_rank, h, nope)
        q_lat = torch.einsum("bqhd,chd->bqhc", q_nope, wk)   # (B,1,h,rank)
        scores = (torch.einsum("bqhc,btc->bhqt", q_lat, new_cache["c_kv"])
                  + torch.einsum("bqhd,btd->bhqt", q_pe, new_cache["k_pe"]))
        scores = scores.to(torch.float32) * scale
        mine = _local_positions(kpos)
        mask = (mine <= pos) & (mine >= 0)
        kv_ax = tp.current().kv
        if kv_ax.size > 1:
            o_lat = _combine(scores, mask, lambda p: torch.einsum(
                "bhqt,btc->bqhc", p, new_cache["c_kv"].to(torch.float32)),
                kv_ax).to(x.dtype)
        else:
            scores = torch.where(mask, scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            o_lat = torch.einsum("bhqt,btc->bqhc", probs, new_cache["c_kv"])
        if par:
            h0, h1 = tp.heads_of(lo, hi, vd)
        wv = tp.head_cols(params["wv_b"], h, vd, h0, h1, ax, vs)
        wv = wv.reshape(m.kv_lora_rank, h1 - h0, vd)
        out = torch.einsum("bqhc,chv->bqhv", o_lat[:, :, h0:h1], wv)
    else:
        cin = tp.copy(c_kv, ax) if par else c_kv
        k_nope = tp.head_cols(cin @ params["wk_b"], h, nope, h0, h1, ax, ks)
        v = tp.head_cols(cin @ params["wv_b"], h, vd, h0, h1, ax, vs)
        k_nope = k_nope.reshape(B, S, h1 - h0, nope)
        v = v.reshape(B, S, h1 - h0, vd)
        k_pe_h = (tp.copy(k_pe, ax) if par else k_pe)[:, :, None, :]
        k = torch.cat([k_nope, k_pe_h.expand(B, S, h1 - h0, rope)], dim=-1)
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
    out = out.reshape(B, S, (h1 - h0) * vd)
    return _out_proj(out, par, lo, hi, h0, vd, params["wo"], ax), new_cache
