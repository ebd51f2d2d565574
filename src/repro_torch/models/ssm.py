"""Recurrent blocks (port of ``repro/models/ssm.py``): the mLSTM block
(matrix memory; prefill through the chunkwise kernel, decode through the
one-step recurrence), the sLSTM block (scalar memory, strictly
sequential) and the RG-LRU block of Griffin / RecurrentGemma (prefill
through the ``rglru_scan`` kernel, decode through the one-step
recurrence).

Under tensor parallelism (``launch/tp.py``) the RG-LRU block is sharded on
its width: ``w_x``, ``w_gate``, the conv and ``lam`` hold this rank's
channels, the gates' (w, w) products take the whole conv'd input
(gathered, as GSPMD must gather it) and give this rank's columns, the
scan and its decode step run on the local (B, S, W / m) shard, and
``w_out`` is row-parallel.  The xLSTM blocks belong to a data-parallel
arch: their decode state arrives whole (the step gathers a sharded
state before the block and cuts it after).

Parameters and states are dicts of tensors under the reference's names,
so ``repro_torch.models.transformer.params_from_jax`` maps one onto the
other leaf for leaf.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import tp
from .layers import dense_init, dtype_of, pdtype_of, rms_norm_headwise


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------

def causal_conv(x, w):
    """x (B, S, ch), w (cw, ch) -> (B, S, ch).  The reference's shifted sum
    (an ``F.conv1d`` would run float32 through cuDNN in TF32)."""
    cw = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = xp[:, 0:S] * w[0]
    for j in range(1, cw):
        out = out + xp[:, j: j + S] * w[j]
    return out.to(x.dtype)


def conv_step(x1, w, state):
    """x1 (B, 1, ch); state (B, cw-1, ch) -> (out (B, 1, ch), new_state)."""
    win = torch.cat([state, x1.to(state.dtype)], dim=1)            # (B,cw,ch)
    out = torch.einsum("bcw,cw->bw", win.to(torch.float32),
                       w.to(torch.float32))[:, None]
    return out.to(x1.dtype), win[:, 1:]


def _conv_tail(cfg: ModelConfig, x):
    """The last cw-1 positions of x (left-padded with zeros when S is
    shorter): the conv state a prefill hands to decode."""
    S = x.shape[1]
    tail = x[:, max(S - (cfg.conv_width - 1), 0):]
    if tail.shape[1] < cfg.conv_width - 1:
        tail = F.pad(tail, (0, 0, cfg.conv_width - 1 - tail.shape[1], 0))
    # a copy: a view would keep the whole (B, S, ch) input alive in the
    # decode state
    return tail.to(dtype_of(cfg)).clone()


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM matrix memory)
# ---------------------------------------------------------------------------

def mlstm_inner(cfg: ModelConfig) -> int:
    return int(cfg.proj_factor * cfg.d_model)


def mlstm_init(cfg: ModelConfig, gen: torch.Generator):
    d, H = cfg.d_model, cfg.num_heads
    inner = mlstm_inner(cfg)
    pd = pdtype_of(cfg)
    dev = gen.device
    f32 = torch.float32
    return {
        "w_up": dense_init(gen, (d, 2 * inner), pd),
        "conv": dense_init(gen, (cfg.conv_width, inner), pd, scale=0.3),
        "wq": dense_init(gen, (inner, inner), pd),
        "wk": dense_init(gen, (inner, inner), pd),
        "wv": dense_init(gen, (inner, inner), pd),
        "w_i": dense_init(gen, (inner, H), f32),
        "w_f": dense_init(gen, (inner, H), f32),
        "b_f": torch.full((H,), 3.0, dtype=f32, device=dev),  # remember
        "b_i": torch.zeros((H,), dtype=f32, device=dev),
        "skip": torch.ones((inner,), dtype=pd, device=dev),
        "out_scale": torch.ones((inner,), dtype=pd, device=dev),
        "w_down": dense_init(gen, (inner, d), pd),
    }


def mlstm_state_shape(cfg: ModelConfig, batch: int):
    """{leaf: (shape, dtype)} of one mLSTM block's decode state."""
    H = cfg.num_heads
    inner = mlstm_inner(cfg)
    dh = inner // H
    f32 = torch.float32
    return {
        "C": ((batch, H, dh, dh), f32),
        "n": ((batch, H, dh), f32),
        "m": ((batch, H), f32),
        "conv": ((batch, cfg.conv_width - 1, inner), dtype_of(cfg)),
    }


def _mlstm_qkv_gates(cfg, params, c_in, c_act):
    B, S, inner = c_in.shape
    H = cfg.num_heads
    dh = inner // H

    def heads(a):                                                # (B,H,S,dh)
        return a.reshape(B, S, H, dh).permute(0, 2, 1, 3)

    q = heads(c_act @ params["wq"])
    k = heads(c_act @ params["wk"])
    v = heads(c_in @ params["wv"])
    gf = c_act.to(torch.float32)
    log_f = F.logsigmoid(gf @ params["w_f"] + params["b_f"])     # (B,S,H)
    log_i = gf @ params["w_i"] + params["b_i"]
    return q, k, v, log_f.permute(0, 2, 1), log_i.permute(0, 2, 1)


def _mlstm_out(cfg, params, h, c_act, g):
    """h (B, H, S, dh) -> block output (B, S, d)."""
    B, H, S, dh = h.shape
    hs = h.permute(0, 2, 1, 3)                                   # (B,S,H,dh)
    ones = torch.ones((dh,), dtype=torch.float32, device=h.device)
    hn = rms_norm_headwise(hs, ones).reshape(B, S, H * dh)
    hn = hn * params["out_scale"] + c_act * params["skip"]
    return (hn * F.silu(g)) @ params["w_down"]


def apply_mlstm(cfg: ModelConfig, params, x, *, mode: str, state=None):
    inner = mlstm_inner(cfg)
    up = x @ params["w_up"]
    c_in, g = up[..., :inner], up[..., inner:]

    if mode == "decode":
        c_out, conv_state = conv_step(c_in, params["conv"], state["conv"])
        c_act = F.silu(c_out)
        q, k, v, log_f, log_i = _mlstm_qkv_gates(cfg, params, c_in, c_act)
        h1, (C, n, m) = ops.mlstm_step(
            q[:, :, 0], k[:, :, 0], v[:, :, 0], log_f[:, :, 0],
            log_i[:, :, 0], (state["C"], state["n"], state["m"]))
        h = h1[:, :, None, :]                                    # (B,H,1,dh)
        new_state = {"C": C, "n": n, "m": m, "conv": conv_state}
    else:
        c_act = F.silu(causal_conv(c_in, params["conv"]))
        q, k, v, log_f, log_i = _mlstm_qkv_gates(cfg, params, c_in, c_act)
        h, (C, n, m) = ops.mlstm_chunkwise(q, k, v, log_f, log_i)
        new_state = None
        if mode == "prefill":
            new_state = {"C": C, "n": n, "m": m,
                         "conv": _conv_tail(cfg, c_in)}
    return _mlstm_out(cfg, params, h, c_act, g), new_state


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, strictly sequential)
# ---------------------------------------------------------------------------

def slstm_init(cfg: ModelConfig, gen: torch.Generator):
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    ff = int(4 * d / 3)
    pd = pdtype_of(cfg)
    dev = gen.device
    f32 = torch.float32
    return {
        "conv": dense_init(gen, (cfg.conv_width, d), pd, scale=0.3),
        "w": dense_init(gen, (d, 4 * d), f32),
        "r": dense_init(gen, (H, dh, 4 * dh), f32, scale=1.0 / math.sqrt(dh)),
        "b": torch.cat([torch.zeros((d,)), torch.full((d,), 3.0),
                        torch.zeros((2 * d,))]).to(dtype=f32, device=dev),
        "wu_g": dense_init(gen, (d, ff), pd),
        "wu": dense_init(gen, (d, ff), pd),
        "wd": dense_init(gen, (ff, d), pd),
    }


def slstm_state_shape(cfg: ModelConfig, batch: int):
    """{leaf: (shape, dtype)} of one sLSTM block's decode state."""
    d = cfg.d_model
    f32 = torch.float32
    return {
        "c": ((batch, d), f32),
        "n": ((batch, d), f32),
        "h": ((batch, d), f32),
        "m": ((batch, d), f32),
        "conv": ((batch, cfg.conv_width - 1, d), dtype_of(cfg)),
    }


def _slstm_cell(cfg, params, xc_t, carry):
    """xc_t (B, d) conv'd input; carry (c, n, h, m) each (B, d) f32."""
    c, n, h, m = carry
    B, d = xc_t.shape
    H = cfg.num_heads
    dh = d // H
    gx = xc_t.to(torch.float32) @ params["w"] + params["b"]     # (B,4d)
    hr = h.reshape(B, H, dh)
    gr = torch.einsum("bhd,hde->bhe", hr, params["r"]).reshape(B, 4 * d)
    gi, gf, gz, go = (gx + gr).chunk(4, dim=-1)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    lf = F.logsigmoid(gf)
    m_new = torch.maximum(lf + m, gi)
    ip = torch.exp(gi - m_new)
    fp = torch.exp(lf + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


def _slstm_ffn(params, h, dtype):
    ones = torch.ones((h.shape[-1],), dtype=torch.float32, device=h.device)
    hn = rms_norm_headwise(h.to(torch.float32), ones).to(dtype)
    return (F.gelu(hn @ params["wu_g"], approximate="tanh") *
            (hn @ params["wu"])) @ params["wd"]


def apply_slstm(cfg: ModelConfig, params, x, *, mode: str, state=None):
    B, S, d = x.shape
    if mode == "decode":
        xc, conv_state = conv_step(x, params["conv"], state["conv"])
        carry = (state["c"], state["n"], state["h"], state["m"])
        carry = _slstm_cell(cfg, params, xc[:, 0], carry)
        h = carry[2][:, None]
        new_state = {"c": carry[0], "n": carry[1], "h": carry[2],
                     "m": carry[3], "conv": conv_state}
    else:
        xc = causal_conv(x, params["conv"])
        z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        carry = (z, z, z, torch.full((B, d), -1e30, dtype=torch.float32,
                                     device=x.device))
        hs = []
        for t in range(S):                # the reference's lax.scan
            carry = _slstm_cell(cfg, params, xc[:, t], carry)
            hs.append(carry[2])
        h = torch.stack(hs, dim=1)                               # (B,S,d)
        new_state = None
        if mode == "prefill":
            new_state = {"c": carry[0], "n": carry[1], "h": carry[2],
                         "m": carry[3], "conv": _conv_tail(cfg, x)}
    return _slstm_ffn(params, h, x.dtype), new_state


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block)
# ---------------------------------------------------------------------------

_RG_C = 8.0  # RG-LRU decay sharpness constant


def rglru_init(cfg: ModelConfig, gen: torch.Generator):
    d, w = cfg.d_model, cfg.lru_width
    pd = pdtype_of(cfg)
    # Lambda init so that a = exp(-8*softplus(L)*r) lands in ~[0.9, 0.999]
    u = 0.1 + 0.8 * torch.rand((w,), generator=gen, device=gen.device)
    lam = torch.log(torch.expm1(-torch.log(u) / _RG_C))
    return {
        "w_x": dense_init(gen, (d, w), pd),
        "w_gate": dense_init(gen, (d, w), pd),
        "conv": dense_init(gen, (cfg.conv_width, w), pd, scale=0.3),
        "w_rg": dense_init(gen, (w, w), torch.float32),
        "w_ig": dense_init(gen, (w, w), torch.float32),
        "lam": lam,
        "w_out": dense_init(gen, (w, d), pd),
    }


def rglru_state_shape(cfg: ModelConfig, batch: int):
    """{leaf: (shape, dtype)} of one RG-LRU block's decode state."""
    w = cfg.lru_width
    return {"h": ((batch, w), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, w), dtype_of(cfg))}


def _rglru_gates(params, ucf, ax=tp.ONE):
    """The gated input i * u and log a from the conv'd input ucf
    (float32); the (w, w) gate products stay float32.  Width-parallel on
    `ax`: ucf is this rank's channels, gathered whole for the products,
    whose columns are this rank's."""
    full = tp.gather(ucf, -1, ax, scatter=True)
    r = torch.sigmoid(full @ params["w_rg"])
    i = torch.sigmoid(full @ params["w_ig"])
    log_a = -_RG_C * F.softplus(params["lam"]) * r
    return i * ucf, log_a


def apply_rglru(cfg: ModelConfig, params, x, *, mode: str, state=None):
    ax = tp.current().tp
    if not (ax.size > 1 and params["w_x"].shape[-1] < cfg.lru_width):
        ax = tp.ONE
    x = tp.copy(x, ax)
    u = x @ params["w_x"]
    g = F.gelu(x @ params["w_gate"], approximate="tanh")

    if mode == "decode":
        uc, conv_state = conv_step(u, params["conv"], state["conv"])
        xin, log_a = _rglru_gates(params, uc[:, 0].to(torch.float32), ax)
        h = ops.rglru_step(xin, log_a, state["h"])
        y = h[:, None].to(x.dtype)
        new_state = {"h": h, "conv": conv_state}
    else:
        uc = causal_conv(u, params["conv"])
        xin, log_a = _rglru_gates(params, uc.to(torch.float32), ax)
        h = ops.rglru_scan(xin, log_a)                          # (B,S,w) f32
        y = h.to(x.dtype)
        new_state = None
        if mode == "prefill":
            new_state = {"h": h[:, -1].clone(), "conv": _conv_tail(cfg, u)}
    return tp.reduce((y * g) @ params["w_out"], ax), new_state
