"""Model assembly (port of ``repro/models/transformer.py``): every block
kind of the registry (ATTN, LOCAL_ATTN, MLSTM, SLSTM, RGLRU), the MoE
feed-forward in place of the MLP, whisper's cross-attention blocks, and
the decoder-only LM over token or embedding inputs; ``build_lm`` hands
encoder-decoder configurations to ``encdec.build_encdec``.

The reference groups layers into segments of (pattern, repeats), stacks
each pattern position's parameters along a leading ``repeats`` axis and
scans over it.  The port runs the same layers as a Python loop and keeps
one parameter dict (and one decode state) per layer, in layer order: layer
``l`` of a segment is pattern position ``l % len(pattern)`` of repeat
``l // len(pattern)``.  ``params_from_jax``, ``state_from_jax`` and
``state_to_jax`` carry the reference's stacked pytrees (as numpy arrays)
across that map.

Entry points produced by ``build_lm``:
  init_params(gen)                     -> params (on gen's device)
  loss_fn(params, batch)               -> (loss + 0.01 aux, metrics)
  prefill(params, batch, max_len)      -> (last_logits, decode_state)
  decode_step(params, state, tok, pos, positions=None)
                                       -> (logits, decode_state)
  decode_state_shape(batch, max_len)   -> [{leaf: (shape, dtype)}] per layer

``max_len`` sizes the attention caches (a ring holds min(max_len,
window) positions) and ``pos`` is the decoded token's position.  An
embeds-input model (qwen2-vl) takes ``batch["embeds"]`` (B, S, d) and its
(B, 3, S) M-RoPE ``positions`` at prefill, and the next input's
embedding (B, d) in place of a token at decode.  ``loss_fn`` takes the
batch's ``labels`` (and an optional ``loss_mask``) and returns the cross
entropy plus 0.01 times the MoE aux loss summed over the layers, with
metrics {"loss", "aux_loss", "tokens"}.

In train mode with ``cfg.remat`` (and grad enabled) each repeat of a
segment's pattern runs under ``torch.utils.checkpoint`` (non-reentrant):
the reference's ``jax.checkpoint`` of its scan body, one pattern
instance; ``cfg.remat_group`` > 1 (dividing the repeats) puts that many
instances under one checkpoint, as the reference groups them.  The
backward then runs each group's forward again, its kernels included.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.tree import map_leaves
# the walker's name in tests/test_torch_gpu.py's import
from repro_torch.tree import map_leaves as tree_map  # noqa: F401
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLSTM, RGLRU, SLSTM,
                                      ModelConfig)
from repro_torch.launch import tp
from . import attention as attn
from . import ssm
from .layers import (apply_mlp, apply_norm, cross_entropy, dtype_of,
                     embed_init, embed_tokens, full_logits, last_logits,
                     mlp_init, norm_init, unembed)
from .moe import apply_moe, moe_init


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in order."""
    return [kind for pattern, repeats in cfg.layout
            for _ in range(repeats) for kind in pattern]


# ---------------------------------------------------------------------------
# Single block: init / state-shape / apply
# ---------------------------------------------------------------------------

def block_init(cfg: ModelConfig, kind: str, gen: torch.Generator, *,
               cross: bool = False):
    dev = gen.device
    if kind in (ATTN, LOCAL_ATTN):
        p = {"ln1": norm_init(cfg, dev), "attn": attn.attn_init(cfg, gen)}
        if cross:
            p["ln_x"] = norm_init(cfg, dev)
            p["xattn"] = attn.attn_init(cfg, gen)
        if cfg.moe is not None:
            p["ln2"] = norm_init(cfg, dev)
            p["moe"] = moe_init(cfg, gen)
        elif cfg.d_ff:
            p["ln2"] = norm_init(cfg, dev)
            p["mlp"] = mlp_init(cfg, gen)
        return p
    if kind == MLSTM:
        return {"ln": norm_init(cfg, dev), "cell": ssm.mlstm_init(cfg, gen)}
    if kind == SLSTM:
        return {"ln": norm_init(cfg, dev), "cell": ssm.slstm_init(cfg, gen)}
    if kind == RGLRU:
        return {"ln1": norm_init(cfg, dev), "cell": ssm.rglru_init(cfg, gen),
                "ln2": norm_init(cfg, dev), "mlp": mlp_init(cfg, gen)}
    raise ValueError(kind)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == ATTN else cfg.local_window


def block_state_shape(cfg: ModelConfig, kind: str, batch: int,
                      max_len: int = 0, cross: bool = False):
    if kind in (ATTN, LOCAL_ATTN):
        st = {"kv": attn.kv_cache_shape(cfg, batch, max_len,
                                        _window(cfg, kind))}
        if cross:
            kvd = ((batch, cfg.enc_seq, cfg.num_kv_heads, cfg.head_dim),
                   dtype_of(cfg))
            st["ck"] = kvd
            st["cv"] = kvd
        return st
    if kind == MLSTM:
        return {"cell": ssm.mlstm_state_shape(cfg, batch)}
    if kind == SLSTM:
        return {"cell": ssm.slstm_state_shape(cfg, batch)}
    if kind == RGLRU:
        return {"cell": ssm.rglru_state_shape(cfg, batch)}
    raise ValueError(kind)


def _cross_kv(cfg: ModelConfig, params, enc_out):
    """The cross-attention keys and values of the encoder output, each
    (B, enc_seq, KV, D) in the activation dtype: computed once at
    prefill and carried in the decode state."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.num_kv_heads, cfg.head_dim)
    return ((enc_out @ params["wk"]).reshape(shape).to(dtype_of(cfg)),
            (enc_out @ params["wv"]).reshape(shape).to(dtype_of(cfg)))


def _cross_decode(cfg: ModelConfig, params, x, ck, cv):
    """One decode step's cross-attention against the carried ck/cv."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    T = ck.shape[1]
    out = attn.decode_mha(q, ck, cv, torch.arange(T, device=x.device),
                          cur_pos=T - 1, sharded=False)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ params["wo"]


def _apply_attn_block(cfg: ModelConfig, kind: str, params, x, *, mode,
                      state, pos, positions, max_len, enc_out, causal):
    h, kv = attn.apply_attention(
        cfg, params["attn"], apply_norm(cfg, params["ln1"], x), mode=mode,
        window=_window(cfg, kind),
        cache=None if state is None else state["kv"], pos=pos,
        positions=positions, max_len=max_len, causal=causal)
    x = x + h
    new_state = None if kv is None else {"kv": kv}
    if "xattn" in params:
        xn = apply_norm(cfg, params["ln_x"], x)
        if mode == "decode":
            ck, cv = state["ck"], state["cv"]
            xh = _cross_decode(cfg, params["xattn"], xn, ck, cv)
        else:
            xh, _ = attn.apply_attention(cfg, params["xattn"], xn,
                                         mode="train",
                                         cross_kv=(enc_out, enc_out),
                                         causal=False)
            if mode == "prefill":
                ck, cv = _cross_kv(cfg, params["xattn"], enc_out)
        x = x + xh
        if mode != "train":
            new_state = dict(new_state, ck=ck, cv=cv)
    aux = None
    if "moe" in params:
        h, aux = apply_moe(cfg, params["moe"],
                           apply_norm(cfg, params["ln2"], x))
        x = x + h
    elif "mlp" in params:
        x = x + apply_mlp(cfg, params["mlp"],
                          apply_norm(cfg, params["ln2"], x))
    return x, new_state, aux


def block_apply(cfg: ModelConfig, kind: str, params, x, *, mode: str,
                state=None, pos=None, positions=None, max_len: int = 0,
                enc_out=None, causal: bool = True):
    """Returns (x, new_state); ``layers_apply`` also sums the MoE aux
    losses."""
    x, st, _ = _block(cfg, kind, params, x, mode=mode, state=state, pos=pos,
                      positions=positions, max_len=max_len, enc_out=enc_out,
                      causal=causal)
    return x, st


def _block(cfg: ModelConfig, kind: str, params, x, *, mode, state, pos,
           positions, max_len, enc_out, causal):
    """(x, new_state, the MoE aux loss or None without an MoE)."""
    aux = None
    if kind in (ATTN, LOCAL_ATTN):
        x, st, aux = _apply_attn_block(cfg, kind, params, x, mode=mode,
                                       state=state, pos=pos,
                                       positions=positions, max_len=max_len,
                                       enc_out=enc_out, causal=causal)
    elif kind == RGLRU:
        h, st = ssm.apply_rglru(cfg, params["cell"],
                                apply_norm(cfg, params["ln1"], x), mode=mode,
                                state=None if state is None else state["cell"])
        x = x + h
        x = x + apply_mlp(cfg, params["mlp"],
                          apply_norm(cfg, params["ln2"], x))
        st = None if st is None else {"cell": st}
    elif kind in (MLSTM, SLSTM):
        fn = ssm.apply_mlstm if kind == MLSTM else ssm.apply_slstm
        h, st = fn(cfg, params["cell"], apply_norm(cfg, params["ln"], x),
                   mode=mode, state=None if state is None else state["cell"])
        x = x + h
        st = None if st is None else {"cell": st}
    else:
        raise ValueError(kind)
    return x, st, aux


def layers_apply(cfg: ModelConfig, blocks, x, *, mode: str, states=None,
                 pos=None, positions=None, max_len: int = 0, enc_out=None,
                 causal: bool = True):
    """All layers in order (the reference's segments_apply).  Returns
    (x, new_states, aux): new_states None in train mode, aux the MoE aux
    losses summed over the layers (float32 0-d).  In train mode with
    ``cfg.remat`` and grad enabled, each group of pattern instances runs
    under a checkpoint."""
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    aux = None
    new_states = []

    def add(total, a):
        return a if total is None else total if a is None else total + a

    def run(xx, lis):
        a, outs = None, []
        for li, kind in lis:
            # a named range per block kind, for the profilers' breakdowns
            with torch.profiler.record_function(f"block:{kind}"):
                xx, ns, a_l = _block(
                    cfg, kind, blocks[li], xx, mode=mode,
                    state=None if states is None else states[li], pos=pos,
                    positions=positions, max_len=max_len, enc_out=enc_out,
                    causal=causal)
            a = add(a, a_l)
            outs.append(ns)
        return xx, a, outs

    li = 0
    for pattern, repeats in cfg.layout:
        n = len(pattern)
        group = cfg.remat_group if remat and cfg.remat_group > 1 and \
            repeats % cfg.remat_group == 0 else 1
        for r in range(0, repeats, group):
            lis = [(li + j, pattern[j % n])
                   for j in range(r * n, (r + group) * n)]
            if remat:
                # the recompute runs in the backward pass: in this
                # forward's tensor-parallel layout, whatever is current
                x, a = torch.utils.checkpoint.checkpoint(
                    lambda xx, lis=lis, ctx=tp.current():
                    _in_layout(ctx, run, xx, lis)[:2], x,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, a, outs = run(x, lis)
                new_states += outs
            aux = add(aux, a)
        li += repeats * n
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, (new_states if mode != "train" else None), aux


def _in_layout(ctx, fn, *args):
    with tp.use(ctx):
        return fn(*args)


def layers_state_shape(cfg: ModelConfig, batch: int, max_len: int = 0,
                       cross: bool = False):
    return [block_state_shape(cfg, kind, batch, max_len, cross)
            for kind in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# Decoder-only LM
# ---------------------------------------------------------------------------

def build_lm(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        from .encdec import build_encdec
        return build_encdec(cfg)

    def init_params(gen: torch.Generator):
        return {
            "embed": embed_init(cfg, gen),
            "blocks": [block_init(cfg, kind, gen)
                       for kind in layer_kinds(cfg)],
            "ln_f": norm_init(cfg, gen.device),
        }

    def _backbone(params, x, *, mode, states=None, pos=None, positions=None,
                  max_len=0):
        x, new_states, aux = layers_apply(
            cfg, params["blocks"], x, mode=mode, states=states, pos=pos,
            positions=positions, max_len=max_len)
        return apply_norm(cfg, params["ln_f"], x), new_states, aux

    def _inputs(params, batch):
        if cfg.embeds_input:
            x = batch["embeds"].to(dtype_of(cfg))
        else:
            x = embed_tokens(cfg, params["embed"], batch["tokens"])
        return x, batch.get("positions") if cfg.position_inputs else None

    def loss_fn(params, batch):
        """(loss + 0.01 aux, {"loss", "aux_loss", "tokens"}) on a batch
        with ``labels`` (B, S) and an optional ``loss_mask``."""
        x, positions = _inputs(params, batch)
        x, _, aux = _backbone(params, x, mode="train", positions=positions)
        logits = unembed(cfg, params["embed"], x)
        loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                             vocab=cfg.vocab_size)
        return loss + 0.01 * aux, {
            "loss": loss, "aux_loss": aux,
            "tokens": torch.tensor(float(batch["labels"].numel()),
                                   device=loss.device)}

    def prefill(params, batch, max_len: int = 0):
        """max_len sizes the attention caches (recurrent blocks ignore
        it)."""
        x, positions = _inputs(params, batch)
        x, states, _ = _backbone(params, x, mode="prefill",
                                 positions=positions, max_len=max_len)
        return last_logits(cfg, params["embed"], x), states

    def decode_step(params, states, tokens, pos=None, positions=None):
        """tokens (B,) int, or for an embeds-input model the next inputs'
        embeddings (B, d); pos: their position (an int or a 0-d tensor),
        which attention reads and the recurrent blocks ignore; positions:
        (B, 3, 1) M-RoPE ids (default: pos on all three rows)."""
        if cfg.embeds_input:
            x = tokens.to(dtype_of(cfg))[:, None, :]
        else:
            x = embed_tokens(cfg, params["embed"], tokens[:, None])
        x, states, _ = _backbone(params, x, mode="decode", states=states,
                                 pos=pos, positions=positions)
        logits = full_logits(cfg, unembed(cfg, params["embed"], x))
        return logits[:, 0], states

    def decode_state_shape(batch: int, max_len: int = 0):
        return layers_state_shape(cfg, batch, max_len)

    return dict(config=cfg, init_params=init_params, loss_fn=loss_fn,
                prefill=prefill, decode_step=decode_step,
                decode_state_shape=decode_state_shape)


# ---------------------------------------------------------------------------
# the reference's stacked pytrees <-> the port's per-layer dicts
# ---------------------------------------------------------------------------

def tensor_from_numpy(a, device="cpu"):
    """A numpy array (float32, int, or ml_dtypes bfloat16) as a tensor,
    bit for bit."""
    a = np.array(a, copy=True)              # contiguous, writable, owned
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t):
    """A tensor as a numpy array, bit for bit (bfloat16 as ml_dtypes'
    bfloat16, the dtype of the reference's bf16 arrays)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _unstack(cfg: ModelConfig, segs, fn):
    """The reference's ((pattern position -> stacked leaf) per segment)
    as one entry per layer, each leaf passed through fn."""
    out = []
    for si, (pattern, repeats) in enumerate(cfg.layout):
        for r in range(repeats):
            for bi in range(len(pattern)):
                out.append(map_leaves(lambda a: fn(np.asarray(a)[r]),
                                    segs[si][bi]))
    return out


def _stack(cfg: ModelConfig, layers):
    """The inverse of _unstack: per-layer numpy trees -> the reference's
    tuple of segments of tuples of stacked trees."""
    segs, li = [], 0
    for pattern, repeats in cfg.layout:
        per_pos = [[] for _ in pattern]
        for _ in range(repeats):
            for bi in range(len(pattern)):
                per_pos[bi].append(layers[li])
                li += 1
        segs.append(tuple(_stack_trees(trees) for trees in per_pos))
    return tuple(segs)


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """An encoder-decoder's encoder stack: ``enc_layers`` layers of the
    decoder's block pattern, without cross-attention."""
    return cfg.replace(num_layers=cfg.enc_layers, is_encoder_decoder=False)


def params_from_jax(cfg: ModelConfig, params_np, device="cpu"):
    """The reference's ``init_params`` pytree (leaves as numpy arrays) as
    the port's parameters on `device`: the stacked segments (``blocks``;
    an encoder-decoder's ``encoder`` and ``decoder``) become per-layer
    lists, every other entry keeps its tree."""
    def conv(a):
        return tensor_from_numpy(a, device)
    stacks = {"blocks": cfg, "decoder": cfg}
    if cfg.is_encoder_decoder:
        stacks["encoder"] = encoder_config(cfg)
    return {name: _unstack(stacks[name], tree, conv) if name in stacks
            else map_leaves(conv, tree) for name, tree in params_np.items()}


def state_from_jax(cfg: ModelConfig, states_np, device="cpu"):
    """The reference's decode state (segments of stacked leaves, numpy) as
    the port's per-layer states on `device`."""
    return _unstack(cfg, states_np, lambda a: tensor_from_numpy(a, device))


def state_to_jax(cfg: ModelConfig, states):
    """The port's per-layer states as the reference's decode-state pytree
    of numpy arrays (tuples of segments of stacked leaves)."""
    return _stack(cfg, [map_leaves(tensor_to_numpy, st) for st in states])
