"""Model assembly (port of ``repro/models/transformer.py:36-296``) for the
block kinds the port carries: MLSTM and SLSTM (xlstm), RGLRU and
LOCAL_ATTN (recurrentgemma), each RG-LRU and local-attention block
followed by its MLP.

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
  prefill(params, batch, max_len)      -> (last_logits, decode_state)
  decode_step(params, state, tok, pos) -> (logits, decode_state)
  decode_state_shape(batch, max_len)   -> [{leaf: (shape, dtype)}] per layer

``max_len`` sizes the attention caches (a local-attention ring holds
min(max_len, window) positions) and ``pos`` is the decoded token's
position.  Global attention, MoE, MLA, encoder-decoder and embeds-input
configurations raise ``NotImplementedError`` naming their ROADMAP item;
``loss_fn`` and training wait for the training slice.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLSTM, RGLRU, SLSTM,
                                      ModelConfig)
from . import attention as attn
from . import ssm
from .layers import (apply_mlp, apply_norm, embed_init, embed_tokens,
                     mlp_init, norm_init, unembed)

#: the block kinds the port carries
PORTED = (MLSTM, SLSTM, RGLRU, LOCAL_ATTN)
#: block kinds and configuration features still to port, by ROADMAP item
UNPORTED = {
    ATTN: "ROADMAP Queue 1 item 16 (global attention models)",
    "moe": "ROADMAP Queue 1 item 17 (the other families)",
    "mla": "ROADMAP Queue 1 item 17 (the other families)",
    "encoder-decoder": "ROADMAP Queue 1 item 17 (the other families)",
    "embeds-input": "ROADMAP Queue 1 item 17 (the other families)",
}


def _unported(kind: str):
    return NotImplementedError(f"block kind {kind!r}: see "
                               f"{UNPORTED.get(kind, 'ROADMAP Queue 1')}")


def check_ported(cfg: ModelConfig):
    """Raise NotImplementedError for anything this slice does not carry."""
    features = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("encoder-decoder", cfg.is_encoder_decoder),
        ("embeds-input", cfg.embeds_input)) if on]
    features += [kind for pattern, _ in cfg.layout for kind in pattern]
    for f in features:
        if f not in PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {f!r} is not ported yet; see "
                f"{UNPORTED.get(f, 'ROADMAP Queue 1')}")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of every layer, in order."""
    return [kind for pattern, repeats in cfg.layout
            for _ in range(repeats) for kind in pattern]


# ---------------------------------------------------------------------------
# Single block: init / state-shape / apply
# ---------------------------------------------------------------------------

def block_init(cfg: ModelConfig, kind: str, gen: torch.Generator):
    dev = gen.device
    if kind == MLSTM:
        return {"ln": norm_init(cfg, dev), "cell": ssm.mlstm_init(cfg, gen)}
    if kind == SLSTM:
        return {"ln": norm_init(cfg, dev), "cell": ssm.slstm_init(cfg, gen)}
    if kind == RGLRU:
        return {"ln1": norm_init(cfg, dev), "cell": ssm.rglru_init(cfg, gen),
                "ln2": norm_init(cfg, dev), "mlp": mlp_init(cfg, gen)}
    if kind == LOCAL_ATTN:
        p = {"ln1": norm_init(cfg, dev), "attn": attn.attn_init(cfg, gen)}
        if cfg.d_ff:
            p["ln2"] = norm_init(cfg, dev)
            p["mlp"] = mlp_init(cfg, gen)
        return p
    raise _unported(kind)


def block_state_shape(cfg: ModelConfig, kind: str, batch: int,
                      max_len: int = 0):
    if kind == MLSTM:
        return {"cell": ssm.mlstm_state_shape(cfg, batch)}
    if kind == SLSTM:
        return {"cell": ssm.slstm_state_shape(cfg, batch)}
    if kind == RGLRU:
        return {"cell": ssm.rglru_state_shape(cfg, batch)}
    if kind == LOCAL_ATTN:
        return {"kv": attn.kv_cache_shape(cfg, batch, max_len,
                                          cfg.local_window)}
    raise _unported(kind)


def block_apply(cfg: ModelConfig, kind: str, params, x, *, mode: str,
                state=None, pos=None, max_len: int = 0):
    """Returns (x, new_state)."""
    if kind == LOCAL_ATTN:
        h, kv = attn.apply_attention(
            cfg, params["attn"], apply_norm(cfg, params["ln1"], x),
            mode=mode, window=cfg.local_window,
            cache=None if state is None else state["kv"], pos=pos,
            max_len=max_len)
        x = x + h
        if "mlp" in params:
            x = x + apply_mlp(cfg, params["mlp"],
                              apply_norm(cfg, params["ln2"], x))
        return x, None if kv is None else {"kv": kv}
    if kind == RGLRU:
        h, st = ssm.apply_rglru(cfg, params["cell"],
                                apply_norm(cfg, params["ln1"], x), mode=mode,
                                state=None if state is None else state["cell"])
        x = x + h
        x = x + apply_mlp(cfg, params["mlp"],
                          apply_norm(cfg, params["ln2"], x))
        return x, None if st is None else {"cell": st}
    if kind not in (MLSTM, SLSTM):
        raise _unported(kind)
    fn = ssm.apply_mlstm if kind == MLSTM else ssm.apply_slstm
    h, st = fn(cfg, params["cell"], apply_norm(cfg, params["ln"], x),
               mode=mode, state=None if state is None else state["cell"])
    return x + h, None if st is None else {"cell": st}


def layers_apply(cfg: ModelConfig, blocks, x, *, mode: str, states=None,
                 pos=None, max_len: int = 0):
    """All layers in order (the reference's segments_apply).  Returns
    (x, new_states) with new_states None in train mode."""
    new_states = []
    for li, kind in enumerate(layer_kinds(cfg)):
        # a named range per block kind, for profile_serve's breakdown
        with torch.profiler.record_function(f"block:{kind}"):
            x, ns = block_apply(cfg, kind, blocks[li], x, mode=mode,
                                state=None if states is None else states[li],
                                pos=pos, max_len=max_len)
        new_states.append(ns)
    return x, (new_states if mode != "train" else None)


# ---------------------------------------------------------------------------
# Decoder-only LM
# ---------------------------------------------------------------------------

def build_lm(cfg: ModelConfig):
    check_ported(cfg)

    def init_params(gen: torch.Generator):
        return {
            "embed": embed_init(cfg, gen),
            "blocks": [block_init(cfg, kind, gen)
                       for kind in layer_kinds(cfg)],
            "ln_f": norm_init(cfg, gen.device),
        }

    def _backbone(params, x, *, mode, states=None, pos=None, max_len=0):
        x, new_states = layers_apply(cfg, params["blocks"], x, mode=mode,
                                     states=states, pos=pos, max_len=max_len)
        return apply_norm(cfg, params["ln_f"], x), new_states

    def prefill(params, batch, max_len: int = 0):
        """max_len sizes the attention caches (recurrent blocks ignore
        it)."""
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        x, states = _backbone(params, x, mode="prefill", max_len=max_len)
        logits = unembed(cfg, params["embed"], x[:, -1:])
        return logits[:, 0], states

    def decode_step(params, states, tokens, pos=None):
        """tokens (B,) int; pos: the tokens' position (an int or a 0-d
        tensor), which attention reads and the recurrent blocks ignore."""
        x = embed_tokens(cfg, params["embed"], tokens[:, None])
        x, states = _backbone(params, x, mode="decode", states=states,
                              pos=pos)
        logits = unembed(cfg, params["embed"], x)
        return logits[:, 0], states

    def decode_state_shape(batch: int, max_len: int = 0):
        return [block_state_shape(cfg, kind, batch, max_len)
                for kind in layer_kinds(cfg)]

    return dict(config=cfg, init_params=init_params, prefill=prefill,
                decode_step=decode_step,
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


def tree_map(fn, tree):
    """fn applied to every leaf of nested dicts, lists and tuples (the
    port's parameters and decode states)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _unstack(cfg: ModelConfig, segs, fn):
    """The reference's ((pattern position -> stacked leaf) per segment)
    as one entry per layer, each leaf passed through fn."""
    out = []
    for si, (pattern, repeats) in enumerate(cfg.layout):
        for r in range(repeats):
            for bi in range(len(pattern)):
                out.append(tree_map(lambda a: fn(np.asarray(a)[r]),
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


def params_from_jax(cfg: ModelConfig, params_np, device="cpu"):
    """The reference's ``init_params`` pytree (leaves as numpy arrays) as
    the port's parameters on `device`."""
    def conv(a):
        return tensor_from_numpy(a, device)
    return {"embed": tree_map(conv, params_np["embed"]),
            "blocks": _unstack(cfg, params_np["blocks"], conv),
            "ln_f": tree_map(conv, params_np["ln_f"])}


def state_from_jax(cfg: ModelConfig, states_np, device="cpu"):
    """The reference's decode state (segments of stacked leaves, numpy) as
    the port's per-layer states on `device`."""
    return _unstack(cfg, states_np, lambda a: tensor_from_numpy(a, device))


def state_to_jax(cfg: ModelConfig, states):
    """The port's per-layer states as the reference's decode-state pytree
    of numpy arrays (tuples of segments of stacked leaves)."""
    return _stack(cfg, [tree_map(tensor_to_numpy, st) for st in states])
