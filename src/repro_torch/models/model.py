"""Public model facade (port of ``repro/models/model.py``):
``build_model(cfg)`` and concrete batches for smoke runs.

``batch_specs`` gives each input of a shape cell as (shape, dtype name)
and ``make_batch`` fills them from a numpy generator in the reference's
order, so the same seed gives the same batch on both sides: token ids
(and labels) drawn from the vocabulary, embeddings (whisper's stub
``audio_embeds``, qwen2-vl's ``embeds``) standard normal, and qwen2-vl's
(t, h, w) M-RoPE ``positions`` an arange on all three rows.  The result
is a dict of tensors on the requested device.  ``batch_prefix`` and
``decode_input`` cut a batch into a prompt and the inputs of the decode
steps after it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from .layers import DTYPES
from .transformer import build_lm, tensor_from_numpy

build_model = build_lm


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    """{name: (shape, dtype name)} of the batch argument of prefill."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    specs = {}
    if cfg.is_encoder_decoder:
        specs["audio_embeds"] = ((B, cfg.enc_seq, d), cfg.act_dtype)
        specs["tokens"] = ((B, S), "int32")
    elif cfg.embeds_input:
        specs["embeds"] = ((B, S, d), cfg.act_dtype)
        if cfg.position_inputs:
            specs["positions"] = ((B, 3, S), "int32")
    else:
        specs["tokens"] = ((B, S), "int32")
    if shape.kind == "train":
        specs["labels"] = ((B, S), "int32")
    return specs


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               rng: np.random.Generator, device="cpu"):
    """Concrete random batch (smoke tests; small shapes only).  Embeddings
    are drawn in float64, rounded to float32 and then cast to the
    activation dtype."""
    out = {}
    for name, (shp, dt) in batch_specs(cfg, shape).items():
        if dt == "int32" and name == "positions":
            a = np.broadcast_to(np.arange(shp[-1], dtype=np.int32), shp)
        elif dt == "int32":
            a = rng.integers(0, cfg.vocab_size, shp).astype(np.int32)
        else:
            a = rng.standard_normal(shp).astype(np.float32)
        out[name] = tensor_from_numpy(a, device).to(
            torch.int32 if dt == "int32" else DTYPES[dt])
    return out


def batch_prefix(batch, n: int):
    """The batch's first n positions: tokens, embeddings and (t, h, w) ids
    cut along the sequence; whisper's stub frames kept whole."""
    return {k: v[:, :, :n] if k == "positions" else
            v if k == "audio_embeds" else v[:, :n] for k, v in batch.items()}


def decode_input(batch, i: int):
    """Position i's decode input and keywords for ``decode_step``: the
    token, or for an embeds-input model the embedding (B, d) and its
    M-RoPE ids (B, 3, 1)."""
    if "embeds" in batch:
        kw = {}
        if "positions" in batch:
            kw["positions"] = batch["positions"][:, :, i:i + 1]
        return batch["embeds"][:, i], kw
    return batch["tokens"][:, i], {}
