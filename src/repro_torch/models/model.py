"""Public model facade (port of ``repro/models/model.py``):
``build_model(cfg)`` and concrete batches for smoke runs.

``batch_specs`` gives each input of a shape cell as (shape, dtype name)
and ``make_batch`` fills them from a numpy generator, so the same seed
gives the same batch on both sides; the result is a dict of tensors on
the requested device.  Only token inputs are ported: encoder-decoder and
embeds-input configurations raise ``NotImplementedError`` until the
slices that port their models.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from .transformer import UNPORTED, build_lm, tensor_from_numpy

build_model = build_lm


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    """{name: (shape, dtype name)} of the batch argument of prefill."""
    for name, on in (("encoder-decoder", cfg.is_encoder_decoder),
                     ("embeds-input", cfg.embeds_input)):
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {name!r} inputs are not ported yet; see "
                f"{UNPORTED.get(name, 'ROADMAP Queue 1')}")
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S), "int32")}
    if shape.kind == "train":
        specs["labels"] = ((B, S), "int32")
    return specs


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               rng: np.random.Generator, device="cpu"):
    """Concrete random batch (smoke tests; small shapes only)."""
    return {name: tensor_from_numpy(
                rng.integers(0, cfg.vocab_size, shp).astype(np.int32),
                device)
            for name, (shp, _) in batch_specs(cfg, shape).items()}
