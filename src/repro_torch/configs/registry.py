"""Architecture registry: ``get_config(arch_id)`` / ``reduced_config(arch_id)``.

One module per assigned architecture lives alongside this file; each exposes
``CONFIG`` (the exact public configuration) and optionally ``REDUCED_OVERRIDES``
for the CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from .base import ModelConfig

ARCH_IDS = (
    "xlstm_350m",
    "mixtral_8x7b",
    "qwen3_moe_235b_a22b",
    "recurrentgemma_9b",
    "internlm2_20b",
    "smollm_360m",
    "minicpm3_4b",
    "nemotron_4_340b",
    "whisper_small",
    "qwen2_vl_2b",
)

# Canonical ids as listed in the assignment (dash form) -> module name.
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def normalize(arch: str) -> str:
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return arch


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"{__package__}.{normalize(arch)}")
    return mod.CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (small layers/width/experts)."""
    mod = importlib.import_module(f"{__package__}.{normalize(arch)}")
    cfg: ModelConfig = mod.CONFIG
    over: Dict = dict(getattr(mod, "REDUCED_OVERRIDES", {}))
    base = dict(
        num_layers=len(cfg.block_pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        act_dtype="float32",
        param_dtype="float32",
        microbatches_train=1,
        remat=False,
    )
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(cfg.moe, num_experts=4, experts_per_token=2)
    if cfg.mla is not None:
        base["mla"] = dataclasses.replace(
            cfg.mla, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8)
    if cfg.is_encoder_decoder:
        base["enc_layers"] = 2
        base["enc_seq"] = 16
    if cfg.window:
        base["window"] = 32
    if cfg.local_window:
        base["local_window"] = 32
    base.update(over)
    return cfg.replace(**base)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
