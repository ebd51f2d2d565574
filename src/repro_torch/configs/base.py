"""Model/shape configuration dataclasses for the assigned architecture pool.

Every architecture in the pool is described by a single frozen ``ModelConfig``.
The model zoo (``repro.models``) consumes these configs; the launcher
(``repro.launch``) pairs them with ``ShapeConfig`` cells for the dry-run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# Block kinds understood by the model assembly.
ATTN = "attn"            # global self-attention (causal for decoder LMs)
LOCAL_ATTN = "local"     # sliding-window / local attention
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block
RGLRU = "rglru"          # RG-LRU recurrent block (Griffin/RecurrentGemma)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek/MiniCPM3 style)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # Block layout: a pattern of block kinds tiled to num_layers.  For plain
    # transformers this is ("attn",).  Hybrids use e.g. ("rglru","rglru","local").
    block_pattern: Tuple[str, ...] = (ATTN,)

    # Attention options.
    window: int = 0                  # sliding-window size (0 = full attention)
    local_window: int = 0            # window for LOCAL_ATTN blocks
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # (t,h,w) M-RoPE half-dim sections

    # Feed-forward.
    mlp: str = "swiglu"              # swiglu | relu2 | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # xLSTM / RG-LRU options.
    proj_factor: float = 2.0         # mLSTM inner projection factor
    conv_width: int = 4              # temporal conv width (ssm/hybrid blocks)
    lru_width: int = 0               # RG-LRU width (0 -> d_model)

    # Encoder-decoder (whisper).
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 0                 # stub-frontend sequence length (e.g. 1500 frames)

    # Modality frontend stub: inputs are precomputed embeddings, not token ids.
    embeds_input: bool = False
    # Provide (t, h, w) position ids alongside embeddings (qwen2-vl M-RoPE).
    position_inputs: bool = False

    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embeddings: bool = False   # gemma-style sqrt(d_model) input scaling
    act_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # Training policy (per-arch, chosen so the dry-run fits 16 GB/chip HBM).
    optimizer: str = "adamw"         # adamw | adafactor
    remat: bool = True
    remat_group: int = 1             # layers per remat block (smaller ckpt set)
    microbatches_train: int = 1      # gradient-accumulation microbatches
    # TP over the `model` mesh axis; False => fully-data-parallel (small archs
    # whose head/ff dims don't tile 16 ways: batch shards over data x model).
    tensor_parallel: bool = True
    # FSDP (ZeRO-3) over the `data` axis for params: required only for models
    # whose bf16 params exceed HBM at TP-16 (nemotron-340b, qwen3-235b); it
    # costs backward re-gathers (~2.5x flops observed), so default off.
    fsdp: bool = False

    # Which shape cells are supported (long_500k only for sub-quadratic archs).
    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    @property
    def layout(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Segments of (pattern, repeats) covering num_layers.

        The main body is a scan over ``repeats`` of the full pattern; a
        remainder (num_layers % len(pattern)) becomes a trailing segment so
        configs like recurrentgemma's 38 = 12*3 + 2 are representable.
        """
        p = len(self.block_pattern)
        segs = []
        if self.num_layers // p:
            segs.append((self.block_pattern, self.num_layers // p))
        if self.num_layers % p:
            segs.append((self.block_pattern[: self.num_layers % p], 1))
        return tuple(segs)

    def supports(self, shape: ShapeConfig) -> bool:
        return shape.name not in self.skip_shapes

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
