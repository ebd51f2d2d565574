"""Deterministic synthetic data pipeline.

Tokens are a cheap stateless hash of (seed, step, row, position) so any
worker can regenerate any shard after elastic remapping or restart — the
data pipeline itself needs no checkpoint beyond the step counter (this is
the property real deterministic loaders provide and what the LARK-replicated
checkpoint relies on for exactly-once semantics).

The stream embeds a learnable structure (token t+1 depends on t) so smoke
training runs show decreasing loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _hash2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = (a.astype(np.uint64) << np.uint64(32)) ^ b.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclass
class SyntheticLMData:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    # markov-ish structure: next token = (prev * A + noise) % V
    structure: int = 31

    def batch_at(self, step: int, host_id: int = 0, num_hosts: int = 1) -> Dict:
        rows = self.batch // num_hosts
        row0 = host_id * rows
        ridx = np.arange(row0, row0 + rows, dtype=np.uint64)[:, None]
        base = _hash2(np.uint64(self.seed * 1_000_003 + step), ridx)
        noise = _hash2(base, np.arange(self.seq + 1, dtype=np.uint64)[None, :])
        v = self.cfg.vocab_size
        toks = np.empty((rows, self.seq + 1), dtype=np.int64)
        toks[:, 0] = noise[:, 0] % v
        for t in range(1, self.seq + 1):
            toks[:, t] = (toks[:, t - 1] * self.structure
                          + (noise[:, t] % 17)) % v
        out: Dict = {}
        if self.cfg.is_encoder_decoder:
            rng = np.random.default_rng(self.seed * 7919 + step)
            out["audio_embeds"] = rng.standard_normal(
                (rows, self.cfg.enc_seq, self.cfg.d_model)).astype(np.float32)
            out["tokens"] = toks[:, :-1].astype(np.int32)
        elif self.cfg.embeds_input:
            rng = np.random.default_rng(self.seed * 7919 + step)
            out["embeds"] = rng.standard_normal(
                (rows, self.seq, self.cfg.d_model)).astype(np.float32)
            if self.cfg.position_inputs:
                pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                                      (rows, 3, self.seq))
                out["positions"] = np.ascontiguousarray(pos)
        else:
            out["tokens"] = toks[:, :-1].astype(np.int32)
        out["labels"] = toks[:, 1:].astype(np.int32)
        return out

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
