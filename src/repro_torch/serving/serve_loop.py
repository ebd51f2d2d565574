"""Batched serving driver (port of ``repro/serving/serve_loop.py``):
prefill, then greedy decode, with session checkpoints into the LARK
store every ``checkpoint_every`` tokens.

Runs on the card unless ``device="cpu"`` is passed; the parameters move
to the loop's device once, at construction.

Greedy serving feeds each step's argmax token back.  A decoder-only
model over embeddings (qwen2-vl) cannot take a token id: its
``decode_step`` wants the next input's embedding (B, d).  The reference's
loop hands it the ids anyway and fails inside ``decode_step`` with an
``IndexError``; this loop raises a ``ValueError`` naming the cause before
the first decode step.  Drive such a model through its ``decode_step``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.tree import map_leaves
from .kv_session import LarkSessionStore


class ServeLoop:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 session_store: Optional[LarkSessionStore] = None,
                 checkpoint_every: int = 8, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = map_leaves(lambda t: t.to(self.device), params)
        self.max_len = max_len
        self.sessions = session_store
        self.checkpoint_every = checkpoint_every

    def _check_decodes_tokens(self):
        if self.cfg.embeds_input and not self.cfg.is_encoder_decoder:
            raise ValueError(
                f"{self.cfg.name} takes input embeddings, not token ids: "
                "its decode_step needs the next input's embedding (B, "
                f"d_model={self.cfg.d_model}), which greedy decoding of "
                "argmax token ids cannot supply; call the model's "
                "decode_step with embeddings instead")

    def _to_device(self, batch: Dict):
        """A batch of numpy arrays or tensors on the loop's device."""
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def generate(self, batch: Dict, steps: int, session_id: str = "s0",
                 greedy: bool = True) -> np.ndarray:
        batch = self._to_device(batch)
        logits, state = self.model["prefill"](self.params, batch,
                                              max_len=self.max_len)
        prompt_len = (batch["tokens"].shape[1] if "tokens" in batch
                      else batch["embeds"].shape[1])
        self._check_decodes_tokens()
        toks: List[np.ndarray] = []
        cur = logits.argmax(-1).to(torch.int32)
        for i in range(steps):
            logits, state = self.model["decode_step"](self.params, state, cur,
                                                      prompt_len + i)
            cur = logits.argmax(-1).to(torch.int32)
            toks.append(cur.cpu().numpy())
            if self.sessions is not None and \
                    (i + 1) % self.checkpoint_every == 0:
                self.sessions.save_session(session_id, state,
                                           np.stack(toks, 1),
                                           prompt_len + i + 1)
        return np.stack(toks, axis=1)

    @torch.no_grad()
    def resume(self, session_id: str, steps: int) -> Optional[np.ndarray]:
        """Continue a session from its last committed decode state."""
        if self.sessions is None:
            return None
        self._check_decodes_tokens()
        ok, blob = self.sessions.load_session(session_id)
        if not ok or blob is None:
            return None
        state = map_leaves(lambda t: t.to(self.device), blob["state"])
        toks = [blob["tokens"][:, i] for i in range(blob["tokens"].shape[1])]
        cur = torch.from_numpy(np.asarray(toks[-1])).to(self.device)
        for i in range(steps):
            logits, state = self.model["decode_step"](self.params, state, cur,
                                                      blob["pos"] + i)
            cur = logits.argmax(-1).to(torch.int32)
            toks.append(cur.cpu().numpy())
        return np.stack(toks, axis=1)
