"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``; the audio frontend is a stub).

The batch supplies precomputed frame embeddings ``audio_embeds``
(B, enc_seq, d_model) beside the decoder's ``tokens``.  The encoder is
``enc_layers`` non-causal layers of the decoder's block pattern; every
decoder layer adds cross-attention to the encoder output, whose keys and
values are computed once at prefill and carried in the decode state
(``ck``/``cv``).  Both stacks add sinusoidal positions: the reference's
stated deviation from whisper's learned decoder positions, followed here.
``loss_fn`` is the decoder's cross entropy alone, as the reference's
(its metrics carry the aux loss; no MoE config is encoder-decoder).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tp
from .layers import (apply_norm, cross_entropy, dtype_of, embed_init,
                     embed_tokens, full_logits, last_logits, norm_init,
                     sinusoidal_positions, unembed)
from .transformer import (block_init, encoder_config, layer_kinds,
                          layers_apply, layers_state_shape)


def build_encdec(cfg: ModelConfig):
    enc_cfg = encoder_config(cfg)

    def init_params(gen: torch.Generator):
        dev = gen.device
        return {
            "embed": embed_init(cfg, gen),
            "encoder": [block_init(enc_cfg, kind, gen)
                        for kind in layer_kinds(enc_cfg)],
            "enc_ln": norm_init(cfg, dev),
            "decoder": [block_init(cfg, kind, gen, cross=True)
                        for kind in layer_kinds(cfg)],
            "ln_f": norm_init(cfg, dev),
        }

    def encode(params, audio_embeds):
        """The encoder output (B, enc_seq, d), normalized.  Under sequence
        parallelism the frames are this rank's block where the batch's
        spec shards them (the encoder then runs sequence-parallel and its
        output is gathered), else whole."""
        x = audio_embeds.to(dtype_of(cfg))
        ctx = tp.current()
        sp = ctx.sp if x.shape[1] < cfg.enc_seq else tp.ONE
        pos = torch.arange(x.shape[1], device=x.device) + \
            sp.rank * x.shape[1]
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)[None]
        with tp.use(dataclasses.replace(ctx, sp=sp)):
            x, _, _ = layers_apply(enc_cfg, params["encoder"], x,
                                   mode="train", causal=False)
        return tp.gather(apply_norm(cfg, params["enc_ln"], x), 1, sp,
                         scatter=True)

    def _embed_dec(params, tokens, offset=0):
        x = embed_tokens(cfg, params["embed"], tokens)
        S = tokens.shape[1]
        pos = torch.arange(S, device=x.device) + offset + \
            tp.current().sp.rank * S
        return x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)[None]

    def loss_fn(params, batch):
        enc = encode(params, batch["audio_embeds"])
        x = _embed_dec(params, batch["tokens"])
        x, _, aux = layers_apply(cfg, params["decoder"], x, mode="train",
                                 enc_out=enc)
        x = apply_norm(cfg, params["ln_f"], x)
        logits = unembed(cfg, params["embed"], x)
        loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                             vocab=cfg.vocab_size)
        return loss, {"loss": loss, "aux_loss": aux,
                      "tokens": torch.tensor(float(batch["labels"].numel()),
                                             device=loss.device)}

    def prefill(params, batch, max_len: int = 0):
        enc = encode(params, batch["audio_embeds"])
        x = _embed_dec(params, batch["tokens"])
        x, states, _ = layers_apply(cfg, params["decoder"], x,
                                    mode="prefill", enc_out=enc,
                                    max_len=max_len)
        x = apply_norm(cfg, params["ln_f"], x)
        return last_logits(cfg, params["embed"], x), states

    def decode_step(params, states, tokens, pos, positions=None):
        x = _embed_dec(params, tokens[:, None], offset=int(pos))
        x, states, _ = layers_apply(cfg, params["decoder"], x, mode="decode",
                                    states=states, pos=pos)
        x = apply_norm(cfg, params["ln_f"], x)
        logits = full_logits(cfg, unembed(cfg, params["embed"], x))
        return logits[:, 0], states

    def decode_state_shape(batch: int, max_len: int = 0):
        return layers_state_shape(cfg, batch, max_len, cross=True)

    return dict(config=cfg, init_params=init_params, encode=encode,
                loss_fn=loss_fn, prefill=prefill, decode_step=decode_step,
                decode_state_shape=decode_state_shape)
