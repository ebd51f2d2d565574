"""The port's encoder-decoder (whisper) against the reference, on
``reduced_config("whisper_small")`` (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, 16 stub frames, LayerNorm, GELU MLP, no RoPE,
float32) with weights from the reference's ``init_params(PRNGKey(0))``.

The encoder's output (sinusoidal positions, non-causal attention, the
final norm) against the reference's stack applied the same way; every
leaf of both stacks across ``params_from_jax`` bit for bit; a decoder
block with cross-attention in train, prefill and decode (the cross
keys and values ``ck``/``cv`` computed once at prefill and carried);
whole model: prefill logits, every decode-state leaf (``ck``/``cv``
among them), 4 greedy decode steps; ``ServeLoop`` generate and resume
after ``fail_server(0)`` against the reference's greedy tokens.
Tolerances: ``tests/_torch_lm.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCH = "whisper_small"
MAX_LEN = 32


@pytest.fixture(scope="module")
def models():
    return lm.models(ARCH)


def _audio(cfg, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _ref_encode(cfg, pj, audio):
    enc_cfg = cfg.replace(num_layers=cfg.enc_layers, is_encoder_decoder=False)
    x = jnp.asarray(audio)
    x = x + RL.sinusoidal_positions(jnp.arange(x.shape[1]), cfg.d_model)[None]
    x, _, _ = RT.segments_apply(enc_cfg, pj["encoder"], x, mode="train",
                                causal=False)
    return RL.apply_norm(cfg, pj["enc_ln"], x)


def test_layout_and_leaves_cross_bit_for_bit(models):
    cfg, _, pj, _, pt = models
    assert set(pt) == {"embed", "encoder", "enc_ln", "decoder", "ln_f"}
    enc_cfg = TT.encoder_config(cfg)
    assert enc_cfg.num_layers == 2 and not enc_cfg.is_encoder_decoder
    lm.params_cross(models, (("encoder", enc_cfg), ("decoder", None)))
    assert "xattn" in pt["decoder"][0] and "xattn" not in pt["encoder"][0]


def test_encoder_output_matches_reference(models):
    cfg, _, pj, port, pt = models
    audio = _audio(cfg)
    lm.close(port["encode"](pt, torch.from_numpy(audio)),
             _ref_encode(cfg, pj, audio))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_block_matches_reference(models, mode):
    cfg, _, pj, port, pt = models
    rp = lm.layer_params(cfg, pj["decoder"], 1)
    tp = pt["decoder"][1]
    audio = _audio(cfg)
    enc_j = _ref_encode(cfg, pj, audio)
    enc_t = port["encode"](pt, torch.from_numpy(audio))
    x = np.random.default_rng(6).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    kw = dict(mode=mode, max_len=MAX_LEN)
    if mode != "decode":
        want, wst, _ = RT.block_apply(cfg, "attn", rp, jnp.asarray(x[:, :8]),
                                      enc_out=enc_j, **kw)
        got, gst = TT.block_apply(cfg, "attn", tp, torch.from_numpy(x[:, :8]),
                                  enc_out=enc_t, **kw)
    else:
        _, st, _ = RT.block_apply(cfg, "attn", rp, jnp.asarray(x[:, :8]),
                                  mode="prefill", max_len=MAX_LEN,
                                  enc_out=enc_j)
        want, wst, _ = RT.block_apply(cfg, "attn", rp, jnp.asarray(x[:, 8:]),
                                      state=st, pos=jnp.int32(8), **kw)
        got, gst = TT.block_apply(cfg, "attn", tp, torch.from_numpy(x[:, 8:]),
                                  state=lm.to_torch(st), pos=8, **kw)
    lm.close(got, want)
    if mode == "train":
        assert wst is None and gst is None
        return
    assert set(gst) == set(wst) == {"kv", "ck", "cv"}
    for name in ("ck", "cv"):
        assert tuple(gst[name].shape) == (2, cfg.enc_seq, cfg.num_kv_heads,
                                          cfg.head_dim)
        lm.close(gst[name], wst[name])
    for name in ("k", "v"):
        lm.close(gst["kv"][name], wst["kv"][name])


def test_model_matches_reference(models):
    out = lm.model_matches(models, lm.batch(models[0], 10), MAX_LEN)
    # the decode state carries the prefill's cross keys unchanged
    for li in range(2):
        assert torch.equal(out[-1][2][li]["ck"], out[0][2][li]["ck"])


def test_decode_state_shape_matches_reference(models):
    lm.decode_state_shape_matches(models)


def test_serve_generate_and_resume_match_reference(models):
    lm.serve_matches(models, lm.batch(models[0], 12), MAX_LEN)
