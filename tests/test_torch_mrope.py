"""qwen2-vl's M-RoPE and whisper's sinusoidal positions in the port
against the reference, and qwen2-vl (an embeds-input decoder) on
``reduced_config("qwen2_vl_2b")`` (d_model 64, 4 heads over 2 KV heads
of 16, M-RoPE sections (2, 3, 3), float32) with weights from the
reference's ``init_params(PRNGKey(0))``.

``mrope_angles`` at the reduced and the full sections on (t, h, w) ids
that differ by row; ``sinusoidal_positions`` over whisper's 1500
frames; attention with M-RoPE ids in train, prefill and decode, and
with the default ids; whole model: prefill over embeddings with
(t, h, w) ids, every decode-state leaf, and 4 ``decode_step`` calls
that each take the next embedding and its ids; and ``ServeLoop``, the
serve CLI and ``resume`` raising a ``ValueError`` before any decode
step (the reference's loop fails inside ``decode_step``).
Tolerances: ``tests/_torch_lm.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro.models import attention as RA
from repro.models import layers as RL
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.serving import LarkSessionStore, ServeLoop

torch.set_num_threads(1)

ARCH = "qwen2_vl_2b"
MAX_LEN = 32


@pytest.fixture(scope="module")
def models():
    return lm.models(ARCH)


def _thw(B, S, seed=0, start=0):
    """(t, h, w) ids: t a running index, h and w a patch grid's rows and
    columns, so the three rows differ."""
    rng = np.random.default_rng(seed)
    t = start + np.arange(S)
    h, w = rng.integers(0, 7, (2, B, S))
    return np.stack([np.broadcast_to(t, (B, S)), h, w], 1).astype(np.int32)


@pytest.mark.parametrize("dim,sections", [(16, (2, 3, 3)),
                                          (128, (16, 24, 24))])
def test_mrope_angles_match_reference(dim, sections):
    pos = _thw(2, 40)
    cj, sj = RL.mrope_angles(jnp.asarray(pos), dim, 1e6, sections)
    ct, st = TL.mrope_angles(torch.from_numpy(pos), dim, 1e6, sections)
    assert tuple(ct.shape) == (2, 40, dim // 2)
    lm.close(ct, cj)
    lm.close(st, sj)
    with pytest.raises(ValueError, match="sum"):
        TL.mrope_angles(torch.from_numpy(pos), dim + 2, 1e6, sections)


@pytest.mark.parametrize("dim", [64, 768])
def test_sinusoidal_positions_match_reference(dim):
    """Over whisper's 1500 frames.  XLA's float32 exp and torch's differ
    by one ulp on a few frequencies (neither is correctly rounded
    everywhere), and position p multiplies that into the angle p·f, whose
    float32 rounding it can then flip: so each element is held within
    two ulps of its angle, |p·f|·2^-22, plus the rounding of sin and cos,
    2^-22; the frequencies themselves within one ulp."""
    half = dim // 2
    fj = np.asarray(jnp.exp(-np.log(1e4) * jnp.arange(half, dtype=jnp.float32)
                            / (half - 1)))
    ft = torch.exp(-np.log(1e4) * torch.arange(half, dtype=torch.float32)
                   / (half - 1)).numpy()
    assert np.abs(fj.view(np.int32) - ft.view(np.int32)).max() <= 1
    pos = np.arange(1500)
    want = np.asarray(RL.sinusoidal_positions(jnp.asarray(pos), dim))
    got = TL.sinusoidal_positions(torch.from_numpy(pos), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1500, dim)
    ang = np.abs(pos[:, None] * np.concatenate([fj, fj]))
    assert (np.abs(got.numpy() - want) <= ang * 2.0 ** -22 + 2.0 ** -22).all()
    lm.close(got[:64], want[:64])


@pytest.mark.parametrize("ids", ["thw", "default"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attention_with_mrope_matches_reference(models, mode, ids):
    cfg, _, pj, _, pt = models
    rp = lm.layer_params(cfg, pj["blocks"], 0)["attn"]
    tp = pt["blocks"][0]["attn"]
    x = np.random.default_rng(7).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    pos = _thw(2, 13) if ids == "thw" else None

    def kw(sl, j):
        if pos is None:
            return {}
        p = pos[:, :, sl]
        return {"positions": jnp.asarray(p) if j else torch.from_numpy(p)}
    args = dict(mode=mode, max_len=MAX_LEN)
    if mode != "decode":
        want, wc = RA.apply_attention(cfg, rp, jnp.asarray(x[:, :12]),
                                      **args, **kw(slice(0, 12), True))
        got, gc = TA.apply_attention(cfg, tp, torch.from_numpy(x[:, :12]),
                                     **args, **kw(slice(0, 12), False))
    else:
        _, cache = RA.apply_attention(cfg, rp, jnp.asarray(x[:, :12]),
                                      mode="prefill", max_len=MAX_LEN,
                                      **kw(slice(0, 12), True))
        want, wc = RA.apply_attention(cfg, rp, jnp.asarray(x[:, 12:]),
                                      cache=cache, pos=jnp.int32(12), **args,
                                      **kw(slice(12, 13), True))
        got, gc = TA.apply_attention(cfg, tp, torch.from_numpy(x[:, 12:]),
                                     cache=lm.to_torch(cache), pos=12,
                                     **args, **kw(slice(12, 13), False))
    lm.close(got, want)
    if mode != "train":
        for name in ("k", "v"):
            lm.close(gc[name], wc[name])


def test_model_prefill_and_decode_step_match_reference(models):
    """Prefill over embeddings with (t, h, w) ids, then decode_step with
    the next embedding (B, d) and its ids (B, 3, 1), four times."""
    cfg = models[0]
    S, steps = 12, 4
    rng = np.random.default_rng(8)
    b = {"embeds": rng.standard_normal((2, S + steps, cfg.d_model))
         .astype(np.float32), "positions": _thw(2, S + steps)}
    prompt = {"embeds": b["embeds"][:, :S],
              "positions": b["positions"][:, :, :S]}
    inputs = [(b["embeds"][:, S + i], np.ascontiguousarray(
        b["positions"][:, :, S + i:S + i + 1])) for i in range(steps)]
    lm.model_matches(models, prompt, MAX_LEN, steps, inputs)


def test_model_with_make_batch_positions_matches_reference(models):
    """make_batch's inputs (ids an arange on all three rows) on both
    sides, then one decode step with the ids left to their default."""
    cfg, ref, pj, port, pt = models
    b = lm.batch(cfg, 12)
    assert set(b) == {"embeds", "positions"}
    out = lm.run_both(models, b, MAX_LEN, steps=0)
    lm.close_deep(out[0][0], out[0][1])
    e = np.random.default_rng(9).standard_normal((2, cfg.d_model)) \
        .astype(np.float32)
    lj, _ = ref["decode_step"](pj, out[0][3], jnp.asarray(e), jnp.int32(12))
    lt, _ = port["decode_step"](pt, out[0][2], torch.from_numpy(e), 12)
    lm.close_deep(lt, lj)


def test_decode_state_shape_matches_reference(models):
    lm.decode_state_shape_matches(models)


def test_serve_loop_raises_before_any_decode_step(models):
    cfg, _, _, _, pt = models
    sess = LarkSessionStore(num_nodes=4, rf=2)
    loop = ServeLoop(cfg, pt, max_len=MAX_LEN, session_store=sess,
                     device="cpu")
    calls = []
    step = loop.model["decode_step"]
    loop.model["decode_step"] = lambda *a, **k: calls.append(1) or \
        step(*a, **k)
    with pytest.raises(ValueError, match="embedding"):
        loop.generate(lm.batch(cfg, 12), steps=4, session_id="s")
    sess.save_session("s", [], np.zeros((2, 1), np.int32), 12)
    with pytest.raises(ValueError, match="embedding"):
        loop.resume("s", steps=4)
    assert calls == []


def test_serve_cli_raises_for_qwen2_vl():
    with pytest.raises(ValueError, match="qwen2_vl_2b"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--fail-server"])
