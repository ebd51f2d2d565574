"""The port's global-attention (ATTN) models against the reference:
smollm-360m, internlm2-20b and nemotron-4-340b (squared-ReLU MLP) on
their reduced configs (d_model 64, 4 heads over 2 KV heads of 16, d_ff
128, float32), and mixtral's sliding window (``cfg.window`` 32 in the
reduced config, a ring cache) with weights from the reference's
``init_params(PRNGKey(0))`` carried across by ``params_from_jax``.

Per block: the ATTN block (attention and its MLP, or mixtral's MoE) in
train, prefill and decode, with the full cache and with the ring at
prompt 8 and at prompt 48, where it wraps with a non-zero roll.  Whole
model: prefill logits, every decode-state leaf (the int32 ``pos``
included), 4 greedy decode steps with equal tokens and a
``state_to_jax`` round trip, verbatim and at 3 layers; both of ``mha``'s
q-chunked branches inside a whole model at a 4608-token prompt (global
on smollm, local on mixtral, whose MoE there ranks 9216 slots in two
chunks); ``ServeLoop`` generate and resume after ``fail_server(0)``.

Last, ``chip_smoke.decode_parity``, the card's check that a decode at
position S-1 matches a prefill of S positions in bf16 within
``chip_smoke.DECODE_TOL`` of the largest logit, passes at the right
position and fails one position off, on every family it runs.
Tolerances: ``tests/_torch_lm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro.models import transformer as RT
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

DENSE = ["smollm_360m", "internlm2_20b", "nemotron_4_340b"]
MAX_LEN = 64


@pytest.fixture(scope="module", params=DENSE + ["mixtral_8x7b"])
def models(request):
    return lm.models(request.param)


@pytest.mark.parametrize("prompt", [8, 48])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attn_block_matches_reference(models, mode, prompt):
    """The ATTN block at window cfg.window: 0 (the full cache) for the
    dense models, 32 for mixtral (the ring; it wraps at prompt 48)."""
    cfg, _, pj, _, pt = models
    rp = lm.layer_params(cfg, pj["blocks"], 0)
    tp = pt["blocks"][0]
    x = np.random.default_rng(prompt).standard_normal(
        (2, prompt + 1, cfg.d_model)).astype(np.float32)
    kw = dict(mode=mode, max_len=MAX_LEN)
    if mode != "decode":
        want, wst, _ = RT.block_apply(cfg, "attn", rp,
                                      jnp.asarray(x[:, :prompt]), **kw)
        got, gst = TT.block_apply(cfg, "attn", tp,
                                  torch.from_numpy(x[:, :prompt]), **kw)
    else:
        _, st, _ = RT.block_apply(cfg, "attn", rp, jnp.asarray(x[:, :prompt]),
                                  mode="prefill", max_len=MAX_LEN)
        want, wst, _ = RT.block_apply(cfg, "attn", rp,
                                      jnp.asarray(x[:, prompt:]), state=st,
                                      pos=jnp.int32(prompt), **kw)
        got, gst = TT.block_apply(cfg, "attn", tp,
                                  torch.from_numpy(x[:, prompt:]),
                                  state=lm.to_torch(st), pos=prompt, **kw)
    lm.close(got, want)
    if mode == "train":
        assert wst is None and gst is None
        return
    kv = gst["kv"]
    assert kv["pos"].dtype == torch.int32 and \
        np.array_equal(kv["pos"].numpy(), np.asarray(wst["kv"]["pos"]))
    assert kv["k"].shape[1] == (min(MAX_LEN, cfg.window) if cfg.window
                                else MAX_LEN)
    for name in ("k", "v"):
        lm.close(kv[name], wst["kv"][name])


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("layers", [None, 3], ids=["verbatim", "3layers"])
def test_model_matches_reference(arch, layers):
    m = lm.models(arch, **({} if layers is None else {"num_layers": layers}))
    lm.model_matches(m, lm.batch(m[0], 8), MAX_LEN)


@pytest.mark.parametrize("prompt", [8, 48])
def test_mixtral_ring_model_matches_reference(prompt):
    """Window 32: at prompt 48 the ring has wrapped before the first
    decode step, and each step overwrites the oldest slot."""
    m = lm.models("mixtral_8x7b")
    assert m[0].window == 32
    out = lm.model_matches(m, lm.batch(m[0], prompt), MAX_LEN)
    assert out[-1][2][0]["kv"]["k"].shape[1] == 32


@pytest.mark.parametrize("arch", ["smollm_360m", "mixtral_8x7b"],
                         ids=["global", "local"])
def test_q_chunked_branches_in_a_whole_model(arch):
    """A 4608-token prompt: Sq * Sk > 4096^2 and Sq % 512 == 0, so mha
    scans 512-row q chunks, over every key (smollm) or over each chunk's
    trailing window + 512 keys (mixtral, window 32)."""
    m = lm.models(arch)
    lm.model_matches(m, lm.batch(m[0], 4608, rows=1), 4610, steps=1)


def test_decode_state_shape_matches_reference(models):
    lm.decode_state_shape_matches(models)


def test_serve_generate_and_resume_match_reference(models):
    lm.serve_matches(models, lm.batch(models[0], 40), MAX_LEN)


FAMILIES = ["smollm_360m", "internlm2_20b", "minicpm3_4b", "qwen2_vl_2b",
            "whisper_small", "mixtral_8x7b", "qwen3_moe_235b_a22b",
            "nemotron_4_340b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_tolerance_rejects_a_decode_one_position_off(arch):
    """chip_smoke's check (b) on the reduced config in bf16 with seed-0
    weights, 2 prompts of 24 from SyntheticLMData: within DECODE_TOL at
    position S-1, beyond it at S-2 and at S."""
    import chip_smoke as cs
    cfg = reduced_config(arch).replace(act_dtype="bfloat16",
                                       param_dtype="bfloat16")
    model, params = cs.init_model(cfg, "cpu")
    b = cs.serve_batch(cfg, 2, 24, device="cpu")
    with torch.no_grad():
        pmodel = TT.build_lm(cs.no_drop(cfg))
        full, _ = pmodel["prefill"](params, b, 25)
        right, *off = cs.decode_parity(pmodel, params, b, full,
                                       offs=(0, -1, 1))
    assert right <= cs.DECODE_TOL
    assert min(off) > cs.DECODE_TOL, off
