"""The port's Multi-head Latent Attention (minicpm3) against the
reference, on ``reduced_config("minicpm3_4b")`` (d_model 64, 4 heads,
q rank 32, kv rank 16, qk 8 + 8 rope dims, v head dim 8, float32) with
weights from the reference's ``init_params(PRNGKey(0))``.

``_apply_mla`` (through ``apply_attention``) in train and prefill (K and
V expanded to every head, scale 1/sqrt(16), v's head dim 8 beside q's
16) and in decode (absorbed: scores against the latent cache through
``wk_b``, the output through ``wv_b``), with every latent-cache leaf
(``c_kv``, ``k_pe``, the int32 ``pos``); the MLA leaves across
``params_from_jax`` bit for bit; the latent cache's shapes; whole model:
prefill logits, every decode-state leaf and 4 greedy decode steps, at
the verbatim depth and at 3 layers; ``ServeLoop`` generate and resume
after ``fail_server(0)``.  Tolerances: ``tests/_torch_lm.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro.models import attention as RA
from repro_torch.models import attention as TA

torch.set_num_threads(1)

ARCH = "minicpm3_4b"
MAX_LEN = 32


@pytest.fixture(scope="module")
def models():
    return lm.models(ARCH)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_mla_matches_reference(models, mode):
    cfg, _, pj, _, pt = models
    rp = lm.layer_params(cfg, pj["blocks"], 0)["attn"]
    tp = pt["blocks"][0]["attn"]
    assert set(tp) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b",
                       "wv_b", "wo"}
    x = np.random.default_rng(4).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    kw = dict(mode=mode, max_len=MAX_LEN)
    if mode != "decode":
        want, wc = RA.apply_attention(cfg, rp, jnp.asarray(x[:, :20]), **kw)
        got, gc = TA.apply_attention(cfg, tp, torch.from_numpy(x[:, :20]),
                                     **kw)
    else:
        _, cache = RA.apply_attention(cfg, rp, jnp.asarray(x[:, :20]),
                                      mode="prefill", max_len=MAX_LEN)
        want, wc = RA.apply_attention(cfg, rp, jnp.asarray(x[:, 20:]),
                                      cache=cache, pos=jnp.int32(20), **kw)
        got, gc = TA.apply_attention(cfg, tp, torch.from_numpy(x[:, 20:]),
                                     cache=lm.to_torch(cache), pos=20, **kw)
    lm.close(got, want)
    if mode == "train":
        assert wc is None and gc is None
        return
    assert set(gc) == set(wc) == {"c_kv", "k_pe", "pos"}
    assert gc["pos"].dtype == torch.int32
    assert np.array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    for name in ("c_kv", "k_pe"):
        assert tuple(gc[name].shape) == wc[name].shape
        lm.close(gc[name], wc[name])


def test_latent_cache_shape(models):
    cfg = models[0]
    spec = TA.kv_cache_shape(cfg, 3, MAX_LEN)
    assert spec == {"c_kv": ((3, MAX_LEN, 16), torch.float32),
                    "k_pe": ((3, MAX_LEN, 8), torch.float32),
                    "pos": ((MAX_LEN,), torch.int32)}
    lm.decode_state_shape_matches(models)


def test_mla_leaves_cross_bit_for_bit(models):
    lm.params_cross(models)


@pytest.mark.parametrize("layers", [None, 3], ids=["verbatim", "3layers"])
def test_model_matches_reference(layers):
    m = lm.models(ARCH, **({} if layers is None else {"num_layers": layers}))
    lm.model_matches(m, lm.batch(m[0], 12), MAX_LEN)


def test_serve_generate_and_resume_match_reference(models):
    lm.serve_matches(models, lm.batch(models[0], 16), MAX_LEN)
