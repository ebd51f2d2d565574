"""The port's mixture-of-experts (``models/moe.py``) against the
reference, on ``reduced_config("mixtral_8x7b")`` and
``reduced_config("qwen3_moe_235b_a22b")`` (4 experts, top 2, capacity
factor 1.25, d_model 64, d_ff 128, float32; qwen3 with q/k RMS norm)
with weights from the reference's ``init_params(PRNGKey(0))``.

``apply_moe`` on inputs pulled toward one expert, so the capacity
C = ceil(S·K·1.25/E) drops slots (asserted): the routes (top-k experts
equal, weights and router probabilities close), the output and the aux
loss.  ``_slot_ranks`` equal to the reference's on its one-hot branch
and on its chunked branch above 8192 slots.  The MoE leaves come across
``params_from_jax`` bit for bit.  Whole models: prefill logits, every
decode-state leaf, 4 greedy decode steps (mixtral also in
``tests/test_torch_dense.py``, with its window), the ATTN block with
qk-norm in every mode, and ``ServeLoop`` generate and resume after
``fail_server(0)``.  Tolerances: ``tests/_torch_lm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = ["mixtral_8x7b", "qwen3_moe_235b_a22b"]
MAX_LEN = 64


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return lm.models(request.param)


def _skewed(cfg, router, S=64, seed=0):
    """x (2, S, d) pulled toward router column 0, so most tokens pick
    expert 0 and its capacity overflows."""
    rng = np.random.default_rng(seed)
    col = np.asarray(router)[:, 0]
    x = rng.standard_normal((2, S, cfg.d_model)) + \
        4.0 * col / np.linalg.norm(col)
    return x.astype(np.float32)


def test_apply_moe_drops_and_matches_reference(models):
    cfg, _, pj, _, pt = models
    rp = lm.layer_params(cfg, pj["blocks"], 0)["moe"]
    tp = pt["blocks"][0]["moe"]
    x = _skewed(cfg, rp["router"])
    # the routes: the reference's router, softmax and top_k
    probs_j = jax.nn.softmax(jnp.asarray(x) @ rp["router"], axis=-1)
    top_w_j, top_e_j = jax.lax.top_k(probs_j, cfg.moe.experts_per_token)
    top_w_j = top_w_j / jnp.sum(top_w_j, -1, keepdims=True)
    probs, top_w, top_e = TM.route(cfg, tp, torch.from_numpy(x))
    assert np.array_equal(top_e.numpy(), np.asarray(top_e_j))
    lm.close(top_w, top_w_j)
    lm.close(probs, probs_j)
    # the capacity drops slots: more than C pick expert 0 in each row
    C = TM.capacity(cfg, x.shape[1])
    ranks = TM._slot_ranks(top_e.reshape(2, -1), cfg.moe.num_experts)
    assert C == 40 and int((ranks >= C).sum()) > 0
    want, aux_j = RM.apply_moe(cfg, rp, jnp.asarray(x))
    got, aux = TM.apply_moe(cfg, tp, torch.from_numpy(x))
    assert aux.dtype == torch.float32 and aux.dim() == 0
    lm.close(got, want)
    lm.close(aux, aux_j)


@pytest.mark.parametrize("SK", [37, 8192, 2 * 8192 + 37],
                         ids=["one_hot", "one_chunk", "chunked"])
def test_slot_ranks_match_reference(SK):
    se = np.random.default_rng(SK).integers(0, 8, (3, SK)).astype(np.int32)
    want = np.asarray(RM._slot_ranks(jnp.asarray(se), 8))
    got = TM._slot_ranks(torch.from_numpy(se), 8)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_moe_leaves_cross_bit_for_bit(models):
    lm.params_cross(models)
    leaves = dict(lm.lm_leaves(models[4]["blocks"][0]["moe"]))
    assert leaves["['router']"].dtype == torch.float32
    assert tuple(leaves["['wi_gate']"].shape) == (4, 64, 128)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attn_block_matches_reference(mode):
    """qwen3-moe's ATTN block: q/k RMS norm, then the MoE."""
    cfg, _, pj, _, pt = lm.models("qwen3_moe_235b_a22b")
    assert cfg.qk_norm
    rp = lm.layer_params(cfg, pj["blocks"], 0)
    x = np.random.default_rng(3).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    kw = dict(mode=mode, max_len=MAX_LEN)
    if mode != "decode":
        want, _, _ = RT.block_apply(cfg, "attn", rp, jnp.asarray(x), **kw)
        got, _ = TT.block_apply(cfg, "attn", pt["blocks"][0],
                                torch.from_numpy(x), **kw)
    else:
        _, st, _ = RT.block_apply(cfg, "attn", rp, jnp.asarray(x[:, :12]),
                                  mode="prefill", max_len=MAX_LEN)
        want, wst, _ = RT.block_apply(cfg, "attn", rp,
                                      jnp.asarray(x[:, 12:]), state=st,
                                      pos=jnp.int32(12), **kw)
        got, gst = TT.block_apply(cfg, "attn", pt["blocks"][0],
                                  torch.from_numpy(x[:, 12:]),
                                  state=lm.to_torch(st), pos=12, **kw)
        for name in ("k", "v"):
            lm.close(gst["kv"][name], wst["kv"][name])
    lm.close(got, want)


def test_model_matches_reference(models):
    lm.model_matches(models, lm.batch(models[0], 24), MAX_LEN)


def test_decode_state_shape_matches_reference(models):
    lm.decode_state_shape_matches(models)


def test_serve_generate_and_resume_match_reference(models):
    lm.serve_matches(models, lm.batch(models[0], 40), MAX_LEN)
