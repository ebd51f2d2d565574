"""The port's recurrentgemma model against the reference.

Most tests run ``reduced_config("recurrentgemma_9b")`` (d_model 64, 4
heads with one KV head of 16, d_ff 128, local window 32, float32) with
``lru_width=64`` on both sides and 5 layers, so the 2-layer remainder
segment of the 38 = 12 * 3 + 2 layout runs (layout (R, R, L) x 1 +
(R, R)); the reference's reduced config keeps the full model's
``lru_width`` 4096 (two (4096, 4096) float32 gate matrices per RG-LRU
block), which one whole-model test runs verbatim.  Weights are the
reference's ``init_params(PRNGKey(0))`` carried across by
``params_from_jax``.

Per layer: ``rope_angles``/``apply_rope``, ``apply_mlp`` for every MLP
kind, ``apply_rglru`` and ``apply_attention`` (window 0 and 32, prompt 8
and 48: the ring wraps with a non-zero roll at 48) in train, prefill and
decode, and ``mha``'s two q-chunked branches at S = 4608.  Whole model:
prefill logits and every decode-state leaf (the ring caches' int32
``pos`` included) at prompt 8 and 48, 4 greedy decode steps with equal
tokens, ``state_to_jax`` round trips, and ``ServeLoop`` generate and
resume after ``fail_server(0)`` against the reference's greedy tokens.

Tolerances (float32 on both sides, sums in another order): per block
atol 5e-5 / rtol 5e-4, as ``tests/test_kernels.py``; whole model rtol
1e-3 and atol 1e-3 of the leaf's largest magnitude (at least 1), as
``tests/test_torch_xlstm.py``, because each random-weight layer
amplifies a difference in its input."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced
from repro.models import attention as RA
from repro.models import build_model as ref_build
from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch.configs import reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import (layer_kinds, params_from_jax,
                                            state_from_jax, state_to_jax)
from repro_torch.serving import LarkSessionStore, ServeLoop

torch.set_num_threads(1)

ARCH = "recurrentgemma_9b"
MAX_LEN = 64


def _configs(**kw):
    return ref_reduced(ARCH).replace(**kw), reduced_config(ARCH).replace(**kw)


def _reference(rcfg, tcfg):
    ref = ref_build(rcfg)
    pj = ref["init_params"](jax.random.PRNGKey(0))
    ref = dict(ref, prefill=jax.jit(ref["prefill"], static_argnames="max_len"),
               decode_step=jax.jit(ref["decode_step"]))
    return ref, pj, build_model(tcfg), params_from_jax(
        tcfg, jax.tree.map(np.asarray, pj))


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = _configs(lru_width=64, num_layers=5)
    assert repr(rcfg) == repr(tcfg)
    return (rcfg,) + _reference(rcfg, tcfg)


def _torch(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=5e-5, rtol=5e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _close_deep(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-3 * scale)


def _layer_params(cfg, pj, li):
    """Layer li's reference parameters, sliced out of its segment stack."""
    for si, (pattern, repeats) in enumerate(cfg.layout):
        n = len(pattern) * repeats
        if li < n:
            return jax.tree.map(lambda a: a[li // len(pattern)],
                                pj["blocks"][si][li % len(pattern)])
        li -= n
    raise IndexError(li)


def test_layout_has_the_remainder_segment(models):
    cfg, _, pj, _, pt = models
    assert cfg.layout == ((("rglru", "rglru", "local"), 1),
                          (("rglru", "rglru"), 1))
    assert layer_kinds(cfg) == ["rglru", "rglru", "local", "rglru", "rglru"]
    for li in range(cfg.num_layers):
        want = jax.tree.leaves(_layer_params(cfg, pj, li))
        got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                           pt["blocks"][li]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, np.asarray(w))


def test_rope_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 48, 4, 16)) \
        .astype(np.float32)
    for pos in (np.arange(48), np.array([1234])):
        cj, sj = RL.rope_angles(jnp.asarray(pos), 16, 10_000.0)
        ct, st = TL.rope_angles(torch.from_numpy(pos), 16, 10_000.0)
        _close(ct, cj)
        _close(st, sj)
        n = len(pos)
        _close(TL.apply_rope(torch.from_numpy(x[:, :n]), ct[None], st[None]),
               RL.apply_rope(jnp.asarray(x[:, :n]), cj[None], sj[None]))


@pytest.mark.parametrize("kind", ["swiglu", "gelu_glu", "relu2", "gelu"])
@pytest.mark.parametrize("S", [1, 8])
def test_mlp_matches_reference(kind, S):
    """Every MLP kind, over a decode step's single token and a prompt's
    (the MLP does not depend on the mode)."""
    rcfg, tcfg = _configs(mlp=kind)
    pj = RL.mlp_init(rcfg, jax.random.PRNGKey(3))
    pt = {k: _torch(v) for k, v in pj.items()}
    x = np.random.default_rng(S).standard_normal((2, S, rcfg.d_model)) \
        .astype(np.float32)
    _close(TL.apply_mlp(tcfg, pt, torch.from_numpy(x)),
           RL.apply_mlp(rcfg, pj, jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_block_matches_reference(models, mode):
    cfg, _, pj, _, pt = models
    x = np.random.default_rng(1).standard_normal((2, 41, cfg.d_model)) \
        .astype(np.float32)
    rp = _layer_params(cfg, pj, 3)["cell"]
    tp = pt["blocks"][3]["cell"]
    if mode != "decode":
        want, wst = RS.apply_rglru(cfg, rp, jnp.asarray(x), mode=mode)
        got, gst = TS.apply_rglru(cfg, tp, torch.from_numpy(x), mode=mode)
    else:
        _, st = RS.apply_rglru(cfg, rp, jnp.asarray(x[:, :40]),
                               mode="prefill")
        want, wst = RS.apply_rglru(cfg, rp, jnp.asarray(x[:, 40:]),
                                   mode="decode", state=st)
        # the port decodes from the reference's own state
        got, gst = TS.apply_rglru(cfg, tp, torch.from_numpy(x[:, 40:]),
                                  mode="decode",
                                  state={k: _torch(v) for k, v in st.items()})
    _close(got, want)
    if mode == "train":
        assert wst is None and gst is None
        return
    assert set(gst) == set(wst)
    for name in wst:
        assert gst[name].dtype == torch.float32
        _close(gst[name], wst[name])


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("prompt", [8, 48])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attention_block_matches_reference(models, window, prompt, mode):
    """The local-attention layer's weights with the full cache (window 0)
    and the ring (window 32; at prompt 48 the ring wraps, rolled by 16)."""
    cfg, _, pj, _, pt = models
    x = np.random.default_rng(prompt + window).standard_normal(
        (2, prompt + 1, cfg.d_model)).astype(np.float32)
    rp = _layer_params(cfg, pj, 2)["attn"]
    tp = pt["blocks"][2]["attn"]
    kw = dict(window=window, max_len=MAX_LEN)
    if mode != "decode":
        want, wc = RA.apply_attention(cfg, rp, jnp.asarray(x[:, :prompt]),
                                      mode=mode, **kw)
        got, gc = TA.apply_attention(cfg, tp, torch.from_numpy(x[:, :prompt]),
                                     mode=mode, **kw)
    else:
        _, cache = RA.apply_attention(cfg, rp, jnp.asarray(x[:, :prompt]),
                                      mode="prefill", **kw)
        want, wc = RA.apply_attention(cfg, rp, jnp.asarray(x[:, prompt:]),
                                      mode="decode", cache=cache,
                                      pos=jnp.int32(prompt), **kw)
        got, gc = TA.apply_attention(
            cfg, tp, torch.from_numpy(x[:, prompt:]), mode="decode",
            cache={k: _torch(v) for k, v in cache.items()}, pos=prompt, **kw)
    _close(got, want)
    if mode == "train":
        assert wc is None and gc is None
        return
    assert set(gc) == set(wc)
    assert np.array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    assert gc["pos"].dtype == torch.int32
    for name in ("k", "v"):
        _close(gc[name], wc[name])


@pytest.mark.parametrize("window", [0, 32], ids=["full", "local"])
def test_mha_q_chunked_branches_match_reference(window):
    """S = 4608: Sq * Sk > 4096^2 and Sq % 512 == 0, so mha scans 512-row
    q chunks: each over the trailing window + 512 keys (window 32) or over
    all keys (window 0)."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((1, 4608, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4608, 1, 16)).astype(np.float32)
            for _ in range(2))
    want = RA.mha(*(jnp.asarray(a) for a in (q, k, v)), window=window)
    got = TA.mha(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    _close(got, want)


def _run_both(models, prompt, steps=4):
    cfg, ref, pj, port, pt = models
    tok = np.random.default_rng(prompt).integers(
        0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    lj, sj = ref["prefill"](pj, {"tokens": jnp.asarray(tok)},
                            max_len=MAX_LEN)
    lt, st = port["prefill"](pt, {"tokens": torch.from_numpy(tok)}, MAX_LEN)
    out = [(lt, lj, st, sj)]
    cur = jnp.argmax(lj, -1).astype(jnp.int32)
    curt = lt.argmax(-1).to(torch.int32)
    assert np.array_equal(np.asarray(cur), curt.numpy())
    for i in range(steps):
        lj, sj = ref["decode_step"](pj, sj, cur, jnp.int32(prompt + i))
        lt, st = port["decode_step"](pt, st, curt, prompt + i)
        out.append((lt, lj, st, sj))
        cur = jnp.argmax(lj, -1).astype(jnp.int32)
        curt = lt.argmax(-1).to(torch.int32)
        assert np.array_equal(np.asarray(cur), curt.numpy())
    return out


def _states_close(cfg, st, sj):
    want = jax.tree.map(np.asarray, sj)
    got = state_to_jax(cfg, st)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.int32:
            assert np.array_equal(g, w)           # the ring's positions
        else:
            _close_deep(g, w)
    # the converters invert each other on the reference's own state
    back = state_to_jax(cfg, state_from_jax(cfg, want))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("prompt", [8, 48])
def test_model_prefill_and_decode_match_reference(models, prompt):
    cfg = models[0]
    steps = _run_both(models, prompt)
    for lt, lj, st, sj in (steps[0], steps[-1]):
        _close_deep(lt, lj)
        _states_close(cfg, st, sj)
    for lt, lj, _, _ in steps[1:-1]:
        _close_deep(lt, lj)


def _zeros(spec):
    """Zero tensors for a {leaf: (shape, dtype)} spec."""
    return {k: _zeros(v) if isinstance(v, dict) else
            torch.zeros(v[0], dtype=v[1]) for k, v in spec.items()}


def test_decode_state_shape_matches_reference(models):
    cfg, ref, _, port, _ = models
    want = jax.tree.leaves(ref["decode_state_shape"](3, MAX_LEN))
    got = jax.tree.leaves(state_to_jax(cfg, [
        _zeros(st) for st in port["decode_state_shape"](3, MAX_LEN)]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_verbatim_reduced_config_matches_reference():
    """The reference's reduced config as it is (3 layers, lru_width
    4096): prefill logits and state at a 48-token prompt, 2 decode
    steps."""
    rcfg, tcfg = _configs()
    assert tcfg.lru_width == 4096 and tcfg.num_layers == 3
    steps = _run_both((rcfg,) + _reference(rcfg, tcfg), 48, steps=2)
    for lt, lj, st, sj in steps:
        _close_deep(lt, lj)
    _states_close(tcfg, steps[-1][2], steps[-1][3])


def test_serve_generate_and_resume_match_reference(models):
    """ServeLoop's greedy tokens equal the reference model's (prefill at
    max_len, decode at each position), and a session resumed after
    fail_server(0) equals the uninterrupted run."""
    cfg, ref, pj, _, pt = models
    tok = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)
    logits, state = ref["prefill"](pj, {"tokens": jnp.asarray(tok)},
                                   max_len=MAX_LEN)
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    want = []
    for i in range(12):
        logits, state = ref["decode_step"](pj, state, cur, jnp.int32(48 + i))
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(cur))
    want = np.stack(want, 1)
    sess = LarkSessionStore(num_nodes=4, rf=2)
    loop = ServeLoop(cfg, pt, max_len=MAX_LEN, session_store=sess,
                     checkpoint_every=4, device="cpu")
    got = loop.generate({"tokens": tok}, steps=8, session_id="s")
    np.testing.assert_array_equal(got, want[:, :8])
    sess.fail_server(0)
    resumed = loop.resume("s", steps=4)
    np.testing.assert_array_equal(resumed, want)
