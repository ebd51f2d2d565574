"""The port's xLSTM model against the reference, on
``reduced_config("xlstm_350m")`` (8 layers: 7 mLSTM + 1 sLSTM, d_model
64, float32) with the reference's ``init_params(PRNGKey(0))`` carried
across by ``params_from_jax``.

Per block: ``apply_mlstm`` and ``apply_slstm`` in train, prefill and
decode modes.  Whole model: prefill logits and every decode-state leaf
at prompt 8 (one padded chunk) and 300 (two chunks of 256, the second
ragged), then 4 greedy decode steps with equal tokens.

Tolerances (float32 on both sides, sums in another order): per block
atol 5e-5 / rtol 5e-4 as ``tests/test_kernels.py`` (a block fed the
reference's own input agrees to ~2e-6).  Through all 8 layers the
differences grow: each layer of this random-weight model amplifies a
difference in its input 5-10x (measured at prompt 8: 1.6e-6 after the
first layer, 9e-4 after the eighth, on activations of magnitude ~4), so
the whole-model checks take rtol 1e-3 and an atol of 1e-3 times the
leaf's largest magnitude (at least 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get
from repro.configs import reduced_config as ref_reduced
from repro.data import SyntheticLMData as RefData
from repro.models import build_model as ref_build
from repro.models import make_batch as ref_make_batch
from repro.models import ssm as RS
from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model, make_batch, ssm as TS
from repro_torch.models.transformer import (layer_kinds, params_from_jax,
                                            state_from_jax, state_to_jax,
                                            tensor_from_numpy,
                                            tensor_to_numpy)

torch.set_num_threads(1)

ARCH = "xlstm_350m"


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = ref_reduced(ARCH), reduced_config(ARCH)
    assert repr(rcfg) == repr(tcfg)
    ref = ref_build(rcfg)
    pj = ref["init_params"](jax.random.PRNGKey(0))
    pnp = jax.tree.map(np.asarray, pj)
    # the whole-model reference runs jitted (as its ServeLoop runs it)
    ref = dict(ref, prefill=jax.jit(ref["prefill"], static_argnames="max_len"),
               decode_step=jax.jit(ref["decode_step"]))
    return rcfg, ref, pj, tcfg, build_model(tcfg), params_from_jax(tcfg, pnp)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    assert repr(get_config(arch)) == repr(ref_get(arch))
    assert repr(reduced_config(arch)) == repr(ref_reduced(arch))


@pytest.mark.parametrize("arch", ["xlstm_350m", "whisper_small",
                                  "qwen2_vl_2b"])
def test_synthetic_data_and_batches_match_reference(arch):
    cfg = reduced_config(arch)
    got = SyntheticLMData(cfg, 3, 17, seed=5).batch_at(2)
    want = RefData(ref_reduced(arch), 3, 17, seed=5).batch_at(2)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name])
    shape = ShapeConfig("tiny", seq_len=6, global_batch=2, kind="train")
    # whisper's stub frames and qwen2-vl's embeddings and (t, h, w) ids
    # come from the same numpy draws as the reference's, in its order
    # (equal values show it)
    got = make_batch(cfg, shape, np.random.default_rng(1))
    want = ref_make_batch(ref_reduced(arch), shape, np.random.default_rng(1))
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].numpy().dtype == w.dtype
        assert np.array_equal(got[name].numpy(), w)


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
    p = len(cfg.block_pattern)
    return jax.tree.map(lambda a: a[li // p], pj["blocks"][0][li % p])


def test_layers_unstack_in_pattern_order(models):
    cfg, _, pj, tcfg, _, pt = models
    assert layer_kinds(tcfg) == ["mlstm"] * 7 + ["slstm"]
    for li in range(cfg.num_layers):
        want = _layer_params(cfg, pj, li)
        got = pt["blocks"][li]
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            node = got
            for key in path:
                node = node[key.key]
            assert torch.equal(node, torch.from_numpy(np.array(leaf)))


@pytest.mark.parametrize("kind,li", [("mlstm", 2), ("slstm", 7)])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_block_matches_reference(models, kind, li, mode):
    cfg, _, pj, _, _, pt = models
    rng = np.random.default_rng(li)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    rfn, tfn = (RS.apply_mlstm, TS.apply_mlstm) if kind == "mlstm" else \
        (RS.apply_slstm, TS.apply_slstm)
    rp = _layer_params(cfg, pj, li)["cell"]
    want, wst = rfn(cfg, rp, jnp.asarray(x), mode=mode)
    got, gst = tfn(cfg, pt["blocks"][li]["cell"], torch.from_numpy(x),
                   mode=mode)
    _close(got, want)
    if mode == "train":
        assert wst is None and gst is None
    else:
        assert set(gst) == set(wst)
        for name in wst:
            _close(gst[name], wst[name])


@pytest.mark.parametrize("kind,li", [("mlstm", 0), ("slstm", 7)])
def test_block_decode_matches_reference(models, kind, li):
    cfg, _, pj, _, _, pt = models
    rng = np.random.default_rng(10 + li)
    x = rng.standard_normal((2, 41, cfg.d_model)).astype(np.float32)
    rfn, tfn = (RS.apply_mlstm, TS.apply_mlstm) if kind == "mlstm" else \
        (RS.apply_slstm, TS.apply_slstm)
    rp = _layer_params(cfg, pj, li)["cell"]
    _, wst = rfn(cfg, rp, jnp.asarray(x[:, :40]), mode="prefill")
    # the port decodes from the reference's own state
    st = {k: torch.from_numpy(np.array(v)) for k, v in wst.items()}
    want, wst = rfn(cfg, rp, jnp.asarray(x[:, 40:]), mode="decode", state=wst)
    got, gst = tfn(cfg, pt["blocks"][li]["cell"], torch.from_numpy(x[:, 40:]),
                   mode="decode", state=st)
    _close(got, want)
    for name in wst:
        _close(gst[name], wst[name])


@pytest.mark.parametrize("prompt", [8, 300])
def test_model_prefill_and_decode_match_reference(models, prompt):
    rcfg, ref, pj, tcfg, port, pt = models
    tok = np.random.default_rng(prompt).integers(
        0, rcfg.vocab_size, (2, prompt)).astype(np.int32)
    lj, sj = ref["prefill"](pj, {"tokens": jnp.asarray(tok)}, max_len=0)
    lt, st = port["prefill"](pt, {"tokens": torch.from_numpy(tok)}, 0)
    _close_deep(lt, lj)
    want = jax.tree.map(np.asarray, sj)
    got = state_to_jax(tcfg, st)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close_deep(g, w)
    # the converters invert each other on the reference's own state
    back = state_to_jax(tcfg, state_from_jax(tcfg, want))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(g, w)
    cur = jnp.argmax(lj, -1).astype(jnp.int32)
    curt = lt.argmax(-1).to(torch.int32)
    assert np.array_equal(np.asarray(cur), curt.numpy())
    for i in range(4):
        lj, sj = ref["decode_step"](pj, sj, cur, jnp.int32(prompt + i))
        lt, st = port["decode_step"](pt, st, curt, prompt + i)
        _close_deep(lt, lj)
        cur = jnp.argmax(lj, -1).astype(jnp.int32)
        curt = lt.argmax(-1).to(torch.int32)
        assert np.array_equal(np.asarray(cur), curt.numpy())
    for g, w in zip(jax.tree.leaves(state_to_jax(tcfg, st)),
                    jax.tree.leaves(jax.tree.map(np.asarray, sj))):
        _close_deep(g, w)


def test_decode_state_shape_matches_reference(models):
    rcfg, ref, _, tcfg, port, _ = models
    want = ref["decode_state_shape"](3, 16)
    got = port["decode_state_shape"](3, 16)
    leaves = []
    for st in got:
        leaves.append({"cell": {k: np.zeros(shape, dtype=np.float32)
                                for k, (shape, _) in st["cell"].items()}})
    stacked = state_to_jax(tcfg, [jax.tree.map(torch.from_numpy, s)
                                  for s in leaves])
    for g, w in zip(jax.tree.leaves(stacked), jax.tree.leaves(want)):
        assert g.shape == w.shape
    dtypes = {k: d for st in got for k, (_, d) in st["cell"].items()}
    assert dtypes["C"] == torch.float32 and dtypes["conv"] == torch.float32


def test_bfloat16_leaves_cross_bit_for_bit():
    """The full width's bf16 leaves (weights, conv states) cross between
    the reference's numpy arrays and tensors without a rounding."""
    want = np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal(
        (3, 5)), jnp.bfloat16))
    t = tensor_from_numpy(want)
    assert t.dtype == torch.bfloat16
    back = tensor_to_numpy(t)
    assert back.dtype == want.dtype and \
        np.array_equal(back.view(np.int16), want.view(np.int16))


def test_unported_configs_raise():
    """Nothing of the registry is left unported: only a block kind that
    no configuration names raises, as the reference's ValueError."""
    from repro_torch.configs import get_config
    cfg = get_config("smollm_360m").replace(block_pattern=("conv",),
                                            num_layers=1)
    gen = torch.Generator()
    gen.manual_seed(0)
    with pytest.raises(ValueError, match="conv"):
        build_model(cfg)["init_params"](gen)
    assert build_model(get_config("whisper_small"))["config"].name == \
        "whisper_small"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds(arch):
    """Every architecture of the registry builds in the port at its full
    config (entry points only: no weights are drawn here)."""
    model = build_model(get_config(arch))
    assert model["config"] is get_config(arch)
    assert {"init_params", "prefill", "decode_step",
            "decode_state_shape"} <= set(model)
    shapes = model["decode_state_shape"](1, 8)
    assert len(shapes) == get_config(arch).num_layers
