"""One ``make_train_step`` step of the port against the reference's
(``repro.training.make_train_step``) from the same weights and batch:
the metrics and every updated parameter, with 1 and 2 microbatches;
remat on and off giving equal gradients; sharding arguments that are not
NamedSharding trees refused; ``make_serve_steps``; and the loss falling on a tiny model
(``tests/test_models_smoke.py::test_loss_decreases_quickly_on_tiny_model``).

Tolerance: the whole-model one of ``tests/_torch_lm.py`` (rtol 1e-3,
atol 1e-3 of the leaf's largest magnitude) on the parameters, rtol 1e-4
on the metrics, float32 on both sides."""
import jax
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro.training import make_train_step as ref_make_train_step
from repro_torch import tree
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.training import (accumulate_grads, make_serve_steps,
                                  make_train_step)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,nmb", [("smollm_360m", 1),
                                      ("smollm_360m", 2),
                                      ("mixtral_8x7b", 2)])
def test_one_step_matches_reference(arch, nmb):
    rcfg, tcfg = lm.configs(arch, microbatches_train=nmb)
    r_init, r_step, _ = ref_make_train_step(rcfg, peak_lr=0.05)
    pj, sj = r_init(jax.random.PRNGKey(0))
    b = lm.train_batch(tcfg, rows=4)
    pj2, _, mj = jax.jit(r_step)(pj, sj, jax.tree.map(jax.numpy.asarray, b))
    init_fn, step_fn, opt = make_train_step(tcfg, peak_lr=0.05)
    pt = params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    pt2, st2, mt = step_fn(pt, opt.init(pt), lm.to_torch(b))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=1e-4)
    assert int(st2["count"]) == 1
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, pj2))
    for (path, g), w in zip(tree.leaves_with_paths(pt2), tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        lm.close_deep(g, w)
    # the step moved the parameters
    assert any(not torch.equal(a, b) for a, b in
               zip(tree.leaves(pt2), tree.leaves(pt)))


def test_remat_on_and_off_give_equal_gradients():
    cfg = reduced_config("smollm_360m").replace(num_layers=4)
    b = lm.to_torch(lm.train_batch(cfg))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg)["init_params"](gen)
    out = [accumulate_grads(build_model(c)["loss_fn"], params, b)
           for c in (cfg, cfg.replace(remat=True),
                     cfg.replace(remat=True, remat_group=2))]
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for g, h in zip(tree.leaves(grads), tree.leaves(out[0][1])):
            assert torch.equal(g, h)


def test_sharding_arguments_are_refused_on_one_card():
    """Sharding arguments must be launch.shardings.NamedSharding trees
    (a mesh's step: tests/test_torch_train_dp.py runs it on a one-rank
    mesh and on two ranks)."""
    cfg = reduced_config("smollm_360m")
    with pytest.raises(TypeError, match="NamedSharding"):
        make_train_step(cfg, grad_shardings={"w": object()})


def test_serve_steps_wrap_prefill_and_decode():
    cfg = reduced_config("smollm_360m")
    prefill, decode, model = make_serve_steps(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model["init_params"](gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    logits, state = prefill(params, {"tokens": toks}, 12)
    want, _ = model["prefill"](params, {"tokens": toks}, 12)
    assert torch.equal(logits, want) and logits.grad_fn is None
    nxt, _ = decode(params, state, logits.argmax(-1).to(torch.int32), 8)
    assert nxt.shape == logits.shape and torch.isfinite(nxt).all()


def test_loss_decreases_quickly_on_tiny_model():
    cfg = reduced_config("smollm_360m")
    data = SyntheticLMData(cfg, batch=4, seq=32)
    init_fn, step_fn, _ = make_train_step(cfg, peak_lr=5e-3)
    gen = torch.Generator()
    gen.manual_seed(1)
    params, opt = init_fn(gen)
    losses = []
    for i in range(30):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(i % 4).items()}
        params, opt, m = step_fn(params, opt, b)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, \
        losses[:3] + losses[-3:]
