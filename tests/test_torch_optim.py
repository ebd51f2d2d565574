"""The port's optimizers against the reference's (``repro.optim``):
``warmup_cosine``, ``clip_by_global_norm``, ``adamw`` (float32 moments)
and ``adafactor`` (factored second moments, bf16 momentum) over a few
steps of the same numpy trees and gradients, and the quadratic of
``tests/test_framework.py::test_optimizers_minimize_quadratic``.

Trees: a dict with a matrix, a stacked 3-D leaf, a vector and a list of
leaves (the port's per-layer lists), float32 and bf16 parameters.
Tolerance: rtol 1e-5 / atol 1e-7 on float32 (elementwise float32
arithmetic in another order); bf16 results within one bf16 step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import make_optimizer as ref_make
from repro.optim import warmup_cosine as ref_warmup
from repro_torch import tree
from repro_torch.models.transformer import tensor_from_numpy, \
    tensor_to_numpy
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               make_optimizer, warmup_cosine)

torch.set_num_threads(1)


def _trees(seed, bf16=False):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": (2, 3, 4), "b": (7,),
              "layers": [(3, 3), (5,)]}

    def make(shape):
        return rng.standard_normal(shape).astype(np.float32)

    p = {"w": make(shapes["w"]), "stack": make(shapes["stack"]),
         "b": make(shapes["b"]), "layers": [make(s) for s in
                                            shapes["layers"]]}
    if bf16:
        p["w"] = np.asarray(jnp.asarray(p["w"], jnp.bfloat16))
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) *
                                     (1 + i)).astype(np.float32), p)
             for i in range(4)]
    return p, grads


def _close(got_tree, want_tree):
    for g, w in zip(tree.leaves(got_tree), jax.tree.leaves(want_tree)):
        g = tensor_to_numpy(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
        else:
            g, w = g.astype(np.float32), w.astype(np.float32)
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-7)


def _run(opt_t, opt_j, seed, bf16):
    p_np, grads = _trees(seed, bf16)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = tree.map_leaves(tensor_from_numpy, p_np)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for g in grads:
        gj = jax.tree.map(jnp.asarray, g)
        gt = tree.map_leaves(tensor_from_numpy, g)
        uj, sj = opt_j.update(gj, sj, pj)
        ut, st = opt_t.update(gt, st, pt)
        _close(ut, uj)
        pj = jax.tree.map(lambda p, u: p + u.astype(p.dtype), pj, uj)
        pt = tree.map_leaves(lambda p, u: p + u.to(p.dtype), pt, ut)
        _close(pt, pj)
    return st, sj


def test_warmup_cosine_matches_reference():
    for args in [(1e-3,), (0.1, 5, 200), (3e-4, 100, 10_000, 0.2)]:
        lt, lj = warmup_cosine(*args), ref_warmup(*args)
        for step in [0, 1, 4, 5, 6, 50, 99, 100, 101, 150, 199, 5000,
                     20000]:
            np.testing.assert_allclose(float(lt(step)),
                                       float(lj(jnp.int32(step))),
                                       rtol=1e-6)
            np.testing.assert_allclose(
                float(lt(torch.tensor(step, dtype=torch.int32))),
                float(lj(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _trees(3, bf16=True)
    g = grads[2]
    gt = tree.map_leaves(tensor_from_numpy, g)
    ct, nt = clip_by_global_norm(gt, max_norm)
    cj, nj = ref_clip(jax.tree.map(jnp.asarray, g), max_norm)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    _close(ct, cj)
    # the port's test_framework twin
    ct, nt = clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(nt) == pytest.approx(20.0)
    assert float(torch.linalg.norm(ct["a"])) == pytest.approx(1.0, rel=1e-3)


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_matches_reference_over_steps(bf16):
    lt, lj = warmup_cosine(0.05, 2, 50), ref_warmup(0.05, 2, 50)
    st, sj = _run(adamw(lt), ref_adamw(lj), 11, bf16)
    assert int(st["count"]) == int(sj["count"]) == 4
    _close(st["m"], sj["m"])
    _close(st["v"], sj["v"])


@pytest.mark.parametrize("bf16", [False, True])
def test_adafactor_matches_reference_over_steps(bf16):
    lt, lj = warmup_cosine(0.05, 2, 50), ref_warmup(0.05, 2, 50)
    st, sj = _run(adafactor(lt), ref_adafactor(lj), 12, bf16)
    # factored second moments for >= 2-D leaves, a flat list in leaf order
    assert [sorted(v) for v in st["v"]] == [sorted(v) for v in sj["v"]]
    for vt, vj in zip(st["v"], sj["v"]):
        for key in vt:
            np.testing.assert_allclose(vt[key].numpy(), np.asarray(vj[key]),
                                       rtol=1e-5, atol=1e-12)
    # bf16 momentum
    assert all(m.dtype == torch.bfloat16 for m in tree.leaves(st["m"]))
    _close(st["m"], sj["m"])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_make_optimizer_and_moment_dtypes(name):
    kw = {"moment_dtype": "bfloat16"} if name == "adamw" else \
        {"momentum_dtype": "float32"}
    st, sj = _run(make_optimizer(name, 1e-2, **kw), ref_make(name, 1e-2,
                                                             **kw), 13,
                  False)
    _close(st["m"], sj["m"])
    with pytest.raises(ValueError):
        make_optimizer("sgd")


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizers_minimize_quadratic(opt_name):
    lr = warmup_cosine(0.1, warmup=5, total=200)
    opt = adamw(lr) if opt_name == "adamw" else adafactor(lr)
    params = {"w": torch.tensor([[3.0, -2.0], [1.0, 4.0]])}
    state = opt.init(params)
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(torch.square(w)), (w,))
        updates, state = opt.update({"w": g}, state, params)
        params = tree.map_leaves(lambda p, u: p + u, params, updates)
    assert float(torch.sum(torch.square(params["w"]))) < 0.05
