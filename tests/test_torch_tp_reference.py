"""The tensor-parallel tests' configurations that the other reference
tests do not run (``_torch_tp.CASES`` with overrides: mixtral with 3
experts, minicpm3 with 3 heads and a vocabulary of 255, recurrentgemma
with an RG-LRU of 64 channels, whisper with remat), one process of the
port against the reference from the same weights (``params_from_jax``
of the reference's ``PRNGKey(0)`` initialization) and inputs: the
case's train steps (``TRAIN_STEPS`` of ``make_train_step`` on the case's
rows) and its prefill and greedy decode steps.  With
``tests/test_torch_tp.py``, which holds the 2 x 2 mesh's ranks against
one process of the port, this ties the sharded runs to the reference.

Tolerance: ``tests/_torch_lm.py``'s whole-model one (rtol 1e-3, atol
1e-3 of the leaf's largest magnitude) on the parameters, the logits
and the decode state, and rtol 1e-3 on the loss and grad norm, as in
``tests/test_torch_tp.py``; float32 on both sides."""
import jax
import numpy as np
import pytest
import torch

import _torch_lm as lm
import _torch_tp as T
from repro.configs import reduced_config as ref_reduced
from repro.models import build_model as ref_build
from repro.training import make_train_step as ref_make_train_step
from repro_torch import tree
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.training import make_train_step

torch.set_num_threads(1)

CHANGED = [n for n, c in T.CASES.items() if c[1]]
TRAIN = [n for n in CHANGED if "train" in T.CASES[n][3]]
SERVE = [n for n in CHANGED if "serve" in T.CASES[n][3]]


def configs(name):
    rcfg, tcfg = T.config(name, ref_reduced), T.config(name)
    assert repr(rcfg) == repr(tcfg)
    return rcfg, tcfg


def test_the_overridden_cases_are_these():
    assert sorted(CHANGED) == sorted(
        ["mixtral_8x7b", "mixtral_8x7b_b1", "minicpm3_4b",
         "recurrentgemma_9b", "recurrentgemma_9b_b1", "whisper_small_sp"])


@pytest.mark.parametrize("name", TRAIN)
def test_train_steps_match_reference(name):
    rcfg, tcfg = configs(name)
    rows = T.CASES[name][2]
    r_init, r_step, _ = ref_make_train_step(rcfg)
    pj, sj = r_init(jax.random.PRNGKey(0))
    b = lm.train_batch(tcfg, seq=T.TRAIN_SEQ, rows=rows)
    _, step_fn, opt = make_train_step(tcfg)
    pt = params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    st = opt.init(pt)
    r_step = jax.jit(r_step)
    bj, bt = jax.tree.map(jax.numpy.asarray, b), lm.to_torch(b)
    for _ in range(T.TRAIN_STEPS):
        pj, sj, mj = r_step(pj, sj, bj)
        pt, st, mt = step_fn(pt, st, bt)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-3)
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    for (path, g), w in zip(tree.leaves_with_paths(pt), tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        lm.close_deep(g, w)


@pytest.mark.parametrize("name", SERVE)
def test_prefill_and_decode_match_reference(name):
    rcfg, tcfg = configs(name)
    ref = ref_build(rcfg)
    pj = ref["init_params"](jax.random.PRNGKey(0))
    ref = dict(ref, prefill=jax.jit(ref["prefill"],
                                    static_argnames="max_len"),
               decode_step=jax.jit(ref["decode_step"]))
    m = (tcfg, ref, pj, build_model(tcfg),
         params_from_jax(tcfg, jax.tree.map(np.asarray, pj)))
    b = lm.batch(tcfg, T.PROMPT, rows=T.CASES[name][2], seed=1)
    lm.model_matches(m, b, T.MAX_LEN, steps=T.DECODE_STEPS)
