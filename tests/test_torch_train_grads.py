"""The port's ``loss_fn`` against ``jax.value_and_grad`` of the
reference's, for every registry architecture's reduced config but xlstm
(``test_torch_train_xlstm.py``): the total (the cross entropy plus 0.01
times the MoE aux loss), the metrics and every gradient leaf, with the
reference's weights carried over by ``params_from_jax`` and its
gradients mapped the same way.

Inputs: the reference's ``make_batch`` for a train cell (2 rows of 16
tokens) from numpy's seed 0.  Tolerance: the whole-model one of
``tests/_torch_lm.py`` (rtol 1e-3, atol 1e-3 of the leaf's largest
magnitude), float32 on both sides."""
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro.models import build_model as ref_build
from repro_torch.training import accumulate_grads

torch.set_num_threads(1)

ARCHS = ("mixtral_8x7b", "qwen3_moe_235b_a22b", "recurrentgemma_9b",
         "internlm2_20b", "smollm_360m", "minicpm3_4b", "nemotron_4_340b",
         "whisper_small", "qwen2_vl_2b")
MOE = ("mixtral_8x7b", "qwen3_moe_235b_a22b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch):
    _, ref, pj, port, pt = lm.models(arch)
    cfg = lm.configs(arch)[1]
    b = lm.train_batch(cfg)
    total_j, metrics_j, grads_j = lm.ref_loss_and_grads(ref_build(cfg), pj,
                                                        b)
    total, metrics = port["loss_fn"](pt, lm.to_torch(b))
    lm.close(total.detach(), total_j, atol=1e-5, rtol=1e-5)
    for key in ("loss", "aux_loss", "tokens"):
        lm.close(metrics[key].detach(), metrics_j[key], atol=1e-5,
                 rtol=1e-5)
    if arch in MOE:
        # the aux term is in the total, and is not negligible
        assert float(metrics["aux_loss"]) > 0.1
        lm.close(total.detach(), metrics["loss"].detach() +
                 0.01 * metrics["aux_loss"].detach(), atol=1e-6, rtol=0)
    loss, grads = accumulate_grads(port["loss_fn"], pt, lm.to_torch(b))
    lm.close(loss, total_j, atol=1e-5, rtol=1e-5)
    lm.grads_close(cfg, grads, grads_j)


def test_loss_mask_weights_the_mean():
    """A loss_mask averages over its weight, as the reference's."""
    arch = "smollm_360m"
    _, ref, pj, port, pt = lm.models(arch)
    cfg = lm.configs(arch)[1]
    b = lm.train_batch(cfg)
    b["loss_mask"] = (np.arange(16)[None, :] < np.array([[10], [4]])) \
        .astype(np.float32)
    total_j, _, grads_j = lm.ref_loss_and_grads(ref_build(cfg), pj, b)
    loss, grads = accumulate_grads(port["loss_fn"], pt, lm.to_torch(b))
    lm.close(loss, total_j, atol=1e-5, rtol=1e-5)
    lm.grads_close(cfg, grads, grads_j)
