"""xlstm's reduced config (mLSTM through the chunkwise Function, sLSTM's
per-token loop) under training: the port's loss and every gradient leaf
against ``jax.value_and_grad`` of the reference's loss_fn, with remat on
and off (the gradients equal), and an mLSTM block whose cell parameters
all receive a gradient.  Tolerance: ``tests/_torch_lm.py``'s whole-model
one."""
import torch

import _torch_lm as lm
from repro.models import build_model as ref_build
from repro_torch import tree
from repro_torch.models import build_model
from repro_torch.training import accumulate_grads

torch.set_num_threads(1)


def test_loss_and_gradients_match_reference_with_remat_on_and_off():
    arch = "xlstm_350m"
    _, _, pj, port, pt = lm.models(arch)
    cfg = lm.configs(arch)[1]
    b = lm.train_batch(cfg)
    total_j, _, grads_j = lm.ref_loss_and_grads(ref_build(cfg), pj, b)
    loss, grads = accumulate_grads(port["loss_fn"], pt, lm.to_torch(b))
    lm.close(loss, total_j, atol=1e-5, rtol=1e-5)
    lm.grads_close(cfg, grads, grads_j)
    remat = build_model(cfg.replace(remat=True))
    loss_r, grads_r = accumulate_grads(remat["loss_fn"], pt, lm.to_torch(b))
    assert torch.equal(loss_r, loss)
    for g, h in zip(tree.leaves(grads_r), tree.leaves(grads)):
        assert torch.equal(g, h)
    # every leaf of an mLSTM cell gets a gradient (the kernel path must
    # not detach the gates, projections or the conv)
    cell = grads["blocks"][0]["cell"]
    assert all(float(g.abs().max()) > 0 for g in tree.leaves(cell))
