"""The data-parallel train step (``make_train_step`` with sharding
arguments) against one process on the full batch.

Two ``gloo`` ranks (a ``file://`` store under the test's tmp dir) on a
(2, 1) ("data", "model") mesh each take their half of the batch, train
the reduced smollm (2 microbatches) and xlstm for two steps, and
all-reduce-average the gradients and the loss; one process trains the
same weights on the whole batch.  In the same spawn the ZeRO step: the
AdamW moments distributed under ``opt_state_shardings``, so each rank
reduce-scatters the gradients into its shard (``grad_shardings``),
updates its shard of the parameters and all-gathers them.

Tolerance: the ranks split the sums over batch rows, so the float32
results move by reduction order alone.  Measured (CPU): smollm's leaves
within 1e-7 of their largest magnitude, xlstm's within 3.2e-5 (its
sLSTM recurrence amplifies rounding), its optimizer moments within
2.8e-4 and its second step's grad_norm 7.4e-5 relative.  Held: every
leaf within rtol 1e-3 and atol 1e-3 of the leaf's largest magnitude
(``_torch_lm.close_deep``, the port's whole-model tolerance), the loss
and grad_norm within rtol 1e-3; the two ranks equal bit for bit.  On a
mesh of one rank the step is the unsharded step bit for bit; a
tensor-parallel arch on a model axis above 1 takes the sharded step
(held in tests/test_torch_tp.py), and a data-parallel rank whose rows do
not split into the microbatches raises."""
import pickle

import numpy as np
import pytest
import torch

import _torch_lm as lm
import _torch_ranks as TR
from repro_torch import tree
from repro_torch.configs import reduced_config
from repro_torch.launch import dist as rdist
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import batch_shardings, grad_shardings
from repro_torch.training import make_train_step
from repro_torch.training.train_loop import _is_sharded

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rdist.spawn(TR.train_rank_main, 2, (2, str(tmp / "store"), str(tmp)),
                timeout_s=110)
    return [pickle.loads((tmp / f"train{r}.pkl").read_bytes())
            for r in range(2)]


def _one_process(arch):
    cfg, params, opt_state, batch = TR.train_setup(arch)
    _, step_fn, _ = make_train_step(cfg)
    return TR.train(step_fn, params, opt_state, batch)


@pytest.mark.parametrize("arch", list(TR.TRAIN_ARCHS))
def test_two_ranks_match_one_process(ranks, arch):
    params, opt_state, metrics = _one_process(arch)
    (p0, o0, m0, _), (p1, o1, m1, _) = (ranks[0][arch, False],
                                        ranks[1][arch, False])
    for a, b in zip(p0 + o0, p1 + o1):
        assert np.array_equal(a, b)               # the update is replicated
    assert m0 == m1
    _match_one_process(arch, params, opt_state, metrics, p0, o0, m0)


def _match_one_process(arch, params, opt_state, metrics, p0, o0, m0):
    for got, want in zip(m0, metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
    assert len(p0) == len(tree.leaves(params))
    for got, want in zip(p0, tree.leaves(params)):
        lm.close_deep(got, want.numpy())
    assert len(o0) == len(tree.leaves(opt_state))
    for got, want in zip(o0, tree.leaves(opt_state)):
        lm.close_deep(got, want.float().numpy())
    # the step moved the parameters
    start = tree.leaves(TR.train_setup(arch)[1])
    assert any(not np.array_equal(a, s.numpy()) for a, s in zip(p0, start))


@pytest.mark.parametrize("arch", list(TR.TRAIN_ARCHS))
def test_zero_moments_match_one_process(ranks, arch):
    """The ZeRO step: moments distributed under opt_state_shardings, each
    rank holding its shard only; the parameters replicated bit for bit,
    and everything within the bound of one process."""
    params, opt_state, metrics = _one_process(arch)
    (p0, o0, m0, s0), (p1, o1, m1, s1) = (ranks[0][arch, True],
                                          ranks[1][arch, True])
    for a, b in zip(p0, p1):
        assert np.array_equal(a, b)
    assert m0 == m1
    for shapes in (s0, s1):
        assert all(local == want for local, want in shapes)
    # each rank holds half of every moment leaf with an even dim, and
    # the others (the step count among them) whole
    assert len(s0) == len(o0)
    for (local, _), whole in zip(s0, o0):
        assert 2 * int(np.prod(local)) == whole.size or (
            local == whole.shape and all(n % 2 for n in whole.shape))
    _match_one_process(arch, params, opt_state, metrics, p0, o0, m0)


@pytest.mark.parametrize("arch", list(TR.TRAIN_ARCHS))
@pytest.mark.parametrize("given", ["both", "grad_only"])
def test_one_rank_mesh_is_the_unsharded_step(tmp_path, arch, given):
    params1, opt1, metrics1 = _one_process(arch)
    rdist.init(f"file://{tmp_path / 'store'}", rank=0, world_size=1,
               timeout_s=60)
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"))
        cfg, params, opt_state, batch = TR.train_setup(arch)
        bsh = batch_shardings(cfg, mesh, batch, 4) if given == "both" \
            else None
        _, step_fn, _ = make_train_step(
            cfg, grad_shardings=grad_shardings(cfg, mesh, params),
            batch_shardings=bsh)
        params, opt_state, metrics = TR.train(step_fn, params, opt_state,
                                              batch)
    finally:
        rdist.shutdown()
    assert metrics == metrics1
    for a, b in zip(tree.leaves((params, opt_state)),
                    tree.leaves((params1, opt1))):
        assert torch.equal(a, b)


def test_tensor_parallel_arch_on_a_model_axis_raises():
    fake_world(4)
    try:
        mesh = make_host_mesh((2, 2), ("data", "model"))
        cfg = reduced_config("internlm2_20b")
        assert cfg.tensor_parallel
        batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32)}
        # a tensor-parallel arch on a model axis builds the sharded step
        # (tests/test_torch_tp.py holds it against one process)
        bsh = batch_shardings(cfg, mesh, batch, 4)
        make_train_step(cfg, batch_shardings=bsh)
        assert _is_sharded(cfg, mesh, {k: s.spec for k, s in bsh.items()})
        # a non-TP arch on the same mesh takes the model axis as data:
        # 4 ranks of one row cannot each split it into 2 microbatches
        dense = reduced_config("smollm_360m").replace(microbatches_train=2)
        _, step_fn, _ = make_train_step(
            dense, batch_shardings=batch_shardings(dense, mesh, batch, 4))
        with pytest.raises(ValueError, match="2 microbatches"):
            step_fn(None, None, batch)
    finally:
        rdist.shutdown()
