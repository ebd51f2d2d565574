"""The port on the card: each CUDA kernel against its plain PyTorch
version, bitwise, and the engine on cuda against the engine on the CPU.

This file imports neither jax nor repro, so it runs on a machine that
has only torch and a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test is marked ``gpu`` and skips where torch sees no card."""
import numpy as np
import pytest
import torch

from repro_torch.core.availability_batched import \
    simulate_availability_batched
from repro_torch.core.downtime_batched import simulate_downtime_batched
from repro_torch.kernels import fused_step, pac_eval

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _words(rng, shape):
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("rf", [2, 3, 4])
@pytest.mark.parametrize("n_pad", [155, 160])
def test_cuda_pac_eval_matches_plain(cuda, rf, n_pad):
    rng = np.random.default_rng(rf + n_pad)
    up = torch.from_numpy(rng.random((8 * 64, n_pad)) < 0.9).to(cuda)
    full = torch.from_numpy(rng.random((8 * 64, n_pad)) < 0.3).to(cuda)
    before = pac_eval.pac_eval.launches
    got = pac_eval.pac_eval(up, full, rf=rf, voters=2 * rf - 1, n_real=155)
    torch.cuda.synchronize()
    assert pac_eval.pac_eval.launches == before + 1
    want = pac_eval.pac_eval_plain(up, full, rf=rf, voters=2 * rf - 1,
                                   n_real=155)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("rf", [2, 3, 4])
def test_cuda_fused_pac_eval_matches_plain(cuda, rf):
    rng = np.random.default_rng(rf)
    upw = _words(rng, (4, 5, 64)).to(cuda)
    fullw = _words(rng, (4, 5, 64)).to(cuda)
    before = fused_step.fused_pac_eval.launches
    got = fused_step.fused_pac_eval(upw, fullw, rf=rf, voters=2 * rf - 1,
                                    n_real=155)
    torch.cuda.synchronize()
    assert fused_step.fused_pac_eval.launches == before + 1
    want = fused_step.fused_pac_eval_plain(upw, fullw, rf=rf,
                                           voters=2 * rf - 1, n_real=155)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_cuda_engine_matches_cpu(cuda, packed):
    n = 40
    kw = dict(n=n, partitions=32, rf=2, p=5e-3, trials=3, max_ticks=4_000,
              min_ticks=10 ** 9, chunk_steps=64, max_steps=300, seed=11,
              trajectory=True, packed=packed, pair_fail_prob=0.5,
              restart_period=150, wave_width=2,
              p_node=np.array([5e-3, 2e-2, 1e-3])[np.arange(n) % 3])
    got = simulate_availability_batched(device=cuda, **kw)
    want = simulate_availability_batched(device="cpu", **kw)
    for k in want.trajectory:
        assert np.array_equal(got.trajectory[k], want.trajectory[k]), k
    assert (got.u_lark, got.u_maj, got.lark_events) == \
        (want.u_lark, want.u_maj, want.lark_events)


def _rosters(rng, R, rf, n):
    """(R, rf) int32 distinct in-range ranks, with some padding ranks."""
    ro = np.stack([rng.permutation(n)[:rf] for _ in range(R)])
    ro[::7, 0] = n + 3                        # out of range: reads down
    return torch.from_numpy(ro.astype(np.int32))


@pytest.mark.parametrize("extras", [False, True], ids=["base", "extras"])
@pytest.mark.parametrize("with_roster", [False, True],
                         ids=["first-rf", "roster"])
@pytest.mark.parametrize("rf", [2, 3, 4])
@pytest.mark.parametrize("n_pad", [155, 160])
def test_cuda_downtime_eval_matches_plain(cuda, n_pad, rf, with_roster,
                                          extras):
    rng = np.random.default_rng(rf + n_pad + 10 * with_roster)
    R = 8 * 64
    up = torch.from_numpy(rng.random((R, n_pad)) < 0.9)
    up[0] = False
    full = torch.from_numpy(rng.random((R, n_pad)) < 0.3)
    roster = _rosters(rng, R, rf, 155) if with_roster else None
    kw = dict(rf=rf, n_real=155, want_repmask=extras,
              want_rleader=extras and with_roster)
    before = (pac_eval.downtime_eval.launches,
              pac_eval.downtime_eval.roster_launches)
    got = pac_eval.downtime_eval(
        up.to(cuda), full.to(cuda),
        roster=None if roster is None else roster.to(cuda), **kw)
    torch.cuda.synchronize()
    after = (pac_eval.downtime_eval.launches,
             pac_eval.downtime_eval.roster_launches)
    assert after[int(with_roster)] == before[int(with_roster)] + 1
    want = pac_eval.downtime_eval_plain(up, full, roster=roster, **kw)
    assert len(got) == len(want)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_cuda_node_count_matches_plain(cuda):
    rng = np.random.default_rng(3)
    rec = torch.from_numpy(rng.integers(-3, 160, (8, 4096))
                           .astype(np.int32))
    act = torch.from_numpy(rng.random((8, 4096)) < 0.3)
    before = pac_eval.node_count.launches
    got = pac_eval.node_count(rec.to(cuda), act.to(cuda), n_real=155)
    torch.cuda.synchronize()
    assert pac_eval.node_count.launches == before + 1
    assert torch.equal(got.cpu(),
                       pac_eval.node_count_plain(rec, act, n_real=155))


@pytest.mark.parametrize("with_counts", [False, True],
                         ids=["eval", "counts"])
@pytest.mark.parametrize("with_roster", [False, True],
                         ids=["first-rf", "roster"])
@pytest.mark.parametrize("rf", [2, 3, 4])
def test_cuda_fused_downtime_eval_matches_plain(cuda, rf, with_roster,
                                                with_counts):
    rng = np.random.default_rng(rf + 4 * with_roster + 2 * with_counts)
    B, W, P = 4, 5, 256
    upw, fullw = _words(rng, (B, W, P)), _words(rng, (B, W, P))
    upw[0, :, :3] = 0
    roster = _rosters(rng, B * P, rf, 155).reshape(B, P, rf) \
        if with_roster else None
    rec = torch.from_numpy(rng.integers(-3, 160, (B, P)).astype(np.int32))
    act = torch.from_numpy(rng.random((B, P)) < 0.5)
    kw = dict(rf=rf, n_real=155, want_repmask=True,
              want_rleader=with_roster)
    cnt = dict(recruit=rec, active=act) if with_counts else {}
    before = fused_step.fused_downtime_eval.launches
    got = fused_step.fused_downtime_eval(
        upw.to(cuda), fullw.to(cuda),
        roster=None if roster is None else roster.to(cuda),
        **{k: v.to(cuda) for k, v in cnt.items()}, **kw)
    torch.cuda.synchronize()
    assert fused_step.fused_downtime_eval.launches == before + 1
    want = fused_step.fused_downtime_eval_plain(upw, fullw, roster=roster,
                                                **cnt, **kw)
    assert len(got) == len(want)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("config", ["fixed-bw", "skew-bw"])
def test_cuda_downtime_engine_matches_cpu(cuda, config, packed):
    n = 40
    kw = dict(n=n, partitions=32, rf=2, p=2e-2, trials=3, max_ticks=4_000,
              min_ticks=10 ** 9, chunk_steps=64, max_steps=192, seed=11,
              trajectory=True, packed=packed, rebuild_steps=30,
              rebuild_ticks_per_gib=30, node_bandwidth_gibps=1.0)
    if config == "skew-bw":
        kw.update(rebuild_model="reconfig", size_dist="zipf", size_skew=1.0)
    got = simulate_downtime_batched(device=cuda, **kw)
    want = simulate_downtime_batched(device="cpu", **kw)
    for k in want.trajectory:
        assert np.array_equal(got.trajectory[k], want.trajectory[k]), k
    assert (got.pause_lark, got.pause_quorum, got.quorum_events) == \
        (want.pause_lark, want.pause_quorum, want.quorum_events)
    assert np.array_equal(got.hist_quorum, want.hist_quorum)
