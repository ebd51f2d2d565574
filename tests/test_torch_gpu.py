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
