"""The port's mLSTM math against the reference.

``mlstm_chunkwise_plain`` (the CPU path of the CUDA kernel) against the
oracle ``repro.kernels.ref.mlstm_chunkwise`` and the Pallas
``mlstm_chunkwise`` in interpret mode, on ``tests/test_kernels.py``'s
three shapes, with that file's tolerance; against the oracle for the
final state, a ragged S, an ``initial`` state and large gate spreads;
``mlstm_step_plain`` against ``ref.mlstm_step``; chunkwise against
stepwise; the wrapper's dispatch on the CPU; and the rounding-scale
check the card holds the kernel to (``mlstm_check``): the oracle passes
it, a wrong carry fails it.

Inputs come from numpy with a seed and go through both sides in float32.
Tolerances: atol 5e-5 / rtol 5e-4 wherever ``test_kernels.py`` uses
them (float32 sums in another order); the chunkwise-vs-stepwise bound
2e-4 / 2e-3 is that file's too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.mlstm_chunk import mlstm_chunkwise as pallas_mlstm
from repro_torch.kernels import mlstm_check as MC
from repro_torch.kernels import mlstm_chunk as T
from repro_torch.kernels import ops as TOPS

torch.set_num_threads(1)

ATOL, RTOL = 5e-5, 5e-4


def _inputs(seed, B, H, S, Dq, Dv=None, *, li_scale=1.0, lf_shift=2.0):
    rng = np.random.default_rng(seed)
    Dv = Dv or Dq
    q, k = (rng.standard_normal((B, H, S, Dq)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, S, Dv)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        jnp.asarray(rng.standard_normal((B, H, S)), jnp.float32) * 2
        + lf_shift))
    li = (rng.standard_normal((B, H, S)) * li_scale).astype(np.float32)
    return q, k, v, lf, li


def _initial(seed, B, H, Dq, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Dq, Dv)).astype(np.float32),
            rng.standard_normal((B, H, Dq)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jnp(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,H,S,D,chunk", [(1, 1, 128, 16, 32),
                                           (2, 2, 256, 32, 64),
                                           (1, 2, 256, 64, 128)])
def test_plain_matches_oracle_and_pallas_interpret(B, H, S, D, chunk):
    x = _inputs(B * 100 + S + D, B, H, S, D)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=chunk)
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk)
    hk, _ = pallas_mlstm(*_jnp(*x), chunk=chunk, interpret=True)
    _close(h, hr)
    _close(h, hk)
    # the final state the kernel emits from its own carry: the oracle's
    _close(C, Cr)
    _close(n, nr)
    _close(m, mr)


@pytest.mark.parametrize("S,chunk", [(100, 32), (37, 256), (257, 64)])
def test_ragged_sequence_matches_oracle(S, chunk):
    x = _inputs(S, 2, 2, S, 16, 24)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=chunk)
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk)
    assert h.shape == (2, 2, S, 24)
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


@pytest.mark.parametrize("S,chunk", [(64, 32), (50, 32)])
def test_initial_state_matches_oracle(S, chunk):
    x = _inputs(7 + S, 1, 2, S, 16)
    init = _initial(8 + S, 1, 2, 16, 16)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=chunk,
                                           initial=_torch(*init))
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk,
                                         initial=_jnp(*init))
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


def test_prefill_continuation_equals_one_pass():
    """Two calls carrying the state equal one call over the whole
    sequence (the use of `initial` in a continued prefill)."""
    S = 96
    q, k, v, lf, li = _torch(*_inputs(3, 1, 2, S, 16))
    h, st = T.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=32)
    cut = 64
    h1, st1 = T.mlstm_chunkwise_plain(q[:, :, :cut], k[:, :, :cut],
                                      v[:, :, :cut], lf[:, :, :cut],
                                      li[:, :, :cut], chunk=32)
    h2, st2 = T.mlstm_chunkwise_plain(q[:, :, cut:], k[:, :, cut:],
                                      v[:, :, cut:], lf[:, :, cut:],
                                      li[:, :, cut:], chunk=32, initial=st1)
    _close(torch.cat([h1, h2], dim=2), h)
    for got, want in zip(st2, st):
        _close(got, want)


def test_stabilizer_spread_matches_oracle():
    """log_f near 0 (f ~ 1, long memory) and log_i over +-10: the
    running max m, not the raw gates, keeps the exponentials finite."""
    x = _inputs(11, 1, 2, 160, 16, li_scale=10.0, lf_shift=8.0)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=64)
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=64)
    assert torch.isfinite(h).all() and torch.isfinite(C).all()
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


def test_step_matches_oracle():
    rng = np.random.default_rng(5)
    B, H, D = 2, 3, 16
    q, k, v = (rng.standard_normal((B, H, D)).astype(np.float32)
               for _ in range(3))
    lf = np.log(rng.uniform(0.1, 0.99, (B, H))).astype(np.float32)
    li = rng.standard_normal((B, H)).astype(np.float32)
    state = _initial(6, B, H, D, D)
    h, (C, n, m) = T.mlstm_step_plain(*_torch(q, k, v, lf, li),
                                      _torch(*state))
    hr, (Cr, nr, mr) = R.mlstm_step(*_jnp(q, k, v, lf, li), _jnp(*state))
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


def test_chunkwise_matches_stepwise():
    B, H, S, D = 1, 2, 96, 16
    q, k, v, lf, li = _torch(*_inputs(9, B, H, S, D, lf_shift=1.0))
    hc, (C, n, m) = T.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=32)
    state = (torch.zeros((B, H, D, D)), torch.zeros((B, H, D)),
             torch.full((B, H), -1e30))
    hs = []
    for t in range(S):
        h1, state = T.mlstm_step_plain(q[:, :, t], k[:, :, t], v[:, :, t],
                                       lf[:, :, t], li[:, :, t], state)
        hs.append(h1)
    _close(hc, torch.stack(hs, 2), atol=2e-4, rtol=2e-3)
    _close(C, state[0], atol=2e-4, rtol=2e-3)


def test_wrapper_dispatches_by_device_without_fallback():
    q, k, v, lf, li = _torch(*_inputs(1, 1, 1, 40, 8))
    before = (T.mlstm_chunkwise.launches, T.mlstm_chunkwise_plain.calls)
    h, _ = TOPS.mlstm_chunkwise(q, k, v, lf, li, chunk=16)
    assert T.mlstm_chunkwise.launches == before[0]     # plain path: no launch
    assert T.mlstm_chunkwise_plain.calls == before[1] + 1
    want, _ = T.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=16)
    assert torch.equal(h, want)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.mlstm_chunkwise(q.to(meta), k.to(meta), v.to(meta), lf.to(meta),
                          li.to(meta))
    with pytest.raises(TypeError):
        T.mlstm_chunkwise(q.double(), k, v, lf, li)
    with pytest.raises(ValueError, match="log_f"):
        T.mlstm_chunkwise(q, k, v, lf[:, :, :-1], li)
    with pytest.raises(ValueError, match="initial"):
        T.mlstm_chunkwise(q, k, v, lf, li, initial=(
            torch.zeros((1, 1, 8, 9)), torch.zeros((1, 1, 8)),
            torch.zeros((1, 1))))


def test_shared_memory_budget_covers_the_full_width():
    """xlstm-350m's head dim (2048 / 4 = 512) at chunk 256 fits one
    block's shared memory; a head dim past the budget is refused."""
    assert T.columns_smem_bytes(512, 256) <= T.SMEM_LIMIT
    assert T.columns_smem_bytes(1024, 256) > T.SMEM_LIMIT


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("li_scale,lf_shift", [(1.0, 2.0), (10.0, 8.0)],
                         ids=["gates", "stabilizer"])
def test_rounding_check_passes_the_oracle(initial, li_scale, lf_shift):
    """The oracle (XLA's float32 sums, another order) passes
    ``mlstm_errors`` against the plain version: every output within what
    float32 rounding allows."""
    B, H, S, D, chunk = 2, 2, 200, 32, 64
    x = _inputs(7, B, H, S, D, li_scale=li_scale, lf_shift=lf_shift)
    init = _initial(8, B, H, D, D) if initial else None
    tinit = None if init is None else _torch(*init)
    hr, sr = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk,
                               initial=None if init is None else
                               _jnp(*init))
    (want_h, want_state), scales = MC.reference(_torch(*x), chunk, tinit)
    errs = MC.mlstm_errors(*_torch(hr), _torch(*sr), want_h, want_state,
                           scales)
    assert all(e <= 1.0 for e in errs.values()), errs


@pytest.mark.parametrize("dtype,factor", [
    (torch.float32, 1.001), (torch.float32, 1.01),
    (torch.bfloat16, 1.01), (torch.bfloat16, 1.1)])
def test_rounding_check_catches_a_wrong_carry(dtype, factor):
    """A carried-in C off by 0.1 % fails the check in float32, and off
    by 1 % in bf16, whose h carries 8 bits (a tolerance set by the
    largest |h| let a 10 % carry error through in bf16)."""
    B, H, S, D, chunk = 1, 2, 128, 32, 64
    x = _inputs(9, B, H, S, D, li_scale=10.0, lf_shift=8.0)
    q, k, v, lf, li = _torch(*x)
    q, k, v = (a.to(dtype) for a in (q, k, v))
    C0, n0, m0 = _torch(*_initial(10, B, H, D, D))
    args = (q, k, v, lf, li)
    (want_h, want_state), scales = MC.reference(args, chunk, (C0, n0, m0))
    h, state = T.mlstm_chunkwise_plain(*args, chunk=chunk,
                                       initial=(C0, n0, m0))
    assert max(MC.mlstm_errors(h, state, want_h, want_state,
                               scales).values()) <= 1.0
    h, state = T.mlstm_chunkwise_plain(*args, chunk=chunk,
                                       initial=(C0 * factor, n0, m0))
    assert MC.mlstm_errors(h, state, want_h, want_state,
                           scales)["h"] > 1.0


@pytest.mark.parametrize("li_scale,lf_shift", [(1.0, 2.0), (10.0, 8.0)],
                         ids=["gates", "stabilizer"])
def test_rounding_scale_covers_float32_against_float64(monkeypatch,
                                                       li_scale, lf_shift):
    """The plain version in float32 against the same math in float64
    (the true sums, nearly) stays within an eighth of what the check
    allows: the margin GAMMA leaves for a kernel's other order."""
    B, H, S, D, chunk = 1, 2, 300, 128, 128
    x = _torch(*_inputs(11, B, H, S, D, li_scale=li_scale,
                        lf_shift=lf_shift))
    (h, state), scales = MC.reference(x, chunk, None)
    zero = (torch.zeros(B, H, D, D, dtype=torch.float64),
            torch.zeros(B, H, D, dtype=torch.float64),
            torch.full((B, H), T.NEG, dtype=torch.float64))
    monkeypatch.setattr(T, "_f32", lambda *xs: tuple(a.double() for a in xs))
    h64, state64 = T.mlstm_chunkwise_plain(*(a.double() for a in x),
                                           chunk=chunk, initial=zero)
    errs = MC.mlstm_errors(h, state, h64, state64, scales)
    assert max(errs.values()) <= 1 / 8, errs
