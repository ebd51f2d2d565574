"""The port's PAC kernels, held bitwise against the reference.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the reference Pallas kernels in interpret mode and the numpy
oracle.  tests/test_torch_gpu.py holds the CUDA kernels against the
plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitpack as ref_bitpack
from repro.kernels import fused_step as ref_fused
from repro.kernels import pac_eval as ref_pac
from repro.kernels.pac_np import pac_eval_rank_np
from repro_torch.kernels import bitpack, fused_step, ops, pac_eval


def _state(R, n_pad, seed, density=0.85):
    rng = np.random.default_rng(seed)
    return rng.random((R, n_pad)) < density, rng.random((R, n_pad)) < 0.4


def _words(rng, shape):
    """uint32 words over the whole range (bit 31 set in about half)."""
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _as_i32(words_u32):
    return torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32))


@pytest.mark.parametrize("rf", [2, 3, 4])
@pytest.mark.parametrize("n_real,n_pad", [(37, 37), (37, 40), (33, 64)])
def test_plain_pac_eval_matches_pallas_interpret_and_numpy(rf, n_real,
                                                           n_pad):
    R, voters = 64, 2 * (rf - 1) + 1
    up, full = _state(R, n_pad, seed=rf * 100 + n_pad, density=0.55)
    want_np = pac_eval_rank_np(up, full, rf=rf, voters=voters,
                               n_real=n_real)
    want_pl = ref_pac.pac_eval(jnp.asarray(up), jnp.asarray(full), rf=rf,
                               voters=voters, n_real=n_real, block_p=32,
                               interpret=True)
    got = pac_eval.pac_eval(torch.from_numpy(up), torch.from_numpy(full),
                            rf=rf, voters=voters, n_real=n_real)
    for g, w_np, w_pl in zip(got, want_np, want_pl):
        assert g.dtype == torch.bool
        assert np.array_equal(g.numpy(), w_np)
        assert np.array_equal(g.numpy(), np.asarray(w_pl))
    assert not got[2][:, n_real:].any()       # creps never picks padding
    assert got[0].any() and not got[0].all()  # both outcomes exercised


@pytest.mark.parametrize("rf,voters", [(2, 3), (3, 5), (4, 7), (3, 3)])
def test_plain_fused_pac_eval_matches_pallas_interpret(rf, voters):
    B, P, n_real = 2, 32, 37
    rng = np.random.default_rng(rf * 10 + voters)
    W = ref_bitpack.n_words(n_real)
    upw = _words(rng, (B, W, P))
    upw[0, :, :4] = 0xFFFFFFFF                # every lane up
    upw[1, :, :4] = 0                         # no lane up
    fullw = _words(rng, (B, W, P))
    assert (upw >> 31).any()
    l_ref, m_ref, c_ref = ref_fused.fused_pac_eval(
        jnp.asarray(upw), jnp.asarray(fullw), rf=rf, voters=voters,
        n_real=n_real, block_t=1, block_p=16, interpret=True)
    lark, maj, crepsw = fused_step.fused_pac_eval(
        _as_i32(upw), _as_i32(fullw), rf=rf, voters=voters, n_real=n_real)
    assert np.array_equal(lark.numpy(), np.asarray(l_ref))
    assert np.array_equal(maj.numpy(), np.asarray(m_ref))
    assert crepsw.dtype == torch.int32
    assert np.array_equal(crepsw.numpy().view(np.uint32), np.asarray(c_ref))


@pytest.mark.parametrize("rf", [2, 4])
def test_packed_and_unpacked_plain_versions_agree(rf):
    B, P, n_real, n_pad = 3, 16, 45, 64
    up, full = _state(B * P, n_pad, seed=rf)
    lark, maj, creps = pac_eval.pac_eval_plain(
        torch.from_numpy(up), torch.from_numpy(full), rf=rf,
        voters=2 * rf - 1, n_real=n_real)

    def words(b):
        return bitpack.pack_words(torch.from_numpy(b).reshape(B, P, n_pad)) \
            .movedim(-1, 1).contiguous()

    pl, pm, pc = fused_step.fused_pac_eval_plain(
        words(up), words(full), rf=rf, voters=2 * rf - 1, n_real=n_real)
    assert torch.equal(pl.reshape(-1), lark)
    assert torch.equal(pm.reshape(-1), maj)
    unpacked = bitpack.unpack_words(pc.movedim(1, -1), n_pad)
    assert torch.equal(unpacked.reshape(B * P, n_pad), creps)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 155])
def test_pack_unpack_round_trip_and_reference_bits(n):
    rng = np.random.default_rng(n)
    bools = rng.random((3, 5, n)) < 0.5
    bools[0, 0] = True                        # a word with bit 31 set
    words = bitpack.pack_words(torch.from_numpy(bools))
    assert words.dtype == torch.int32
    want = ref_bitpack.pack_words(bools, np)
    assert np.array_equal(words.numpy().view(np.uint32), want)
    assert torch.equal(bitpack.unpack_words(words, n),
                       torch.from_numpy(bools))
    u32 = bitpack.to_u32(words)
    assert int(u32.min()) >= 0 and torch.equal(bitpack.to_i32(u32), words)


def test_popcount_and_prefix_masks_match_reference():
    rng = np.random.default_rng(3)
    w = np.concatenate([_words(rng, 2048), np.array(
        [0, 1, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)])
    assert np.array_equal(bitpack.popcount32(_as_i32(w)).numpy(),
                          ref_bitpack.popcount32(w, np))
    for count in (0, 1, 31, 32, 33, 155, 200):
        assert bitpack.prefix_masks(count, 155) == \
            ref_bitpack.prefix_masks(count, 155)


def test_step_eval_dispatches_by_layout_and_rejects_downtime():
    B, P, n = 2, 8, 20
    up, full = _state(B * P, n, seed=5)
    spec = ops.StepSpec(metric="availability", rf=2, n_real=n)
    o = ops.step_eval(spec, torch.from_numpy(up), torch.from_numpy(full))
    want = pac_eval_rank_np(up, full, rf=2, voters=3, n_real=n)
    assert np.array_equal(o.lark.numpy(), want[0])
    assert o.leader is None and o.counts is None
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ops.step_eval(ops.StepSpec(metric="downtime", rf=2, n_real=n),
                      torch.from_numpy(up), torch.from_numpy(full))
