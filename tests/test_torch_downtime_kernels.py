"""The port's §6 kernels, held bitwise against the reference.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the reference Pallas kernels in interpret mode (``downtime_eval``
with and without a roster, ``node_count``, ``fused_downtime_eval``) and
the numpy oracles.  tests/test_torch_gpu.py holds the CUDA kernels
against the plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitpack as ref_bitpack
from repro.kernels import fused_step as ref_fused
from repro.kernels import pac_eval as ref_pac
from repro.kernels.pac_np import (downtime_eval_rank_np,
                                  rebuild_node_counts_np)
from repro_torch.kernels import bitpack, fused_step, ops, pac_eval


def _words(rng, shape):
    """uint32 words over the whole range (bit 31 set in about half)."""
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _as_i32(words_u32):
    return torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32))


def _assert_outs_equal(got, want, *, words_at=None):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy()
        if i == words_at:
            g = g.view(np.uint32)
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert np.array_equal(g, w), i


@pytest.mark.parametrize("with_roster", [False, True],
                         ids=["first-rf", "roster"])
@pytest.mark.parametrize("rf", [2, 3])
@pytest.mark.parametrize("n_real,n_pad", [(29, 29), (29, 40)])
def test_plain_downtime_eval_matches_pallas_interpret_and_numpy(
        rf, n_real, n_pad, with_roster):
    R = 64
    rng = np.random.default_rng(rf * 100 + n_pad + 7 * with_roster)
    up = rng.random((R, n_pad)) < 0.6
    full = rng.random((R, n_pad)) < 0.4
    up[0] = False                           # dead row: leader sentinel
    up[1, :n_real] = True
    roster = None
    if with_roster:
        roster = np.stack([rng.permutation(n_real)[:rf]
                           for _ in range(R)]).astype(np.int32)
    for extras in (False, True):
        rl = extras and with_roster
        want_np = downtime_eval_rank_np(up, full, rf=rf, n_real=n_real,
                                        roster=roster, want_repmask=extras,
                                        want_rleader=rl)
        want_pl = ref_pac.downtime_eval(
            jnp.asarray(up), jnp.asarray(full), rf=rf, n_real=n_real,
            block_p=32, interpret=True,
            roster=None if roster is None else jnp.asarray(roster),
            want_repmask=extras, want_rleader=rl)
        got = pac_eval.downtime_eval(
            torch.from_numpy(up), torch.from_numpy(full), rf=rf,
            n_real=n_real,
            roster=None if roster is None else torch.from_numpy(roster),
            want_repmask=extras, want_rleader=rl)
        _assert_outs_equal(got, want_np)
        _assert_outs_equal(got, want_pl)
    assert got[2][0] == n_real                # no node up: sentinel
    assert not got[-1][:, n_real:].any()      # creps never picks padding
    assert got[1].any() and not got[1].all()  # both qmaj outcomes


def test_plain_roster_ranks_outside_the_real_lanes_read_down():
    """A rank in the padding columns, past the tile or negative reads as
    a down member, as the Pallas kernel's one-hot compare over valid
    lanes does."""
    R, n_real, n_pad, rf = 32, 29, 40, 3
    rng = np.random.default_rng(9)
    up = rng.random((R, n_pad)) < 0.9
    full = rng.random((R, n_pad)) < 0.4
    roster = rng.integers(-3, n_pad + 4, (R, rf)).astype(np.int32)
    want = ref_pac.downtime_eval(
        jnp.asarray(up), jnp.asarray(full), rf=rf, n_real=n_real,
        block_p=32, interpret=True, roster=jnp.asarray(roster),
        want_rleader=True)
    got = pac_eval.downtime_eval(
        torch.from_numpy(up), torch.from_numpy(full), rf=rf, n_real=n_real,
        roster=torch.from_numpy(roster), want_rleader=True)
    _assert_outs_equal(got, want)
    assert ((roster < 0) | (roster >= n_real)).any()


def test_plain_node_count_matches_pallas_interpret_and_numpy():
    B, P, n_real = 3, 200, 31
    rng = np.random.default_rng(2)
    recruit = rng.integers(-3, n_real + 4, (B, P)).astype(np.int32)
    recruit[:, :8] = n_real                   # the no-recruit sentinel
    active = rng.random((B, P)) < 0.7
    want_np = rebuild_node_counts_np(recruit, active, n_real=n_real)
    want_pl = np.asarray(ref_pac.node_count(
        jnp.asarray(recruit), jnp.asarray(active), n_real=n_real,
        interpret=True))[:, :n_real]
    got = pac_eval.node_count(torch.from_numpy(recruit),
                              torch.from_numpy(active), n_real=n_real)
    assert got.dtype == torch.int32 and got.shape == (B, n_real)
    assert np.array_equal(got.numpy(), want_np)
    assert np.array_equal(got.numpy(), want_pl)
    ok = active & (recruit >= 0) & (recruit < n_real)
    assert int(got.sum()) == int(ok.sum()) > 0


@pytest.mark.parametrize("with_roster", [False, True],
                         ids=["first-rf", "roster"])
@pytest.mark.parametrize("B,P", [(3, 17), (1, 100)])
def test_plain_counts_mode_matches_pallas_interpret_and_numpy(B, P,
                                                              with_roster):
    """downtime_eval with recruit/active on CPU tensors: the eval of the
    reference's downtime_eval and, last, the counts of its node_count
    (Pallas, interpret mode) and of rebuild_node_counts_np, at a P that
    no tile divides, with the sentinel and other ids outside [0, n_real)
    on active rows."""
    n_real, n_pad, rf = 29, 40, 2
    R = B * P
    rng = np.random.default_rng(B * 1000 + P + with_roster)
    up = rng.random((R, n_pad)) < 0.6
    full = rng.random((R, n_pad)) < 0.4
    up[0] = False
    recruit = rng.integers(-3, n_real + 4, (B, P)).astype(np.int32)
    active = rng.random((B, P)) < 0.6
    recruit[:, :4] = [-1, n_real, n_real + 5, 2 ** 31 - 1]
    active[:, :4] = True
    roster = np.stack([rng.permutation(n_real)[:rf]
                       for _ in range(R)]).astype(np.int32) \
        if with_roster else None
    want = ref_pac.downtime_eval(
        jnp.asarray(up), jnp.asarray(full), rf=rf, n_real=n_real,
        block_p=R, interpret=True,
        roster=None if roster is None else jnp.asarray(roster))
    want_cnt = np.asarray(ref_pac.node_count(
        jnp.asarray(recruit), jnp.asarray(active), n_real=n_real,
        interpret=True))[:, :n_real]
    assert np.array_equal(want_cnt, rebuild_node_counts_np(
        recruit, active, n_real=n_real))
    got = pac_eval.downtime_eval(
        torch.from_numpy(up), torch.from_numpy(full), rf=rf, n_real=n_real,
        roster=None if roster is None else torch.from_numpy(roster),
        recruit=torch.from_numpy(recruit), active=torch.from_numpy(active))
    _assert_outs_equal(got[:-1], want)
    assert got[-1].dtype == torch.int32 and got[-1].shape == (B, n_real)
    assert np.array_equal(got[-1].numpy(), want_cnt)
    assert int(got[-1].sum()) > 0


@pytest.mark.parametrize("with_counts", [False, True],
                         ids=["eval", "counts"])
@pytest.mark.parametrize("with_roster", [False, True],
                         ids=["first-rf", "roster"])
@pytest.mark.parametrize("rf", [2, 3])
def test_plain_fused_downtime_eval_matches_pallas_interpret(
        rf, with_roster, with_counts):
    B, P, n_real = 2, 32, 45
    W = ref_bitpack.n_words(n_real)
    rng = np.random.default_rng(rf * 10 + 2 * with_roster + with_counts)
    upw = _words(rng, (B, W, P))
    upw[0, :, :4] = 0                         # no lane up
    fullw = _words(rng, (B, W, P))
    assert (upw >> 31).any()
    roster = rng.integers(-2, 70, (B, P, rf)).astype(np.int32) \
        if with_roster else None
    recruit = rng.integers(-2, n_real + 3, (B, P)).astype(np.int32)
    active = rng.random((B, P)) < 0.6
    kw = dict(want_repmask=True, want_rleader=with_roster)
    want = ref_fused.fused_downtime_eval(
        jnp.asarray(upw), jnp.asarray(fullw), rf=rf, n_real=n_real,
        block_t=1, block_p=16, interpret=True,
        roster=None if roster is None
        else jnp.asarray(np.moveaxis(roster, -1, 1)),
        recruit=jnp.asarray(recruit) if with_counts else None,
        active=jnp.asarray(active) if with_counts else None, **kw)
    if with_counts:
        want = tuple(want[:-1]) + (np.asarray(want[-1])[:, :n_real],)
    got = fused_step.fused_downtime_eval(
        _as_i32(upw), _as_i32(fullw), rf=rf, n_real=n_real,
        roster=None if roster is None else torch.from_numpy(roster),
        recruit=torch.from_numpy(recruit) if with_counts else None,
        active=torch.from_numpy(active) if with_counts else None, **kw)
    words_at = 5 + 1 + int(with_roster)
    _assert_outs_equal(got, want, words_at=words_at)
    assert got[2][0, 0] == n_real             # leader sentinel


@pytest.mark.parametrize("rf", [2, 3])
def test_packed_and_unpacked_plain_downtime_versions_agree(rf):
    B, P, n_real, n_pad = 3, 16, 45, 64
    rng = np.random.default_rng(rf)
    up = rng.random((B * P, n_pad)) < 0.6
    full = rng.random((B * P, n_pad)) < 0.4
    roster = np.stack([rng.permutation(n_real)[:rf]
                       for _ in range(B * P)]).astype(np.int32)
    kw = dict(rf=rf, n_real=n_real, want_repmask=True, want_rleader=True)
    flat = pac_eval.downtime_eval_plain(
        torch.from_numpy(up), torch.from_numpy(full),
        roster=torch.from_numpy(roster), **kw)

    def words(b):
        return bitpack.pack_words(torch.from_numpy(b).reshape(B, P, n_pad)) \
            .movedim(-1, 1).contiguous()

    packed = fused_step.fused_downtime_eval_plain(
        words(up), words(full),
        roster=torch.from_numpy(roster).reshape(B, P, rf), **kw)
    for f, pk in zip(flat[:-1], packed[:-1]):
        assert torch.equal(pk.reshape(-1), f)
    unpacked = bitpack.unpack_words(packed[-1].movedim(1, -1), n_pad)
    assert torch.equal(unpacked.reshape(B * P, n_pad), flat[-1])


def test_select_bit_matches_reference():
    rng = np.random.default_rng(5)
    planes = [_words(rng, (4, 64)) for _ in range(3)]
    rank = rng.integers(-40, 130, (4, 64)).astype(np.int32)
    want = ref_bitpack.select_bit(planes, rank, np)
    got = bitpack.select_bit([bitpack.to_u32(_as_i32(w)) for w in planes],
                             torch.from_numpy(rank))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_step_eval_downtime_dispatch_and_argument_checks(packed):
    B, P, n, rf = 2, 8, 20, 2
    rng = np.random.default_rng(8)
    up = torch.from_numpy(rng.random((B, P, n)) < 0.7)
    full = torch.from_numpy(rng.random((B, P, n)) < 0.4)
    roster = torch.from_numpy(np.stack(
        [rng.permutation(n)[:rf] for _ in range(B * P)]).astype(np.int32))
    recruit = torch.from_numpy(rng.integers(0, n + 1, (B, P))
                               .astype(np.int32))
    active = torch.from_numpy(rng.random((B, P)) < 0.5)
    if packed:
        u = bitpack.pack_words(up).movedim(-1, 1).contiguous()
        f = bitpack.pack_words(full).movedim(-1, 1).contiguous()
        ro = roster.reshape(B, P, rf)
    else:
        u, f, ro = up.reshape(B * P, n), full.reshape(B * P, n), roster
    spec = ops.StepSpec(metric="downtime", rf=rf, n_real=n,
                        rebuild_model="reconfig", packed=packed)
    o = ops.step_eval(spec, u, f, roster=ro, recruit=recruit,
                      active=active)
    want = downtime_eval_rank_np(
        up.reshape(B * P, n).numpy(), full.reshape(B * P, n).numpy(),
        rf=rf, n_real=n, roster=roster.numpy())
    for got, w in zip((o.lark, o.maj, o.leader, o.leader_full, o.nrep),
                      want[:5]):
        assert np.array_equal(got.reshape(-1).numpy(), w)
    assert np.array_equal(o.counts.numpy(), rebuild_node_counts_np(
        recruit.numpy(), active.numpy(), n_real=n))
    assert o.repmask is None and o.rleader is None
    fixed = ops.StepSpec(metric="downtime", rf=rf, n_real=n, packed=packed)
    with pytest.raises(ValueError, match="reconfig"):
        ops.step_eval(fixed, u, f, roster=ro)
    with pytest.raises(ValueError, match="together"):
        ops.step_eval(spec, u, f, recruit=recruit)


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("downtime_eval", "pac_eval_launch", pac_eval._ARGTYPES),
    ("fused_downtime", "fused_pac_eval_launch", fused_step._ARGTYPES),
    ("downtime_eval", "downtime_eval_launch", pac_eval._DT_ARGTYPES),
    ("downtime_eval", "downtime_roster_launch", pac_eval._DT_ARGTYPES),
    ("downtime_eval", "node_count_launch", pac_eval._NC_ARGTYPES),
    ("downtime_eval", "downtime_eval_counts_launch", pac_eval._DTC_ARGTYPES),
    ("downtime_eval", "downtime_roster_counts_launch",
     pac_eval._DTC_ARGTYPES),
    ("fused_downtime", "fused_downtime_eval_launch",
     fused_step._FDT_ARGTYPES),
])
def test_ctypes_argtypes_match_the_c_launchers(source, symbol, argtypes):
    """Each launcher's ctypes argtypes name its C parameters one for one:
    a pointer or the stream is c_void_p, an int c_int.  (ctypes passes
    surplus arguments as C ints, so a short tuple would cut pointers.)"""
    import ctypes
    import re
    from repro_torch.kernels import _build
    assert source in _build.SOURCES
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    want = tuple(ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params)
    assert tuple(argtypes) == want
