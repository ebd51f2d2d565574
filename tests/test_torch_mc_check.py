"""The check of the Monte Carlo row kernels, repro_torch.kernels.mc_check,
on the CPU: its planted faults and timing copies name text that occurs
once in the CUDA sources, its byte counts at the paper tile, the cases it
gives the card, and the bit tricks of csrc/downtime_eval.cu in plain
Python.  Also the plain downtime_eval's repmask when rf exceeds n_pad,
against the Pallas kernel in interpret mode.  tests/test_torch_gpu.py
runs the kernels themselves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pac_eval as ref_pac
from repro_torch.kernels import _build, mc_check, pac_eval

FAULT_CASES = [(src, f) for src, faults in mc_check.FAULTS.items()
               for f in faults]
ABLATION_CASES = [(src, a) for src, variants in mc_check.ABLATIONS.items()
                  for a in variants]


def _source(src):
    return (_build.CSRC / f"{src}.cu").read_text()


@pytest.mark.parametrize("src,fault", FAULT_CASES,
                         ids=[f"{s}-{f}" for s, f in FAULT_CASES])
def test_each_fault_text_occurs_once_in_its_source(src, fault):
    old, new = mc_check.FAULTS[src][fault]
    assert old != new
    assert _source(src).count(old) == 1


@pytest.mark.parametrize("src,variant", ABLATION_CASES,
                         ids=[f"{s}-{a}" for s, a in ABLATION_CASES])
def test_each_ablation_text_occurs_once_in_its_source(src, variant):
    text = _source(src)
    for old, new in mc_check.ABLATIONS[src][variant]:
        assert old != new
        assert text.count(old) == 1


def test_every_source_has_its_launchers():
    for src, symbols in mc_check.SYMBOLS.items():
        assert src in _build.SOURCES
        for sym in symbols:
            assert f'extern "C" int {sym}(' in _source(src)


@pytest.mark.parametrize("what,want", [
    ("downtime_eval", 15_597_568),
    ("downtime_eval_roster", 15_859_712),
    ("latency_charge", 4_735_024),
])
def test_byte_counts_at_the_paper_tile(what, want):
    R = 8 * 4096
    got = {"downtime_eval": mc_check.downtime_bytes(R, 155),
           "downtime_eval_roster": mc_check.downtime_bytes(R, 155, 2),
           "latency_charge": mc_check.latency_bytes(8, 4096, 4, 16, 9)}
    assert got[what] == want


def test_tables_touched_counts_the_bits_of_the_or_below_nbits():
    assert mc_check.tables_touched([1, 256, 3], 22) == 3
    assert mc_check.tables_touched([0, 0], 22) == 0
    assert mc_check.tables_touched([2 ** 30], 22) == 0
    assert mc_check.tables_touched([2 ** 30], 31) == 1
    # the timed shape: intervals in [1, 400) touch at most 9 tables
    assert mc_check.tables_touched(range(1, 400), 22) == 9


def test_cases_reach_the_edges_of_the_tiling():
    cases = mc_check.DOWNTIME_CASES
    assert {31, 63} <= {c[2] for c in cases}
    assert any(c[3] < c[2] for c in cases)              # padding columns
    assert all(c[1] % 16 for c in cases)                # ragged last tiles
    assert any(all(o % 16 for o in c[5]) for c in cases)
    lat = mc_check.LATENCY_CASES
    assert any((b * p) % 128 for _, b, p, _, _ in lat)
    assert any(off % 16 for _, _, _, off, _ in lat)
    assert {0, 8} <= {slo for *_, slo in lat}


@pytest.mark.parametrize("dtype,offset", [(torch.bool, 3), (torch.int32, 4),
                                          (torch.float32, 12),
                                          (torch.bool, 0)])
def test_view_at_is_a_contiguous_copy_at_the_offset(dtype, offset):
    t = (torch.arange(60) % 3).to(dtype).reshape(6, 10)
    v = mc_check.view_at(t, offset)
    assert v.data_ptr() % 16 == offset
    assert v.is_contiguous() and v.dtype == dtype
    assert torch.equal(v, t)


def test_rosters_hold_distinct_ranks_and_seats_out_of_range():
    gen = torch.Generator()
    gen.manual_seed(0)
    ro = mc_check.rosters(gen, 77, 3, 31, "cpu")
    assert ro.shape == (77, 3) and ro.dtype == torch.int32
    assert (ro[::7, 0] == 34).all() and (ro[::11, 2] == -1).all()
    inside = (ro >= 0) & (ro < 31)
    assert inside.float().mean() > 0.8
    for row in ro.tolist():
        seats = [r for r in row if 0 <= r < 31]
        assert len(seats) == len(set(seats))


def _set_lanes(x):
    """csrc/downtime_eval.cu set_lanes, in Python."""
    return (((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080


def test_set_lanes_flags_exactly_the_nonzero_bytes():
    rng = np.random.default_rng(0)
    for b in range(256):                      # each byte value, each place
        for place in range(4):
            others = int(rng.integers(0, 2 ** 32)) & ~(0xFF << 8 * place)
            x = others | (b << 8 * place)
            flags = _set_lanes(x)
            for i in range(4):
                byte = (x >> 8 * i) & 0xFF
                assert ((flags >> 8 * i) & 0xFF) == (0x80 if byte else 0)


def test_repmask_packing_spreads_four_lane_flags_into_four_bits():
    for pattern in range(16):
        mine = sum(0x80 << 8 * i for i in range(4) if pattern >> i & 1)
        assert (((mine >> 7) * 0x01020408) & 0xFFFFFFFF) >> 24 == pattern


@pytest.mark.parametrize("n_pad,rf", [(1, 2), (3, 5), (17, 30)])
def test_plain_repmask_with_rf_above_n_pad_matches_the_pallas_kernel(
        n_pad, rf):
    """bit j of repmask is lane j < rf up; with rf > n_pad only the
    n_pad lanes there are can be set (the Pallas kernel's lanes < rf)."""
    rng = np.random.default_rng(n_pad + rf)
    up = rng.random((32, n_pad)) < 0.6
    full = rng.random((32, n_pad)) < 0.4
    want = ref_pac.downtime_eval(jnp.asarray(up), jnp.asarray(full), rf=rf,
                                 n_real=n_pad, block_p=32, interpret=True,
                                 want_repmask=True)
    got = pac_eval.downtime_eval(torch.from_numpy(up),
                                 torch.from_numpy(full), rf=rf,
                                 n_real=n_pad, want_repmask=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
