"""The check of the Monte Carlo row kernels, repro_torch.kernels.mc_check,
on the CPU: its planted faults and timing copies name text that occurs
once in the CUDA sources, its launchers' ctypes argtypes, its byte counts
at the paper tile, the cases it gives the card, and the bit tricks of
csrc/downtime_eval.cu in plain Python.  Also the plain downtime_eval's
repmask when rf exceeds n_pad, and the plain fused_downtime_eval at the
W of mc_check's cases, against the Pallas kernels in interpret mode.
tests/test_torch_gpu.py runs the kernels themselves."""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_step as ref_fused
from repro.kernels import pac_eval as ref_pac
from repro_torch.kernels import _build, fused_step, mc_check, pac_eval

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
        assert len(mc_check.ARGTYPES[src]) == len(symbols)
        for sym in symbols:
            assert f'extern "C" int {sym}(' in _source(src)


LAUNCHERS = [(src, sym) for src, syms in mc_check.SYMBOLS.items()
             for sym in syms]


@pytest.mark.parametrize("src,symbol", LAUNCHERS,
                         ids=[s for _, s in LAUNCHERS])
def test_launcher_argtypes_name_the_c_parameters(src, symbol):
    """mc_check's argtypes of each launcher are its C parameters one for
    one (pointers and the stream c_void_p, ints c_int)."""
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", _source(src),
                  re.S)
    want = tuple(ctypes.c_void_p if "*" in prm else ctypes.c_int
                 for prm in m.group(1).split(","))
    assert tuple(mc_check.argtypes_of(symbol)) == want


def test_pac_eval_launch_lives_in_downtime_eval_with_the_wrapper_argtypes():
    assert not (_build.CSRC / "pac_eval.cu").exists()
    assert "pac_eval" not in _build.SOURCES
    assert mc_check.argtypes_of("pac_eval_launch") == pac_eval._ARGTYPES
    assert 'extern "C" int pac_eval_launch(' in _source("downtime_eval")


def test_parent_sources_find_each_timed_launcher(tmp_path):
    """A checkout where pac_eval, fused_pac_eval or node_count had a
    source of its own times that source's launcher; this tree's finds the
    three row launchers, the two counts launchers and node_count in
    downtime_eval.cu and both fused ones in fused_downtime.cu."""
    here = mc_check.parent_sources(_build.CSRC)
    assert here["downtime_eval"] == ("pac_eval_launch",
                                     "downtime_eval_launch",
                                     "downtime_roster_launch",
                                     "downtime_eval_counts_launch",
                                     "downtime_roster_counts_launch",
                                     "node_count_launch")
    assert here["fused_downtime"] == ("fused_pac_eval_launch",
                                      "fused_downtime_eval_launch")
    assert "fused_step" not in here and "node_count" not in here
    (tmp_path / "pac_eval.cu").write_text(
        'extern "C" int pac_eval_launch(const void* up);\n')
    (tmp_path / "downtime_eval.cu").write_text(
        'extern "C" int downtime_eval_launch(int R);\n'
        'extern "C" int downtime_roster_launch(int R);\n')
    (tmp_path / "node_count.cu").write_text(
        'extern "C" int node_count_launch(const void* recruit,\n'
        '                                 int n_real, void* stream);\n')
    (tmp_path / "fused_step.cu").write_text(
        'extern "C" int fused_pac_eval_launch(const void* upw,\n'
        '                                     int voters, void* stream);\n')
    (tmp_path / "fused_downtime.cu").write_text(
        'extern "C" int fused_downtime_eval_launch(\n    int rf);\n')
    assert mc_check.parent_sources(tmp_path) == {
        "downtime_eval": ("downtime_eval_launch", "downtime_roster_launch"),
        "pac_eval": ("pac_eval_launch",),
        "node_count": ("node_count_launch",),
        "fused_step": ("fused_pac_eval_launch",),
        "fused_downtime": ("fused_downtime_eval_launch",)}


def test_fused_pac_eval_launch_lives_in_fused_downtime_with_its_argtypes():
    assert not (_build.CSRC / "fused_step.cu").exists()
    assert "fused_step" not in _build.SOURCES
    assert mc_check.argtypes_of("fused_pac_eval_launch") == \
        fused_step._ARGTYPES
    assert 'extern "C" int fused_pac_eval_launch(' in \
        _source("fused_downtime")
    assert mc_check.TIMED["fused_pac_eval"] == "fused_pac_eval_launch"


def test_pac_faults_are_downtime_eval_faults_a_pac_case_can_fail():
    assert set(mc_check.PAC_FAULTS) < set(mc_check.FAULTS["downtime_eval"])
    assert "seat_out_of_range_up" not in mc_check.PAC_FAULTS
    assert "voters_off_by_one" in mc_check.PAC_FAULTS
    assert set(mc_check.DOWNTIME_FAULTS) | set(mc_check.PAC_FAULTS) | \
        set(mc_check.COUNTS_FAULTS) == set(mc_check.FAULTS["downtime_eval"])
    assert "voters_off_by_one" not in mc_check.DOWNTIME_FAULTS
    assert not set(mc_check.COUNTS_FAULTS) & (
        set(mc_check.DOWNTIME_FAULTS) | set(mc_check.PAC_FAULTS))


def test_counts_faults_plant_each_way_the_counts_can_go_wrong():
    """The counts mode's six faults: the sentinel counted, active
    ignored, the trial of the tile's first row, a group adding 1, the
    memset dropped, a ragged last tile's rows dropped."""
    assert set(mc_check.COUNTS_FAULTS) == {
        "count_id_le_n_real", "count_active_ignored", "count_trial_of_tile",
        "count_group_size_one", "count_memset_dropped",
        "count_ragged_tile_dropped"}


def test_counts_launchers_and_node_count_live_in_downtime_eval():
    assert not (_build.CSRC / "node_count.cu").exists()
    assert "node_count" not in _build.SOURCES
    syms = mc_check.SYMBOLS["downtime_eval"]
    assert syms[mc_check.COUNTS] == "downtime_eval_counts_launch"
    assert syms[mc_check.COUNTS + 1] == "downtime_roster_counts_launch"
    assert syms[mc_check.NODE_COUNT] == "node_count_launch"
    assert mc_check.argtypes_of("node_count_launch") == pac_eval._NC_ARGTYPES
    for sym in syms[mc_check.COUNTS:mc_check.NODE_COUNT]:
        assert mc_check.argtypes_of(sym) == pac_eval._DTC_ARGTYPES
    # the parent's symbols of the step pairs keep their C signatures
    for parent_sym, change_sym in mc_check.STEP_PAIRS.values():
        assert mc_check.argtypes_of(parent_sym) == pac_eval._DT_ARGTYPES
        assert change_sym in syms


def test_fused_pac_faults_are_fused_downtime_faults_a_pac_case_can_fail():
    faults = set(mc_check.FAULTS["fused_downtime"])
    assert set(mc_check.FUSED_PAC_FAULTS) < faults
    assert {"last_word_unmasked", "loop_word_stride",
            "voters_one_lane_long"} == set(mc_check.FUSED_PAC_FAULTS)
    assert set(mc_check.FUSED_DOWNTIME_FAULTS) | \
        set(mc_check.FUSED_PAC_FAULTS) == faults
    assert "voters_one_lane_long" not in mc_check.FUSED_DOWNTIME_FAULTS


def test_missed_faults_names_fused_pac_faults_no_fused_pac_case_failed():
    caught = {"fused_downtime": {f: ["fused_downtime_eval:w9_n270"]
                                 for f in mc_check.FAULTS["fused_downtime"]}}
    caught["fused_downtime"]["voters_one_lane_long"] = [
        "fused_pac_eval:w1_n31"]
    caught["fused_downtime"]["last_word_unmasked"] = [
        "fused_pac_eval:w5_n155_ragged", "fused_downtime_eval:w1_n31"]
    missed = mc_check.missed_faults(caught)
    assert missed == ["loop_word_stride (fused_pac_eval)"]


def test_missed_faults_names_pac_faults_no_pac_case_failed():
    caught = {"downtime_eval": {f: ["downtime_eval:n31"]
                                for f in mc_check.FAULTS["downtime_eval"]},
              "fused_downtime": {"loop_word_stride": ["fused_downtime_eval:"
                                                      "w9_n270"],
                                 "word_select_next": []}}
    caught["downtime_eval"]["voters_off_by_one"] = ["pac_eval:n31"]
    caught["downtime_eval"]["seat_out_of_range_up"] = []
    missed = mc_check.missed_faults(caught)
    assert "word_select_next" in missed
    assert "seat_out_of_range_up" in missed
    assert "voters_off_by_one (pac_eval)" not in missed
    assert "creps_rank_lt (pac_eval)" in missed
    assert "seat_out_of_range_up (pac_eval)" not in missed


@pytest.mark.parametrize("what,want", [
    ("downtime_eval", 15_597_568),
    ("downtime_eval_roster", 15_859_712),
    ("downtime_eval_counts", 15_766_368),
    ("downtime_eval_roster_counts", 16_028_512),
    ("node_count", 168_800),
    ("latency_charge", 4_735_024),
    ("pac_eval", 15_302_656),
    ("fused_downtime_eval", 2_757_472),
    ("fused_downtime_eval_fixed", 2_326_528),
    ("fused_pac_eval", 2_031_616),
])
def test_byte_counts_at_the_paper_tile(what, want):
    R = 8 * 4096
    got = {"downtime_eval": mc_check.downtime_bytes(R, 155),
           "downtime_eval_roster": mc_check.downtime_bytes(R, 155, 2),
           "downtime_eval_counts": mc_check.downtime_bytes(
               R, 155, B=8, n_real=155),
           "downtime_eval_roster_counts": mc_check.downtime_bytes(
               R, 155, 2, B=8, n_real=155),
           "node_count": mc_check.counts_bytes(8, 4096, 155),
           "latency_charge": mc_check.latency_bytes(8, 4096, 4, 16, 9),
           "pac_eval": mc_check.pac_bytes(R, 155),
           "fused_downtime_eval": mc_check.fused_bytes(
               8, 5, 4096, rf=2, n_real=155, counts=True),
           "fused_downtime_eval_fixed": mc_check.fused_bytes(8, 5, 4096),
           "fused_pac_eval": mc_check.fused_pac_bytes(8, 5, 4096)}
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


def _tile_rows(R, n_pad):
    """csrc/downtime_eval.cu make_plan's T for a one-pass tile, in
    Python: 64 rows, halved to 16 while the three row buffers overflow
    100 KiB or the tiles leave some of the 132 SMs idle."""
    def tile(T):
        return 3 * ((T * n_pad + 32 + 15) & ~15)
    T = 64
    while T > 16 and (tile(T) > 100 * 1024 or (R + T - 1) // T < 132):
        T //= 2
    return T


def test_counts_cases_reach_the_edges_of_the_counts():
    """Tiles across trial boundaries and ragged last tiles at T 64 and
    16, B 1 / 8 / 9, n_real 1 / 31 / 155 / 300, n_pad 31 and 63, every
    row on node 0, active all false and all true."""
    cases = mc_check.COUNTS_CASES
    assert {4096, 4095, 100, 17} <= {c[2] for c in cases}
    assert {1, 8, 9} <= {c[1] for c in cases}
    assert {1, 31, 155, 300} <= {c[4] for c in cases}
    assert {31, 63} <= {c[3] for c in cases}
    assert all(c[4] <= c[3] for c in cases)
    assert {"zero", "mixed"} == {c[5] for c in cases}
    assert {"mixed", "all", "none"} == {c[6] for c in cases}
    def T(c):
        return _tile_rows(c[1] * c[2], c[3])

    assert {T(c) for c in cases} == {16, 64}
    straddle = [c for c in cases if c[1] > 1 and c[2] % T(c)]
    assert {T(c) for c in straddle} == {16, 64}
    ragged = [c for c in cases if (c[1] * c[2]) % T(c)]
    assert {T(c) for c in ragged} == {16, 64}


@pytest.mark.parametrize("case", mc_check.COUNTS_CASES,
                         ids=[c[0] for c in mc_check.COUNTS_CASES])
def test_counts_inputs_hold_what_the_case_names(case):
    gen = torch.Generator()
    gen.manual_seed(2)
    name, Bq, Pq, n_pad, n_real, ids, act = case
    up, full, roster, recruit, active = mc_check.counts_inputs(gen, case, 2)
    assert up.shape == full.shape == (Bq * Pq, n_pad)
    assert roster.shape == (Bq * Pq, 2) and roster.dtype == torch.int32
    assert recruit.shape == active.shape == (Bq, Pq)
    assert recruit.dtype == torch.int32 and active.dtype == torch.bool
    if act == "none":
        assert not active.any()
    elif act == "all":
        assert active.all()
    if ids == "zero":
        assert (recruit == 0).all()
    else:
        flat_r, flat_a = recruit.reshape(-1), active.reshape(-1)
        for edge in mc_check.EDGE_IDS:
            hit = flat_r == edge(n_real)
            assert hit.any()
            if act != "none":
                assert (flat_a & hit).any()
    counts = pac_eval.downtime_eval(up, full, rf=2, n_real=n_real,
                                    recruit=recruit, active=active)[-1]
    assert torch.equal(counts, pac_eval.node_count_plain(recruit, active,
                                                         n_real=n_real))
    assert (int(counts.sum()) > 0) == (act != "none")


def test_pac_knobs_reach_the_voters_edges():
    knobs = mc_check.PAC_KNOBS
    voters = {v for _, v in knobs}
    assert {3, 31, 33} <= voters                        # in, at, across 32
    assert {2, 3, 4, 30} <= {rf for rf, _ in knobs}
    cases = mc_check.DOWNTIME_CASES
    # voters past n_real but inside n_pad, and past n_pad
    assert any(c[3] < v < c[2] for c in cases for v in voters)
    assert any(v > c[2] for c in cases for v in voters)
    assert any(v > 32 and v < c[3] for c in cases for v in voters)
    assert any(c[5][0] % 16 and c[5][1] % 16 for c in cases)  # unaligned


def test_fused_cases_reach_the_edges_of_the_register_path():
    cases = mc_check.FUSED_CASES
    assert {1, 5, 8, 9} <= {c[2] for c in cases}        # W; 9 is the loop
    assert any(c[2] > 8 for c in cases)
    assert all(c[4] <= 32 * c[2] for c in cases)
    assert any(c[4] % 32 for c in cases if c[2] <= 8)   # a padded last word
    assert any(c[4] % 32 for c in cases if c[2] > 8)
    assert any(c[3] % 128 for c in cases)               # ragged P
    assert {"mixed", "all", "none"} <= {c[6] for c in cases}
    assert any(c[7] % 8 for c in cases)                 # no int2 rosters


def test_fused_pac_cases_reach_the_voters_edges_and_the_loop():
    cases = mc_check.FUSED_PAC_CASES
    knobs = mc_check.FUSED_PAC_KNOBS
    assert {1, 5, 8, 9} <= {c[2] for c in cases}        # W; 9 is the loop
    assert all(c[4] <= 32 * c[2] for c in cases)
    assert any(c[4] % 32 for c in cases if c[2] <= 8)   # a padded last word
    assert any(c[4] % 32 for c in cases if c[2] > 8)
    assert any(c[3] % 128 for c in cases)               # ragged P
    voters = {v for _, v in knobs}
    assert {3, 31, 33} <= voters                        # in, at, across 32
    for case in cases:                                  # past n_real, and
        assert any(v > case[4] for v in voters)         # past every word
        assert any(v > 32 * case[2] for v in voters)
        assert any(32 < v < case[4] for v in voters) or case[4] <= 33
    assert any(rf > 4 for rf, _ in knobs)


@pytest.mark.parametrize("case", mc_check.FUSED_CASES[:2],
                         ids=[c[0] for c in mc_check.FUSED_CASES[:2]])
def test_fused_inputs_hold_what_the_case_names(case):
    gen = torch.Generator()
    gen.manual_seed(1)
    name, Bq, W, Pq, n_real, dens, act, off = case
    upw, fullw, roster, recruit, active = mc_check.fused_inputs(gen, case, 3)
    assert upw.shape == fullw.shape == (Bq, W, Pq)
    assert upw.dtype == torch.int32
    assert not upw[0, :, :5].any()
    assert roster.shape == (Bq, Pq, 3) and roster.data_ptr() % 16 == off
    assert ((recruit < 0) | (recruit >= n_real)).any()
    assert active.any() and not active.all()
    assert (upw < 0).any()                              # bit 31 set


@pytest.mark.parametrize("W,n_real", [(1, 31), (9, 270)])
def test_plain_fused_downtime_eval_at_the_cases_w_matches_pallas(W, n_real):
    """The plain version that mc_check holds the kernel against, at a
    one-word and a loop-path W, against the Pallas kernel in interpret
    mode: roster, counts and extras on."""
    B, P, rf = 2, 16, 3
    rng = np.random.default_rng(W)
    upw = rng.integers(0, 2 ** 32, (B, W, P), dtype=np.uint64) \
        .astype(np.uint32)
    fullw = rng.integers(0, 2 ** 32, (B, W, P), dtype=np.uint64) \
        .astype(np.uint32)
    upw[0, :, :3] = 0
    roster = rng.integers(-2, n_real + 3, (B, P, rf)).astype(np.int32)
    recruit = rng.integers(-2, n_real + 3, (B, P)).astype(np.int32)
    active = rng.random((B, P)) < 0.5
    want = ref_fused.fused_downtime_eval(
        jnp.asarray(upw), jnp.asarray(fullw), rf=rf, n_real=n_real,
        block_t=1, block_p=16, interpret=True,
        roster=jnp.asarray(np.moveaxis(roster, -1, 1)),
        recruit=jnp.asarray(recruit), active=jnp.asarray(active),
        want_repmask=True, want_rleader=True)
    got = fused_step.fused_downtime_eval(
        torch.from_numpy(upw.view(np.int32)),
        torch.from_numpy(fullw.view(np.int32)), rf=rf, n_real=n_real,
        roster=torch.from_numpy(roster), recruit=torch.from_numpy(recruit),
        active=torch.from_numpy(active), want_repmask=True,
        want_rleader=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if i == 7:                                      # crepsw
            assert np.array_equal(g.numpy().view(np.uint32), w)
        elif i == 8:                                    # counts, padded
            assert np.array_equal(g.numpy(), w[:, :n_real])
        else:
            assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("W,n_real,rf,voters", [(1, 31, 3, 33),
                                                (9, 270, 4, 33),
                                                (9, 257, 2, 300)])
def test_plain_fused_pac_eval_at_the_cases_w_matches_pallas(W, n_real, rf,
                                                            voters):
    """The plain version that mc_check holds the pac mode against, at a
    one-word and a loop-path W with voters across a word and past n_real,
    against the Pallas fused_pac_eval in interpret mode."""
    B, P = 2, 16
    rng = np.random.default_rng(W + voters)
    upw = rng.integers(0, 2 ** 32, (B, W, P), dtype=np.uint64) \
        .astype(np.uint32)
    fullw = rng.integers(0, 2 ** 32, (B, W, P), dtype=np.uint64) \
        .astype(np.uint32)
    upw[0, :, :3] = 0
    want = ref_fused.fused_pac_eval(
        jnp.asarray(upw), jnp.asarray(fullw), rf=rf, voters=voters,
        n_real=n_real, block_t=1, block_p=16, interpret=True)
    got = fused_step.fused_pac_eval(
        torch.from_numpy(upw.view(np.int32)),
        torch.from_numpy(fullw.view(np.int32)), rf=rf, voters=voters,
        n_real=n_real)
    assert len(got) == len(want) == 3
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy().view(np.uint32),
                          np.asarray(want[2]))


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
