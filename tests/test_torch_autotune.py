"""The port's tile tuners (``repro_torch.kernels.ops``) against the cases of
tests/test_autotune.py and against the reference's tuners: candidate sets
that are pure functions of the shape, pinned at the paper tile and at
n_pad 31 / 63, the same choice from the same candidates, ties toward the
smaller tile, the deterministic CPU fallback, a cache whose kinds never
alias, an injected measure bypassing it; the run-time tile's validation
and the Python mirror of the CUDA sources' tile constants; and the
traffic model ``step_hbm_bytes`` against ``mc_check``'s byte counts.
The kernels themselves run on the card (``chip_smoke.py`` phase 10a,
``tests/test_torch_gpu.py``)."""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core.availability_batched import \
    simulate_availability_batched
from repro_torch.core.client_latency import simulate_client_latency
from repro_torch.core.downtime_batched import simulate_downtime_batched
from repro_torch import bench_gate
from repro_torch.experiments.schema import row_key
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.kernels import _build, fused_step, mc_check, ops, pac_eval

torch.set_num_threads(1)

PAPER = (8 * 4096, 155)
FUSED_PAPER = ((1, 32), (1, 64), (1, 128), (1, 256), (1, 512), (1, 1024),
               (2, 32), (2, 64), (2, 128), (2, 256), (2, 512),
               (4, 32), (4, 64), (4, 128), (4, 256),
               (8, 32), (8, 64), (8, 128))


def _source(name):
    return (_build.CSRC / f"{name}.cu").read_text()


def _constant(text, name):
    m = re.search(rf"constexpr int {name} = ([0-9 *]+);", text)
    return eval(m.group(1))                    # e.g. "100 * 1024"


def test_candidates_are_a_pure_function_of_the_shape():
    a = ops.block_p_candidates(4096, 64)
    assert a == ops.block_p_candidates(4096, 64) and a
    assert all(4096 % bp == 0 for bp in a)
    assert all(pac_eval.row_tile_bytes(bp, 64) <= 100 * 1024 for bp in a)
    f = ops.fused_block_candidates(8, 4096, 160, rf=3,
                                   kernel="fused_downtime_roster")
    assert f == ops.fused_block_candidates(8, 4096, 160, rf=3,
                                           kernel="fused_downtime_roster")
    for bt, bp in f:
        assert 8 % bt == 0 and 4096 % bp == 0
        assert ops.fused_block_registers(bt, bp) <= ops.SM_REGISTERS


@pytest.mark.parametrize("R,n_pad,kernel,want", [
    (*PAPER, "pac", (16, 32, 64, 128)),
    (*PAPER, "downtime", (16, 32, 64, 128)),
    (*PAPER, "downtime_roster", (16, 32, 64, 128)),
    (8 * 128, 31, "pac", (16, 32, 64, 128)),
    (8 * 128, 63, "downtime_roster", (16, 32, 64, 128)),
    (1152, 63, "downtime", (16, 32, 64, 128)),
    (4096, 300, "pac", (16, 32, 64)),          # 128 rows overflow 100 KiB
    (256, 2500, "downtime", (16,)),            # column passes
    (8 * 4093, 155, "pac", (64,)),             # no tile divides R: the
])                                             # plan's own, refused below
def test_block_p_candidates_pinned(R, n_pad, kernel, want):
    assert ops.block_p_candidates(R, n_pad, rf=2, kernel=kernel) == want


@pytest.mark.parametrize("B,P,n_pad,want", [
    (8, 4096, 155, FUSED_PAPER),
    (8, 4096, 31, FUSED_PAPER),
    (8, 4096, 63, FUSED_PAPER),
    (9, 128, 155, ((1, 32), (1, 64), (1, 128))),
    (1, 100, 155, ((1, 128),)),                # P has no divisor from 32
])
def test_fused_block_candidates_pinned(B, P, n_pad, want):
    for kernel in ops.FUSED_KERNELS:
        assert ops.fused_block_candidates(B, P, n_pad, rf=2,
                                          kernel=kernel) == want


def test_register_budget_prunes_the_big_blocks():
    small = ops.fused_block_candidates(
        16, 4096, 155, registers=ops.fused_block_registers(1, 256))
    assert small and max(bt * bp for bt, bp in small) <= 256
    assert max(bt * bp for bt, bp in
               ops.fused_block_candidates(16, 4096, 155)) == 1024


def test_autotune_same_candidates_same_choice():
    fake = lambda R, n, bp: {16: 9.0, 32: 4.0, 64: 4.0, 128: 6.0}[bp]
    kw = dict(rf=3, voters=5, n_real=63, candidates=(16, 32, 64, 128),
              measure=fake)
    r1 = ops.autotune_block_p(1024, 64, **kw)
    r2 = ops.autotune_block_p(1024, 64, **kw)
    assert r1.block_p == r2.block_p == 32       # tie 32/64 -> smaller tile
    assert r1 == r2 and r1.source == "measured"
    assert r1.timings_us[128] == 6.0


def test_autotune_rejects_non_tiling_candidates():
    with pytest.raises(ValueError, match="divide"):
        ops.autotune_block_p(1000, 64, rf=2, voters=3, n_real=63,
                             candidates=(33,), measure=lambda *a: 1.0)
    with pytest.raises(ValueError, match="divide"):     # the plan's own
        ops.autotune_block_p(8 * 4093, 155, rf=2, voters=3, n_real=155,
                             measure=lambda *a: 1.0)
    with pytest.raises(ValueError, match="does not tile"):
        ops.autotune_fused_blocks(4, 64, 64, rf=2, voters=3, n_real=63,
                                  candidates=((3, 32),),
                                  measure=lambda *a: 1.0)


def test_autotune_cpu_fallback_is_deterministic():
    """No measure on the CPU: the kernels' default tiles, never a race."""
    r1 = ops.autotune_block_p(2048, 64, rf=2, voters=3, n_real=63,
                              device="cpu")
    r2 = ops.autotune_block_p(2048, 64, rf=2, voters=3, n_real=63,
                              device="cpu")
    assert r1.source == "heuristic-fallback" and r1.timings_us == {}
    assert r1.block_p == r2.block_p == pac_eval.default_row_tile(2048, 64)
    assert r1.block_p == 16                    # 2048 / 64 < 132 SMs
    assert ops.autotune_block_p(8 * 4096, 155, rf=2, voters=3, n_real=155,
                                device="cpu").block_p == 64
    f1 = ops.autotune_fused_blocks(8, 4096, 155, rf=2, voters=3,
                                   n_real=155, device="cpu")
    f2 = ops.autotune_fused_blocks(8, 4096, 155, rf=2, voters=3,
                                   n_real=155, device="cpu")
    assert (f1.block_t, f1.block_p) == (f2.block_t, f2.block_p) == (1, 128)
    assert f1.source == "heuristic-fallback" and f1.timings_us == {}


def test_force_on_the_cpu_raises():
    with pytest.raises(ValueError, match="no tile to race"):
        ops.autotune_block_p(1024, 64, rf=2, voters=3, n_real=63,
                             device="cpu", force=True)
    with pytest.raises(ValueError, match="no tile to race"):
        ops.autotune_fused_blocks(8, 128, 64, rf=2, voters=3, n_real=63,
                                  device="cpu", force=True)


def test_unknown_kernels_raise():
    with pytest.raises(ValueError, match="autotune kernel"):
        ops.autotune_block_p(512, 64, rf=2, voters=3, n_real=63,
                             kernel="mystery", device="cpu")
    with pytest.raises(ValueError, match="fused autotune kernel"):
        ops.autotune_fused_blocks(4, 64, 64, rf=2, voters=3, n_real=63,
                                  kernel="mystery", device="cpu")
    with pytest.raises(ValueError, match="autotune kernel"):
        ops.race_calls("mystery", (64,), 31, rf=2, voters=3, n_real=31,
                       device=torch.device("cpu"))


def test_kernel_kinds_do_not_alias_in_the_cache():
    """Keys lead with the tuner's tag and the kind, and hold the geometry,
    the candidates and the device's name."""
    ops._AUTOTUNE_CACHE.clear()
    kw = dict(rf=2, voters=3, n_real=63, device="cpu")
    a = ops.autotune_block_p(8 * 512, 64, kernel="pac", **kw)
    b = ops.autotune_block_p(8 * 512, 64, kernel="downtime_roster", **kw)
    f = ops.autotune_fused_blocks(8, 512, 64, kernel="fused_pac", **kw)
    g = ops.autotune_fused_blocks(8, 512, 64, kernel="fused_downtime", **kw)
    keys = list(ops._AUTOTUNE_CACHE)
    assert len(keys) == 4
    assert {k[0] for k in keys} == {"block_p", "fused"}
    assert {k[1] for k in keys} == {"pac", "downtime_roster", "fused_pac",
                                    "fused_downtime"}
    assert all(k[-1] == "cpu" for k in keys)
    assert (a.block_p, b.block_p) == (16, 16)
    assert (f.block_t, f.block_p) == (g.block_t, g.block_p) == (1, 128)


def test_an_injected_measure_bypasses_the_cache():
    ops._AUTOTUNE_CACHE.clear()
    kw = dict(rf=2, voters=3, n_real=63, candidates=(32, 64))
    a = ops.autotune_block_p(512, 64, measure=lambda R, n, bp: float(bp),
                             **kw)
    b = ops.autotune_block_p(512, 64, measure=lambda R, n, bp: -float(bp),
                             **kw)
    fkw = dict(rf=2, voters=3, n_real=63, candidates=((1, 32), (2, 32)))
    f = ops.autotune_fused_blocks(
        4, 64, 64, measure=lambda B, P, n, bt, bp: float(bt), **fkw)
    g = ops.autotune_fused_blocks(
        4, 64, 64, measure=lambda B, P, n, bt, bp: -float(bt), **fkw)
    assert (a.block_p, b.block_p) == (32, 64)
    assert ((f.block_t, f.block_p), (g.block_t, g.block_p)) == \
        ((1, 32), (2, 32))
    assert ops._AUTOTUNE_CACHE == {}


FAKES = [lambda *a: 1.0,                        # all tied
         lambda *a: float(sum(a[-2:])),
         lambda *a: float((a[-1] * 7919) % 13),
         lambda *a: -float(a[-1])]


@pytest.mark.parametrize("fake", range(len(FAKES)))
def test_choices_equal_the_reference_tuners(fake):
    """The same explicit candidates and the same injected measure give the
    reference's choice and timings, in both tuners."""
    measure = FAKES[fake]
    kw = dict(rf=2, voters=3, n_real=155, candidates=(16, 32, 64, 128),
              measure=lambda R, n, bp: measure(R, n, bp))
    got = ops.autotune_block_p(*PAPER, **kw)
    want = ref_ops.autotune_block_p(*PAPER, **kw)
    assert (got.block_p, dict(got.timings_us), got.source) == \
        (want.block_p, dict(want.timings_us), want.source)
    fkw = dict(rf=2, voters=3, n_real=155, candidates=FUSED_PAPER,
               measure=lambda B, P, n, bt, bp: measure(B, P, n, bt, bp))
    got = ops.autotune_fused_blocks(8, 4096, 155, **fkw)
    want = ref_ops.autotune_fused_blocks(8, 4096, 155, **fkw)
    assert (got.block_t, got.block_p, dict(got.timings_us)) == \
        (want.block_t, want.block_p, dict(want.timings_us))


@pytest.mark.parametrize("spec,want", [
    (dict(metric="availability"), (15_302_656, 2_031_616)),
    (dict(metric="downtime"), (15_597_568, 2_326_528)),
    (dict(metric="downtime", rebuild_model="reconfig"),
     (16_028_512, 2_757_472)),
])
def test_step_hbm_bytes_are_mc_checks_byte_counts(spec, want):
    """At the paper tile (B = 8, P = 4096, n = 155, rf = 2): pac_eval and
    fused_pac_eval, downtime_eval and fused_downtime_eval fixed, and both
    with the roster and the counts folded in."""
    s = ops.StepSpec(rf=2, n_real=155, packed=True, **spec)
    hbm = ops.step_hbm_bytes(s, 8, 4096, 155)
    assert (hbm["unfused_bytes"], hbm["fused_bytes"]) == want
    R, W = 8 * 4096, 5
    reconfig = spec.get("rebuild_model") == "reconfig"
    if spec["metric"] == "availability":
        mc = (mc_check.pac_bytes(R, 155), mc_check.fused_pac_bytes(8, W, 4096))
    else:
        mc = (mc_check.downtime_bytes(R, 155, 2 if reconfig else 0,
                                      B=8 if reconfig else 0, n_real=155),
              mc_check.fused_bytes(8, W, 4096, rf=2 if reconfig else 0,
                                   n_real=155, counts=reconfig))
    assert mc == want
    assert hbm["ratio"] == want[0] / want[1]


def test_step_hbm_bytes_count_the_zoo_extras():
    base = ops.step_hbm_bytes(ops.StepSpec(
        metric="downtime", rf=2, n_real=155, rebuild_model="reconfig"),
        8, 4096, 155)
    zoo = ops.step_hbm_bytes(ops.StepSpec(
        metric="downtime", rf=2, n_real=155, rebuild_model="reconfig",
        engines=("hermes", "spinnaker")), 8, 4096, 155)
    for key in ("unfused_bytes", "fused_bytes"):
        assert zoo[key] - base[key] == 2 * 4 * 8 * 4096


def test_python_tile_constants_mirror_the_cuda_sources():
    dt, fd = _source("downtime_eval"), _source("fused_downtime")
    assert (_constant(dt, "kLanes"), _constant(dt, "kMaxRows"),
            _constant(dt, "kTopRows"), _constant(dt, "kMinRows")) == \
        (pac_eval._LANES, pac_eval._MAX_ROWS, pac_eval._TOP_ROWS,
         pac_eval._MIN_ROWS)
    assert (_constant(dt, "kMinBlocks"), _constant(dt, "kBudget"),
            _constant(dt, "kRosterCap"), _constant(dt, "kSlop")) == \
        (pac_eval._MIN_BLOCKS, pac_eval._BUDGET, pac_eval._ROSTER_CAP,
         pac_eval._SLOP)
    assert (_constant(fd, "kThreads"), _constant(fd, "kMaxThreads"),
            _constant(fd, "kMinBlockP"), _constant(fd, "kMaxBlockP"),
            _constant(fd, "kMaxBlockT")) == \
        (fused_step.DEFAULT_BLOCK[1], fused_step.MAX_THREADS,
         fused_step.MIN_BLOCK_P, fused_step.MAX_BLOCK_P,
         fused_step.MAX_BLOCK_T)
    # the named blocks' kernel caps a thread's registers at the count the
    # register budget assumes, which lets the largest block fit an SM
    assert _constant(fd, "kNamedRegs") == ops.FUSED_REGS_PER_THREAD == \
        ops.SM_REGISTERS // fused_step.MAX_THREADS
    assert "__maxnreg__(kNamedRegs)" in fd


@pytest.mark.parametrize("block_p", [8, 33, 48, 256, 4096])
def test_invalid_row_tiles_are_refused(block_p):
    with pytest.raises(ValueError, match="row tile"):
        pac_eval._row_tile(block_p, 8 * 4096, 155, rf=2, roster=False)
    assert pac_eval._row_tile(None, 8 * 4093, 155, rf=2, roster=True) == 0
    assert pac_eval._row_tile(128, 8 * 4096, 155, rf=2, roster=True) == 128
    with pytest.raises(ValueError, match="row tile"):   # column passes
        pac_eval._row_tile(32, 256, 2500, rf=2, roster=False)


@pytest.mark.parametrize("block", [(3, 32), (1, 16), (1, 2048), (2, 1024),
                                   (32, 32), (1, 96), (16, 128)])
def test_invalid_fused_blocks_are_refused(block):
    with pytest.raises(ValueError, match="is not a block"):
        fused_step._block(*block, 8, 4096)
    assert fused_step._block(None, None, 8, 4093) == (0, 0)
    assert fused_step._block(8, None, 8, 4096) == (8, 128)
    assert fused_step._block(None, 1024, 8, 4096) == (1, 1024)


def test_cpu_wrappers_accept_and_ignore_a_tile():
    """On CPU tensors the plain version runs whatever the tile, as the
    reference's non-Pallas backends ignore it."""
    rng = np.random.default_rng(0)
    up = torch.from_numpy(rng.random((100, 31)) < 0.9)
    full = torch.from_numpy(rng.random((100, 31)) < 0.3)
    kw = dict(rf=2, voters=3, n_real=31)
    for a, b in zip(pac_eval.pac_eval(up, full, block_p=33, **kw),
                    pac_eval.pac_eval_plain(up, full, **kw)):
        assert torch.equal(a, b)
    upw = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (3, 1, 50),
                                        dtype=np.int64).astype(np.int32))
    got = fused_step.fused_downtime_eval(upw, upw, rf=2, n_real=31,
                                         block_t=3, block_p=7)
    for a, b in zip(got, fused_step.fused_downtime_eval_plain(
            upw, upw, rf=2, n_real=31)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [False, True])
def test_engines_take_a_tile(packed):
    """pac_block_p / block_t reach the step (accepted and ignored on the
    CPU): the same trajectories as without."""
    kw = dict(n=31, partitions=64, rf=2, p=3e-3, trials=2, max_ticks=4000,
              min_ticks=10, max_steps=24, chunk_steps=8, trajectory=True,
              packed=packed, device="cpu")
    tile = dict(pac_block_p=32, block_t=2 if packed else None)
    a = simulate_availability_batched(**kw)
    b = simulate_availability_batched(**kw, **tile)
    assert a.ticks == b.ticks and a.u_lark == b.u_lark
    assert a.trajectory.keys() == b.trajectory.keys()
    for key in a.trajectory:
        assert np.array_equal(np.asarray(a.trajectory[key]),
                              np.asarray(b.trajectory[key]))
    d = simulate_downtime_batched(**kw, rebuild_model="reconfig")
    e = simulate_downtime_batched(**kw, rebuild_model="reconfig", **tile)
    assert (d.pause_lark, d.pause_quorum) == (e.pause_lark, e.pause_quorum)
    kw.pop("trajectory")
    f = simulate_client_latency(**kw)
    g = simulate_client_latency(**kw, **tile)
    assert (f.lat_lark, f.lat_quorum) == (g.lat_lark, g.lat_quorum)


CONFIGS = sorted((Path(__file__).resolve().parents[1] / "benchmarks" /
                  "configs").glob("*.toml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_bench_gate_autotune_copy_is_the_config_on_pallas(path, tmp_path):
    """bench_gate --autotune runs each config as a copy with backend pallas
    and autotune on, and nothing else changed."""
    copy = tmp_path / path.name
    copy.write_text(bench_gate.tuned_text(path.read_text()))
    got = ExperimentSpec.from_file(str(copy)).canonical()
    want = ExperimentSpec.from_file(str(path)).canonical()
    assert got["backend"] == "pallas" and got["autotune"] is True
    assert {k: v for k, v in got.items() if k not in ("backend",
                                                      "autotune")} == \
        {k: v for k, v in want.items() if k not in ("backend", "autotune")}
    runs = list(bench_gate._runs([path], True, tmp_path, autotune=True))
    assert [r[0] for r in runs] == [f"{path.stem}_autotune",
                                    f"{path.stem}_autotune_packed"]
    assert all(r[2] == path.parents[1] / f"BENCH_{path.stem}.json"
               for r in runs)


def test_the_autotune_row_is_never_gated(tmp_path):
    """The autotune row has no row key.  check_regression --identical
    compares every row in order, so a dump with it fails on the row
    count; bench_gate gates the copy without it, whose rows all equal."""
    spec = importlib.util.spec_from_file_location(
        "check_regression", Path(__file__).resolve().parents[1] /
        "benchmarks" / "check_regression.py")
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    base = json.loads((Path(__file__).resolve().parents[1] / "benchmarks" /
                       "BENCH_downtime_reconfig.json").read_text())
    tuned = {"kind": "autotune", "block_p": 16, "source": "measured",
             "kernel": "downtime_roster", "rf": 2,
             "timings_us": {"16": 1.0}}
    assert row_key(tuned) is None and gate.row_key(tuned) is None
    new = dict(base, rows=[tuned] + base["rows"])
    failures, _ = gate.compare_identical(new, base)
    assert failures[0].startswith("row count differs")
    dump = tmp_path / "tuned.json"
    dump.write_text(json.dumps(new))
    gated = bench_gate.gated_copy(dump)
    assert gated == tmp_path / "tuned.gated.json"
    failures, checked = gate.compare_identical(
        gate.load_rows(str(gated)), base)
    assert failures == [] and checked == len(base["rows"])
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps(base))
    assert bench_gate.gated_copy(plain) == plain
