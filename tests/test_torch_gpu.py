"""The port on the card: each CUDA kernel against its plain PyTorch
version (the Monte Carlo kernels bitwise, ``mlstm_chunkwise``,
``rglru_scan`` and ``flash_attention_fwd`` at stated tolerances, with
their planted faults), the engines (§5.1, §6 with the protocol zoo, and
client latency) on cuda against the same runs on the CPU, and the
reduced xLSTM and recurrentgemma serve paths on cuda against the CPU,
the §5.2 micro-simulator's ``microsim_scan`` bitwise against its plain
tick loop (a table a launch, and both tables in one), and the mLSTM
backward's sm90 source within its allowance.

This file imports neither jax nor repro, so it runs on a machine that
has only torch and a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test is marked ``gpu`` and skips where torch sees no card."""
import numpy as np
import pytest
import torch

from repro_torch.core.availability_batched import \
    simulate_availability_batched
from repro_torch.core.client_latency import simulate_client_latency
from repro_torch.core.downtime_batched import (ENGINES,
                                               simulate_downtime_batched)
from repro_torch.configs import reduced_config
from repro_torch.core import microsim
from repro_torch.kernels import (flash_attention, flash_check, fused_step,
                                 mc_check, microsim_scan, mlstm_check,
                                 mlstm_chunk, pac_eval, rglru_check,
                                 rglru_scan)
from repro_torch.kernels.latency import decay_pow_tables
from repro_torch.models import build_model
from repro_torch.serving import ServeLoop
from repro_torch.models.transformer import tree_map

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


@pytest.mark.parametrize("rf,voters", mc_check.PAC_KNOBS,
                         ids=[f"rf{r}-v{v}" for r, v in mc_check.PAC_KNOBS])
@pytest.mark.parametrize("case", mc_check.DOWNTIME_CASES,
                         ids=[c[0] for c in mc_check.DOWNTIME_CASES])
def test_cuda_pac_eval_edge_cases_match_plain(cuda, case, rf, voters):
    """pac_eval on the edges of downtime_eval.cu's tiling (ragged last
    tiles, n_pad 31 / 63 / 160, views at byte offsets) with voters within
    the first word, across the 32nd lane and past n_real and n_pad."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1000 * rf + voters)
    up, full, _ = mc_check.downtime_inputs(gen, case, 2, cuda)
    kw = dict(rf=rf, voters=voters, n_real=case[3])
    before = pac_eval.pac_eval.launches
    got = pac_eval.pac_eval(up, full, **kw)
    torch.cuda.synchronize()
    assert pac_eval.pac_eval.launches == before + 1
    assert mc_check.same(got, pac_eval.pac_eval_plain(up, full, **kw))


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


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("rf", [2, 4, 30])
@pytest.mark.parametrize("n_pad", [1, 15, 16, 17, 31, 32, 33, 155, 160, 257])
def test_cuda_downtime_eval_matches_plain(cuda, n_pad, rf, layout):
    """Both launchers on the edges of the kernel's tiling: row widths
    around 16-byte and word boundaries, 8 * 131 rows (not a multiple of
    any tile), inputs as views at a byte offset, rf above n_pad, rosters
    with seats out of range, and every want_repmask / want_rleader
    combination, against the plain version bit for bit."""
    rng = np.random.default_rng(rf + 7 * n_pad + (layout == "unaligned"))
    R = 8 * 131
    n_real = max(1, n_pad - 3) if n_pad > 16 else n_pad
    up = torch.from_numpy(rng.random((R, n_pad)) < 0.6)
    up[:3] = False
    full = torch.from_numpy(rng.random((R, n_pad)) < 0.4)
    roster = torch.from_numpy(
        rng.integers(-2, n_pad + 3, (R, rf)).astype(np.int32))
    on_card = [up.to(cuda), full.to(cuda), roster.to(cuda)]
    if layout == "unaligned":
        on_card = [mc_check.view_at(t, o) for t, o in zip(on_card, (3, 9, 4))]
        assert all(t.data_ptr() % 16 != 0 for t in on_card)
    combos = [(False, False, False), (False, True, False),
              (True, False, False), (True, True, False),
              (True, False, True), (True, True, True)]
    for with_roster, repmask, rleader in combos:
        if repmask and rf > 30:
            continue
        kw = dict(rf=rf, n_real=n_real, want_repmask=repmask,
                  want_rleader=rleader)
        before = (pac_eval.downtime_eval.launches,
                  pac_eval.downtime_eval.roster_launches)
        got = pac_eval.downtime_eval(
            on_card[0], on_card[1],
            roster=on_card[2] if with_roster else None, **kw)
        torch.cuda.synchronize()
        after = (pac_eval.downtime_eval.launches,
                 pac_eval.downtime_eval.roster_launches)
        assert after[int(with_roster)] == before[int(with_roster)] + 1
        want = pac_eval.downtime_eval_plain(
            up, full, roster=roster if with_roster else None, **kw)
        assert len(got) == len(want)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), \
            (with_roster, repmask, rleader)


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


@pytest.mark.parametrize("case", mc_check.COUNTS_CASES,
                         ids=[c[0] for c in mc_check.COUNTS_CASES])
def test_cuda_counts_mode_edge_cases_match_plain(cuda, case):
    """downtime_eval's counts mode (first-rf and roster) and node_count
    alone on mc_check's counts cases: tiles across trial boundaries and
    ragged last tiles at 64 and 16 rows, B 1 / 8 / 9, n_real 1 to 300,
    the ids that count nowhere on active rows, every row on node 0; one
    launch each, bit for bit."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(case[1] * case[2])
    n_real = case[4]
    up, full, roster, recruit, active = mc_check.counts_inputs(gen, case, 3)
    want_cnt = pac_eval.node_count_plain(recruit, active, n_real=n_real)
    for with_roster in (False, True):
        kw = dict(rf=3, n_real=n_real, want_repmask=True,
                  want_rleader=with_roster,
                  roster=roster if with_roster else None)
        counter = "roster_counts_launches" if with_roster \
            else "counts_launches"
        before = getattr(pac_eval.downtime_eval, counter)
        got = pac_eval.downtime_eval(up, full, recruit=recruit,
                                     active=active, **kw)
        torch.cuda.synchronize()
        assert getattr(pac_eval.downtime_eval, counter) == before + 1
        assert mc_check.same(
            got, pac_eval.downtime_eval_plain(up, full, **kw) + (want_cnt,)),\
            with_roster
    before = pac_eval.node_count.launches
    got = pac_eval.node_count(recruit, active, n_real=n_real)
    torch.cuda.synchronize()
    assert pac_eval.node_count.launches == before + 1
    assert torch.equal(got, want_cnt)


@pytest.mark.parametrize("config", ["fixed-bw", "skew-bw"])
def test_cuda_unpacked_bandwidth_step_is_one_row_eval_launch(cuda, config):
    """Under shared bandwidth each unpacked step makes exactly one
    row-eval launch, in the counts mode, and node_count never launches:
    one plain launch for the t = 0 eval, then one counts launch a step."""
    kw = dict(n=40, partitions=32, rf=2, p=2e-2, trials=3, max_ticks=4_000,
              min_ticks=10 ** 9, chunk_steps=64, max_steps=128, seed=11,
              trajectory=True, rebuild_steps=30, rebuild_ticks_per_gib=30,
              node_bandwidth_gibps=1.0)
    if config == "skew-bw":
        kw.update(rebuild_model="reconfig", size_dist="zipf", size_skew=1.0)
    dt = pac_eval.downtime_eval
    names = ("launches", "roster_launches", "counts_launches",
             "roster_counts_launches")
    before = [getattr(dt, k) for k in names] + [pac_eval.node_count.launches]
    r = simulate_downtime_batched(device=cuda, **kw)
    torch.cuda.synchronize()
    got = [getattr(dt, k) - b for k, b in zip(names, before)] + \
        [pac_eval.node_count.launches - before[-1]]
    steps = len(r.trajectory["times"])
    plain = steps if config == "fixed-bw" else 0
    assert steps > 0 and got == [1, 0, plain, steps - plain, 0]


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


@pytest.mark.parametrize("rf", [2, 3])
@pytest.mark.parametrize("case", mc_check.FUSED_CASES,
                         ids=[c[0] for c in mc_check.FUSED_CASES])
def test_cuda_fused_downtime_eval_edge_cases_match_plain(cuda, case, rf):
    """fused_downtime_eval at W 1, 5 and 8 (words in registers) and 9 (the
    loop), n_real not a multiple of 32, a ragged P, rosters at an offset
    that rules out the int2 load, recruit ids outside [0, n_real), active
    mixed, all true and all false; first-rf and roster, with and without
    the counts."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(rf)
    upw, fullw, roster, recruit, active = mc_check.fused_inputs(gen, case,
                                                                rf)
    for with_roster in (False, True):
        for counts in (False, True):
            kw = dict(rf=rf, n_real=case[4], want_repmask=True,
                      want_rleader=with_roster,
                      roster=roster if with_roster else None)
            if counts:
                kw.update(recruit=recruit, active=active)
            before = fused_step.fused_downtime_eval.launches
            got = fused_step.fused_downtime_eval(upw, fullw, **kw)
            torch.cuda.synchronize()
            assert fused_step.fused_downtime_eval.launches == before + 1
            assert mc_check.same(
                got, fused_step.fused_downtime_eval_plain(upw, fullw, **kw)), \
                (with_roster, counts)


@pytest.mark.parametrize("case", mc_check.FUSED_PAC_CASES,
                         ids=[c[0] for c in mc_check.FUSED_PAC_CASES])
def test_cuda_fused_pac_eval_edge_cases_match_plain(cuda, case):
    """fused_pac_eval, fused_downtime.cu's pac mode, at W 1, 5 and 8
    (words in registers) and 9 (the loop), n_real not a multiple of 32, a
    ragged P, with voters within the first word, across it and past
    n_real and every word."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(case[2])
    name, Bq, W, Pq, n_real, dens = case
    upw = mc_check.words(gen, (Bq, W, Pq), dens)
    fullw = mc_check.words(gen, (Bq, W, Pq))
    for rf, voters in mc_check.FUSED_PAC_KNOBS:
        kw = dict(rf=rf, voters=voters, n_real=n_real)
        before = fused_step.fused_pac_eval.launches
        got = fused_step.fused_pac_eval(upw, fullw, **kw)
        torch.cuda.synchronize()
        assert fused_step.fused_pac_eval.launches == before + 1
        assert mc_check.same(
            got, fused_step.fused_pac_eval_plain(upw, fullw, **kw)), kw


def test_cuda_mc_check_catches_planted_faults(cuda):
    """Every mc_check case passes on the four Monte Carlo row kernels,
    and each planted fault of their sources fails at least one (pac_eval's
    own a pac_eval case)."""
    assert mc_check.main([]) == 0


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


def _latency_inputs(rng, B, P, NB=4, max_ticks=3_000_000):
    """Adversarial latency_charge inputs: dt with many bits set and 0,
    rem below 0, inside and beyond dt, mixed flags, dirty fractions a few
    ulps around the 1e-30 flush floor.  max_ticks sets the tables (its
    bit length) and caps dt."""
    lam = rng.uniform(0.0, 4.0, P)
    f = np.geomspace(0.001, 1.0, NB)
    f = f / f.sum()
    tabs = decay_pow_tables(lam, np.full(NB, 1.0 / NB), f, 1024, max_ticks)
    dirty = rng.uniform(0.0, 1.0, (B, P, NB)).astype(np.float32)
    near = np.float32(1e-30) + rng.integers(-4, 5, dirty.shape) * \
        np.spacing(np.float32(1e-30))
    dirty = np.where(rng.random(dirty.shape) < 0.3, near, dirty) \
        .astype(np.float32)
    dt = rng.integers(0, max_ticks + 1, B).astype(np.int64)
    dt[:4] = [d & max_ticks for d in
              (0, 0x2AAAAAAA, 0x55555555, 2 ** 21 - 1)]  # 0, many bits set
    dt = dt.astype(np.int32)
    rem = rng.integers(0, min(3 * max_ticks, 2 ** 31 - 1),
                       (B, P)).astype(np.int32)
    rem[:, ::3] = (dt[:, None] * rng.random((B, (P + 2) // 3))) \
        .astype(np.int32)
    rem[:, 1::3] = rng.integers(-50, 0, (B, (P + 1) // 3))
    return dict(dirty=dirty, dt_i=dt, avail=rng.random((B, P)) < 0.7,
                qok=rng.random((B, P)) < 0.7, rem=rem,
                pow_tables=tabs, kf=(1024 * f).astype(np.float32),
                lamw=rng.uniform(0.0, 8.0, P).astype(np.float32))


@pytest.mark.parametrize("nbits", [1, 22, 31])
@pytest.mark.parametrize("nbins", [2, 16, 30])
@pytest.mark.parametrize("NB", [1, 3, 4, 8])
def test_cuda_latency_charge_matches_plain(cuda, NB, nbins, nbits):
    """Every bucket count the kernel instantiates around its 16-byte
    paths, histogram widths, decay chains up to dt with bit 30 set, 4 *
    1031 rows (a ragged last block), dirty and the tables as views at a
    byte offset, both slo_ticks; bit for bit."""
    rng = np.random.default_rng(100 * NB + 10 * nbins + nbits)
    args = {k: torch.from_numpy(v) for k, v in
            _latency_inputs(rng, 4, 1031, NB=NB,
                            max_ticks=2 ** nbits - 1).items()}
    assert args["pow_tables"].shape[0] == nbits
    if nbits == 31:
        assert (args["dt_i"] >> 30).any()
    for layout in ("aligned", "unaligned"):
        on_card = {k: v.to(cuda) for k, v in args.items()}
        if layout == "unaligned":
            for k in ("dirty", "pow_tables"):
                on_card[k] = mc_check.view_at(on_card[k], 4)
        for slo_ticks in (0, 8):
            before = pac_eval.latency_charge.launches
            got = pac_eval.latency_charge(**on_card, nbins=nbins,
                                          slo_ticks=slo_ticks)
            torch.cuda.synchronize()
            assert pac_eval.latency_charge.launches == before + 1
            want = pac_eval.latency_charge_plain(**args, nbins=nbins,
                                                 slo_ticks=slo_ticks)
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), \
                (layout, slo_ticks)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("config", ["fixed", "reconfig-skew-bw"])
def test_cuda_latency_engine_matches_cpu(cuda, config, packed):
    kw = dict(n=40, partitions=32, rf=2, p=2e-2, trials=3, max_ticks=4_000,
              min_ticks=10 ** 9, chunk_steps=64, max_steps=192, seed=11,
              packed=packed, dupres_ticks=4, rebuild_steps=30,
              rebuild_ticks_per_gib=30, write_skew=1.0, slo_curve_bins=5)
    if config != "fixed":
        kw.update(rebuild_model="reconfig", size_dist="zipf", size_skew=1.0,
                  node_bandwidth_gibps=1.0)
    before = pac_eval.latency_charge.launches
    got = simulate_client_latency(device=cuda, **kw)
    assert pac_eval.latency_charge.launches > before
    want = simulate_client_latency(device="cpu", **kw)
    for k, v in want.downtime.latency_raw.items():
        assert np.array_equal(got.downtime.latency_raw[k], v), k
    assert (got.lat_lark, got.lat_quorum, got.p999_quorum,
            got.slo_quorum) == (want.lat_lark, want.lat_quorum,
                                want.p999_quorum, want.slo_quorum)
    assert got.lat_quorum > 0


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_cuda_zoo_engine_matches_cpu(cuda, packed):
    kw = dict(n=40, partitions=32, rf=3, p=2e-2, trials=3, max_ticks=4_000,
              min_ticks=10 ** 9, chunk_steps=64, max_steps=192, seed=11,
              trajectory=True, packed=packed, rebuild_model="reconfig",
              rebuild_ticks_per_gib=30, engines=ENGINES, lease_ticks=40,
              view_change_ticks=200)
    got = simulate_downtime_batched(device=cuda, **kw)
    want = simulate_downtime_batched(device="cpu", **kw)
    for k in want.trajectory:
        assert np.array_equal(got.trajectory[k], want.trajectory[k]), k
    for engine in ENGINES:
        g, w = got.engine_stats(engine), want.engine_stats(engine)
        assert (g["pause"], g["events"]) == (w["pause"], w["events"])
        assert np.array_equal(g["hist"], w["hist"])
    assert want.hermes_events > 0 and want.spinnaker_events > 0


def _mlstm_inputs(rng, B, H, S, Dq, Dv, dtype, device):
    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=dt)
    q, k = (t(rng.standard_normal((B, H, S, Dq))) for _ in range(2))
    v = t(rng.standard_normal((B, H, S, Dv)))
    lf = torch.nn.functional.logsigmoid(
        t(rng.standard_normal((B, H, S)) * 2 + 2, torch.float32))
    li = t(rng.standard_normal((B, H, S)) * 3, torch.float32)
    return q, k, v, lf, li


def _logits_close(got, want, atol, rtol):
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(1.0, want.abs().max().item())
    assert torch.allclose(got, want, atol=atol * scale, rtol=rtol), \
        (got - want).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,S,Dq,Dv,chunk,initial", [
    (2, 2, 256, 64, 64, 64, False),       # whole chunks
    (1, 2, 1000, 32, 48, 256, False),     # ragged tail, Dv off the tile
    (2, 1, 300, 16, 16, 128, True),       # a carried-in state
    (1, 1, 320, 512, 128, 256, False),    # the full width's head dim
    (1, 2, 300, 192, 192, 64, True),      # sm90: Dq off 128, ragged, initial
    (2, 1, 400, 128, 320, 128, False),    # sm90: 64-column Dv blocks
])
def test_cuda_mlstm_chunkwise_matches_plain(cuda, dtype, B, H, S, Dq, Dv,
                                            chunk, initial):
    """Tolerance: every element of h and of the final (C, n, m) within
    what float32 rounding allows (``mlstm_check.mlstm_errors``: 2^-16 of
    h's rounding scale, the same sums over absolute values, plus 2^-7 of
    |h| for one rounding to bf16; 2^-12 of the state's).  The launch goes
    to ``_route``'s source and is counted on that route alone."""
    rng = np.random.default_rng(S + Dq)
    args = _mlstm_inputs(rng, B, H, S, Dq, Dv, dtype, cuda)
    init = None
    if initial:
        init = (torch.randn(B, H, Dq, Dv, device=cuda),
                torch.randn(B, H, Dq, device=cuda),
                torch.randn(B, H, device=cuda))
    fn = mlstm_chunk.mlstm_chunkwise
    route = mlstm_chunk._route(dtype, Dq, Dv, chunk)
    before = (fn.launches, fn.sm90_launches, fn.simt_launches)
    h, state = fn(*args, chunk=chunk, initial=init)
    torch.cuda.synchronize()
    assert (fn.launches, fn.sm90_launches, fn.simt_launches) == (
        before[0] + 1, before[1] + (route == "sm90"),
        before[2] + (route == "simt"))
    assert h.dtype == dtype and h.shape == (B, H, S, Dv)
    (want_h, want_state), scales = mlstm_check.reference(args, chunk, init)
    errs = mlstm_check.mlstm_errors(h, state, want_h, want_state, scales)
    assert all(e <= 1.0 for e in errs.values()), errs
    # deterministic: no atomics, so a second launch is bitwise the first
    h2, state2 = fn(*args, chunk=chunk, initial=init)
    assert torch.equal(h, h2) and all(torch.equal(a, b)
                                      for a, b in zip(state, state2))


def test_cuda_mlstm_check_catches_planted_faults(cuda):
    """The card-side cases at the serve width pass on both of the
    kernel's sources, and each planted fault of ``mlstm_check.FAULTS``
    fails at least one of them."""
    assert mlstm_check.main() == 0


def test_cuda_reduced_serve_matches_cpu(cuda):
    """The reduced xlstm serve path on cuda (kernel) against the CPU
    (plain): prefill logits at a 300-token prompt (two chunks, ragged) to
    rtol 1e-3 / atol 1e-3 of the largest logit, and equal greedy tokens."""
    cfg = reduced_config("xlstm_350m")
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model["init_params"](gen)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 300))
    batch = {"tokens": tok.astype(np.int32)}
    lc, _ = model["prefill"](params, {"tokens": torch.from_numpy(
        batch["tokens"])})
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    fn = mlstm_chunk.mlstm_chunkwise
    before = (fn.launches, fn.simt_launches)
    lg, _ = model["prefill"](gpu_params, {"tokens": torch.from_numpy(
        batch["tokens"]).to(cuda)})
    # the reduced config is float32: the simt route
    assert (fn.launches, fn.simt_launches) == (before[0] + 7, before[1] + 7)
    _logits_close(lg, lc, 1e-3, 1e-3)
    got = ServeLoop(cfg, params, device=cuda).generate(batch, steps=8)
    want = ServeLoop(cfg, params, device="cpu").generate(batch, steps=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,kind", [
    (2, 256, 128, "uniform"),       # whole chunks
    (1, 300, 100, "model"),         # ragged S and W
    (2, 1000, 4096, "long"),        # the full width, a -> 1
    (1, 77, 33, "short"),           # one ragged chunk, a -> 0
])
def test_cuda_rglru_scan_matches_plain(cuda, dtype, B, S, W, kind):
    """Tolerance: every element within ``rglru_check.rglru_allowance`` of
    the plain version in float64 (the recurrence over |b|, run over 2^-20
    of it per step plus b's rounding where 1 - exp(2 log_a) cancels); any
    input type, output float32; a second launch is bitwise the first."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S + W)
    x, la = rglru_check.rglru_inputs(gen, B, S, W, kind)
    x = x.to(dtype)
    before = rglru_scan.rglru_scan.launches
    h = rglru_scan.rglru_scan(x, la)
    torch.cuda.synchronize()
    assert rglru_scan.rglru_scan.launches == before + 1
    assert h.dtype == torch.float32 and h.shape == (B, S, W)
    want, allowed = rglru_check.reference(x, la)
    assert rglru_check.rglru_error(h, want, allowed) <= 1.0
    assert torch.equal(h, rglru_scan.rglru_scan(x, la))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,Sq,Sk,D,Dv,causal,window", [
    (1, 2, 128, 128, 64, 64, True, 0),
    (2, 3, 200, 200, 32, 32, True, 48),      # ragged tiles, a window
    (1, 2, 64, 192, 64, 32, True, 0),        # Sq < Sk: left-aligned
    (1, 1, 192, 64, 32, 32, True, 32),       # rows no key may attend
    (1, 2, 130, 130, 256, 256, False, 0),    # the full head dim, no mask
    # bf16 of these takes the sm90 source
    (1, 2, 200, 200, 128, 128, True, 48),    # ragged tiles, a window
    (1, 2, 64, 300, 128, 128, True, 0),      # Sq < Sk: left-aligned
    (1, 2, 300, 64, 256, 256, True, 32),     # rows no key may attend
    (2, 2, 333, 333, 256, 256, True, 100),   # ragged q and k tiles
    (1, 2, 700, 700, 64, 64, False, 300),    # a window, not causal
    (1, 1, 1, 1, 64, 64, True, 0),           # one position
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, B, H, Sq, Sk, D, Dv,
                                            causal, window):
    """Tolerance: every element within ``flash_check``'s allowance of the
    plain version on float64 copies (2^-16 of the same sums over absolute
    values, plus 2^-7 |o| for bf16's rounding); rows no key may attend
    give 0; a second launch is bitwise the first; the launch went to the
    source that ``_route`` names for the dtype and head dims."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(Sq + Sk + D)
    q = torch.randn((B, H, Sq, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, H, Sk, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, H, Sk, Dv), generator=gen, device=cuda).to(dtype)
    fwd = flash_attention.flash_attention_fwd
    route = flash_attention._route(dtype, D, Dv)
    counts = (fwd.launches, fwd.sm90_launches, fwd.simt_launches)
    o = fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.sm90_launches, fwd.simt_launches) == (
        counts[0] + 1, counts[1] + (route == "sm90"),
        counts[2] + (route == "simt"))
    assert o.dtype == dtype and o.shape == (B, H, Sq, Dv)
    want, allowed = flash_check.reference(q, k, v, causal=causal,
                                          window=window)
    assert flash_check.flash_error(o, want, allowed) <= 1.0
    assert torch.equal(o, flash_attention.flash_attention_fwd(
        q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("check", [rglru_check, flash_check],
                         ids=["rglru", "flash"])
def test_cuda_rglru_and_flash_checks_catch_planted_faults(cuda, check):
    """The card-side cases at the serve width pass on each kernel's
    source, and each planted fault of ``FAULTS`` fails at least one."""
    assert check.main() == 0


def test_cuda_reduced_recurrentgemma_serve_matches_cpu(cuda):
    """A 5-layer reduced recurrentgemma (the remainder segment included)
    on cuda (kernel) against the CPU (plain): prefill logits at a 48-token
    prompt over the 32-token window to rtol 1e-3 / atol 1e-3 of the
    largest logit, 4 rglru_scan launches per prefill, and equal greedy
    tokens."""
    cfg = reduced_config("recurrentgemma_9b").replace(num_layers=5)
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model["init_params"](gen)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))
    batch = {"tokens": tok.astype(np.int32)}
    lc, _ = model["prefill"](params, {"tokens": torch.from_numpy(
        batch["tokens"])}, 56)
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    before = rglru_scan.rglru_scan.launches
    lg, _ = model["prefill"](gpu_params, {"tokens": torch.from_numpy(
        batch["tokens"]).to(cuda)}, 56)
    assert rglru_scan.rglru_scan.launches == before + 4
    _logits_close(lg, lc, 1e-3, 1e-3)
    got = ServeLoop(cfg, params, max_len=56, device=cuda).generate(batch,
                                                                  steps=8)
    want = ServeLoop(cfg, params, max_len=56, device="cpu").generate(
        batch, steps=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table", sorted(microsim.TABLES))
@pytest.mark.parametrize("case", [c[0] for c in microsim_scan.CASES])
def test_cuda_microsim_scan_matches_plain(cuda, case, table):
    """All 12 grid rows, LARK and baseline, every output bitwise; the
    short case also on the CPU's plain loop (cuda and cpu agree)."""
    _, ticks, fail_t, recover_t, scale = next(
        c for c in microsim_scan.CASES if c[0] == case)
    if case == "paper_constants":
        ticks = 2100
    x = microsim_scan.case_configs(table, scale, cuda)
    with microsim_scan.outage(fail_t, recover_t):
        before = microsim_scan.microsim_scan.launches
        got = microsim_scan.microsim_scan(*x, ticks=ticks)
        torch.cuda.synchronize()
        assert microsim_scan.microsim_scan.launches == before + 1
        want = microsim_scan.microsim_scan(*(c.cpu() for c in x),
                                           ticks=ticks)
    for mode in microsim_scan.MODES:
        for k, w in want[mode].items():
            assert torch.equal(got[mode][k].cpu(), w), (mode, k)


def test_cuda_microsim_both_tables_in_one_launch(cuda):
    """Both tables' grids in one launch (each table's own Threefry
    counters) equal the CPU's plain loop table by table, bitwise."""
    tables = sorted(microsim.TABLES)
    per = [microsim_scan.case_configs(t, 1.0, "cpu") for t in tables]
    both = [torch.cat(cs) for cs in zip(*per)]
    before = microsim_scan.microsim_scan.launches
    got = microsim_scan.microsim_scan(*(c.to(cuda) for c in both),
                                      ticks=2100, rows_per_table=12)
    torch.cuda.synchronize()
    assert microsim_scan.microsim_scan.launches == before + 1
    for i, cs in enumerate(per):
        want = microsim_scan.microsim_scan(*cs, ticks=2100)
        for mode in microsim_scan.MODES:
            for k, w in want[mode].items():
                assert torch.equal(got[mode][k][12 * i:12 * (i + 1)].cpu(),
                                   w), (i, mode, k)


@pytest.mark.parametrize("S,kind,Dq,Dv,L", [
    (512, "gates", 128, 192, 128), (300, "clamp", 128, 192, 128),
    (500, "stress", 320, 64, 192),        # 64-row S and dP tiles
    (1100, "gates", 64, 64, 1024),        # 32 positions a lane in the gates
])
def test_cuda_mlstm_bwd_sm90_matches_plain(cuda, S, kind, Dq, Dv, L):
    """The bf16 backward at 64-multiple head dims takes the sm90 source,
    within ``mlstm_check``'s allowance of the float64 plain backward,
    and repeats bitwise."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S)
    args = mlstm_check.mlstm_bwd_inputs(gen, 1, 2, S, Dq, Dv,
                                        torch.bfloat16, kind)
    assert mlstm_chunk.bwd_route(torch.bfloat16, Dq, Dv, L) == "sm90"
    before = mlstm_chunk.mlstm_chunkwise_bwd.sm90_launches
    got = mlstm_chunk.mlstm_chunkwise_bwd(*args, chunk=L)
    again = mlstm_chunk.mlstm_chunkwise_bwd(*args, chunk=L)
    torch.cuda.synchronize()
    assert mlstm_chunk.mlstm_chunkwise_bwd.sm90_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want, scales = mlstm_check.bwd_reference((*args, L))
    errs = mlstm_check.mlstm_bwd_errors(got, want, scales)
    assert max(errs.values()) <= 1.0, errs
