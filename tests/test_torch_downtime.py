"""The port's §6 commit-pause engine against the reference, bitwise.

``simulate_downtime_batched(device="cpu", trajectory=True)`` must
reproduce the reference's numpy backend (and, on the i.i.d. model, its
jax backend) exactly — every result field and every trajectory column —
for the fixed and reconfig rebuild models, with and without shared
rebuild bandwidth, packed and unpacked, for the i.i.d. model and every
registered scenario.  The zero-knob limits, a mid-run restart through
``carry_from_numpy`` and the host-side size tables are pinned too."""
import math

import numpy as np
import pytest
import torch

from repro.core import availability_batched as RA
from repro.core import client_latency as RC
from repro.core import downtime_batched as R
from repro.core.scenarios import get_scenario, scenario_names
from repro.kernels.ops import StepSpec as RefStepSpec
from repro.kernels.ops import _rebuild_node_counts_impl
from repro.kernels.ops import step_eval as ref_step_eval
from repro_torch.core import availability_batched as TA
from repro_torch.core import downtime_batched as T

# the tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N = 13
#: small enough for the CPU, busy enough that every state machine moves:
#: p = 2e-2 fails a node about every 50 ticks, and the 30-tick rebuilds
#: complete inside the 64-step window
KW = dict(n=N, partitions=16, rf=2, p=2e-2, trials=2, max_ticks=4_000,
          min_ticks=10 ** 9, chunk_steps=32, max_steps=64, seed=11,
          trajectory=True, dupres_ticks=2, rebuild_steps=30,
          rebuild_ticks_per_gib=30)

CONFIGS = {
    "fixed": {},
    "fixed-bw": dict(node_bandwidth_gibps=1.0),
    "reconfig": dict(rebuild_model="reconfig"),
    "skew-bw": dict(rebuild_model="reconfig", size_dist="zipf",
                    size_skew=1.0, node_bandwidth_gibps=1.0),
}

_FIELDS = ("p", "rf", "n", "partitions", "trials", "ticks", "pause_lark",
           "pause_quorum", "lark_events", "quorum_events", "ci_lark",
           "ci_quorum", "dupres_ticks", "rebuild_steps", "stopped_early",
           "devices", "rebuild_model", "rebuild_ticks_per_gib", "size_dist",
           "size_skew", "node_bandwidth_gibps", "engines", "lease_ticks",
           "view_change_ticks", "availability_ratio")
_ARRAYS = ("hist_edges", "hist_lark", "hist_quorum", "pause_lark_trials",
           "pause_quorum_trials")


def _assert_same(want, got):
    assert set(want.trajectory) == set(got.trajectory)
    for k in want.trajectory:
        assert want.trajectory[k].dtype == got.trajectory[k].dtype, k
        assert np.array_equal(want.trajectory[k], got.trajectory[k]), k
    for f in _FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    for f in _ARRAYS:
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and np.array_equal(w, g), f


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("scenario", ["iid", *scenario_names()])
def test_trajectories_match_reference(scenario, config, packed):
    kw = dict(KW, packed=packed, **CONFIGS[config])
    if scenario != "iid":
        kw.update(get_scenario(scenario).kwargs(n=N, rf=2, p=2e-2))
    got = T.simulate_downtime_batched(device="cpu", **kw)
    assert got.trajectory["times"].shape == (64, 2)
    assert got.lark_events > 0 and got.quorum_events > 0
    backends = ("numpy", "jax") if scenario == "iid" else ("numpy",)
    for backend in backends:
        _assert_same(R.simulate_downtime_batched(backend=backend, **kw),
                     got)


@pytest.mark.parametrize("config", ["fixed-bw", "skew-bw"])
def test_unpacked_bandwidth_step_counts_in_its_one_row_eval(config,
                                                            monkeypatch):
    """Under shared bandwidth an unpacked step makes one row-eval call,
    which also returns the in-flight counts, and never calls node_count
    alone; the run is the reference's."""
    from repro_torch.kernels import pac_eval
    calls = []
    row_eval = pac_eval.downtime_eval

    def counted(*a, **kw):
        calls.append(kw.get("recruit") is not None)
        return row_eval(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("node_count called apart from the row eval")

    monkeypatch.setattr(pac_eval, "downtime_eval", counted)
    monkeypatch.setattr(pac_eval, "node_count", refused)
    kw = dict(KW, **CONFIGS[config])
    got = T.simulate_downtime_batched(device="cpu", **kw)
    steps = len(got.trajectory["times"])
    assert calls == [False] + [True] * steps   # the t=0 eval, then steps
    _assert_same(R.simulate_downtime_batched(backend="numpy", **kw), got)


@pytest.mark.parametrize("rf,p,seed", [(2, 3e-3, 0), (3, 8e-3, 3)])
def test_zero_knobs_degenerate_to_instantaneous_integrals(rf, p, seed):
    """dupres_ticks=0 makes LARK's pause the instantaneous PAC
    unavailability, and rebuild_steps=0 makes the quorum baseline plain
    majority-of-replica-set availability (voters=rf) — exactly, on the
    port as on the reference."""
    kw = dict(n=11, partitions=16, p=p, trials=2, max_ticks=1_500,
              min_ticks=10 ** 9, chunk_steps=32, max_steps=200, seed=seed,
              trajectory=True, device="cpu")
    dt = T.simulate_downtime_batched(rf=rf, dupres_ticks=0, rebuild_steps=0,
                                     **kw)
    av = TA.simulate_availability_batched(rf=rf, voters=rf, **kw)
    assert dt.pause_lark == av.u_lark
    assert dt.pause_quorum == av.u_maj
    assert np.array_equal(dt.pause_lark_trials, av.u_lark_trials)
    assert np.array_equal(dt.pause_quorum_trials, av.u_maj_trials)
    assert np.array_equal(dt.trajectory["times"], av.trajectory["times"])
    assert np.array_equal(dt.trajectory["paused_lark"],
                          av.trajectory["unavail_lark"])
    assert np.array_equal(dt.trajectory["paused_quorum"],
                          av.trajectory["unavail_maj"])
    assert dt.lark_events == av.lark_events
    assert dt.quorum_events == av.maj_events


def test_infinite_bandwidth_is_the_unshared_model_bit_for_bit():
    kw = dict(KW, rebuild_model="reconfig", device="cpu")
    base = T.simulate_downtime_batched(**kw)
    expl = T.simulate_downtime_batched(size_dist="uniform",
                                       node_bandwidth_gibps=math.inf, **kw)
    _assert_same(base, expl)
    assert base.node_bandwidth_gibps == math.inf
    assert base.size_skew == 0.0          # knob inert under uniform


@pytest.mark.parametrize("hist_bins", [2, 16, 30])
def test_hist_add_matches_reference(hist_bins):
    """Durations at, just below and far above every bucket edge, zero and
    negative ones (dropped), and int32's top."""
    rng = np.random.default_rng(hist_bins)
    edges = (1 << np.arange(31, dtype=np.int64)).clip(max=2 ** 31 - 1)
    d = np.concatenate([edges, edges - 1, [0, -1, -7, 2 ** 31 - 1],
                        rng.integers(-5, 2 ** 31 - 1, 100)]) \
        .astype(np.int32)
    d = np.stack([d, d[::-1]])
    mask = rng.random(d.shape) < 0.8
    hist = rng.integers(0, 50, (2, hist_bins)).astype(np.int32)
    want = R._hist_add(np, hist_bins, hist, mask, d)
    got = T._hist_add(hist_bins, torch.from_numpy(hist),
                      torch.from_numpy(mask), torch.from_numpy(d))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dist,skew", [("uniform", 1.0), ("zipf", 1.2),
                                       ("lognormal", 0.8), ("zipf", 0.0)])
def test_size_tables_match_reference(dist, skew):
    want = R.partition_sizes_gib(7, 300, dist=dist, skew=skew)
    got = T.partition_sizes_gib(7, 300, dist=dist, skew=skew)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    for tpg, cap in ((100, None), (37, 120), (0, None)):
        w = R._partition_rebuild_ticks(7, 300, tpg, dist=dist, skew=skew,
                                       cap=cap)
        g = T._partition_rebuild_ticks(7, 300, tpg, dist=dist, skew=skew,
                                       cap=cap)
        assert g.dtype == np.int32 and np.array_equal(g, w)
    u = np.linspace(0.0, 1.0, 1001)
    assert np.array_equal(T._norm_ppf(u), R._norm_ppf(u))


#: the restart test runs 40 nodes, so holder word 1 has a live bit 31
NC = 40
_RESTART = dict(n=NC, P=16, B=2, horizon=4_000, seed=5, p=2e-2, rf=2)


def _ref_engine(packed, bandwidth):
    """The reference numpy engine's reconfig step and t=0 carry, as its
    simulate_downtime_batched assembles them."""
    c = _RESTART
    n, P, B, rf = c["n"], c["P"], c["B"], c["rf"]
    (xp, succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     _, _) = RA._engine_setup(
        "numpy", n=n, partitions=P, seed=c["seed"], p=c["p"], downtime=10,
        p_node=None, downtime_node=None, max_ticks=c["horizon"])
    spec = RefStepSpec(metric="downtime", rf=rf, n_real=n,
                       rebuild_model="reconfig", packed=packed)

    def dt_fn(u, f, roster=None, recruit=None, active=None):
        o = ref_step_eval(spec, u, f, roster=roster, recruit=recruit,
                          active=active, backend="numpy")
        base = (o.lark, o.maj, o.leader, o.leader_full, o.nrep, o.creps)
        return (base + (o.counts,)) if recruit is not None else base

    advance = RA._make_node_advance(
        np, n=n, horizon=c["horizon"], dt_vec=dt_vec, geo_masks=geo_masks,
        geo_tables=geo_tables, seed_mix=seed_mix, pair_fail_prob=0.0,
        pair_perm=pair_perm, restart_period=0, wave_width=1)
    step = R._make_step(
        np, dt_fn, advance, succ, n=n, P=P, rf=rf, dupres_ticks=2,
        rebuild_steps=30, hist_bins=16, rebuild_model="reconfig",
        rebuild_ticks=R._partition_rebuild_ticks(
            c["seed"], P, 30, dist="zipf", cap=c["horizon"] + 1)
        * np.int32(R._REB_SCALE),
        bandwidth_fp=bandwidth, packed=packed,
        cnt_fn=lambda rec, act: _rebuild_node_counts_impl(
            rec, act, n_real=n, backend="numpy"))
    lane0, up0, ev0, rr_t0 = RA._initial_node_state(
        np, B=B, n=n, seed_mix=seed_mix, geo_masks=geo_masks,
        geo_tables=geo_tables, restart_period=0, horizon=c["horizon"])
    full0, outs0 = RA._initial_full_state(
        np, "numpy", dt_fn, up0, succ, B=B, P=P, n=n, rf=rf, packed=packed)
    zi, zf = np.zeros(B, np.int32), np.zeros(B, np.float32)
    zbp, zh = np.zeros((B, P), np.int32), np.zeros((B, 16), np.int32)
    carry = (zi, up0, ev0, full0, rr_t0, zi, lane0,
             ~outs0[0].reshape(B, P), zbp, up0[:, succ[:, :rf]], zbp,
             ~outs0[1].reshape(B, P), zbp,
             outs0[2].reshape(B, P).astype(np.int32), zf, zf, zi, zi, zh,
             zh,
             np.ascontiguousarray(np.broadcast_to(
                 np.arange(rf, dtype=np.int32), (B, P, rf))),
             np.full((B, P), n, np.int32))
    return step, carry


def _port_step(packed, bandwidth):
    c = _RESTART
    n, P, rf = c["n"], c["P"], c["rf"]
    (succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     _, _) = TA._engine_setup(
        n=n, partitions=P, seed=c["seed"], p=c["p"], downtime=10,
        p_node=None, downtime_node=None, max_ticks=c["horizon"],
        device="cpu")
    spec = T.StepSpec(metric="downtime", rf=rf, n_real=n,
                      rebuild_model="reconfig", packed=packed)

    def dt_fn(u, f, roster=None, recruit=None, active=None):
        o = T.step_eval(spec, u, f, roster=roster, recruit=recruit,
                        active=active)
        base = (o.lark, o.maj, o.leader, o.leader_full, o.nrep, o.creps)
        return (base + (o.counts,)) if recruit is not None else base

    advance = TA._make_node_advance(
        n=n, horizon=c["horizon"], dt_vec=dt_vec, geo_masks=geo_masks,
        geo_tables=geo_tables, seed_mix=seed_mix, pair_fail_prob=0.0,
        pair_perm=pair_perm, restart_period=0, wave_width=1)
    return T._make_step(
        dt_fn, advance, succ, n=n, P=P, rf=rf, dupres_ticks=2,
        rebuild_steps=30, hist_bins=16, rebuild_model="reconfig",
        rebuild_ticks=torch.from_numpy(T._partition_rebuild_ticks(
            c["seed"], P, 30, dist="zipf", cap=c["horizon"] + 1)
            * np.int32(T._REB_SCALE)),
        bandwidth_fp=bandwidth, packed=packed)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_mid_run_restart_from_reference_carry(packed):
    """A reconfig carry with shared bandwidth (zipf sizes, 1 GiB/s),
    taken from the reference mid-run, continues on the port exactly as on
    the reference; the exchange keeps every leaf's dtype."""
    bandwidth = R._REB_SCALE                  # 1 GiB/s in work units
    ref_step, carry = _ref_engine(packed, bandwidth)
    carry, _ = RA._run_chunk_numpy(ref_step, carry, 1, 64)     # mid-run
    want_carry, want_ys = RA._run_chunk_numpy(ref_step, carry, 65, 96)
    assert len(carry) == 22
    assert (carry[10] > 0).any() and (carry[21] < NC).any()   # in flight

    tcarry = T.carry_from_numpy(carry, device="cpu")
    assert tcarry[20].dtype == torch.int32 and tcarry[21].dtype == \
        torch.int32                           # roster, recruit stay int32
    if packed:
        assert tcarry[3].dtype == torch.int32
    back = T.carry_to_numpy(tcarry)
    for a, b in zip(carry, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    got_carry, got_ys = TA._run_chunk(_port_step(packed, bandwidth), tcarry,
                                      65, 96)
    for w, g in zip(want_ys, got_ys):
        assert np.array_equal(w, g)
    for w, g in zip(want_carry, T.carry_to_numpy(got_carry)):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert int(want_ys[2].sum()) > 0          # quorum pauses happened


@pytest.mark.parametrize("kw,item", [
    (dict(engines=("lark", "quorum", "hermes"), lease_ticks=20), "item 7"),
    (dict(engines=("lark", "quorum", "spinnaker"), rebuild_model="reconfig",
          view_change_ticks=3), "item 7"),
    (dict(_disable_predicates=("roster-recruit",),
          rebuild_model="reconfig"), "item 7"),
    (dict(_lat_plan=True), "item 8"),
])
def test_unported_knobs_raise(kw, item):
    """These knobs raised NotImplementedError, naming ROADMAP Queue 1
    `item`, until the protocol zoo (item 7) and the client-latency layer
    (item 8) were ported.  They run now, and give the reference's run."""
    kw = dict(KW, **kw)
    if kw.get("_lat_plan"):
        kw["_lat_plan"] = RC.make_latency_plan(
            KW["seed"], KW["partitions"], R.DowntimeParams(
                key_zipf=1.0, read_frac=0.5, requests_per_tick=8.0,
                slo_ticks=1), KW["max_ticks"])
    want = R.simulate_downtime_batched(backend="numpy", **kw)
    got = T.simulate_downtime_batched(device="cpu", **kw)
    _assert_same(want, got)
    for engine in want.engines:
        w, g = want.engine_stats(engine), got.engine_stats(engine)
        assert all(np.array_equal(w[k], g[k]) for k in w), (item, engine)
    if want.latency_raw is not None:
        assert all(np.array_equal(v, got.latency_raw[k])
                   for k, v in want.latency_raw.items())
        assert want.latency_raw["qsum"].sum() > 0
