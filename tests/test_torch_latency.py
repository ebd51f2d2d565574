"""The port's client-latency layer against the reference, bitwise.

``latency_charge_plain`` (the CPU path of the CUDA kernel) must equal
the reference's jnp decay chain followed by the Pallas
``latency_charge`` in interpret mode, and its numpy
``latency_step_ref``; the host workload tables must equal the
reference's arrays; ``simulate_client_latency(device="cpu")`` must equal
the reference's numpy backend field for field on four models (fixed,
fixed with shared bandwidth, reconfig, packed), with write skew and SLO
curves live; the zero-knob and percentile pins are mirrored; and a run
restarts mid-way from a carry that the reference produced."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import availability_batched as RA
from repro.core import client_latency as RC
from repro.core import downtime_batched as RD
from repro.kernels import latency as RL
from repro.kernels import ops as ROPS
from repro.kernels import pac_eval as RPK
from repro_torch.core import availability_batched as TA
from repro_torch.core import client_latency as TC
from repro_torch.core import downtime_batched as TD
from repro_torch.kernels import latency as TL
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import pac_eval as TPK

# the tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _inputs(seed, B, P, *, rem_hi, max_ticks=3_000_000):
    """Adversarial latency_charge inputs: dt with many bits set and 0,
    rem below 0, inside and beyond dt (up to rem_hi), mixed flags, dirty
    fractions a few ulps around the 1e-30 flush floor."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.0, 4.0, P)
    f, g = RC.key_bucket_shares(1.0)
    tabs = RL.decay_pow_tables(lam, g, f, 1024, max_ticks)
    dirty = rng.uniform(0.0, 1.0, (B, P, 4)).astype(np.float32)
    near = np.float32(1e-30) + rng.integers(-4, 5, dirty.shape) * \
        np.spacing(np.float32(1e-30))
    dirty = np.where(rng.random(dirty.shape) < 0.3, near, dirty) \
        .astype(np.float32)
    dt = rng.integers(0, max_ticks + 1, B).astype(np.int32)
    dt[:4] = 0, 0x2AAAAA, 0x155555, 2 ** 21 - 1        # 0, many bits set
    rem = rng.integers(0, rem_hi, (B, P)).astype(np.int32)
    rem[:, ::3] = (np.minimum(dt, rem_hi)[:, None] *
                   rng.random((B, (P + 2) // 3))).astype(np.int32)
    rem[:, 1::3] = rng.integers(-50, 0, (B, (P + 1) // 3))
    return dict(dirty=dirty, dt_i=dt, avail=rng.random((B, P)) < 0.7,
                qok=rng.random((B, P)) < 0.7, rem=rem, pow_tables=tabs,
                kf=(1024 * f).astype(np.float32),
                lamw=rng.uniform(0.0, 8.0, P).astype(np.float32))


def _port(a):
    out = TPK.latency_charge_plain(
        **{k: torch.from_numpy(v) for k, v in a.items()
           if k not in ("nbins", "slo_ticks")},
        nbins=a["nbins"], slo_ticks=a["slo_ticks"])
    return [o.numpy() for o in out]


@pytest.mark.parametrize("slo_ticks", [0, 8])
def test_plain_kernel_matches_pallas_interpret(slo_ticks):
    """Against the reference's Pallas path: the jnp decay chain, then
    ``latency_charge`` interpreted on (B·P) rows.  rem stays below 4096,
    so every product pay·rem is exact in float32 (XLA may contract the
    reference's qsum expression into an FMA inside the kernel body, which
    only an inexact product exposes)."""
    B, P, nbins = 8, 40, 16
    a = dict(_inputs(slo_ticks, B, P, rem_hi=4096), nbins=nbins,
             slo_ticks=slo_ticks)
    got = _port(a)
    R = B * P
    dec = RL.decay_from_dt(jnp.asarray(a["dt_i"]),
                           jnp.asarray(a["pow_tables"]), jnp)
    want = RPK.latency_charge(
        jnp.asarray(a["dirty"].reshape(R, 4)), dec.reshape(R, 4),
        jnp.asarray(a["avail"].reshape(R)), jnp.asarray(a["qok"].reshape(R)),
        jnp.asarray(a["rem"].reshape(R)),
        jnp.asarray(np.repeat(a["dt_i"], P)),
        jnp.asarray(np.tile(a["lamw"], B)), jnp.asarray(a["kf"]),
        nbins=nbins, slo_ticks=slo_ticks, interpret=True)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).reshape(g.shape), g)
    assert (got[1] > 0).any() and (got[2] > 0).any()


@pytest.mark.parametrize("slo_ticks", [0, 8])
@pytest.mark.parametrize("rem_hi", [4096, 9_000_000])
def test_plain_kernel_matches_numpy_reference(slo_ticks, rem_hi):
    a = _inputs(100 + slo_ticks, 8, 40, rem_hi=rem_hi)
    want = RL.latency_step_ref(**a, nbins=16, slo_ticks=slo_ticks, xp=np)
    got = _port(dict(a, nbins=16, slo_ticks=slo_ticks))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    # the ops entry point is the same call, in the reference's shapes
    ops = TOPS.client_latency_step(
        *(torch.from_numpy(a[k]) for k in ("dirty", "dt_i", "avail", "qok",
                                           "rem")),
        pow_tables=torch.from_numpy(a["pow_tables"]),
        kf=torch.from_numpy(a["kf"]), lamw=torch.from_numpy(a["lamw"]),
        nbins=16, slo_ticks=slo_ticks)
    assert [o.shape for o in ops] == [(8, 40, 4), (8, 40, 4), (8, 40, 16),
                                      (8, 40), (8, 40)]
    assert all(np.array_equal(o.numpy(), w) for o, w in zip(ops, want))


def test_kernel_wrapper_checks_its_arguments():
    a = {k: torch.from_numpy(v) for k, v in
         _inputs(3, 4, 8, rem_hi=100).items()}
    with pytest.raises(ValueError, match="rem"):
        TPK.latency_charge(**dict(a, rem=a["rem"].to(torch.int64)),
                           nbins=16, slo_ticks=0)
    with pytest.raises(ValueError, match="lamw"):
        TPK.latency_charge(**dict(a, lamw=a["lamw"][:4]), nbins=16,
                           slo_ticks=0)
    meta = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        TPK.latency_charge(**meta, nbins=16, slo_ticks=0)
    before = TPK.latency_charge.launches
    TPK.latency_charge(**a, nbins=16, slo_ticks=0)
    assert TPK.latency_charge.launches == before     # plain path: no launch


@pytest.mark.parametrize("seed,P", [(0, 1), (7, 64), (123, 300)])
def test_host_tables_match_reference(seed, P):
    for zipf in (0.0, 0.5, 1.0, 2.5):
        want = RC.partition_request_weights(seed, P, key_zipf=zipf,
                                            keys_per_partition=64)
        got = TC.partition_request_weights(seed, P, key_zipf=zipf,
                                           keys_per_partition=64)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for w, g in zip(RC.key_bucket_shares(zipf),
                        TC.key_bucket_shares(zipf)):
            assert np.array_equal(w, g)
    for read_frac, skew in ((0.8, 0.0), (0.8, 1.5), (0.3, 4.0),
                            (1.0, 2.0), (0.0, 1.0)):
        want = RC.partition_write_fractions(seed, P, read_frac=read_frac,
                                            write_skew=skew)
        got = TC.partition_write_fractions(seed, P, read_frac=read_frac,
                                           write_skew=skew)
        assert np.array_equal(got, want)
    lam = np.random.default_rng(seed).uniform(0, 40, P)
    f, g = RC.key_bucket_shares(1.0)
    for max_ticks in (1, 40_000, 3_000_000):
        want = RL.decay_pow_tables(lam, g, f, 1024, max_ticks)
        got = TL.decay_pow_tables(lam, g, f, 1024, max_ticks)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    params = RD.DowntimeParams(key_zipf=1.2, read_frac=0.7,
                               requests_per_tick=16.0, slo_ticks=3,
                               write_skew=2.0)
    want = RC.make_latency_plan(seed, P, params, 50_000)
    got = TC.make_latency_plan(seed, P, TD.DowntimeParams(
        **dataclasses.asdict(params)), 50_000)
    for f_ in dataclasses.fields(want):
        w, g = getattr(want, f_.name), getattr(got, f_.name)
        assert np.array_equal(np.asarray(w), np.asarray(g)), f_.name
    assert (TC._KEY_SALT, TC._WRITE_SALT, TC.KEYS_PER_PARTITION,
            TC.N_KEY_BUCKETS, TC.LATENCY_QUANTILES) == \
        (RC._KEY_SALT, RC._WRITE_SALT, RC.KEYS_PER_PARTITION,
         RC.N_KEY_BUCKETS, RC.LATENCY_QUANTILES)


#: small but failure-rich (the reference's own latency test tile)
_KW = dict(n=6, rf=2, p=2e-4, partitions=64, trials=4, max_ticks=12_000,
           min_ticks=12_000, chunk_steps=64, seed=3,
           dupres_ticks=4, requests_per_tick=8.0, key_zipf=1.0,
           read_frac=0.8, slo_ticks=2)

MODELS = {
    "fixed": dict(write_skew=1.5, slo_curve_bins=6),
    "fixed-bw": dict(node_bandwidth_gibps=1.0, slo_curve_bins=4),
    "reconfig": dict(rebuild_model="reconfig", write_skew=0.7),
    "packed": dict(packed=True, rebuild_model="reconfig", size_dist="zipf",
                   node_bandwidth_gibps=1.0, write_skew=2.0,
                   slo_curve_bins=3),
}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.asarray(a).dtype == np.asarray(b).dtype and \
            np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("model", list(MODELS))
def test_latency_matches_reference(model):
    kw = dict(_KW, **MODELS[model])
    want = RC.simulate_client_latency(backend="numpy", **kw)
    got = TC.simulate_client_latency(device="cpu", **kw)
    assert got.device == "cpu" and got.lat_quorum > 0 and got.lat_lark > 0
    for f in dataclasses.fields(want):
        if f.name in ("backend", "downtime"):
            continue
        assert _same(getattr(want, f.name), getattr(got, f.name)), f.name
    raw_w, raw_g = want.downtime.latency_raw, got.downtime.latency_raw
    assert raw_w.keys() == raw_g.keys()
    assert ("dupw" in raw_g) == bool(kw.get("write_skew"))
    for k in raw_w:
        assert _same(raw_w[k], raw_g[k]), k
    assert (got.downtime.pause_lark, got.downtime.pause_quorum) == \
        (want.downtime.pause_lark, want.downtime.pause_quorum)


def test_zero_knob_limit_exactly_zero():
    r = TC.simulate_client_latency(device="cpu", **{
        **_KW, "dupres_ticks": 0, "key_zipf": 0.0, "read_frac": 1.0})
    for col in ("lat_lark", "lat_quorum", "lat_hermes",
                "p50_lark", "p99_lark", "p999_lark",
                "p50_quorum", "p99_quorum", "p999_quorum",
                "p50_hermes", "p99_hermes", "p999_hermes",
                "slo_lark", "slo_quorum", "slo_hermes"):
        assert getattr(r, col) == 0.0, col
    assert np.all(r.downtime.latency_raw["dup"] == 0.0)
    assert np.all(r.downtime.latency_raw["qhist"] == 0.0)
    plain = TD.simulate_downtime_batched(
        n=6, rf=2, p=2e-4, partitions=32, trials=2, max_ticks=4_000,
        min_ticks=4_000, chunk_steps=64, seed=0, device="cpu")
    assert plain.latency_raw is None


def test_percentile_walk_pins():
    p = TC._percentile
    masses = [(1.0, 32.0), (2.0, 32.0)]
    assert p(masses, 64.0, 0.5) == 1.0           # exact CDF landing
    assert p(masses, 64.0, 0.75) == 2.0
    assert p([(5.0, 1.0)], 100.0, 0.99) == 0.0
    assert p([(5.0, 1.0)], 100.0, 0.995) == 5.0
    assert p([], 100.0, 0.999) == 0.0            # zero mass / total
    assert p([(3.0, 0.0)], 100.0, 0.5) == 0.0
    assert p([(3.0, 1.0)], 0.0, 0.5) == 0.0
    assert p([(3.0, 1.0)], -1.0, 0.999) == 0.0
    for q in (0.5, 0.99, 0.999):                 # single bucket
        assert p([(7.0, 10.0)], 10.0, q) == 7.0
    assert p([(3.0, 200.0)], 100.0, 0.5) == 3.0  # overcharged total
    assert p([(3.0, 200.0)], 100.0, 0.999) == 3.0
    assert p([(9.0, 1.0), (2.0, 99.0)], 100.0, 0.5) == 2.0
    rng = np.random.default_rng(0)
    for _ in range(200):                         # ordering, as reference
        masses = [(float(rng.integers(0, 100)), float(rng.uniform(0, 50)))
                  for _ in range(int(rng.integers(1, 9)))]
        total = float(rng.uniform(0, 2) * sum(m[1] for m in masses) + 1e-9)
        got = [p(masses, total, q) for q in (0.5, 0.99, 0.999)]
        assert got == [RC._percentile(masses, total, q)
                       for q in (0.5, 0.99, 0.999)]
        assert 0.0 <= got[0] <= got[1] <= got[2]


# ---------------------------------------------------------------------------
# mid-run restart: the reference's numpy engine with the latency layer and
# the whole zoo, continued by the port from its carry
# ---------------------------------------------------------------------------

_R = dict(n=13, P=16, B=2, horizon=6_000, seed=5, p=1e-2, rf=2)
_KNOBS = dict(dupres_ticks=3, rebuild_steps=30, hist_bins=16,
              rebuild_model="reconfig", engines=("hermes", "spinnaker"),
              lease_ticks=40, view_change_ticks=200)
_PARAMS = dict(key_zipf=1.0, read_frac=0.6, requests_per_tick=16.0,
               slo_ticks=2, write_skew=1.0)


def _ref_engine(packed):
    """The reference numpy engine's step and t=0 carry with the zoo and
    the latency leaves, as its simulate_downtime_batched assembles them."""
    c = _R
    n, P, B, rf = c["n"], c["P"], c["B"], c["rf"]
    (xp, succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     _, _) = RA._engine_setup(
        "numpy", n=n, partitions=P, seed=c["seed"], p=c["p"], downtime=10,
        p_node=None, downtime_node=None, max_ticks=c["horizon"])
    spec = ROPS.StepSpec(metric="downtime", rf=rf, n_real=n,
                         rebuild_model="reconfig", packed=packed,
                         engines=_KNOBS["engines"])

    def dt_fn(u, f, roster=None, recruit=None, active=None):
        o = ROPS.step_eval(spec, u, f, roster=roster, backend="numpy")
        ex = tuple(x for x in (o.repmask, o.rleader) if x is not None)
        return (o.lark, o.maj, o.leader, o.leader_full, o.nrep) + ex + \
            (o.creps,)

    plan = RC.make_latency_plan(c["seed"], P, RD.DowntimeParams(
        **_PARAMS), c["horizon"])

    def lat_fn(lat, dt_i, avail, qok, rem):
        out = ROPS.client_latency_step(
            lat[0], dt_i, avail, qok, rem, pow_tables=plan.pow_tables,
            kf=plan.kf, lamw=plan.lamw, nbins=plan.nbins,
            slo_ticks=plan.slo_ticks, backend="numpy")
        return (out[0],) + tuple(a + b for a, b in zip(lat[1:], out[1:]))

    advance = RA._make_node_advance(
        np, n=n, horizon=c["horizon"], dt_vec=dt_vec, geo_masks=geo_masks,
        geo_tables=geo_tables, seed_mix=seed_mix, pair_fail_prob=0.0,
        pair_perm=pair_perm, restart_period=0, wave_width=1)
    step = RD._make_step(
        np, dt_fn, advance, succ, n=n, P=P, rf=rf, packed=packed,
        rebuild_ticks=RD._partition_rebuild_ticks(
            c["seed"], P, 30, cap=c["horizon"] + 1) * np.int32(RD._REB_SCALE),
        lat_fn=lat_fn, **_KNOBS)
    lane0, up0, ev0, rr_t0 = RA._initial_node_state(
        np, B=B, n=n, seed_mix=seed_mix, geo_masks=geo_masks,
        geo_tables=geo_tables, restart_period=0, horizon=c["horizon"])
    full0, outs0 = RA._initial_full_state(
        np, "numpy", dt_fn, up0, succ, B=B, P=P, n=n, rf=rf, packed=packed)
    lark0, qmaj0 = outs0[0].reshape(B, P), outs0[1].reshape(B, P)
    zi, zf = np.zeros(B, np.int32), np.zeros(B, np.float32)
    zbp, zh = np.zeros((B, P), np.int32), np.zeros((B, 16), np.int32)
    lz = np.zeros((B, P), np.float32)
    carry = (zi, up0, ev0, full0, rr_t0, zi, lane0, ~lark0, zbp,
             up0[:, succ[:, :rf]], zbp, ~qmaj0, zbp,
             outs0[2].reshape(B, P).astype(np.int32), zf, zf, zi, zi, zh,
             zh,
             np.ascontiguousarray(np.broadcast_to(
                 np.arange(rf, dtype=np.int32), (B, P, rf))),
             np.full((B, P), n, np.int32),
             ~lark0, zbp, outs0[5].reshape(B, P).astype(np.int32), zbp, zf,
             zi, zh,
             ~qmaj0, zbp, zbp, zbp, zf, zi, zh,
             np.zeros((B, P, 4), np.float32), np.zeros((B, P, 4), np.float32),
             np.zeros((B, P, 16), np.float32), lz, lz)
    return step, carry, plan


def _port_step(packed, plan):
    c = _R
    n, P, rf = c["n"], c["P"], c["rf"]
    (succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     _, _) = TA._engine_setup(
        n=n, partitions=P, seed=c["seed"], p=c["p"], downtime=10,
        p_node=None, downtime_node=None, max_ticks=c["horizon"],
        device="cpu")
    spec = TD.StepSpec(metric="downtime", rf=rf, n_real=n,
                       rebuild_model="reconfig", packed=packed,
                       engines=_KNOBS["engines"])

    def dt_fn(u, f, roster=None, recruit=None, active=None):
        o = TD.step_eval(spec, u, f, roster=roster)
        ex = tuple(x for x in (o.repmask, o.rleader) if x is not None)
        return (o.lark, o.maj, o.leader, o.leader_full, o.nrep) + ex + \
            (o.creps,)

    tabs = {k: torch.from_numpy(getattr(plan, k))
            for k in ("pow_tables", "kf", "lamw")}

    def lat_fn(lat, dt_i, avail, qok, rem):
        out = TOPS.client_latency_step(lat[0], dt_i, avail, qok, rem,
                                       nbins=plan.nbins,
                                       slo_ticks=plan.slo_ticks, **tabs)
        return (out[0],) + tuple(a + b for a, b in zip(lat[1:], out[1:]))

    advance = TA._make_node_advance(
        n=n, horizon=c["horizon"], dt_vec=dt_vec, geo_masks=geo_masks,
        geo_tables=geo_tables, seed_mix=seed_mix, pair_fail_prob=0.0,
        pair_perm=pair_perm, restart_period=0, wave_width=1)
    return TD._make_step(
        dt_fn, advance, succ, n=n, P=P, rf=rf, packed=packed,
        rebuild_ticks=torch.from_numpy(TD._partition_rebuild_ticks(
            c["seed"], P, 30, cap=c["horizon"] + 1) * np.int32(TD._REB_SCALE)),
        lat_fn=lat_fn, **_KNOBS)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_mid_run_restart_from_reference_carry(packed):
    """A reconfig carry with hermes, spinnaker and the latency leaves,
    taken from the reference mid-run, continues on the port exactly as
    on the reference; the exchange keeps every leaf's dtype."""
    ref_step, carry, plan = _ref_engine(packed)
    carry, _ = RA._run_chunk_numpy(ref_step, carry, 1, 64)     # mid-run
    want_carry, want_ys = RA._run_chunk_numpy(ref_step, carry, 65, 96)
    assert len(carry) == 22 + 7 + 7 + 5
    assert (carry[-5] > 0).any() and (carry[-1] > 0).any()    # dirty, qsum

    tcarry = TD.carry_from_numpy(carry, device="cpu")
    back = TD.carry_to_numpy(tcarry)
    for a, b in zip(carry, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    got_carry, got_ys = TA._run_chunk(_port_step(packed, plan), tcarry, 65,
                                      96)
    for w, g in zip(want_ys, got_ys):
        assert np.array_equal(w, g)
    for w, g in zip(want_carry, TD.carry_to_numpy(got_carry)):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert math.isfinite(float(want_carry[-1].sum()))
