"""Client-traffic commit-latency engine — what requests see under
failover, in PyTorch (port of ``repro/core/client_latency.py``).

Runs a batched per-key request workload over the exact counter-RNG
trajectories of ``core/downtime_batched.py`` and reports the commit
latency distribution a request stream experiences:

  LARK     a request pays `dupres_ticks` iff it is the first touch of its
           key since a leader change onto a stale leader.  Each (trial,
           partition) carries a dirty-key fraction per key-popularity
           bucket (N_KEY_BUCKETS zipf-rank bands of KEYS_PER_PARTITION
           keys), reset to 1 at a stale-leader change and decayed per
           event interval by the bucket's touch probability.
  quorum   every write arriving while a rebuild is in flight (replica
           majority up) waits out the remaining rebuild.
  hermes   local reads never pay; the write path pays LARK's first-touch
           charge, derived host-side as the write-fraction share.

Each step's charges are one ``ops.client_latency_step`` call: on a CUDA
device one launch of the hand-written ``latency_charge`` kernel, on the
CPU its plain PyTorch version.  The workload tables are host numpy
(float64, cast once to float32), the in-scan state is per-(trial,
partition) float32, and partition pooling happens host-side in float64
at chunk drains — so every number equals the reference's bit for bit
(see ``kernels/latency.py`` for the float contract).

Zero-knob limit: dupres_ticks=0, uniform keys and read_frac=1 give
exactly 0 added latency on every column.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..kernels.latency import decay_pow_tables
from .availability import t975
from .availability_batched import _lane_keys, _seed_mix, _uniforms
from .downtime_batched import (BatchedDowntimeResult, DowntimeParams,
                               simulate_downtime_batched)

#: dedicated counter-RNG salt for the key -> partition hash (invariant 3:
#: per-run constants may draw from the counter-hash family under their own
#: salt without perturbing node trajectories)
_KEY_SALT = 0xC2B2AE35

#: dedicated counter-RNG salt for the per-partition write-fraction draw
#: (`write_skew`) — its own stream, so the write mix is independent of
#: both the node trajectories and the key -> partition hash
_WRITE_SALT = 0x85EBCA6B

#: keys per partition in the workload model.  A module constant, not a
#: knob: it only sets the granularity of the analytic dirty-key carry
#: (the bucket key counts K * f_b).
KEYS_PER_PARTITION = 1024

#: zipf-rank bands per partition: bucket b spans ranks
#: (K^(b/4), K^((b+1)/4)] — geometric edges, so the hot head gets its own
#: tiny bucket and the cold tail its own huge one
N_KEY_BUCKETS = 4

#: the reported latency quantiles
LATENCY_QUANTILES = (0.5, 0.99, 0.999)


def _table_uniforms(seed: int, salt: int, count: int) -> np.ndarray:
    """(count,) float64 of the counter hash at step 0 under `salt` over
    lanes 0 .. count-1 — the reference's one-row ``_uniforms`` draw for
    per-run tables, computed on the CPU so every device gets the
    identical table."""
    lanes = _lane_keys(torch.zeros(1, dtype=torch.int64), count)
    return _uniforms(_seed_mix(seed), 0, salt, lanes)[0].numpy() \
        .astype(np.float64)


def partition_request_weights(seed: int, partitions: int, *,
                              key_zipf: float = 0.0,
                              keys_per_partition: int = KEYS_PER_PARTITION
                              ) -> np.ndarray:
    """(P,) float64 request-probability weights, summing to 1.

    Key rank r (of NK = partitions * keys_per_partition keys) carries
    popularity r^-key_zipf and lands on the partition drawn by its
    counter hash under _KEY_SALT; a partition's weight is its keys'
    popularity share.  key_zipf=0 is the exactly-uniform 1/P table."""
    if partitions <= 0:
        raise ValueError("partitions must be >= 1")
    if key_zipf == 0:
        return np.full(partitions, 1.0 / partitions)
    nk = partitions * keys_per_partition
    pop = np.arange(1, nk + 1, dtype=np.float64) ** (-float(key_zipf))
    u = _table_uniforms(seed, _KEY_SALT, nk)
    part = np.minimum((u * partitions).astype(np.int64), partitions - 1)
    w = np.bincount(part, weights=pop, minlength=partitions)
    return w / w.sum()


def partition_write_fractions(seed: int, partitions: int, *,
                              read_frac: float = 0.8,
                              write_skew: float = 0.0) -> np.ndarray:
    """(P,) float64 per-partition write fractions, mean-pinned to
    1 - read_frac.

    write_skew=0 is the exactly-constant `1 - read_frac` table.
    Otherwise each partition draws a Pareto factor (1 - u)^-write_skew
    under _WRITE_SALT and the table is min(c * draw, 1), c the unique
    waterfilling scale that pins the mean to 1 - read_frac exactly."""
    if partitions <= 0:
        raise ValueError("partitions must be >= 1")
    target = 1.0 - read_frac
    if write_skew == 0 or target == 0.0 or target == 1.0:
        return np.full(partitions, target)
    u = _table_uniforms(seed, _WRITE_SALT, partitions)
    raw = (1.0 - u) ** (-float(write_skew))
    # exact waterfilling: with the m largest draws saturated at 1, the
    # scale solving mean = target is (target*P - m) / sum(rest); the
    # first m where that scale leaves draw m itself unsaturated is
    # consistent, and then mean(w) = (m + (target*P - m)) / P = target
    r = np.sort(raw)[::-1]
    tail = r[::-1].cumsum()[::-1]                 # tail[m] = sum r[m:]
    m = np.arange(partitions, dtype=np.float64)
    cm = (target * partitions - m) / tail
    msat = int(np.argmax(cm * r < 1.0))           # first consistent m
    return np.minimum(cm[msat] * raw, 1.0)


def key_bucket_shares(key_zipf: float, *,
                      keys_per_partition: int = KEYS_PER_PARTITION,
                      n_buckets: int = N_KEY_BUCKETS):
    """Within-partition key-popularity buckets: (f, g) float64 arrays of
    key-count fractions and traffic shares per zipf-rank band (geometric
    edges at K^(b/n)).  key_zipf=0 gives g == f exactly."""
    K = keys_per_partition
    edges = [0]
    for b in range(1, n_buckets):
        e = int(round(K ** (b / n_buckets)))
        edges.append(min(max(e, edges[-1] + 1), K - (n_buckets - b)))
    edges.append(K)
    pop = np.arange(1, K + 1, dtype=np.float64) ** (-float(key_zipf))
    tot = pop.sum()
    f = np.asarray([(edges[b + 1] - edges[b]) / K
                    for b in range(n_buckets)])
    g = np.asarray([pop[edges[b]:edges[b + 1]].sum() / tot
                    for b in range(n_buckets)])
    return f, g


@dataclass(frozen=True)
class _LatencyPlan:
    """Host-precomputed workload tables handed to the downtime engine
    (simulate_downtime_batched's `_lat_plan`): per-bucket key counts,
    per-partition float32 write rates, and the decay power tables —
    everything the in-scan latency update consumes."""
    nbins: int
    slo_ticks: int
    kf: np.ndarray           # (NB,) float32 keys per bucket (K * f_b)
    lamw: np.ndarray         # (P,) float32 write requests/tick
    pow_tables: np.ndarray   # (nbits, P, NB) float32 decay squares
    #: (P,) float64 per-partition write fractions, or None under the
    #: uniform mix (write_skew=0) — consumed host-side at chunk drains
    #: to weight hermes' write-path share of the dup charges
    wfp: Optional[np.ndarray] = None


def _percentile(masses, total: float, q: float) -> float:
    """Smallest latency value whose CDF covers quantile q, over a
    distribution of `total` requests with point `masses` [(value, count)]
    at positive latencies and the rest at exactly 0.  The walk takes the
    smallest value whose cumulative mass reaches q * total (`>=`); an
    all-zero-mass distribution returns 0.0; a total below the charged
    mass still terminates (the zero mass is clamped at 0)."""
    if total <= 0:
        return 0.0
    masses = sorted((m for m in masses if m[1] > 0), key=lambda m: m[0])
    charged = sum(m[1] for m in masses)
    cdf = max(total - charged, 0.0)
    need = q * total
    if cdf >= need:
        return 0.0
    for value, count in masses:
        cdf += count
        if cdf >= need:
            return float(value)
    return float(masses[-1][0]) if masses else 0.0


@dataclass
class BatchedLatencyResult:
    """Client-visible commit-latency summary over `trials` trajectories —
    the reference's fields, with `device` (where the run went) in place
    of the reference's `backend`.  Latencies are ticks of added commit
    latency; percentiles are over the full request distribution, zeros
    included; `req_total` is the offered load summed over trials."""
    p: float
    rf: int
    n: int
    partitions: int
    trials: int
    device: str
    devices: int
    ticks: int
    stopped_early: bool
    rebuild_model: str
    dupres_ticks: int
    key_zipf: float
    read_frac: float
    requests_per_tick: float
    slo_ticks: int
    req_total: float
    lat_lark: float                  # mean added latency, ticks/request
    lat_quorum: float
    lat_hermes: float
    ci_lat_lark: float               # 95% across-trial half-widths
    ci_lat_quorum: float
    p50_lark: float
    p99_lark: float
    p999_lark: float
    p50_quorum: float
    p99_quorum: float
    p999_quorum: float
    p50_hermes: float
    p99_hermes: float
    p999_hermes: float
    slo_lark: float                  # fraction of requests > slo_ticks
    slo_quorum: float
    slo_hermes: float
    write_skew: float = 0.0
    slo_curve_bins: int = 0
    node_bandwidth_gibps: float = math.inf
    #: SLO curves (slo_curve_bins > 0 only): violation fractions over
    #: the power-of-two threshold sweep 2^j - 1, j = 0..bins-1
    slo_curve_edges: np.ndarray = field(repr=False, default=None)
    slo_curve_lark: np.ndarray = field(repr=False, default=None)
    slo_curve_quorum: np.ndarray = field(repr=False, default=None)
    slo_curve_hermes: np.ndarray = field(repr=False, default=None)
    hist_edges: np.ndarray = field(repr=False, default=None)
    hist_quorum_req: np.ndarray = field(repr=False, default=None)
    lat_lark_trials: np.ndarray = field(repr=False, default=None)
    lat_quorum_trials: np.ndarray = field(repr=False, default=None)
    downtime: BatchedDowntimeResult = field(repr=False, default=None)


def make_latency_plan(seed: int, partitions: int, params: DowntimeParams,
                      max_ticks: int) -> _LatencyPlan:
    """Build the host-side workload tables for one run (the float64 ->
    float32 rounding happens once, here, identically for every
    device)."""
    w = partition_request_weights(seed, partitions,
                                  key_zipf=params.key_zipf)
    f, g = key_bucket_shares(params.key_zipf)
    lam = params.requests_per_tick * w
    wfp = None
    if params.write_skew > 0:
        wfp = partition_write_fractions(seed, partitions,
                                        read_frac=params.read_frac,
                                        write_skew=params.write_skew)
        lamw = (lam * wfp).astype(np.float32)
    else:
        lamw = (lam * (1.0 - params.read_frac)).astype(np.float32)
    # same subnormal flush as the decay tables (kernels/latency.py)
    lamw[lamw < np.float32(1e-30)] = 0.0
    return _LatencyPlan(
        nbins=params.hist_bins, slo_ticks=params.slo_ticks,
        kf=(KEYS_PER_PARTITION * f).astype(np.float32),
        lamw=lamw,
        pow_tables=decay_pow_tables(lam, g, f, KEYS_PER_PARTITION,
                                    max_ticks),
        wfp=wfp)


def simulate_client_latency(
        *, partitions: int = 4096, seed: int = 0,
        max_ticks: int = 3_000_000,
        key_zipf: float = 1.0, read_frac: float = 0.8,
        requests_per_tick: float = 32.0, slo_ticks: int = 8,
        write_skew: float = 0.0, slo_curve_bins: int = 0,
        dupres_ticks: int = 1, rebuild_steps: int = 100,
        hist_bins: int = 16, rebuild_model: str = "fixed",
        rebuild_ticks_per_gib: int = 100, size_dist: str = "uniform",
        size_skew: float = 1.0,
        node_bandwidth_gibps: float = math.inf,
        params: Optional[DowntimeParams] = None,
        device=None, **kwargs) -> BatchedLatencyResult:
    """Run the §6 downtime Monte Carlo with the client-latency layer
    attached and summarize what the request stream saw.

    Accepts every ``simulate_downtime_batched`` knob (cluster, scenario,
    devices/packed, chunking) via **kwargs, plus the workload knobs
    above, all validated in DowntimeParams; `params` takes precedence
    over the individual keywords.  device: ``None`` runs on ``cuda``
    (and raises without a card); ``"cpu"`` runs the plain kernels."""
    if params is None:
        params = DowntimeParams(
            dupres_ticks=dupres_ticks, rebuild_steps=rebuild_steps,
            hist_bins=hist_bins, rebuild_model=rebuild_model,
            rebuild_ticks_per_gib=rebuild_ticks_per_gib,
            size_dist=size_dist, size_skew=size_skew,
            node_bandwidth_gibps=node_bandwidth_gibps,
            key_zipf=key_zipf, read_frac=read_frac,
            requests_per_tick=requests_per_tick, slo_ticks=slo_ticks,
            write_skew=write_skew, slo_curve_bins=slo_curve_bins)
    plan = make_latency_plan(seed, partitions, params, max_ticks)
    res = simulate_downtime_batched(
        partitions=partitions, seed=seed, max_ticks=max_ticks,
        params=params, _lat_plan=plan, device=device, **kwargs)

    # -- pooling, host-side float64, the reference's expressions verbatim
    raw = res.latency_raw
    now = raw["now"].astype(np.float64)                       # (B,)
    req_b = params.requests_per_tick * now
    req = float(req_b.sum())
    dup_b = raw["dup"].sum(axis=1)                            # (B,)
    dup_tot = float(dup_b.sum())
    qhist = raw["qhist"].sum(axis=0)                          # (nbins,)
    qslo_tot = float(raw["qslo"].sum())
    qsum_tot = float(raw["qsum"].sum())
    wf = 1.0 - params.read_frac
    dup_cost = float(params.dupres_ticks)
    # skewed write mix: the engine pooled a second, write-fraction-
    # weighted view of the dup charges; its absence (write_skew=0) keeps
    # the uniform-mix hermes expressions
    dupw_tot = float(raw["dupw"].sum()) if "dupw" in raw else None

    if req > 0:
        lat_lark = dup_cost * dup_tot / req
        lat_quorum = qsum_tot / req
        lal_b = dup_cost * dup_b / req_b
        laq_b = raw["qsum"] / req_b
        slo_lark = (dup_tot / req) if dup_cost > params.slo_ticks else 0.0
        slo_quorum = qslo_tot / req
        if dupw_tot is not None:
            lat_hermes = dup_cost * dupw_tot / req
            slo_hermes = (dupw_tot / req) \
                if dup_cost > params.slo_ticks else 0.0
        else:
            lat_hermes = wf * lat_lark
            slo_hermes = wf * slo_lark
    else:
        lat_lark = lat_quorum = slo_lark = slo_quorum = 0.0
        lat_hermes = slo_hermes = 0.0
        lal_b = np.zeros_like(req_b)
        laq_b = np.zeros_like(req_b)
    ci_l = ci_q = 0.0
    B = res.trials
    if B >= 3:
        t = t975(B - 1) / math.sqrt(B)
        ci_l = t * float(lal_b.std(ddof=1))
        ci_q = t * float(laq_b.std(ddof=1))

    hermes_mass = dupw_tot if dupw_tot is not None else wf * dup_tot
    lark_masses = [(params.dupres_ticks, dup_tot)]
    hermes_masses = [(params.dupres_ticks, hermes_mass)]
    quorum_masses = [(1 << k, float(qhist[k]))
                     for k in range(params.hist_bins)]
    pcts = {}
    for name, masses in (("lark", lark_masses), ("quorum", quorum_masses),
                         ("hermes", hermes_masses)):
        for q in LATENCY_QUANTILES:
            key = f"p{q * 1000:g}".replace("p500", "p50").replace(
                "p990", "p99")
            pcts[f"{key}_{name}"] = _percentile(masses, req, q)

    curve_edges = curve_lark = curve_quorum = curve_hermes = None
    if params.slo_curve_bins > 0:
        # violation-fraction curves over the threshold sweep 2^j - 1: the
        # quorum curve is the qhist tail sums, with the in-scan scalar
        # substituted at the bin whose threshold is slo_ticks and the
        # neighbours clamped, so the curve stays monotone
        J = params.slo_curve_bins
        curve_edges = np.asarray([(1 << j) - 1 for j in range(J)],
                                 dtype=np.int64)
        if req > 0:
            tail = qhist[::-1].cumsum()[::-1]
            curve_quorum = tail[:J] / req
            curve_lark = np.asarray(
                [(dup_tot / req) if dup_cost > t else 0.0
                 for t in curve_edges])
            if dupw_tot is not None:
                curve_hermes = np.asarray(
                    [(dupw_tot / req) if dup_cost > t else 0.0
                     for t in curve_edges])
            else:
                curve_hermes = wf * curve_lark
            js = np.flatnonzero(curve_edges == params.slo_ticks)
            if js.size:
                j = int(js[0])
                curve_quorum[j] = slo_quorum
                curve_quorum[:j] = np.maximum(curve_quorum[:j],
                                              slo_quorum)
                curve_quorum[j + 1:] = np.minimum(curve_quorum[j + 1:],
                                                  slo_quorum)
        else:
            curve_lark = np.zeros(J)
            curve_quorum = np.zeros(J)
            curve_hermes = np.zeros(J)

    return BatchedLatencyResult(
        p=res.p, rf=res.rf, n=res.n, partitions=res.partitions,
        trials=res.trials, device=res.device, devices=res.devices,
        ticks=res.ticks, stopped_early=res.stopped_early,
        rebuild_model=res.rebuild_model,
        dupres_ticks=params.dupres_ticks, key_zipf=params.key_zipf,
        read_frac=params.read_frac,
        requests_per_tick=params.requests_per_tick,
        slo_ticks=params.slo_ticks, req_total=req,
        write_skew=params.write_skew,
        slo_curve_bins=params.slo_curve_bins,
        node_bandwidth_gibps=params.node_bandwidth_gibps,
        lat_lark=lat_lark, lat_quorum=lat_quorum,
        lat_hermes=lat_hermes,
        ci_lat_lark=ci_l, ci_lat_quorum=ci_q,
        p50_lark=pcts["p50_lark"], p99_lark=pcts["p99_lark"],
        p999_lark=pcts["p999_lark"],
        p50_quorum=pcts["p50_quorum"], p99_quorum=pcts["p99_quorum"],
        p999_quorum=pcts["p999_quorum"],
        p50_hermes=pcts["p50_hermes"], p99_hermes=pcts["p99_hermes"],
        p999_hermes=pcts["p999_hermes"],
        slo_lark=slo_lark, slo_quorum=slo_quorum,
        slo_hermes=slo_hermes,
        slo_curve_edges=curve_edges, slo_curve_lark=curve_lark,
        slo_curve_quorum=curve_quorum, slo_curve_hermes=curve_hermes,
        hist_edges=np.asarray([1 << k for k in range(params.hist_bins)],
                              dtype=np.int64),
        hist_quorum_req=qhist,
        lat_lark_trials=lal_b, lat_quorum_trials=laq_b,
        downtime=res)
