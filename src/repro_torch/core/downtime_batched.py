"""Batched commit-pause engine — paper §6 at Monte Carlo scale, in
PyTorch (port of ``repro/core/downtime_batched.py``).

Runs B trials x P partitions through the availability engine's exact
counter-RNG node trajectories (its node advance, initial state and
chunk loop are reused), and carries two per-partition protocol state
machines per step:

  LARK         paused iff PAC fails; ready the instant PAC holds again.
               A leader change onto a partition whose new acting leader
               lacks the latest copy costs `dupres_ticks` paused ticks.
  quorum-log   paused iff a majority of the f+1-copy replica set is
               down, or a rebuild is in progress.  rebuild_model "fixed"
               keeps the first rf succession ranks and restarts a
               `rebuild_steps` countdown on every replica loss;
               "reconfig" carries a per-partition roster, recruits the
               next up node after a loss, and counts down a data-sized
               catch-up (`rebuild_ticks_per_gib` x a per-partition size
               from `size_dist`).  A finite `node_bandwidth_gibps`
               makes concurrent catch-ups ingesting on one node share
               its bandwidth, in _REB_SCALE fixed-point work units, in
               both models.

The protocol zoo rides the same trajectories (``engines``): hermes
(membership leases; writes block for `lease_ticks` after a replica-set
member is suspected) and spinnaker (Paxos with reconfiguration; a
`view_change_ticks` reconciliation pause on leader loss, reconfig only).
Each carries 7 leaves and draws no randomness, so switching it on
changes no lark/quorum bit.  The client-latency layer
(``core/client_latency.py``, through `_lat_plan`) appends 5 float32
leaves and charges every interval through ``ops.client_latency_step``.

Each step evaluates the protocols through ``kernels/ops.step_eval``
(metric "downtime"; hermes asks for the membership bitmask `repmask`,
spinnaker for the electable roster leader `rleader`): on a CUDA device
one launch of the hand-written ``downtime_eval`` (plain or roster
variant, with the in-flight node counts under shared bandwidth;
unpacked) or of ``fused_downtime_eval`` (packed), and ``latency_charge``
for the latency layer; on the CPU their plain PyTorch versions.

The port reproduces the reference bit for bit for the same seed and
knobs.  All protocol state is integer or boolean; the pause
accumulators are float32 sums of integer terms, kept as the reference's
separate eager ops (no FMA, no ``torch.compile``; ARCHITECTURE
invariant 8).  The float64 drains, the early stop and the trajectory
columns fall on the reference's chunk boundaries, host-side in numpy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ops import StepSpec, client_latency_step, step_eval
from .availability import t975
from .availability_batched import (_default_max_steps, _engine_setup,
                                   _initial_full_state, _initial_node_state,
                                   _lane_keys, _make_node_advance,
                                   _pack_holders, _run_chunk, _seed_mix,
                                   _TrialShards, _uniforms,
                                   _validate_batched_args)

_SIZE_SALT = 0x94D049BB

REBUILD_MODELS = ("fixed", "reconfig")

#: the protocol zoo: every engine one run can report.  lark and quorum are
#: the paper's §6 pair and always simulated; hermes (Katsarakis et al. —
#: broadcast replication, all replicas serve linearizable reads under
#: membership leases, writes block on a suspected replica until the lease
#: epoch advances) and spinnaker (Rao et al. — Paxos with reconfiguration,
#: a view-change log-reconciliation pause on leader loss) are optional
#: contrast engines riding the same node trajectories.
ENGINES = ("lark", "quorum", "hermes", "spinnaker")

#: the necessity hooks: each disables exactly one transition predicate of
#: the zoo state machines so tests can prove the predicate is load-bearing
DISABLE_PREDICATES = ("lease-expiry", "view-change-trigger",
                      "roster-recruit")

#: per-partition data-size distributions for the reconfiguring baseline.
#: All three pin the same mean (the uniform model's 1.5 GiB), so every
#: distribution describes the same total dataset under the §6
#: equal-storage budget — skew moves bytes between partitions, never
#: adds them.
SIZE_DISTS = ("uniform", "zipf", "lognormal")

#: largest accepted size_skew: (1 - u)^(-skew) reaches 2^(24 * skew) at
#: the 24-bit uniform's top draw, which overflows float64 (and silently
#: NaN-poisons the mean rescale) just past skew ~42 — cap well below it
_SIZE_SKEW_MAX = 32.0

#: fixed-point scale for bandwidth-shared catch-up countdowns: one
#: countdown tick = _REB_SCALE work units, so a contended rebuild can
#: advance in 1/_REB_SCALE-tick quanta while staying pure int32 math
#: (invariant 4 in docs/ARCHITECTURE.md).  An uncontended rebuild
#: advances _REB_SCALE units/tick — arithmetically identical to the
#: plain-tick countdown, which is what makes node_bandwidth_gibps=inf
#: bit-exact against the unshared model.
_REB_SCALE = 256
_REB_BIG = 2 ** 30          # "never finishes" remaining-ticks sentinel

_SIZE_MEAN_GIB = 1.5      # the uniform [1, 2) mean every dist is pinned to

#: largest accepted key_zipf (the client-latency workload's key-popularity
#: exponent): beyond this the zipf mass is so concentrated that the
#: float64 rank weights r^-s underflow for all but the first few keys and
#: the partition weight table degenerates to a handful of point masses
_KEY_ZIPF_MAX = 8.0

#: largest accepted write_skew (the client-latency workload's
#: per-partition write-mix Pareto exponent, core/client_latency.py):
#: same concentration rationale as _KEY_ZIPF_MAX — past this the
#: bounded-Pareto draws collapse the write mix onto a handful of
#: saturated (write fraction 1) partitions and the mean pin degenerates
_WRITE_SKEW_MAX = 8.0


@dataclass(frozen=True)
class DowntimeParams:
    """The §6 engine's protocol/rebuild knobs, validated in one place.

    These eight values are mutually constrained (the skew/bandwidth knobs
    describe the reconfiguring baseline's data-sized catch-ups and are
    rejected under rebuild_model="fixed"; bandwidth has a fixed-point
    quantum floor; ...), and they used to be threaded as loose keywords
    from benchmarks/availability_sweep.py all the way into
    simulate_downtime_batched, with the rules enforced at the bottom.
    One frozen dataclass now owns both the values and the rules: every
    entry point (CLI, engine, tests) constructs it and gets the identical
    ValueError set — see simulate_downtime_batched's docstring for
    per-knob semantics.
    """
    dupres_ticks: int = 1
    rebuild_steps: int = 100
    hist_bins: int = 16
    rebuild_model: str = "fixed"
    rebuild_ticks_per_gib: int = 100
    size_dist: str = "uniform"
    size_skew: float = 1.0
    node_bandwidth_gibps: float = math.inf
    # client-latency workload knobs (core/client_latency.py; inert for the
    # plain downtime metric — the defaults are the zero-request limit).
    # slo_ticks uses a strict `>` (a request violates iff its added
    # latency exceeds the threshold), so slo_ticks=0 is a *live* edge
    # threshold — every request with any positive added latency violates
    # — and doubles as the inert non-latency sentinel only because
    # requests_per_tick=0 offers no requests to violate it.
    # write_skew skews the per-partition write fraction around
    # 1 - read_frac (0 = exactly uniform); slo_curve_bins requests a
    # violation-fraction curve over thresholds 2^j - 1, j < bins (0 =
    # the single slo_ticks point only).
    key_zipf: float = 0.0
    read_frac: float = 1.0
    requests_per_tick: float = 0.0
    slo_ticks: int = 0
    write_skew: float = 0.0
    slo_curve_bins: int = 0
    # protocol-zoo knobs: which engines to report, and their pause costs
    # (lease_ticks — Hermes membership-lease epoch length; a suspected
    # replica blocks writes until it elapses.  view_change_ticks —
    # Spinnaker's log-reconciliation pause after a leader loss.)
    engines: tuple = ("lark", "quorum")
    lease_ticks: int = 0
    view_change_ticks: int = 0

    def __post_init__(self):
        object.__setattr__(self, "engines", tuple(self.engines))
        if not self.engines:
            raise ValueError("engines must name at least one protocol")
        for e in self.engines:
            if e not in ENGINES:
                raise ValueError(f"unknown engine {e!r}; expected a "
                                 f"subset of {ENGINES}")
        if len(set(self.engines)) != len(self.engines):
            raise ValueError(f"duplicate engines: {self.engines}")
        if self.lease_ticks < 0 or self.view_change_ticks < 0:
            raise ValueError("lease_ticks and view_change_ticks must "
                             "be >= 0")
        if self.lease_ticks > 0 and not self.hermes:
            raise ValueError("lease_ticks models the hermes engine's "
                             "membership leases; add 'hermes' to engines")
        if self.view_change_ticks > 0 and not self.spinnaker:
            raise ValueError("view_change_ticks models the spinnaker "
                             "engine's view changes; add 'spinnaker' to "
                             "engines")
        if self.spinnaker and not self.reconfig:
            raise ValueError("the spinnaker engine elects among the "
                             "reconfiguring baseline's roster; use "
                             "rebuild_model='reconfig'")
        if self.dupres_ticks < 0 or self.rebuild_steps < 0:
            raise ValueError("dupres_ticks and rebuild_steps must be >= 0")
        if not 2 <= self.hist_bins <= 30:
            raise ValueError("hist_bins must be in [2, 30]")
        if self.rebuild_model not in REBUILD_MODELS:
            raise ValueError(
                f"rebuild_model must be one of {REBUILD_MODELS}")
        if self.rebuild_ticks_per_gib < 0:
            raise ValueError("rebuild_ticks_per_gib must be >= 0")
        if self.size_dist not in SIZE_DISTS:
            raise ValueError(f"size_dist must be one of {SIZE_DISTS}")
        if not 0 <= self.size_skew <= _SIZE_SKEW_MAX:
            raise ValueError(
                f"size_skew must be in [0, {_SIZE_SKEW_MAX:g}]")
        if not self.node_bandwidth_gibps >= 1.0 / _REB_SCALE:
            raise ValueError(
                f"node_bandwidth_gibps must be >= 1/{_REB_SCALE} "
                "(the fixed-point rate quantum — below it even an "
                "uncontended catch-up rounds to zero progress; "
                "inf disables bandwidth sharing)")
        if not self.reconfig and self.size_dist != "uniform":
            raise ValueError(
                "size_dist models the reconfiguring baseline's "
                "data-sized catch-ups; use rebuild_model='reconfig' "
                "(node_bandwidth_gibps applies to both rebuild models)")
        if not 0 <= self.key_zipf <= _KEY_ZIPF_MAX:
            raise ValueError(
                f"key_zipf must be in [0, {_KEY_ZIPF_MAX:g}] (the zipf "
                "key-popularity exponent; 0 is uniform)")
        if not 0 <= self.read_frac <= 1:
            raise ValueError("read_frac must be in [0, 1]")
        if not (self.requests_per_tick >= 0
                and math.isfinite(self.requests_per_tick)):
            raise ValueError("requests_per_tick must be finite and >= 0")
        if self.slo_ticks < 0:
            raise ValueError("slo_ticks must be >= 0 (0 is a live "
                             "threshold under the strict-> rule: every "
                             "request with positive added latency "
                             "violates it)")
        if not 0 <= self.write_skew <= _WRITE_SKEW_MAX:
            raise ValueError(
                f"write_skew must be in [0, {_WRITE_SKEW_MAX:g}] (the "
                "per-partition write-mix Pareto exponent; 0 is exactly "
                "uniform)")
        if not 0 <= self.slo_curve_bins <= self.hist_bins:
            raise ValueError(
                "slo_curve_bins must be in [0, hist_bins] — the curve's "
                "2^j - 1 thresholds are derived from the power-of-two "
                "latency histogram and cannot outrun its buckets")

    @property
    def reconfig(self) -> bool:
        return self.rebuild_model == "reconfig"

    @property
    def bandwidth_shared(self) -> bool:
        return math.isfinite(self.node_bandwidth_gibps)

    @property
    def hermes(self) -> bool:
        return "hermes" in self.engines

    @property
    def spinnaker(self) -> bool:
        return "spinnaker" in self.engines


# ---------------------------------------------------------------------------
# Host-side partition size tables (float64 numpy, as the reference)
# ---------------------------------------------------------------------------

def _norm_ppf(u: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.2e-9) — vectorized host-side numpy, no scipy.  Only
    used to shape the deterministic lognormal size table."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    u = np.clip(np.asarray(u, dtype=np.float64), 2.0 ** -25, 1 - 2.0 ** -25)
    lo, hi = u < 0.02425, u > 1 - 0.02425
    mid = ~(lo | hi)
    z = np.empty_like(u)
    q = np.sqrt(-2.0 * np.log(np.where(lo, u, 0.5)))
    z_lo = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
            + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = np.sqrt(-2.0 * np.log(np.where(hi, 1 - u, 0.5)))
    z_hi = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
             + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = u - 0.5
    r = q * q
    z_mid = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
             + a[5]) * q / \
        (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    z[lo] = z_lo[lo]
    z[hi] = z_hi[hi]
    z[mid] = z_mid[mid]
    return z


def partition_sizes_gib(seed: int, partitions: int, *,
                        dist: str = "uniform",
                        skew: float = 1.0) -> np.ndarray:
    """Deterministic per-partition data sizes in GiB (float64): uniform in
    [1, 2), or zipf ((1 - u)^(-skew)) / lognormal (exp(skew * z(u)))
    rescaled to the uniform mean of 1.5 GiB, so skew moves bytes between
    partitions without changing the total.  The uniforms are the counter
    hash at step 0 under ``_SIZE_SALT`` over partition-indexed lanes,
    drawn once on the CPU, so every device gets the identical table."""
    if dist not in SIZE_DISTS:
        raise ValueError(f"dist must be one of {SIZE_DISTS}; got {dist!r}")
    if not 0 <= skew <= _SIZE_SKEW_MAX:
        raise ValueError(f"skew must be in [0, {_SIZE_SKEW_MAX:g}] "
                         f"(larger Pareto exponents overflow the float64 "
                         f"size table); got {skew!r}")
    lanes = _lane_keys(torch.zeros(1, dtype=torch.int64), partitions)
    u = _uniforms(_seed_mix(seed), 0, _SIZE_SALT, lanes)[0] \
        .numpy().astype(np.float64)
    if dist == "uniform":
        return 1.0 + u
    if dist == "zipf":
        raw = (1.0 - u) ** (-skew)
    else:                                        # lognormal
        raw = np.exp(skew * _norm_ppf(u))
    return raw * (_SIZE_MEAN_GIB / raw.mean())


def _partition_rebuild_ticks(seed: int, partitions: int,
                             ticks_per_gib: int, *,
                             dist: str = "uniform", skew: float = 1.0,
                             cap: Optional[int] = None) -> np.ndarray:
    """(P,) int32 catch-up countdowns for the reconfiguring baseline:
    floor(ticks_per_gib x size_gib), at least 1 tick whenever a rebuild
    costs anything, at most `cap` (the engine passes horizon + 1, which
    keeps the fixed-point work units in int32)."""
    t = np.floor(ticks_per_gib *
                 partition_sizes_gib(seed, partitions, dist=dist, skew=skew))
    if ticks_per_gib > 0:
        t = np.maximum(t, 1.0)
    if cap is not None:
        t = np.minimum(t, float(cap))
    return t.astype(np.int32)


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------

@dataclass
class BatchedDowntimeResult:
    p: float
    rf: int
    n: int
    partitions: int
    trials: int
    device: str
    ticks: int                       # mean elapsed ticks per trial
    pause_lark: float                # mean commit-pause fraction, pooled
    pause_quorum: float
    lark_events: int                 # pause-start events (incl. dup-res)
    quorum_events: int
    ci_lark: float                   # 95% half-widths on the fractions
    ci_quorum: float
    dupres_ticks: int
    rebuild_steps: int
    stopped_early: bool
    devices: int = 1
    rebuild_model: str = "fixed"
    rebuild_ticks_per_gib: int = 0   # reconfig only; 0 under "fixed"
    size_dist: str = "uniform"       # reconfig only; "uniform" under "fixed"
    size_skew: float = 0.0           # zipf/lognormal only; 0 elsewhere
    node_bandwidth_gibps: float = math.inf   # inf = unshared
    hist_edges: np.ndarray = field(repr=False, default=None)   # (nbins,)
    hist_lark: np.ndarray = field(repr=False, default=None)    # (nbins,)
    hist_quorum: np.ndarray = field(repr=False, default=None)
    pause_lark_trials: np.ndarray = field(repr=False, default=None)
    pause_quorum_trials: np.ndarray = field(repr=False, default=None)
    #: protocol-zoo outputs — None/0 unless the matching engine was in
    #: `engines` (lark/quorum keep their dedicated fields above)
    engines: tuple = ("lark", "quorum")
    lease_ticks: int = 0
    view_change_ticks: int = 0
    pause_hermes: Optional[float] = None
    hermes_events: int = 0
    ci_hermes: float = 0.0
    pause_spinnaker: Optional[float] = None
    spinnaker_events: int = 0
    ci_spinnaker: float = 0.0
    hist_hermes: np.ndarray = field(repr=False, default=None)
    hist_spinnaker: np.ndarray = field(repr=False, default=None)
    pause_hermes_trials: np.ndarray = field(repr=False, default=None)
    pause_spinnaker_trials: np.ndarray = field(repr=False, default=None)
    trajectory: Optional[Dict[str, np.ndarray]] = field(repr=False,
                                                        default=None)
    #: raw per-trial client-latency accumulators (only when driven
    #: through core/client_latency.py): dup (B, NB), qhist (B, nbins),
    #: qslo (B,), qsum (B,), now (B,), and dupw (B, NB) under write skew —
    #: pooled over partitions host-side in float64
    latency_raw: Optional[Dict[str, np.ndarray]] = field(repr=False,
                                                         default=None)

    @property
    def availability_ratio(self) -> float:
        """Quorum-log pause over LARK pause — the §6 headline ratio."""
        return self.pause_quorum / self.pause_lark if self.pause_lark > 0 \
            else math.inf

    def engine_stats(self, engine: str) -> Dict[str, object]:
        """Uniform per-engine view: pause fraction, CI half-width, event
        count, duration histogram, and per-trial fractions."""
        if engine not in self.engines:
            raise ValueError(f"engine {engine!r} was not simulated "
                             f"(engines={self.engines})")
        by = {
            "lark": (self.pause_lark, self.ci_lark, self.lark_events,
                     self.hist_lark, self.pause_lark_trials),
            "quorum": (self.pause_quorum, self.ci_quorum,
                       self.quorum_events, self.hist_quorum,
                       self.pause_quorum_trials),
            "hermes": (self.pause_hermes, self.ci_hermes,
                       self.hermes_events, self.hist_hermes,
                       self.pause_hermes_trials),
            "spinnaker": (self.pause_spinnaker, self.ci_spinnaker,
                          self.spinnaker_events, self.hist_spinnaker,
                          self.pause_spinnaker_trials),
        }[engine]
        return {"pause": by[0], "ci_pause": by[1], "events": by[2],
                "hist": by[3], "pause_trials": by[4]}


# ---------------------------------------------------------------------------
# The per-event step
# ---------------------------------------------------------------------------

def _hist_add(hist_bins: int, hist, mask, d):
    """Add completed pause durations d (B, P) where mask into
    power-of-two buckets (bucket k counts [2^k, 2^(k+1)), top bucket
    open-ended).  The bucket is #{k in 1..hist_bins-1 : d >= 2^k}, the
    reference's count of comparisons, taken by one ``torch.bucketize``
    against the edges 2^k.  Duration-0 runs are dropped."""
    mask = mask & (d > 0)
    edges = torch.tensor([1 << k for k in range(1, hist_bins)],
                         dtype=d.dtype, device=d.device)
    b = torch.bucketize(d, edges, right=True)                 # (B, P)
    return hist + torch.zeros_like(hist, dtype=torch.int64).scatter_add_(
        1, b, mask.to(torch.int64)).to(torch.int32)


def _fdiv(a, b):
    """Floor division of integer tensors (numpy's ``//``; every operand
    the engine divides is non-negative)."""
    return torch.div(a, b, rounding_mode="floor")


def _make_step(dt_fn, advance, succ, *, n: int, P: int, rf: int,
               dupres_ticks: int, rebuild_steps: int, hist_bins: int,
               rebuild_model: str = "fixed", rebuild_ticks=None,
               bandwidth_fp=None, rebuild_fp=None,
               packed: bool = False, lat_fn=None, engines: tuple = (),
               lease_ticks: int = 0, view_change_ticks: int = 0,
               disable=frozenset()):
    """The step closure for one configuration: ``step`` (fixed model),
    ``step_fixed_bw`` (fixed, shared bandwidth) or ``step_reconfig``,
    each the reference's op for op (``step_reconfig`` in the order of the
    reference's packed step, in both layouts).  Carry
    layout is the reference's: 20 base leaves, + (roster, recruit) under
    reconfig or + (recruit,) under fixed with shared bandwidth, then 7
    leaves per zoo engine (hermes, then spinnaker), then the 5 lat leaves
    when `lat_fn` is set.  `disable` strips single zoo transition
    predicates (DISABLE_PREDICATES) for the necessity tests."""
    device = succ.device
    hermes = "hermes" in engines
    spinnaker = "spinnaker" in engines
    lease_on = "lease-expiry" not in disable
    vc_on = "view-change-trigger" not in disable
    recruit_on = "roster-recruit" not in disable
    base_len = 20 + (2 if rebuild_model == "reconfig"
                     else int(bandwidth_fp is not None))
    p_idx = torch.arange(P, dtype=torch.int64, device=device)[None, :]
    lanes_n = torch.arange(n, dtype=torch.int32, device=device)
    slot = torch.arange(rf, dtype=torch.int32, device=device)

    def hist_add(hist, mask, d):
        return _hist_add(hist_bins, hist, mask, d)

    def succ_node(rank, hi: int):
        """succ[p, clip(rank, 0, hi)] as int32 node ids (B, P); succ is
        int64, so the gather is cast back before it meets recruit."""
        return succ[p_idx, rank.clamp(0, hi).to(torch.int64)] \
            .to(torch.int32)

    def contention_rate(counts, recruit):
        """The bandwidth share, in work units per tick, each partition's
        recruit node grants it: min(_REB_SCALE, bandwidth_fp // k) with k
        the node's in-flight count (1 for an unknown recruit)."""
        k = torch.gather(counts, 1,
                         recruit.clamp(0, n - 1).to(torch.int64))
        # sentinel-recruit partitions must not inherit node n-1's
        # in-flight count from the clipped gather
        k = torch.where(recruit < n, k.clamp(min=1), 1)
        return _fdiv(torch.full_like(k, bandwidth_fp), k) \
            .clamp(max=_REB_SCALE)

    def split_carry(carry):
        """(base leaves, hermes state, spinnaker state, lat leaves)."""
        k = base_len
        hstate = sstate = None
        if hermes:
            hstate, k = carry[k:k + 7], k + 7
        if spinnaker:
            sstate, k = carry[k:k + 7], k + 7
        return carry[:base_len], hstate, sstate, carry[k:]

    def join_carry(base, hstate, sstate, lat):
        return base + (hstate if hermes else ()) \
            + (sstate if spinnaker else ()) + lat

    # -- the client-latency hooks (no-ops without a latency plan)

    def lat_interval(lat, dt_i, ldn, qmaj_prev, rem):
        """Charge the client-latency layer for one event interval from
        interval-start state: the partition serves where LARK was up,
        the majority and the remaining rebuild are interval_pause's."""
        if lat_fn is None:
            return lat
        return lat_fn(lat, dt_i, ~ldn, qmaj_prev, rem)

    def lat_dirty_reset(lat, pen):
        """A leader change onto a stale leader makes every key of the
        partition dirty: its next touch pays the dup-res round."""
        if lat_fn is None or pen is None:
            return lat
        return (torch.where(pen[:, :, None], 1.0, lat[0]),) + lat[1:]

    # -- shared protocol blocks, run verbatim by every model

    def interval_pause(now, dt, dt_i, ldn, qrep, qreb, qdn, qt0, lpt, qpt,
                       qhist, rate=None):
        """Pause time over [now, t_clamp) from interval-start state.

        rate=None is the fixed model's plain-tick countdown; a rate tensor
        puts qreb in _REB_SCALE work units.  The rebuild-overlap charge
        sums integer terms in float32 over partitions, as the reference
        does: any summation order gives the reference's bits while the
        partial sums stay below 2^24, which P * horizon bounds at every
        configuration the engine is run at.  Also returns the
        interval-start majority mask and remaining rebuild wall-ticks,
        which the zoo and the latency layer charge from."""
        lpt = lpt + ldn.sum(dim=1).to(torch.float32) * dt
        qmaj_prev = 2 * qrep.sum(dim=2) > rf                  # (B, P)
        qpt = qpt + (~qmaj_prev).sum(dim=1).to(torch.float32) * dt
        if rate is None:
            rem = qreb                       # remaining wall-ticks
            prog = dt_i[:, None]             # progress over the interval
        else:
            safe_rate = rate.clamp(min=1)
            rem = torch.where(qreb > 0,
                              torch.where(rate > 0,
                                          _fdiv(qreb + safe_rate - 1,
                                                safe_rate),
                                          _REB_BIG),
                              0)
            prog = dt_i[:, None] * rate
        qpt = qpt + torch.where(
            qmaj_prev, torch.minimum(rem, dt_i[:, None]), 0) \
            .to(torch.float32).sum(dim=1)
        ends_mid = qdn & qmaj_prev & (qreb > 0) & (prog >= qreb)
        qhist = hist_add(qhist, ends_mid, (now[:, None] + rem) - qt0)
        qdn = qdn & ~ends_mid
        qreb = (qreb - prog).clamp(min=0)
        return lpt, qpt, qreb, qdn, qhist, qmaj_prev, rem

    def lark_transitions(t_clamp, lark, ldr, lfull, ldn, lt0, leader, lpt,
                         lev, lhist):
        """Close LARK runs that came back, open new ones, and charge the
        dup-res penalty (available partition, new acting leader that
        lacks the latest copy).  Returns the penalty mask `pen` too
        (None without a dup-res cost), for the latency layer."""
        lhist = hist_add(lhist, ldn & lark, t_clamp[:, None] - lt0)
        lgo = ~ldn & ~lark
        lt0 = torch.where(lgo, t_clamp[:, None], lt0)
        lev = lev + lgo.sum(dim=1).to(torch.int32)
        ldn = ~lark
        pen = None
        if dupres_ticks > 0:
            pen = (ldr != leader) & lark & ~lfull
            npen = pen.sum(dim=1).to(torch.int32)
            # two eager ops: no FMA (invariant 8)
            lpt = lpt + npen.to(torch.float32) * float(dupres_ticks)
            lev = lev + npen
            lhist = hist_add(lhist, pen, torch.full(
                pen.shape, dupres_ticks, dtype=torch.int32, device=device))
        leader = torch.where(lark, ldr, leader)
        return ldn, lt0, leader, lpt, lev, lhist, pen

    def pause_transitions(t_clamp, pause, dn, t0, ev, hist):
        """Close pause runs whose condition cleared, open new ones (a
        pause start is one event) — the block the quorum baseline and
        every zoo engine share, in one op order."""
        hist = hist_add(hist, dn & ~pause, t_clamp[:, None] - t0)
        go = ~dn & pause
        t0 = torch.where(go, t_clamp[:, None], t0)
        ev = ev + go.sum(dim=1).to(torch.int32)
        return pause, t0, ev, hist

    def quorum_transitions(t_clamp, qmaj, qreb, qdn, qt0, qev, qhist):
        return pause_transitions(t_clamp, ~qmaj | (qreb > 0), qdn, qt0,
                                 qev, qhist)

    # -- protocol-zoo engines: 7 leaves each — (dn bool, t0 i32, two
    # engine-specific (B, P) i32 states, pt f32 (B,), ev i32 (B,), hist
    # i32 (B, hist_bins)) — and no randomness of their own (invariant 3)

    def knob_interval(now, dt, dt_i, base_dn, rem_x, dn, t0, pt, hist, *,
                      expire=True):
        """Interval pause charge for a knob-pause engine: full dt where
        its base condition held at interval start (the lark/quorum
        expression), plus min(countdown, dt) where it did not but a knob
        countdown ran; a countdown expiring mid-interval with the base
        condition clear closes the pause run between events."""
        pt = pt + base_dn.sum(dim=1).to(torch.float32) * dt
        pt = pt + torch.where(~base_dn, torch.minimum(rem_x, dt_i[:, None]),
                              0).to(torch.float32).sum(dim=1)
        if expire:
            ends_mid = dn & ~base_dn & (rem_x > 0) & \
                (dt_i[:, None] >= rem_x)
            hist = hist_add(hist, ends_mid, (now[:, None] + rem_x) - t0)
            dn = dn & ~ends_mid
        return pt, dn, hist

    def hermes_interval(now, dt, dt_i, ldn, hstate):
        """Hermes: down wherever PAC was down at interval start, plus the
        remaining lease-epoch wait where writes were blocked."""
        hdn, ht0, hmask, hlease, hpt, hev, hhist = hstate
        hpt, hdn, hhist = knob_interval(now, dt, dt_i, ldn, hlease, hdn,
                                        ht0, hpt, hhist, expire=lease_on)
        if lease_on:
            hlease = (hlease - dt_i[:, None]).clamp(min=0)
        return (hdn, ht0, hmask, hlease, hpt, hev, hhist)

    def hermes_post(t_clamp, lark, repm, hstate):
        """A member of the carried membership view going down is a
        suspicion: writes block for lease_ticks, and the view re-forms
        on the surviving replicas."""
        hdn, ht0, hmask, hlease, hpt, hev, hhist = hstate
        loss_h = (hmask & ~repm) != 0
        if lease_ticks > 0:
            hlease = torch.where(loss_h, lease_ticks, hlease)
        hmask = repm
        hpause = ~lark | (hlease > 0)
        hdn, ht0, hev, hhist = pause_transitions(t_clamp, hpause, hdn,
                                                 ht0, hev, hhist)
        return (hdn, ht0, hmask, hlease, hpt, hev, hhist)

    def spinnaker_interval(now, dt, dt_i, qmaj_prev, rem0, sstate):
        """Spinnaker: the quorum baseline's interval accounting with the
        view-change countdown overlaid (the later of the two clears the
        pause, so the remaining wait is their max)."""
        sdn, st0, sldr, svc, spt, sev, shist = sstate
        spt, sdn, shist = knob_interval(
            now, dt, dt_i, ~qmaj_prev, torch.maximum(rem0, svc), sdn, st0,
            spt, shist)
        svc = (svc - dt_i[:, None]).clamp(min=0)
        return (sdn, st0, sldr, svc, spt, sev, shist)

    def spinnaker_post(t_clamp, qmaj, qreb, rup_post, roster, rlead,
                       sstate):
        """Losing the elected leader (no longer an up roster member)
        triggers a view change: the new leader, the lowest up roster rank
        (the kernel's rleader), pauses commits for view_change_ticks."""
        sdn, st0, sldr, svc, spt, sev, shist = sstate
        valid = ((roster == sldr[:, :, None]) & rup_post).any(dim=2)
        new_sldr = torch.where(valid, sldr, rlead)
        trigger = ~valid & (sldr < n) & (new_sldr < n) & \
            (new_sldr != sldr)
        if view_change_ticks > 0 and vc_on:
            svc = torch.where(trigger, view_change_ticks, svc)
        sldr = new_sldr
        spause = ~qmaj | (qreb > 0) | (svc > 0)
        sdn, st0, sev, shist = pause_transitions(t_clamp, spause, sdn,
                                                 st0, sev, shist)
        return (sdn, st0, sldr, svc, spt, sev, shist)

    def zoo_interval(now, dt, dt_i, ldn, qmaj_prev, rem0, hstate, sstate):
        if hermes:
            hstate = hermes_interval(now, dt, dt_i, ldn, hstate)
        if spinnaker:
            sstate = spinnaker_interval(now, dt, dt_i, qmaj_prev, rem0,
                                        sstate)
        return hstate, sstate

    def outputs(t_clamp, ldn, qdn, up, hstate, sstate):
        out = (t_clamp, ldn.sum(dim=1).to(torch.int32),
               qdn.sum(dim=1).to(torch.int32),
               up.sum(dim=1).to(torch.int32))
        if hermes:
            out = out + (hstate[0].sum(dim=1).to(torch.int32),)
        if spinnaker:
            out = out + (sstate[0].sum(dim=1).to(torch.int32),)
        return out

    def unpack_rows(out_t, B):
        return tuple(o.reshape(B, P) for o in out_t[:4])

    def repmask_of(out_t, B):
        """The hermes membership bitmask, the first extra (B, P)."""
        return out_t[5].reshape(B, P) if hermes else None

    def step(carry, s: int):
        base, hstate, sstate, lat = split_carry(carry)
        (now, up, ev_t, full, rr_t, rr_idx, lane0, ldn, lt0, qrep, qreb,
         qdn, qt0, leader, lpt, qpt, lev, qev, lhist, qhist) = base
        B = up.shape[0]
        t_clamp, dt, active, up, ev_t, rr_t, rr_idx = advance(
            now, up, ev_t, rr_t, rr_idx, lane0, s)
        dt_i = t_clamp - now                                  # (B,) int32
        lpt, qpt, qreb, qdn, qhist, qmaj_prev, rem0 = interval_pause(
            now, dt, dt_i, ldn, qrep, qreb, qdn, qt0, lpt, qpt, qhist)
        hstate, sstate = zoo_interval(now, dt, dt_i, ldn, qmaj_prev, rem0,
                                      hstate, sstate)
        lat = lat_interval(lat, dt_i, ldn, qmaj_prev, rem0)
        now = t_clamp

        # -- re-evaluate both protocols on the post-event cluster state
        up_succ = up[:, succ]                                 # (B, P, n)
        rep_new = up_succ[:, :, :rf]                          # replica lanes
        if packed:
            out_t = dt_fn(_pack_holders(up_succ), full)
            lark, qmaj, ldr, lfull = out_t[:4]
            full = torch.where(lark[:, None, :], out_t[-1], full)
        else:
            out_t = dt_fn(up_succ.reshape(B * P, n), full.reshape(B * P, n))
            lark, qmaj, ldr, lfull = unpack_rows(out_t, B)
            full = torch.where(lark[:, :, None],
                               out_t[-1].reshape(B, P, n), full)
        repm = repmask_of(out_t, B)

        ldn, lt0, leader, lpt, lev, lhist, pen = lark_transitions(
            t_clamp, lark, ldr, lfull, ldn, lt0, leader, lpt, lev, lhist)
        lat = lat_dirty_reset(lat, pen)
        # -- any replica loss (a replica lane going up -> down, even if
        # masked by a simultaneous recovery of another lane) (re)starts
        # the constant rebuild countdown
        if rebuild_steps > 0:
            loss = (qrep & ~rep_new).any(dim=2)
            qreb = torch.where(loss, rebuild_steps, qreb)
        qdn, qt0, qev, qhist = quorum_transitions(
            t_clamp, qmaj, qreb, qdn, qt0, qev, qhist)
        qrep = rep_new
        if hermes:
            hstate = hermes_post(t_clamp, lark, repm, hstate)
        carry = join_carry(
            (now, up, ev_t, full, rr_t, rr_idx, lane0, ldn, lt0, qrep, qreb,
             qdn, qt0, leader, lpt, qpt, lev, qev, lhist, qhist),
            hstate, sstate, lat)
        return carry, outputs(t_clamp, ldn, qdn, up, hstate, sstate)

    def step_fixed_bw(carry, s: int):
        """The fixed model with per-node bandwidth-contended rebuilds:
        qreb in _REB_SCALE work units (restart value `rebuild_fp`), the
        rebuild pinned to the lost replica's own node (the carried
        `recruit` leaf).  As the reference, the post-event evaluation
        (and, packed, the counts in the same launch) runs before the
        interval charges; the counts and interval_pause still see the
        interval-start recruit/qreb, so this is a dataflow reorder of
        `step`."""
        base, hstate, sstate, lat = split_carry(carry)
        (now, up, ev_t, full, rr_t, rr_idx, lane0, ldn, lt0, qrep, qreb,
         qdn, qt0, leader, lpt, qpt, lev, qev, lhist, qhist,
         recruit) = base
        B = up.shape[0]
        t_clamp, dt, active, up, ev_t, rr_t, rr_idx = advance(
            now, up, ev_t, rr_t, rr_idx, lane0, s)
        dt_i = t_clamp - now                                  # (B,) int32

        up_succ = up[:, succ]                                 # (B, P, n)
        rep_new = up_succ[:, :, :rf]                          # replica lanes
        inflight = (qreb > 0) & (recruit < n)
        if packed:
            out_t = dt_fn(_pack_holders(up_succ), full, None, recruit,
                          inflight)
            lark, qmaj, ldr, lfull = out_t[:4]
        else:
            out_t = dt_fn(up_succ.reshape(B * P, n),
                          full.reshape(B * P, n), None, recruit, inflight)
            lark, qmaj, ldr, lfull = unpack_rows(out_t, B)
        repm = repmask_of(out_t, B)
        rate = contention_rate(out_t[-1], recruit)

        lpt, qpt, qreb, qdn, qhist, qmaj_prev, rem0 = interval_pause(
            now, dt, dt_i, ldn, qrep, qreb, qdn, qt0, lpt, qpt, qhist,
            rate=rate)
        hstate, sstate = zoo_interval(now, dt, dt_i, ldn, qmaj_prev, rem0,
                                      hstate, sstate)
        lat = lat_interval(lat, dt_i, ldn, qmaj_prev, rem0)
        now = t_clamp

        if packed:
            full = torch.where(lark[:, None, :], out_t[-2], full)
        else:
            full = torch.where(lark[:, :, None],
                               out_t[-2].reshape(B, P, n), full)
        ldn, lt0, leader, lpt, lev, lhist, pen = lark_transitions(
            t_clamp, lark, ldr, lfull, ldn, lt0, leader, lpt, lev, lhist)
        lat = lat_dirty_reset(lat, pen)

        # -- a replica loss (re)starts the constant countdown in
        # fixed-point units and pins the rebuild to the lowest replica
        # lane that went up -> down this step
        if rebuild_fp is not None and rebuild_fp > 0:
            lost = qrep & ~rep_new                            # (B, P, rf)
            loss = lost.any(dim=2)
            qreb = torch.where(loss, rebuild_fp, qreb)
            rank = torch.where(lost, slot[None, None, :], rf).amin(dim=2)
            recruit = torch.where(loss, succ_node(rank, rf - 1), recruit)
        qdn, qt0, qev, qhist = quorum_transitions(
            t_clamp, qmaj, qreb, qdn, qt0, qev, qhist)
        qrep = rep_new
        if hermes:
            hstate = hermes_post(t_clamp, lark, repm, hstate)
        carry = join_carry(
            (now, up, ev_t, full, rr_t, rr_idx, lane0, ldn, lt0, qrep, qreb,
             qdn, qt0, leader, lpt, qpt, lev, qev, lhist, qhist, recruit),
            hstate, sstate, lat)
        return carry, outputs(t_clamp, ldn, qdn, up, hstate, sstate)

    def recruit_roster(up_succ, rup, roster):
        """Replace every down roster member with the first up node in
        succession order not already in the roster (a seat with no up
        candidate is kept until a later step finds one).  Returns the new
        roster and (new_rank, took): the most recent recruit's rank per
        partition and whether any seat was filled.  With the
        "roster-recruit" predicate disabled no seat is ever filled."""
        if not recruit_on:
            return (roster,
                    torch.full(rup.shape[:2], n, dtype=torch.int32,
                               device=device),
                    torch.zeros(rup.shape[:2], dtype=torch.bool,
                                device=device))
        in_roster = torch.zeros(up_succ.shape, dtype=torch.bool,
                                device=device)
        for j in range(rf):
            in_roster = in_roster | (lanes_n[None, None, :]
                                     == roster[:, :, j, None])
        new_rank = torch.full(rup.shape[:2], n, dtype=torch.int32,
                              device=device)
        took = torch.zeros(rup.shape[:2], dtype=torch.bool, device=device)
        for j in range(rf):
            need = ~rup[:, :, j]
            cand = up_succ & ~in_roster
            repl = torch.where(cand, lanes_n[None, None, :], n).amin(dim=2)
            take = need & (repl < n)
            old_j = roster[:, :, j]
            new_j = torch.where(take, repl, old_j)
            in_roster = in_roster & ~(take[:, :, None] &
                                      (lanes_n[None, None, :]
                                       == old_j[:, :, None]))
            in_roster = in_roster | (take[:, :, None] &
                                     (lanes_n[None, None, :]
                                      == new_j[:, :, None]))
            roster = torch.where((slot == j)[None, None, :],
                                 new_j[:, :, None], roster)
            new_rank = torch.where(take, repl, new_rank)
            took = took | take
        return roster, new_rank, took

    def roster_up(up_succ, roster):
        """up_succ[b, p, roster[b, p, j]] (B, P, rf) — the carried int32
        roster cast to int64 only for the gather."""
        return torch.gather(up_succ, 2, roster.to(torch.int64))

    def reconfigure(up_succ, roster, qrep):
        """Fresh losses (roster members up at interval start, down now)
        restart the data-sized catch-up; recruitment refills the seats
        and names the ingesting node (the most recent recruit; unknown,
        n, when a loss found no candidate)."""
        rup = roster_up(up_succ, roster)
        loss_any = (qrep & ~rup).any(dim=2)
        roster, new_rank, took = recruit_roster(up_succ, rup, roster)
        return roster, loss_any, new_rank, took

    def restart_catchups(loss_any, new_rank, took, qreb, recruit):
        qreb = torch.where(loss_any, rebuild_ticks[None, :], qreb)
        recruit = torch.where(took, succ_node(new_rank, n - 1),
                              torch.where(loss_any, n, recruit))
        return qreb, recruit

    def zoo_post(t_clamp, lark, qmaj, qreb, qrep, roster, repm, rlead,
                 hstate, sstate):
        if hermes:
            hstate = hermes_post(t_clamp, lark, repm, hstate)
        if spinnaker:
            sstate = spinnaker_post(t_clamp, qmaj, qreb, qrep, roster,
                                    rlead, sstate)
        return hstate, sstate

    def step_reconfig(carry, s: int):
        """The reconfiguring baseline: `step`'s shared blocks with the
        carried per-partition roster as the replica set and the
        per-partition `rebuild_ticks` catch-ups in fixed-point units,
        shared per recruit node when bandwidth_fp is set.  Reordered as
        the reference's packed step so that the evaluation, the roster
        select, the zoo extras and the in-flight counts are one launch
        (``downtime_eval`` in its counts mode, or ``fused_downtime_eval``
        packed): the reconfiguration runs first, the counts still see the
        interval-start recruit/qreb, and interval_pause the
        interval-start protocol state.  LARK's path is untouched."""
        base, hstate, sstate, lat = split_carry(carry)
        (now, up, ev_t, full, rr_t, rr_idx, lane0, ldn, lt0, qrep, qreb,
         qdn, qt0, leader, lpt, qpt, lev, qev, lhist, qhist,
         roster, recruit) = base
        B = up.shape[0]
        t_clamp, dt, active, up, ev_t, rr_t, rr_idx = advance(
            now, up, ev_t, rr_t, rr_idx, lane0, s)
        dt_i = t_clamp - now                                  # (B,) int32

        up_succ = up[:, succ]                                 # (B, P, n)
        roster, loss_any, new_rank, took = reconfigure(up_succ, roster,
                                                       qrep)
        if packed:
            tiles = (_pack_holders(up_succ), full, roster)
        else:
            tiles = (up_succ.reshape(B * P, n), full.reshape(B * P, n),
                     roster.reshape(B * P, rf))
        if bandwidth_fp is None:
            out_t = dt_fn(*tiles)
            rate = torch.full((B, P), _REB_SCALE, dtype=torch.int32,
                              device=device)
        else:
            inflight = (qreb > 0) & (recruit < n)
            *out_t, counts = dt_fn(*tiles, recruit, inflight)
            rate = contention_rate(counts, recruit)
        if packed:
            lark, qmaj, ldr, lfull = out_t[:4]
        else:
            lark, qmaj, ldr, lfull = unpack_rows(out_t, B)
        repm = repmask_of(out_t, B)
        rlead = out_t[5 + int(hermes)].reshape(B, P) if spinnaker else None

        lpt, qpt, qreb, qdn, qhist, qmaj_prev, rem0 = interval_pause(
            now, dt, dt_i, ldn, qrep, qreb, qdn, qt0, lpt, qpt, qhist,
            rate=rate)
        hstate, sstate = zoo_interval(now, dt, dt_i, ldn, qmaj_prev, rem0,
                                      hstate, sstate)
        lat = lat_interval(lat, dt_i, ldn, qmaj_prev, rem0)
        now = t_clamp
        qreb, recruit = restart_catchups(loss_any, new_rank, took, qreb,
                                         recruit)

        if packed:
            full = torch.where(lark[:, None, :], out_t[-1], full)
        else:
            full = torch.where(lark[:, :, None],
                               out_t[-1].reshape(B, P, n), full)
        ldn, lt0, leader, lpt, lev, lhist, pen = lark_transitions(
            t_clamp, lark, ldr, lfull, ldn, lt0, leader, lpt, lev, lhist)
        lat = lat_dirty_reset(lat, pen)
        qdn, qt0, qev, qhist = quorum_transitions(
            t_clamp, qmaj, qreb, qdn, qt0, qev, qhist)
        qrep = roster_up(up_succ, roster)
        hstate, sstate = zoo_post(t_clamp, lark, qmaj, qreb, qrep, roster,
                                  repm, rlead, hstate, sstate)
        carry = join_carry(
            (now, up, ev_t, full, rr_t, rr_idx, lane0, ldn, lt0, qrep, qreb,
             qdn, qt0, leader, lpt, qpt, lev, qev, lhist, qhist, roster,
             recruit), hstate, sstate, lat)
        return carry, outputs(t_clamp, ldn, qdn, up, hstate, sstate)

    if rebuild_model == "reconfig":
        return step_reconfig
    if bandwidth_fp is not None:
        return step_fixed_bw
    return step


# ---------------------------------------------------------------------------
# Carry exchange with the reference engine
# ---------------------------------------------------------------------------

#: carry slots: (now, up, ev_t, full, rr_t, rr_idx, lane0, ldn, lt0, qrep,
#: qreb, qdn, qt0, leader, lpt, qpt, lev, qev, lhist, qhist[, roster],
#: [recruit]), then the hermes and spinnaker blocks (dn, t0, two int32
#: states, pt, ev, hist each), then the lat leaves (dirty, dup, qhist,
#: qslo, qsum)
_FULL, _LANE0 = 3, 6


def carry_from_numpy(carry, device=None):
    """The reference downtime engine's carry, in its order — its 20
    leaves, plus (roster, recruit) under reconfig or (recruit,) under
    fixed with shared bandwidth, then the 7 leaves of each zoo engine
    (hermes, then spinnaker) and the 5 float32 lat leaves — as the port's
    tensors on `device` (``None``: the card, via ``resolve_device``).
    Packed holder words (uint32) are reinterpreted as int32; lane0
    (uint32) becomes int64 of the same value; every other leaf keeps its
    dtype (roster, recruit and the hermes mask stay int32)."""
    dev = resolve_device(device)
    out = []
    for i, a in enumerate(carry):
        a = np.asarray(a)
        if i == _LANE0:
            a = a.astype(np.int64)
        elif a.dtype == np.uint32:
            a = np.ascontiguousarray(a).view(np.int32)
        out.append(torch.from_numpy(np.array(a)).to(dev))
    return tuple(out)


def carry_to_numpy(carry):
    """The port's downtime carry as the reference engine's numpy arrays
    (holder words back to uint32, lane0 to uint32, the rest as carried)."""
    out = []
    for i, t in enumerate(carry):
        a = t.detach().cpu().numpy()
        if i == _LANE0:
            a = a.astype(np.uint32)
        elif i == _FULL and a.dtype == np.int32:
            a = a.view(np.uint32)
        out.append(a)
    return tuple(out)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def simulate_downtime_batched(
        *, n: int = 155, partitions: int = 4096, rf: int = 2,
        p: float = 1e-3, downtime: int = 10, trials: int = 8,
        min_ticks: int = 50_000, max_ticks: int = 3_000_000,
        eps_abs: float = 5e-6, eps_rel: float = 0.05,
        min_events: int = 200, seed: int = 0,
        dupres_ticks: int = 1, rebuild_steps: int = 100,
        hist_bins: int = 16,
        rebuild_model: str = "fixed", rebuild_ticks_per_gib: int = 100,
        size_dist: str = "uniform", size_skew: float = 1.0,
        node_bandwidth_gibps: float = math.inf,
        pair_fail_prob: float = 0.0, restart_period: int = 0,
        wave_width: int = 1, p_node=None, downtime_node=None,
        devices: int = 1, chunk_steps: int = 512,
        max_steps: Optional[int] = None, trajectory: bool = False,
        params: Optional[DowntimeParams] = None, packed: bool = False,
        engines: tuple = ("lark", "quorum"), lease_ticks: int = 0,
        view_change_ticks: int = 0, _disable_predicates: tuple = (),
        _lat_plan=None, use_shard_map: Optional[bool] = None,
        device=None, pac_block_p: Optional[int] = None,
        block_t: Optional[int] = None) -> BatchedDowntimeResult:
    """Batched §6 commit-pause Monte Carlo over `trials` trajectories —
    the reference's knobs and results (see its docstring for each knob).

    The protocol/rebuild knobs come individually or as one validated
    ``params=DowntimeParams(...)``, which then takes precedence.
    device: ``None`` runs on ``cuda`` (and raises without a card);
    ``"cpu"`` runs the plain PyTorch kernels.  devices > 1 shards the
    trials over the default process group's ranks, as the availability
    engine does (``use_shard_map`` forces that path at devices = 1), or
    runs them as one batch without a group — bit-identical either way.
    packed=True carries the holder
    masks as (B, W, P) int32 words and evaluates each step with one
    ``fused_downtime_eval`` launch — layout only, bit-identical.
    pac_block_p (and, packed, block_t) is the kernel's tile, typically an
    autotuner's choice (``step_eval``'s block_p / block_t; None: the
    kernel's default) — throughput only.

    engines adds the protocol zoo on the same node trajectories (hermes:
    `lease_ticks` membership leases; spinnaker: `view_change_ticks`
    reconciliation on leader loss, reconfig only); the zoo changes no
    lark/quorum output bit.  _disable_predicates (private,
    DISABLE_PREDICATES) strips single zoo transition predicates for the
    necessity tests.  _lat_plan (private; set by core/client_latency.py)
    appends the client-latency accumulators to the carry and fills
    `latency_raw`.
    """
    _validate_batched_args(devices=devices, trials=trials,
                           wave_width=wave_width, n=n)
    if params is None:
        params = DowntimeParams(
            dupres_ticks=dupres_ticks, rebuild_steps=rebuild_steps,
            hist_bins=hist_bins, rebuild_model=rebuild_model,
            rebuild_ticks_per_gib=rebuild_ticks_per_gib,
            size_dist=size_dist, size_skew=size_skew,
            node_bandwidth_gibps=node_bandwidth_gibps,
            engines=engines, lease_ticks=lease_ticks,
            view_change_ticks=view_change_ticks)
    dupres_ticks, rebuild_steps = params.dupres_ticks, params.rebuild_steps
    hist_bins, rebuild_model = params.hist_bins, params.rebuild_model
    rebuild_ticks_per_gib = params.rebuild_ticks_per_gib
    size_dist, size_skew = params.size_dist, params.size_skew
    node_bandwidth_gibps = params.node_bandwidth_gibps
    reconfig = params.reconfig
    bandwidth_shared = params.bandwidth_shared
    hermes_on, spinnaker_on = params.hermes, params.spinnaker
    disable = frozenset(_disable_predicates)
    unknown = disable - set(DISABLE_PREDICATES)
    if unknown:
        raise ValueError(f"unknown disable predicates {sorted(unknown)}; "
                         f"expected a subset of {DISABLE_PREDICATES}")
    if (reconfig or bandwidth_shared) \
            and max_ticks > (2 ** 31 - 1) // _REB_SCALE - 2:
        raise ValueError("max_ticks too large for the fixed-point "
                         f"catch-up countdowns (<= "
                         f"{(2 ** 31 - 1) // _REB_SCALE - 2})")
    dev = resolve_device(device)
    shards = _TrialShards(trials, devices, use_shard_map
                          if use_shard_map is not None else devices > 1)
    B, P, horizon = shards.local, partitions, max_ticks   # this rank's B
    (succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     p_arr, dt_arr) = _engine_setup(
        n=n, partitions=P, seed=seed, p=p, downtime=downtime,
        p_node=p_node, downtime_node=downtime_node, max_ticks=max_ticks,
        device=dev)
    zoo = tuple(e for e in ("hermes", "spinnaker") if e in params.engines)
    spec = StepSpec(metric="downtime", rf=rf, n_real=n,
                    rebuild_model=rebuild_model, packed=packed,
                    dupres_ticks=dupres_ticks, rebuild_steps=rebuild_steps,
                    engines=zoo)

    def dt_fn(u, f, roster=None, recruit=None, active=None):
        """(lark, qmaj, leader, leader_full, nrep, *extras, creps
        [, counts]); the extras are repmask (hermes) and rleader
        (spinnaker, roster calls only)."""
        o = step_eval(spec, u, f, roster=roster, recruit=recruit,
                      active=active, block_p=pac_block_p, block_t=block_t)
        extras = tuple(x for x in (o.repmask, o.rleader) if x is not None)
        base = (o.lark, o.maj, o.leader, o.leader_full, o.nrep) + extras \
            + (o.creps,)
        return (base + (o.counts,)) if recruit is not None else base

    rebuild_ticks = torch.as_tensor(_partition_rebuild_ticks(
        seed, P, rebuild_ticks_per_gib, dist=size_dist, skew=size_skew,
        cap=max_ticks + 1) * np.int32(_REB_SCALE), device=dev) \
        if reconfig else None
    bandwidth_fp = int(min(math.floor(_REB_SCALE * node_bandwidth_gibps),
                           _REB_BIG)) if bandwidth_shared else None
    # fixed-model restart value in fixed-point work units; the horizon
    # cap keeps rebuild_steps * _REB_SCALE inside int32
    rebuild_fp = int(min(rebuild_steps, max_ticks + 1)) * _REB_SCALE \
        if (bandwidth_shared and not reconfig) else None
    advance = _make_node_advance(
        n=n, horizon=horizon, dt_vec=dt_vec, geo_masks=geo_masks,
        geo_tables=geo_tables, seed_mix=seed_mix,
        pair_fail_prob=pair_fail_prob, pair_perm=pair_perm,
        restart_period=restart_period, wave_width=wave_width)
    lat_fn = None
    if _lat_plan is not None:
        lat_pow = torch.as_tensor(_lat_plan.pow_tables, device=dev)
        lat_kf = torch.as_tensor(_lat_plan.kf, device=dev)
        lat_lamw = torch.as_tensor(_lat_plan.lamw, device=dev)

        def lat_fn(lat, dt_i, avail, qok, rem):
            nd, di, hi, si, qi = client_latency_step(
                lat[0], dt_i, avail, qok, rem, pow_tables=lat_pow,
                kf=lat_kf, lamw=lat_lamw, nbins=_lat_plan.nbins,
                slo_ticks=_lat_plan.slo_ticks)
            # the charges accumulate by one eager float32 add each
            return (nd, lat[1] + di, lat[2] + hi, lat[3] + si,
                    lat[4] + qi)
    step = _make_step(dt_fn, advance, succ, n=n, P=P, rf=rf,
                      dupres_ticks=dupres_ticks,
                      rebuild_steps=rebuild_steps, hist_bins=hist_bins,
                      rebuild_model=rebuild_model,
                      rebuild_ticks=rebuild_ticks,
                      bandwidth_fp=bandwidth_fp,
                      rebuild_fp=rebuild_fp, packed=packed, lat_fn=lat_fn,
                      engines=zoo, lease_ticks=params.lease_ticks,
                      view_change_ticks=params.view_change_ticks,
                      disable=disable)

    # initial state: everyone up, roster replicas full, both protocols
    # evaluated once at t=0 — without a roster under both models (the
    # t=0 roster is [0..rf-1], so the plain evaluation is exact); under
    # hermes that evaluation also returns the t=0 membership bitmask
    lane0, up0, ev0, rr_t0 = _initial_node_state(
        B=B, n=n, seed_mix=seed_mix, geo_masks=geo_masks,
        geo_tables=geo_tables, restart_period=restart_period,
        horizon=horizon, device=dev, trial0=shards.lo)
    full0, outs0 = _initial_full_state(dt_fn, up0, succ, B=B, P=P, n=n,
                                       rf=rf, packed=packed)
    lark0 = outs0[0].reshape(B, P)
    qmaj0 = outs0[1].reshape(B, P)
    ldr0 = outs0[2].reshape(B, P)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    zf = torch.zeros((B,), dtype=torch.float32, device=dev)
    zbp = torch.zeros((B, P), dtype=torch.int32, device=dev)
    zh = torch.zeros((B, hist_bins), dtype=torch.int32, device=dev)
    carry = (zi, up0, ev0, full0, rr_t0, zi, lane0,
             ~lark0, zbp,                              # ldn, lt0
             up0[:, succ[:, :rf]],                     # qrep (all up)
             zbp,                                      # qreb
             ~qmaj0, zbp,                              # qdn, qt0
             ldr0.to(torch.int32),                     # leader
             zf, zf, zi, zi, zh, zh)
    # no catch-up in flight at t=0, so no recruit node to ingest on
    recruit0 = torch.full((B, P), n, dtype=torch.int32, device=dev)
    if reconfig:
        roster0 = torch.arange(rf, dtype=torch.int32, device=dev) \
            .expand(B, P, rf).contiguous()
        carry = carry + (roster0, recruit0)
    elif bandwidth_shared:
        carry = carry + (recruit0,)
    h0 = len(carry)                   # hermes leaves start here (if any)
    if hermes_on:
        # the t=0 membership view is the repmask of the initial
        # evaluation; the pause mask starts exactly at LARK's
        hmask0 = outs0[5].reshape(B, P).to(torch.int32)
        carry = carry + (~lark0, zbp, hmask0, zbp, zf, zi, zh)
    s0_i = len(carry)                 # spinnaker leaves start here
    if spinnaker_on:
        # rank 0 leads at t=0; no view change in flight, so the pause
        # mask starts at the quorum baseline's
        carry = carry + (~qmaj0, zbp, zbp, zbp, zf, zi, zh)
    lat_i = len(carry)                # lat leaves ride at the carry tail
    if _lat_plan is not None:
        nb = _lat_plan.kf.shape[0]
        lz_nb = torch.zeros((B, P, nb), dtype=torch.float32, device=dev)
        lz_hb = torch.zeros((B, P, _lat_plan.nbins), dtype=torch.float32,
                            device=dev)
        lz_bp = torch.zeros((B, P), dtype=torch.float32, device=dev)
        # dirty starts clean (no leader has changed yet), charges at zero
        carry = carry + (lz_nb, lz_nb, lz_hb, lz_bp, lz_bp)

    if max_steps is None:
        max_steps = _default_max_steps(p_arr, dt_arr, n=n, horizon=horizon,
                                       restart_period=restart_period)

    # per-chunk accumulators, reset every drain: the base ones at fixed
    # offsets 14..19, each zoo engine's (pause time, events, histogram)
    # at offsets +4..+6 of its block
    acc_reset = {14: zf, 15: zf, 16: zi, 17: zi, 18: zh, 19: zh}
    if hermes_on:
        acc_reset.update({h0 + 4: zf, h0 + 5: zi, h0 + 6: zh})
    if spinnaker_on:
        acc_reset.update({s0_i + 4: zf, s0_i + 5: zi, s0_i + 6: zh})

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype)

    Bg = trials                       # the totals hold every rank's trials
    lpt_tot = np.zeros(Bg)
    qpt_tot = np.zeros(Bg)
    lev_tot = qev_tot = 0
    lhist_tot = np.zeros(hist_bins, dtype=np.int64)
    qhist_tot = np.zeros(hist_bins, dtype=np.int64)
    zoo_tot = {}                      # engine -> [pt (B,), ev, hist]
    for name, k0, on in (("hermes", h0, hermes_on),
                         ("spinnaker", s0_i, spinnaker_on)):
        if on:
            zoo_tot[name] = (k0, [np.zeros(Bg), 0,
                                  np.zeros(hist_bins, dtype=np.int64)])
    lat_wfp = None
    if _lat_plan is not None:
        lat_dup = np.zeros((Bg, _lat_plan.kf.shape[0]))
        lat_qhist = np.zeros((Bg, _lat_plan.nbins))
        lat_qslo = np.zeros(Bg)
        lat_qsum = np.zeros(Bg)
        if _lat_plan.wfp is not None:
            # skewed write mix: pool a second, write-fraction-weighted
            # view of the same dup charges (hermes pays dup-res on writes
            # only, so its share is per-partition under write_skew)
            lat_wfp = np.asarray(_lat_plan.wfp, dtype=np.float64)
            lat_dupw = np.zeros((Bg, _lat_plan.kf.shape[0]))
    now = np.zeros(Bg, dtype=np.int64)
    traj = [] if trajectory else None
    stopped = False
    s0 = 1
    while s0 < max_steps:
        carry, ys = _run_chunk(step, carry, s0, chunk_steps, trajectory)
        s0 += chunk_steps
        # drain per-chunk accumulators into float64/int totals: every
        # per-trial array (the latency charges already pooled over
        # partitions, host-side in float64 in the reference's order) is
        # gathered in global trial order before any sum over trials
        local = [host(carry[0], np.int64), host(carry[14], np.float64),
                 host(carry[15], np.float64)] + \
            [carry[i].cpu().numpy() for i in range(16, 20)]
        for k0, _ in zoo_tot.values():
            local += [host(carry[k0 + 4], np.float64),
                      carry[k0 + 5].cpu().numpy(),
                      host(carry[k0 + 6], np.int64)]
        if _lat_plan is not None:
            lt_ = carry[lat_i:]
            dup_bp = host(lt_[1], np.float64)
            local += [dup_bp.sum(axis=1)] + [
                host(t, np.float64).sum(axis=1) for t in lt_[2:5]]
            if lat_wfp is not None:
                local.append((dup_bp * lat_wfp[None, :, None]).sum(axis=1))
            # the dirty fractions persist; the charges restart
            carry = carry[:lat_i] + (lt_[0], lz_nb, lz_hb, lz_bp, lz_bp)
        nl = len(local)
        got = shards.gather(local + list(ys or ()),
                            [0] * nl + [1] * len(ys or ()))
        if trajectory:
            traj.append(got[nl:])
        now, lpt_c, qpt_c, lev_c, qev_c, lh_c, qh_c = got[:7]
        lpt_tot += lpt_c
        qpt_tot += qpt_c
        lev_tot += int(lev_c.sum())
        qev_tot += int(qev_c.sum())
        lhist_tot += lh_c.astype(np.int64).sum(axis=0)
        qhist_tot += qh_c.astype(np.int64).sum(axis=0)
        it = iter(got[7:nl])
        for _, tot in zoo_tot.values():
            tot[0] += next(it)
            tot[1] += int(next(it).sum())
            tot[2] += next(it).sum(axis=0)
        if _lat_plan is not None:
            lat_dup += next(it)
            lat_qhist += next(it)
            lat_qslo += next(it)
            lat_qsum += next(it)
            if lat_wfp is not None:
                lat_dupw += next(it)
        carry = tuple(acc_reset.get(i, c) for i, c in enumerate(carry))
        if (now >= horizon).all():
            break
        # pooled CI early stop, mirroring the availability engine's rule
        if now.mean() >= min_ticks and lev_tot >= min_events \
                and qev_tot >= min_events:
            pt = float(P) * float(now.sum())
            u_l = min(lpt_tot.sum() / pt, 1.0)
            u_q = min(qpt_tot.sum() / pt, 1.0)
            hw_l = 1.96 * math.sqrt(max(u_l * (1 - u_l), 1e-30) / pt)
            hw_q = 1.96 * math.sqrt(max(u_q * (1 - u_q), 1e-30) / pt)
            if hw_l <= max(eps_abs, eps_rel * u_l) and \
                    hw_q <= max(eps_abs, eps_rel * u_q):
                stopped = True
                break

    now = np.maximum(now, 1)
    B = Bg                            # every rank's trials from here on
    pt_b = P * now.astype(np.float64)
    pt = float(pt_b.sum())
    # the instantaneous dup-res charge can overshoot wall time under
    # extreme dupres_ticks — clip, as the reference
    u_l = min(float(lpt_tot.sum()) / pt, 1.0)
    u_q = min(float(qpt_tot.sum()) / pt, 1.0)
    u_l_trials = np.minimum(lpt_tot / pt_b, 1.0)
    u_q_trials = np.minimum(qpt_tot / pt_b, 1.0)
    hw_l = hw_q = 0.0
    if B >= 3:
        t = t975(B - 1) / math.sqrt(B)
        hw_l = t * float(u_l_trials.std(ddof=1))
        hw_q = t * float(u_q_trials.std(ddof=1))
    traj_out = None
    if trajectory:
        names = ["times", "paused_lark", "paused_quorum", "nodes_up"] + \
            [f"paused_{e}" for e in zoo_tot]
        cols = [np.concatenate([c[i] for c in traj])
                for i in range(len(names))]
        traj_out = dict(zip(names, cols))
    lat_raw = None
    if _lat_plan is not None:
        lat_raw = {"dup": lat_dup, "qhist": lat_qhist, "qslo": lat_qslo,
                   "qsum": lat_qsum, "now": now.copy()}
        if lat_wfp is not None:
            lat_raw["dupw"] = lat_dupw

    zoo_kw = {}
    for name, (_, (pt_tot, ev_tot, hist_tot)) in zoo_tot.items():
        u = min(float(pt_tot.sum()) / pt, 1.0)
        u_trials = np.minimum(pt_tot / pt_b, 1.0)
        hw = 0.0
        if B >= 3:
            hw = t975(B - 1) / math.sqrt(B) * float(u_trials.std(ddof=1))
        zoo_kw.update({
            f"pause_{name}": u,
            f"ci_{name}": max(hw, 1.96 * math.sqrt(
                max(u * (1 - u), 1e-30) / pt)),
            f"{name}_events": ev_tot, f"hist_{name}": hist_tot,
            f"pause_{name}_trials": u_trials})
    return BatchedDowntimeResult(
        p=p, rf=rf, n=n, partitions=P, trials=B, device=str(dev),
        ticks=int(now.mean()), pause_lark=u_l, pause_quorum=u_q,
        lark_events=lev_tot, quorum_events=qev_tot,
        ci_lark=max(hw_l,
                    1.96 * math.sqrt(max(u_l * (1 - u_l), 1e-30) / pt)),
        ci_quorum=max(hw_q,
                      1.96 * math.sqrt(max(u_q * (1 - u_q), 1e-30) / pt)),
        dupres_ticks=dupres_ticks, rebuild_steps=rebuild_steps,
        stopped_early=stopped, devices=devices,
        rebuild_model=rebuild_model,
        rebuild_ticks_per_gib=rebuild_ticks_per_gib if reconfig else 0,
        size_dist=size_dist if reconfig else "uniform",
        size_skew=size_skew if size_dist in ("zipf", "lognormal") else 0.0,
        node_bandwidth_gibps=node_bandwidth_gibps,
        hist_edges=np.asarray([1 << k for k in range(hist_bins)],
                              dtype=np.int64),
        hist_lark=lhist_tot, hist_quorum=qhist_tot,
        pause_lark_trials=u_l_trials, pause_quorum_trials=u_q_trials,
        engines=params.engines, lease_ticks=params.lease_ticks,
        view_change_ticks=params.view_change_ticks, trajectory=traj_out,
        latency_raw=lat_raw, **zoo_kw)
