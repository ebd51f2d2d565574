"""Port of ``repro/core/downtime_batched.py`` — only ``DowntimeParams``
and the constants that ``experiments/spec.py`` validates against
(lines 111-305 of the reference, copied).  The §6 commit-pause engine
itself is still to be ported (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

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
