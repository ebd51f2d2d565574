"""Frozen, declarative experiment specifications (port of
``repro/experiments/spec.py``, copied verbatim apart from this line, so
``canonical()`` and ``content_hash()`` give the reference's identity for
the same config).

``ExperimentSpec`` is the single description of one sweep run: the grid
scale, backend/device geometry, metric, scenario selection, and the full
§6 / protocol-zoo / latency-workload knob set.  Every field maps 1:1
onto a ``benchmarks/availability_sweep.py`` flag, and a spec can be
built three equivalent ways:

* ``ExperimentSpec.create(**provided)`` — programmatic; ``provided``
  holds only the keys the caller actually chose, so the metric-gated
  rules ("engines selects the protocol zoo; use metric='downtime'")
  fire exactly like the old CLI did for explicitly-passed flags.
* ``ExperimentSpec.from_file(path)`` — a TOML or JSON config; keys are
  the field names below, unknown keys are rejected with a
  nearest-match suggestion.
* the sweep CLI, which forwards its explicitly-set flags into
  ``create`` — so a CLI-built spec equals the config-built spec for the
  same choices (pinned per committed baseline config in
  tests/test_experiments.py).

Validation lives in exactly two places and nowhere else: the
*metric/engine/reconfig gating* of which knobs may be set at all is
here (``create``), and every *value* rule is delegated to
``core.downtime_batched.DowntimeParams`` plus ``__post_init__`` — the
CLI no longer owns any rule of its own.

Specs are frozen and hashable; ``canonical()`` is the stable mapping
embedded in provenance-stamped artifacts (``meta.spec``) and
``content_hash()`` its sha256 — the round trip
``ExperimentSpec.create(**spec.canonical())`` is lossless.
"""
from __future__ import annotations

import difflib
import hashlib
import json
import math
from dataclasses import dataclass, field, fields

from ..core.downtime_batched import (ENGINES, REBUILD_MODELS, SIZE_DISTS,
                                     DowntimeParams)
from ..core.scenarios import scenario_names

BACKENDS = ("event", "numpy", "jax", "pallas")
METRICS = ("availability", "downtime", "latency")

#: spec keys that only make sense for --metric downtime/latency (the §6
#: protocol/rebuild knob set)
_DOWNTIME_KEYS = ("dupres_ticks", "rebuild_steps", "rebuild_model",
                  "rebuild_ticks_per_gib", "size_dist", "size_skew",
                  "node_bandwidth_gibps")
#: spec keys that select the protocol zoo (--metric downtime only)
_ZOO_KEYS = ("engines", "lease_ticks", "view_change_ticks")
#: spec keys that model the request workload (--metric latency only)
_LATENCY_KEYS = ("key_zipf", "read_frac", "requests_per_tick", "slo_ticks",
                 "write_skew", "slo_curve_bins")
#: reconfig-only knobs among _DOWNTIME_KEYS (node_bandwidth_gibps left
#: this set when fixed-model rebuilds gained bandwidth contention — it
#: now applies to both rebuild models)
_RECONFIG_KEYS = ("size_dist", "size_skew")

#: per-metric defaults for the latency workload knobs — the non-latency
#: values are the zero-request limit DowntimeParams defaults to, so
#: params equality across metrics is stable
_LATENCY_DEFAULTS = {"key_zipf": 1.0, "read_frac": 0.8,
                     "requests_per_tick": 32.0, "slo_ticks": 8}
_NO_LATENCY_DEFAULTS = {"key_zipf": 0.0, "read_frac": 1.0,
                        "requests_per_tick": 0.0, "slo_ticks": 0}


class SpecError(ValueError):
    """An experiment spec that can never run: unknown key, a knob set
    for a metric that does not read it, or an invalid value (the latter
    re-raised from DowntimeParams so every entry point shares one error
    set)."""


def _suggest(key: str, valid) -> str:
    close = difflib.get_close_matches(key, list(valid), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


@dataclass(frozen=True)
class ExperimentSpec:
    """One sweep run, fully specified.  Field order mirrors the CLI
    surface; every default equals the resolved CLI default."""

    #: display/artifact name — configs set it; never part of identity
    name: str = field(default="", compare=False)
    metric: str = "availability"
    backend: str = "event"
    trials: int = 1
    devices: int = 1
    full: bool = False
    smoke: bool = False
    seed: int = 0
    scenarios: tuple = ()
    scenarios_only: bool = False
    packed: bool = False
    autotune: bool = False
    # §6 protocol/rebuild knobs (downtime + latency metrics)
    dupres_ticks: int = 1
    rebuild_steps: int = 100
    rebuild_model: str = "fixed"
    rebuild_ticks_per_gib: int = 100
    size_dist: str = "uniform"
    size_skew: float = 1.0
    node_bandwidth_gibps: float = math.inf
    # protocol zoo (downtime metric)
    engines: tuple = ("lark", "quorum")
    lease_ticks: int = 0
    view_change_ticks: int = 0
    # client-request workload (latency metric).  slo_ticks=0 doubles as
    # the non-latency sentinel default AND a live strict-> threshold
    # under metric 'latency' (every request with any added latency
    # violates) — the per-metric default tables below keep the two
    # readings from colliding: a latency spec defaults to 8, so 0 there
    # is always an explicit caller choice
    key_zipf: float = 0.0
    read_frac: float = 1.0
    requests_per_tick: float = 0.0
    slo_ticks: int = 0
    write_skew: float = 0.0
    slo_curve_bins: int = 0

    def __post_init__(self):
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "engines", tuple(self.engines))
        if self.backend not in BACKENDS:
            raise SpecError(f"backend must be one of {BACKENDS}, "
                            f"got {self.backend!r}")
        if self.metric not in METRICS:
            raise SpecError(f"metric must be one of {METRICS}, "
                            f"got {self.metric!r}")
        if self.trials < 1:
            raise SpecError("trials must be >= 1")
        if self.devices < 1:
            raise SpecError("devices must be >= 1")
        if self.devices > 1:
            if self.backend in ("event", "numpy"):
                raise SpecError("devices > 1 needs backend 'jax' or "
                                "'pallas'")
            if self.trials % self.devices:
                raise SpecError("trials must be a multiple of devices")
        if self.autotune and self.backend != "pallas":
            raise SpecError("autotune tunes the pallas kernel block "
                            "size; use backend 'pallas'")
        if self.packed and self.backend == "event":
            raise SpecError("packed runs the batched engines; use "
                            "backend 'numpy', 'jax', or 'pallas'")
        if self.metric == "latency" and self.backend == "event":
            raise SpecError("metric 'latency' runs the batched engines; "
                            "use backend 'numpy', 'jax', or 'pallas'")
        known = scenario_names()
        for s in self.scenarios:
            if s not in known:
                raise SpecError(
                    f"unknown scenario {s!r}; registered: "
                    f"{', '.join(known)} (or 'all')" + _suggest(s, known))
        if len(set(self.scenarios)) != len(self.scenarios):
            raise SpecError(f"duplicate scenarios: {self.scenarios}")
        # every value rule for the knob set lives in DowntimeParams —
        # constructing it here means spec building and engine entry see
        # the identical ValueError set
        try:
            self.downtime_params()
        except ValueError as e:
            raise SpecError(str(e)) from e

    def downtime_params(self) -> DowntimeParams:
        """The validated engine-knob bundle this spec configures."""
        return DowntimeParams(
            dupres_ticks=self.dupres_ticks,
            rebuild_steps=self.rebuild_steps,
            rebuild_model=self.rebuild_model,
            rebuild_ticks_per_gib=self.rebuild_ticks_per_gib,
            size_dist=self.size_dist, size_skew=self.size_skew,
            node_bandwidth_gibps=self.node_bandwidth_gibps,
            key_zipf=self.key_zipf, read_frac=self.read_frac,
            requests_per_tick=self.requests_per_tick,
            slo_ticks=self.slo_ticks, write_skew=self.write_skew,
            slo_curve_bins=self.slo_curve_bins, engines=self.engines,
            lease_ticks=self.lease_ticks,
            view_change_ticks=self.view_change_ticks)

    # -- construction ----------------------------------------------------

    @classmethod
    def field_names(cls) -> tuple:
        return tuple(f.name for f in fields(cls))

    @classmethod
    def create(cls, **provided) -> "ExperimentSpec":
        """Build a spec from only the keys the caller chose.

        Applies the metric-gated rules the CLI used to own (a knob that
        its metric never reads is an error, not a silent no-op), fills
        per-metric defaults, and normalizes representations (comma
        strings / lists → tuples, 'all' scenario expansion, 'inf'
        strings → float).  Value validation then runs in __post_init__.
        """
        valid = cls.field_names()
        for key in provided:
            if key not in valid:
                raise SpecError(f"unknown spec key {key!r}"
                                + _suggest(key, valid)
                                + f"; valid keys: {', '.join(valid)}")
        values = {k: v for k, v in provided.items() if v is not None}
        # normalize representations before gating so a canonical()
        # round trip and a config file compare like with like
        engines = values.get("engines")
        if isinstance(engines, str):
            engines = tuple(e.strip() for e in engines.split(",")
                            if e.strip())
        if engines is not None:
            values["engines"] = tuple(engines)
        nbw = values.get("node_bandwidth_gibps")
        if isinstance(nbw, str):
            try:
                nbw = float(nbw)
            except ValueError:
                raise SpecError("node_bandwidth_gibps must be a number "
                                f"or 'inf', got {nbw!r}") from None
            values["node_bandwidth_gibps"] = nbw
        metric = values.get("metric", "availability")

        # a knob is only *set* if it differs from its default — so
        # embedding the full canonical mapping (which spells out every
        # field) round-trips, while any meaningful knob for a metric
        # that never reads it stays an error exactly like the old CLI
        defaults = {f.name: f.default for f in fields(cls)}
        significant = {k for k, v in values.items()
                       if v != defaults.get(k, object())}

        def _reject(keys, rule):
            bad = sorted(k for k in keys if k in significant)
            if bad:
                raise SpecError(f"{'/'.join(bad)} {rule}")

        if metric not in ("downtime", "latency"):
            _reject(_DOWNTIME_KEYS, "only apply to metric 'downtime' or "
                    "'latency' (--metric downtime|latency)")
        if metric != "downtime":
            _reject(_ZOO_KEYS, "select the protocol zoo; use metric "
                    "'downtime' (--metric downtime)")
        if metric != "latency":
            _reject(_LATENCY_KEYS, "model the request workload; use "
                    "metric 'latency' (--metric latency)")
        rebuild_model = values.get("rebuild_model", "fixed")
        if rebuild_model == "reconfig":
            _reject(("rebuild_steps",),
                    "is the fixed-model knob; use rebuild_ticks_per_gib "
                    "with rebuild_model 'reconfig'")
        elif rebuild_model == "fixed":
            _reject(("rebuild_ticks_per_gib",),
                    "is the reconfig-model knob; use rebuild_steps with "
                    "rebuild_model 'fixed'")
            _reject(_RECONFIG_KEYS,
                    "model the reconfiguring baseline's data-sized "
                    "catch-ups; use rebuild_model 'reconfig'")
        if "size_skew" in significant and values.get("size_dist") \
                not in ("zipf", "lognormal"):
            raise SpecError("size_skew shapes the zipf/lognormal size "
                            "distributions; set size_dist "
                            "'zipf'|'lognormal'")

        workload = (_LATENCY_DEFAULTS if metric == "latency"
                    else _NO_LATENCY_DEFAULTS)
        for k, v in workload.items():
            values.setdefault(k, v)
        if values.get("scenarios_only") and not values.get("scenarios"):
            # scenario-only with no selection means every registered
            # scenario — the legacy --scenarios-only CLI behavior
            values["scenarios"] = ("all",)
        values["scenarios"] = _resolve_scenarios(
            values.get("scenarios", ()))
        return cls(**values)

    @classmethod
    def from_file(cls, path: str) -> "ExperimentSpec":
        """Load a spec from a TOML (or JSON) config file.  Keys are the
        spec field names; unknown keys are rejected with a nearest-match
        suggestion, and every gating/value rule applies exactly as for a
        programmatic or CLI build."""
        with open(path, "rb") as fh:
            raw = fh.read()
        if str(path).endswith(".json"):
            data = json.loads(raw.decode("utf-8"))
        else:
            data = _loads_toml(raw.decode("utf-8"))
        if not isinstance(data, dict):
            raise SpecError(f"{path}: config must be a table of "
                            "spec keys")
        try:
            return cls.create(**data)
        except SpecError as e:
            raise SpecError(f"{path}: {e}") from None

    # -- serialization ---------------------------------------------------

    def canonical(self) -> dict:
        """JSON-safe mapping of every identity field — the exact form
        embedded in provenance-stamped artifacts as ``meta.spec``.
        Lossless: ``ExperimentSpec.create(**spec.canonical())`` (plus
        the non-identity ``name``) reproduces ``spec`` exactly."""
        out = {}
        for f in fields(self):
            if not f.compare:
                continue
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            elif isinstance(v, float) and math.isinf(v):
                v = "inf"
            out[f.name] = v
        return out

    def content_hash(self) -> str:
        """sha256 of the canonical mapping (sorted-key JSON) — the
        spec's stable identity, independent of where it was loaded from
        or the key order it was written with."""
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()

    def zoo_live(self) -> bool:
        """Whether the protocol zoo is in play — the condition under
        which summary meta carries the zoo keys (a default lark,quorum
        run keeps emitting the pre-zoo meta byte for byte)."""
        return (self.engines != ("lark", "quorum")
                or bool(self.lease_ticks) or bool(self.view_change_ticks))

    def legacy_meta(self) -> dict:
        """The pre-provenance ``meta`` mapping, key for key and value
        for value — provenance-stamped summaries keep emitting these at
        the top level so every meta consumer from before the experiments
        layer keeps working unchanged."""
        meta = {"backend": self.backend, "trials": self.trials,
                "devices": self.devices, "full": self.full,
                "smoke": self.smoke, "scenarios": list(self.scenarios),
                "metric": self.metric, "packed": self.packed}
        if self.metric == "latency":
            meta["key_zipf"] = self.key_zipf
            meta["read_frac"] = self.read_frac
            meta["requests_per_tick"] = self.requests_per_tick
            meta["slo_ticks"] = self.slo_ticks
            meta["write_skew"] = self.write_skew
            meta["slo_curve_bins"] = self.slo_curve_bins
        if self.metric == "downtime" and self.zoo_live():
            meta["engines"] = ",".join(self.engines)
            meta["lease_ticks"] = self.lease_ticks
            meta["view_change_ticks"] = self.view_change_ticks
        if self.metric in ("downtime", "latency"):
            meta["rebuild_model"] = self.rebuild_model
            meta["size_dist"] = self.size_dist
            # match the result rows' normalization: the skew knob is
            # inert under uniform, so record it as 0 there
            meta["size_skew"] = self.size_skew \
                if self.size_dist in ("zipf", "lognormal") else 0.0
            meta["node_bandwidth_gibps"] = \
                None if math.isinf(self.node_bandwidth_gibps) \
                else self.node_bandwidth_gibps
        return meta


def _resolve_scenarios(selection) -> tuple:
    """Expand a scenario selection (a name list / comma string, possibly
    containing 'all') into the resolved registry-name tuple."""
    if isinstance(selection, str):
        selection = [selection]
    names = []
    for sel in selection:
        names.extend(s for s in str(sel).split(",") if s)
    if "all" in names:
        return tuple(scenario_names())
    return tuple(names)


def _loads_toml(text: str) -> dict:
    """Parse TOML via tomllib (3.11+) / tomli when available, else a
    minimal flat-table fallback covering the committed configs' subset
    (top-level ``key = value`` with strings, numbers incl. ``inf``,
    booleans, and one-line arrays) — the runtime floor is 3.10 and the
    experiment layer must not grow a dependency for it."""
    try:
        import tomllib
    except ImportError:
        try:
            import tomli as tomllib
        except ImportError:
            return _loads_flat_toml(text)
    return tomllib.loads(text)


def _scalar(tok: str):
    tok = tok.strip()
    if (tok.startswith('"') and tok.endswith('"') and len(tok) >= 2) or \
            (tok.startswith("'") and tok.endswith("'") and len(tok) >= 2):
        return tok[1:-1]
    if tok == "true":
        return True
    if tok == "false":
        return False
    if tok in ("inf", "+inf"):
        return math.inf
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        raise SpecError(f"cannot parse TOML value {tok!r} "
                        "(fallback parser)") from None


def _strip_comment(line: str) -> str:
    out, quote = [], None
    for ch in line:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out).strip()


def _loads_flat_toml(text: str) -> dict:
    data = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line:
            continue
        if line.startswith("["):
            raise SpecError(f"line {lineno}: tables are not supported "
                            "by the fallback TOML parser; use flat "
                            "key = value entries")
        if "=" not in line:
            raise SpecError(f"line {lineno}: expected key = value, "
                            f"got {line!r}")
        key, val = (s.strip() for s in line.split("=", 1))
        if val.startswith("[") and val.endswith("]"):
            body = val[1:-1].strip()
            items = []
            if body:
                items = [_scalar(tok) for tok in _split_array(body)]
            data[key] = items
        else:
            data[key] = _scalar(val)
    return data


def _split_array(body: str):
    toks, cur, quote = [], [], None
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch == ",":
            toks.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        toks.append(tail)
    return [t for t in (tok.strip() for tok in toks) if t]


#: re-exported engine constants so config consumers need one import
__all__ = ["ExperimentSpec", "SpecError", "BACKENDS", "METRICS",
           "ENGINES", "REBUILD_MODELS", "SIZE_DISTS"]
