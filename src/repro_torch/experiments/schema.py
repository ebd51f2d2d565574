"""Row/artifact schema shared by the sweep, the runner, and the gate.

One declarative table per row family replaces the per-metric keying logic
that used to be re-derived inside ``benchmarks/check_regression.py``: the
key fields (with the defaults that keep pre-knob baselines loadable) and
the gated value/CI column pairs live here, next to the spec that produces
the rows.  This module is deliberately stdlib-only — the regression gate
imports it in CI lanes that never install jax.

Artifact (summary JSON) schema versions:

* pre-provenance (no ``meta.schema_version``): the PR-1..PR-8 dumps;
  still loadable during the transition, with a deprecation note.
* ``SCHEMA_VERSION`` 1: ``meta`` additionally carries ``spec`` (the full
  canonical experiment-spec mapping) and ``provenance`` (git SHA, spec
  content hash, config path + file hash, seed/RNG salts, backend/device
  geometry, wall-clock).  Rows are unchanged — a v1 regen of a committed
  baseline stays byte-identical row for row.
"""
from __future__ import annotations

#: current summary-JSON schema version (``meta.schema_version``)
SCHEMA_VERSION = 1

#: every schema version the strict loader accepts
KNOWN_SCHEMA_VERSIONS = (1,)

#: engine names a "downtime_engine" row may carry — pinned equal to
#: core.downtime_batched.ENGINES by tests/test_experiments.py without
#: making the gate import the engine stack
KNOWN_ENGINES = ("lark", "quorum", "hermes", "spinnaker")

#: gated value/CI column pairs per row family ("availability" covers the
#: legacy iid/scenario kinds; "downtime" rows carry pause fractions;
#: "latency" rows carry mean added commit latencies)
GATED_COLS = {
    "availability": (("u_lark", "ci_lark"), ("u_maj", "ci_maj")),
    "downtime": (("pause_lark", "ci_pause_lark"),
                 ("pause_quorum", "ci_pause_quorum")),
    "downtime_engine": (("pause", "ci_pause"),),
    "latency": (("lat_lark", "ci_lat_lark"),
                ("lat_quorum", "ci_lat_quorum")),
}

#: key fields per row family beyond the family label itself, as
#: (field, default) pairs — a ``_REQUIRED`` default means the row must
#: carry the field (grid coordinates), anything else keeps rows from
#: before that knob existed loadable (e.g. pre-roster downtime rows are
#: all rebuild_model "fixed").  The protocol-zoo engine rows are keyed by
#: the engine whose pause they measure plus the zoo knobs — a hermes row
#: and a spinnaker row at the same grid point are different measurements;
#: latency rows are keyed by the workload knobs for the same reason.
_REQUIRED = object()

ROW_KEY_FIELDS = {
    "iid": (("rf", _REQUIRED), ("p", _REQUIRED)),
    "scenario": (("scenario", _REQUIRED), ("rf", _REQUIRED),
                 ("p", _REQUIRED)),
    "downtime": (("scenario", "iid"), ("rf", _REQUIRED), ("p", _REQUIRED),
                 ("rebuild_model", "fixed"), ("size_dist", "uniform"),
                 ("size_skew", 0.0), ("node_bandwidth_gibps", None)),
    "downtime_engine": (("engine", _REQUIRED), ("scenario", "iid"),
                        ("rf", _REQUIRED), ("p", _REQUIRED),
                        ("rebuild_model", "fixed"), ("lease_ticks", 0),
                        ("view_change_ticks", 0), ("size_dist", "uniform"),
                        ("size_skew", 0.0), ("node_bandwidth_gibps", None)),
    "latency": (("scenario", "iid"), ("rf", _REQUIRED), ("p", _REQUIRED),
                ("rebuild_model", "fixed"), ("read_frac", None),
                ("key_zipf", None), ("slo_ticks", None),
                ("requests_per_tick", None), ("dupres_ticks", None),
                ("write_skew", 0.0), ("node_bandwidth_gibps", None),
                ("slo_curve_bins", 0)),
}

#: row ``kind`` value → (key family, gated-column family); scenario
#: variants share their iid family's knob columns
KIND_FAMILIES = {
    "iid": ("iid", "availability"),
    "scenario": ("scenario", "availability"),
    "downtime": ("downtime", "downtime"),
    "downtime_scenario": ("downtime", "downtime"),
    "downtime_engine": ("downtime_engine", "downtime_engine"),
    "downtime_engine_scenario": ("downtime_engine", "downtime_engine"),
    "latency": ("latency", "latency"),
    "latency_scenario": ("latency", "latency"),
}


def row_key(r: dict):
    """Stable identity tuple for a result row, or None for rows that are
    never gated (autotune/meta rows).  The tuple leads with the key
    family label, then the declared key fields in order — identical to
    the tuples the gate produced before this table existed, so committed
    summary artifacts and their recorded verdict keys stay comparable."""
    kind = r.get("kind")
    fam = KIND_FAMILIES.get(kind)
    if fam is None:
        return None
    key_family, _ = fam
    key = [key_family]
    for field, default in ROW_KEY_FIELDS[key_family]:
        key.append(r[field] if default is _REQUIRED
                   else r.get(field, default))
    return tuple(key)


def row_cols(r: dict):
    """Gated (value, ci) column pairs for a result row."""
    fam = KIND_FAMILIES.get(r.get("kind"))
    if fam is None:
        return ()
    return GATED_COLS[fam[1]]
