"""Config-driven experiment runner, availability metric (port of
``repro/experiments/runner.py``).

One ``ExperimentSpec`` in; CSV progress lines, JSONL events and a
provenance-stamped summary out.  The grids, the scales and every row
expression are the reference's, so a spec regenerates the reference's
rows byte for byte (``benchmarks/check_regression.py --identical``).

* ``iter_rows(spec, device=...)`` — the i.i.d. grid, then each scenario
  grid, in the reference's order and shapes.
* ``ExperimentRunner`` — drives ``iter_rows``, prints the CSV progress
  lines, streams one JSONL event per row, assembles the summary.
* ``run_batch(specs)`` — several specs back to back.

Backends: the spec's ``numpy``, ``jax`` and ``pallas`` all run the port's
engine (the reference proves them row-identical).  ``devices > 1`` is
checked (trials must divide) and runs all trials as one batch on one
card, which invariant 2 makes equal to the sharded run; provenance
records the requested geometry beside the observed one.  Not ported yet,
each raising ``NotImplementedError``: the downtime and latency metrics
(ROADMAP Queue 1 items 5 and 8), ``backend="event"`` (item 11) and
``autotune`` (item 10).
"""
from __future__ import annotations

import json
import math
import time

from ..core.analytical import (improvement_factor, lark_unavailability,
                               node_unavailability)
from ..core.availability_batched import simulate_availability_batched
from ..core.scenarios import get_scenario
from ..device import resolve_device
from .provenance import build_provenance
from .schema import SCHEMA_VERSION, row_key
from .spec import ExperimentSpec

REDUCED_GRID = [(2, 1e-3), (2, 3e-3), (2, 1e-2), (3, 1e-2), (4, 3e-2)]
FULL_GRID = [(2, 1e-4), (2, 1e-3), (2, 1e-2),
             (3, 2e-4), (3, 1e-3), (3, 1e-2),
             (4, 5e-4), (4, 1e-3), (4, 1e-2)]
SMOKE_GRID = [(2, 3e-3), (3, 1e-2)]


def _grid_scale(full: bool, smoke: bool = False):
    """(n, partitions) of the i.i.d. and scenario rows."""
    if smoke:
        return (31, 128)
    return (155, 4096) if full else (63, 512)


def _run_scale(full: bool, smoke: bool, *, scenario: bool):
    """(n, partitions, max_ticks, min_ticks) — the reference's budgets."""
    n, parts = _grid_scale(full, smoke)
    if scenario:
        max_ticks = 30_000 if smoke else (1_000_000 if full else 120_000)
        min_ticks = 8_000 if smoke else 20_000
    else:
        max_ticks = 40_000 if smoke else (3_000_000 if full else 250_000)
        min_ticks = 10_000 if smoke else 30_000
    return n, parts, max_ticks, min_ticks


def _iid_grid(full: bool, smoke: bool):
    return SMOKE_GRID if smoke else (FULL_GRID if full else REDUCED_GRID)


def _gen_run(full: bool = False, seeds=(0,), devices: int = 1,
             smoke: bool = False, packed: bool = False, device=None):
    """i.i.d. rows of a batched backend: one batch of len(seeds) trials
    from seed min(seeds), as the reference's batched branch."""
    grid = _iid_grid(full, smoke)
    n, parts, max_ticks, min_ticks = _run_scale(full, smoke, scenario=False)
    for rf, p in grid:
        r = simulate_availability_batched(
            n=n, partitions=parts, rf=rf, p=p, trials=len(seeds),
            max_ticks=max_ticks, min_ticks=min_ticks, seed=min(seeds),
            devices=devices, packed=packed, device=device)
        u_l, u_m, ticks = r.u_lark, r.u_maj, r.ticks
        ci_l, ci_m = r.ci_lark, r.ci_maj
        f = rf - 1
        yield {
            "kind": "iid", "rf": rf, "p": p, "u_lark": u_l, "u_maj": u_m,
            "ci_lark": ci_l, "ci_maj": ci_m,
            "ratio": u_m / u_l if u_l else float("inf"),
            "analytic_ratio": improvement_factor(f),
            "analytic_u_lark": lark_unavailability(node_unavailability(p), f),
            "ticks": ticks,
        }


def _gen_run_scenarios(names, full: bool = False, trials: int = 4,
                       seed: int = 0, devices: int = 1, smoke: bool = False,
                       packed: bool = False, device=None):
    n, parts, max_ticks, min_ticks = _run_scale(full, smoke, scenario=True)
    for name in names:
        sc = get_scenario(name)
        for rf, p in sc.grid:
            r = simulate_availability_batched(
                n=n, partitions=parts, rf=rf, p=p, trials=trials,
                max_ticks=max_ticks, min_ticks=min_ticks, seed=seed,
                devices=devices, packed=packed, device=device,
                **sc.kwargs(n=n, rf=rf, p=p))
            yield {
                "kind": "scenario", "scenario": name, "rf": rf, "p": p,
                "u_lark": r.u_lark, "u_maj": r.u_maj,
                "ci_lark": r.ci_lark, "ci_maj": r.ci_maj,
                "ratio": r.u_maj / r.u_lark if r.u_lark else float("inf"),
                "ticks": r.ticks,
            }


def _json_safe(row):
    """Non-finite floats are not RFC-JSON; dump them as null."""
    return {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in row.items()}


def row_csv_line(r: dict):
    """The progress line the sweep prints for an availability row."""
    kind = r["kind"]
    if kind == "iid":
        return (f"availability,rf{r['rf']}_p{r['p']:g},0,"
                f"u_lark={r['u_lark']:.3e};u_maj={r['u_maj']:.3e};"
                f"ratio={r['ratio']:.2f};"
                f"analytic={r['analytic_ratio']}")
    if kind == "scenario":
        return (f"availability_scenario,{r['scenario']}_rf{r['rf']}_"
                f"p{r['p']:g},0,u_lark={r['u_lark']:.3e};"
                f"u_maj={r['u_maj']:.3e};ratio={r['ratio']:.2f}")
    return None


def _check_ported(spec: ExperimentSpec):
    if spec.metric != "availability":
        item = 5 if spec.metric == "downtime" else 8
        raise NotImplementedError(
            f"metric {spec.metric!r} is not ported yet (ROADMAP Queue 1 "
            f"item {item}); the port runs metric 'availability'")
    if spec.backend == "event":
        raise NotImplementedError(
            "backend 'event' (the scalar event engine) is not ported yet "
            "(ROADMAP Queue 1 item 11); use backend 'numpy', 'jax' or "
            "'pallas', which all run the port's batched engine")
    if spec.autotune:
        raise NotImplementedError(
            "autotune is not ported yet (ROADMAP Queue 1 item 10)")


def iter_rows(spec: ExperimentSpec, device=None):
    """Every result row of one spec, in emission order: the i.i.d. grid,
    then each scenario grid."""
    _check_ported(spec)
    names = list(spec.scenarios)
    if not spec.scenarios_only:
        yield from _gen_run(
            full=spec.full,
            seeds=tuple(range(spec.seed, spec.seed + spec.trials)),
            devices=spec.devices, smoke=spec.smoke, packed=spec.packed,
            device=device)
    if names:
        yield from _gen_run_scenarios(
            names, full=spec.full, trials=spec.trials, seed=spec.seed,
            devices=spec.devices, smoke=spec.smoke, packed=spec.packed,
            device=device)


class ExperimentRunner:
    """Execute one spec on one device: stream rows (CSV progress + JSONL
    events) and assemble the provenance-stamped summary.

    ``events_path`` appends one JSON object per line: run_start, one row
    record per result row (index, kind, row-key label, wall-clock t_s /
    dt_s), and run_end.  Timestamps live only in the events and the
    provenance, never in rows.  ``device`` defaults to ``cuda``.
    """

    def __init__(self, spec: ExperimentSpec, *, config_path=None,
                 events_path=None, emit=print, device=None):
        self.spec = spec
        self.config_path = config_path
        self.events_path = events_path
        self.emit = emit
        self.device = resolve_device(device)
        self.rows = None
        self._started_unix = None
        self._wall_s = None

    def _event(self, fh, record: dict):
        if fh is not None:
            fh.write(json.dumps(record, sort_keys=True,
                                allow_nan=False) + "\n")
            fh.flush()

    def run(self) -> list:
        spec = self.spec
        fh = open(self.events_path, "a") if self.events_path else None
        t0 = time.monotonic()
        self._started_unix = time.time()
        try:
            self._event(fh, {
                "event": "run_start", "schema_version": SCHEMA_VERSION,
                "name": spec.name, "metric": spec.metric,
                "backend": spec.backend, "trials": spec.trials,
                "devices": spec.devices, "packed": spec.packed,
                "device": str(self.device),
                "spec_sha256": spec.content_hash(),
                "config_path": (str(self.config_path)
                                if self.config_path else None),
                "t_unix": self._started_unix})
            rows = []
            t_prev = t0
            for r in iter_rows(spec, device=self.device):
                rows.append(r)
                line = row_csv_line(r)
                if line is not None and self.emit is not None:
                    self.emit(line)
                t_now = time.monotonic()
                key = row_key(r)
                label = "_".join(str(k) for k in key) if key \
                    else r.get("kind", "?")
                self._event(fh, {
                    "event": "row", "i": len(rows) - 1,
                    "kind": r.get("kind"), "label": label,
                    "t_s": t_now - t0, "dt_s": t_now - t_prev})
                t_prev = t_now
            self._wall_s = time.monotonic() - t0
            self._event(fh, {
                "event": "run_end", "name": spec.name,
                "rows": len(rows), "wall_s": self._wall_s,
                "rows_per_s": (len(rows) / self._wall_s
                               if self._wall_s > 0 else None)})
        finally:
            if fh is not None:
                fh.close()
        self.rows = rows
        return rows

    def summary(self, rows=None) -> dict:
        """The dump document: the reference's legacy meta keys at the top
        level, plus schema_version, the canonical spec and provenance."""
        if rows is None:
            rows = self.rows if self.rows is not None else self.run()
        meta = self.spec.legacy_meta()
        meta["schema_version"] = SCHEMA_VERSION
        meta["spec"] = {"name": self.spec.name, **self.spec.canonical()}
        meta["provenance"] = build_provenance(
            self.spec, config_path=self.config_path, wall_s=self._wall_s,
            started_unix=self._started_unix, device=self.device)
        return {"meta": meta, "rows": [_json_safe(r) for r in rows]}

    def write_summary(self, path: str, rows=None) -> dict:
        doc = self.summary(rows)
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True, allow_nan=False)
        return doc


def run_batch(specs, *, events_path=None, emit=print, device=None) -> list:
    """Execute several specs back to back (one shared events stream);
    returns their summary documents in order."""
    out = []
    for item in specs:
        config_path = None
        if isinstance(item, (str, bytes)):
            config_path, item = item, ExperimentSpec.from_file(item)
        runner = ExperimentRunner(item, config_path=config_path,
                                  events_path=events_path, emit=emit,
                                  device=device)
        runner.run()
        out.append(runner.summary())
    return out
