"""Config-driven experiment runner, availability, downtime and latency
metrics (port of ``repro/experiments/runner.py``).

One ``ExperimentSpec`` in; CSV progress lines, JSONL events and a
provenance-stamped summary out.  The grids, the scales and every row
expression are the reference's, so a spec regenerates the reference's
rows byte for byte (``benchmarks/check_regression.py --identical``).

* ``iter_rows(spec, device=...)`` — the i.i.d. grid, then each scenario
  grid, in the reference's order and shapes: §5.1 availability rows, §6
  downtime rows (with one row per protocol-zoo engine) or client-latency
  rows (``spec.downtime_params()`` carries the knobs).
* ``ExperimentRunner`` — drives ``iter_rows``, prints the CSV progress
  lines, streams one JSONL event per row, assembles the summary.
* ``run_batch(specs)`` — several specs back to back.

Backends: the spec's ``numpy``, ``jax`` and ``pallas`` all run the port's
engine (the reference proves them row-identical).  ``devices = D`` shards
each batched run's trials over the default process group's R ranks (R
must divide D; ``torchrun --nproc-per-node R -m repro_torch.sweep``), or
runs them as one batch without a group, bit-identical either way.  Every
rank runs every row (the drains are collectives); only rank 0 prints,
streams events and writes the summary, whose provenance records the
requested geometry beside the observed one and the world size.  Availability
rows under ``backend="event"`` run the scalar event engine
(``core/availability.py``, host numpy) once per seed, as the reference's
do; scenario, downtime and latency rows under ``"event"`` run the batched
engine on one device, as the reference's ``_batched_backend`` maps them.
Not ported yet, raising ``NotImplementedError``: ``autotune`` (ROADMAP
Queue 1 item 10).
"""
from __future__ import annotations

import json
import math
import time

from ..core.analytical import (improvement_factor, lark_unavailability,
                               node_unavailability)
from ..core.availability import simulate_availability
from ..core.availability_batched import simulate_availability_batched
from ..core.client_latency import simulate_client_latency
from ..core.downtime_batched import DowntimeParams, simulate_downtime_batched
from ..core.scenarios import get_scenario
from ..device import resolve_device
from ..launch import dist as rdist
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


def _gen_run(full: bool = False, seeds=(0,), backend: str = "event",
             devices: int = 1, smoke: bool = False, packed: bool = False,
             device=None):
    """i.i.d. rows.  ``backend="event"``: one scalar event-engine run per
    seed on the host, averaged; any other backend: one batch of
    len(seeds) trials from seed min(seeds) on `device`."""
    grid = _iid_grid(full, smoke)
    n, parts, max_ticks, min_ticks = _run_scale(full, smoke, scenario=False)
    for rf, p in grid:
        if backend == "event":
            us_l, us_m, cis_l, cis_m = [], [], [], []
            ticks = 0
            for s in seeds:
                r = simulate_availability(n=n, partitions=parts, rf=rf, p=p,
                                          max_ticks=max_ticks,
                                          min_ticks=min_ticks, seed=s)
                us_l.append(r.u_lark)
                us_m.append(r.u_maj)
                cis_l.append(r.ci_lark)
                cis_m.append(r.ci_maj)
                ticks = r.ticks
            N = len(seeds)
            u_l = sum(us_l) / N
            u_m = sum(us_m) / N
            # half-width of the across-seed mean: independent runs, so
            # se_mean = sqrt(sum se_i^2) / N
            ci_l = math.sqrt(sum(c * c for c in cis_l)) / N
            ci_m = math.sqrt(sum(c * c for c in cis_m)) / N
        else:
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


def _downtime_row(r, *, kind: str, scenario: str):
    return {
        "kind": kind, "scenario": scenario, "rf": r.rf, "p": r.p,
        "pause_lark": r.pause_lark, "pause_quorum": r.pause_quorum,
        "ci_pause_lark": r.ci_lark, "ci_pause_quorum": r.ci_quorum,
        "ratio": r.availability_ratio,
        "lark_events": r.lark_events, "quorum_events": r.quorum_events,
        "hist_edges": r.hist_edges.tolist(),
        "hist_lark": r.hist_lark.tolist(),
        "hist_quorum": r.hist_quorum.tolist(),
        "dupres_ticks": r.dupres_ticks, "rebuild_steps": r.rebuild_steps,
        "rebuild_model": r.rebuild_model,
        "rebuild_ticks_per_gib": r.rebuild_ticks_per_gib,
        "size_dist": r.size_dist, "size_skew": r.size_skew,
        # inf (no sharing) serializes as null — _json_safe
        "node_bandwidth_gibps": r.node_bandwidth_gibps,
        "ticks": r.ticks,
    }


def _downtime_engine_rows(r, *, kind: str, scenario: str):
    """One row per protocol-zoo engine beyond the lark/quorum pair the
    base downtime row already carries."""
    rows = []
    for engine in r.engines:
        if engine in ("lark", "quorum"):
            continue
        s = r.engine_stats(engine)
        rows.append({
            "kind": kind, "engine": engine, "scenario": scenario,
            "rf": r.rf, "p": r.p,
            "pause": s["pause"], "ci_pause": s["ci_pause"],
            "events": s["events"],
            "hist_edges": r.hist_edges.tolist(),
            "hist": s["hist"].tolist(),
            "lease_ticks": r.lease_ticks,
            "view_change_ticks": r.view_change_ticks,
            "dupres_ticks": r.dupres_ticks,
            "rebuild_steps": r.rebuild_steps,
            "rebuild_model": r.rebuild_model,
            "rebuild_ticks_per_gib": r.rebuild_ticks_per_gib,
            "size_dist": r.size_dist, "size_skew": r.size_skew,
            "node_bandwidth_gibps": r.node_bandwidth_gibps,
            "ticks": r.ticks,
        })
    return rows


def _gen_run_downtime(full: bool = False, trials: int = 4, seed: int = 0,
                      devices: int = 1, smoke: bool = False,
                      params: DowntimeParams = DowntimeParams(),
                      packed: bool = False, device=None):
    """§6 commit-pause rows over the i.i.d. grid: one batch of `trials`
    trials from `seed` per grid point."""
    grid = _iid_grid(full, smoke)
    n, parts, max_ticks, min_ticks = _run_scale(full, smoke, scenario=False)
    for rf, p in grid:
        r = simulate_downtime_batched(
            n=n, partitions=parts, rf=rf, p=p, trials=trials,
            max_ticks=max_ticks, min_ticks=min_ticks, seed=seed,
            devices=devices, params=params, packed=packed, device=device)
        yield _downtime_row(r, kind="downtime", scenario="iid")
        yield from _downtime_engine_rows(r, kind="downtime_engine",
                                         scenario="iid")


def _gen_run_downtime_scenarios(names, full: bool = False, trials: int = 4,
                                seed: int = 0, devices: int = 1,
                                smoke: bool = False,
                                params: DowntimeParams = DowntimeParams(),
                                packed: bool = False, device=None):
    n, parts, max_ticks, min_ticks = _run_scale(full, smoke, scenario=True)
    for name in names:
        sc = get_scenario(name)
        for rf, p in sc.grid:
            r = simulate_downtime_batched(
                n=n, partitions=parts, rf=rf, p=p, trials=trials,
                max_ticks=max_ticks, min_ticks=min_ticks, seed=seed,
                devices=devices, params=params, packed=packed,
                device=device, **sc.kwargs(n=n, rf=rf, p=p))
            yield _downtime_row(r, kind="downtime_scenario", scenario=name)
            yield from _downtime_engine_rows(
                r, kind="downtime_engine_scenario", scenario=name)


def _latency_row(r, *, kind: str, scenario: str):
    row = {
        "kind": kind, "scenario": scenario, "rf": r.rf, "p": r.p,
        "lat_lark": r.lat_lark, "lat_quorum": r.lat_quorum,
        "lat_hermes": r.lat_hermes,
        "ci_lat_lark": r.ci_lat_lark, "ci_lat_quorum": r.ci_lat_quorum,
        "p50_lark": r.p50_lark, "p99_lark": r.p99_lark,
        "p999_lark": r.p999_lark,
        "p50_quorum": r.p50_quorum, "p99_quorum": r.p99_quorum,
        "p999_quorum": r.p999_quorum,
        "p50_hermes": r.p50_hermes, "p99_hermes": r.p99_hermes,
        "p999_hermes": r.p999_hermes,
        "slo_lark": r.slo_lark, "slo_quorum": r.slo_quorum,
        "slo_hermes": r.slo_hermes,
        "req_total": r.req_total,
        "hist_edges": r.hist_edges.tolist(),
        "hist_quorum_req": r.hist_quorum_req.tolist(),
        "dupres_ticks": r.dupres_ticks, "rebuild_model": r.rebuild_model,
        "key_zipf": r.key_zipf, "read_frac": r.read_frac,
        "requests_per_tick": r.requests_per_tick,
        "slo_ticks": r.slo_ticks,
        "ticks": r.ticks,
    }
    # the sharpening knobs only add columns when set, so rows at their
    # degenerate settings keep the reference's pre-knob columns
    if r.write_skew:
        row["write_skew"] = r.write_skew
    if math.isfinite(r.node_bandwidth_gibps):
        row["node_bandwidth_gibps"] = r.node_bandwidth_gibps
    if r.slo_curve_bins:
        row["slo_curve_bins"] = r.slo_curve_bins
        row["slo_curve_edges"] = r.slo_curve_edges.tolist()
        row["slo_curve_lark"] = r.slo_curve_lark.tolist()
        row["slo_curve_quorum"] = r.slo_curve_quorum.tolist()
        row["slo_curve_hermes"] = r.slo_curve_hermes.tolist()
    return row


def _gen_run_latency(full: bool = False, trials: int = 4, seed: int = 0,
                     devices: int = 1, smoke: bool = False,
                     params: DowntimeParams = DowntimeParams(),
                     packed: bool = False, device=None):
    """Client-latency rows over the i.i.d. grid — the downtime metric's
    grid, scale and tick budgets, so both describe the same
    trajectories."""
    grid = _iid_grid(full, smoke)
    n, parts, max_ticks, min_ticks = _run_scale(full, smoke, scenario=False)
    for rf, p in grid:
        r = simulate_client_latency(
            n=n, partitions=parts, rf=rf, p=p, trials=trials,
            max_ticks=max_ticks, min_ticks=min_ticks, seed=seed,
            devices=devices, params=params, packed=packed, device=device)
        yield _latency_row(r, kind="latency", scenario="iid")


def _gen_run_latency_scenarios(names, full: bool = False, trials: int = 4,
                               seed: int = 0, devices: int = 1,
                               smoke: bool = False,
                               params: DowntimeParams = DowntimeParams(),
                               packed: bool = False, device=None):
    n, parts, max_ticks, min_ticks = _run_scale(full, smoke, scenario=True)
    for name in names:
        sc = get_scenario(name)
        for rf, p in sc.grid:
            r = simulate_client_latency(
                n=n, partitions=parts, rf=rf, p=p, trials=trials,
                max_ticks=max_ticks, min_ticks=min_ticks, seed=seed,
                devices=devices, params=params, packed=packed,
                device=device, **sc.kwargs(n=n, rf=rf, p=p))
            yield _latency_row(r, kind="latency_scenario", scenario=name)


def _json_safe(row):
    """Non-finite floats are not RFC-JSON; dump them as null."""
    return {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in row.items()}


def row_csv_line(r: dict):
    """The progress line the sweep prints for a result row."""
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
    if kind == "downtime":
        return (f"downtime,rf{r['rf']}_p{r['p']:g},0,"
                f"pause_lark={r['pause_lark']:.3e};"
                f"pause_quorum={r['pause_quorum']:.3e};"
                f"ratio={r['ratio']:.2f}")
    if kind == "downtime_scenario":
        return (f"downtime_scenario,{r['scenario']}_rf{r['rf']}_"
                f"p{r['p']:g},0,pause_lark={r['pause_lark']:.3e};"
                f"pause_quorum={r['pause_quorum']:.3e};"
                f"ratio={r['ratio']:.2f}")
    if kind == "downtime_engine":
        return (f"downtime_engine,{r['engine']}_rf{r['rf']}_"
                f"p{r['p']:g},0,pause={r['pause']:.3e};"
                f"events={r['events']}")
    if kind == "downtime_engine_scenario":
        return (f"downtime_engine_scenario,{r['engine']}_"
                f"{r['scenario']}_rf{r['rf']}_p{r['p']:g},0,"
                f"pause={r['pause']:.3e};events={r['events']}")
    if kind == "latency":
        return (f"latency,rf{r['rf']}_p{r['p']:g},0,"
                f"lat_lark={r['lat_lark']:.3e};"
                f"lat_quorum={r['lat_quorum']:.3e};"
                f"p999_lark={r['p999_lark']:g};"
                f"p999_quorum={r['p999_quorum']:g};"
                f"slo_quorum={r['slo_quorum']:.3e}")
    if kind == "latency_scenario":
        return (f"latency_scenario,{r['scenario']}_rf{r['rf']}_"
                f"p{r['p']:g},0,lat_lark={r['lat_lark']:.3e};"
                f"lat_quorum={r['lat_quorum']:.3e};"
                f"p999_quorum={r['p999_quorum']:g};"
                f"slo_quorum={r['slo_quorum']:.3e}")
    return None


def _check_ported(spec: ExperimentSpec):
    if spec.autotune:
        raise NotImplementedError(
            "autotune is not ported yet (ROADMAP Queue 1 item 10)")


def iter_rows(spec: ExperimentSpec, device=None):
    """Every result row of one spec, in emission order: the i.i.d. grid,
    then each scenario grid."""
    _check_ported(spec)
    names = list(spec.scenarios)
    # batched rows under "event" run on one device, as the reference's
    # _batched_backend maps them
    devices = 1 if spec.backend == "event" else spec.devices
    if spec.metric in ("downtime", "latency"):
        common = dict(full=spec.full, trials=spec.trials, seed=spec.seed,
                      devices=devices, smoke=spec.smoke,
                      params=spec.downtime_params(),
                      packed=spec.packed, device=device)
        iid, scen = (_gen_run_downtime, _gen_run_downtime_scenarios) \
            if spec.metric == "downtime" \
            else (_gen_run_latency, _gen_run_latency_scenarios)
        if not spec.scenarios_only:
            yield from iid(**common)
        if names:
            yield from scen(names, **common)
        return
    if not spec.scenarios_only:
        yield from _gen_run(
            full=spec.full,
            seeds=tuple(range(spec.seed, spec.seed + spec.trials)),
            backend=spec.backend, devices=spec.devices, smoke=spec.smoke,
            packed=spec.packed, device=device)
    if names:
        yield from _gen_run_scenarios(
            names, full=spec.full, trials=spec.trials, seed=spec.seed,
            devices=devices, smoke=spec.smoke, packed=spec.packed,
            device=device)


class ExperimentRunner:
    """Execute one spec on this rank's device: stream rows (CSV progress
    + JSONL events) and assemble the provenance-stamped summary.

    ``events_path`` appends one JSON object per line: run_start, one row
    record per result row (index, kind, row-key label, wall-clock t_s /
    dt_s), and run_end.  Timestamps live only in the events and the
    provenance, never in rows.  ``device`` defaults to ``cuda``.
    """

    def __init__(self, spec: ExperimentSpec, *, config_path=None,
                 events_path=None, emit=print, device=None):
        rdist.check_divides(spec.devices, rdist.world_size())
        lead = rdist.rank() == 0
        self.spec = spec
        self.config_path = config_path
        self.events_path = events_path if lead else None
        self.emit = emit if lead else None
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
        """Write the summary (rank 0 only; every rank returns it)."""
        doc = self.summary(rows)
        if rdist.rank() == 0:
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True,
                          allow_nan=False)
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
