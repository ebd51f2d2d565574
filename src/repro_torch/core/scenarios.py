"""Named, parameterized failure scenarios for the batched Monte Carlos.

Paper anchors: the ``independent`` scenario is §5.1's i.i.d. grid model;
``rolling-restart`` and ``maintenance-wave`` exercise §5.3's
zero-downtime rolling-restart claim; the rest stress PAC (§3) under the
correlated/heterogeneous failure modes real fleets see.  Every scenario
runs under both batched engines — instantaneous availability
(core/availability_batched.py, §5.1) and commit-pause downtime
(core/downtime_batched.py, §6) — because scenarios only parameterize the
shared node-failure *trajectory*, never the protocol evaluation.

The engines expose mechanism knobs; this module gives the *policies*
built on them stable names, so the sweep CLI, CI, and tests all draw
from one registry instead of hard-coded grids:

    from repro_torch.core.scenarios import get_scenario
    sc = get_scenario("rack-pairs")
    r = simulate_availability_batched(n=63, rf=2, p=3e-3,
                                      **sc.kwargs(n=63, rf=2, p=3e-3))

Knobs a scenario may emit (all consumed by the shared node-advance in
availability_batched.py, so trajectories stay bit-identical across
backends/devices/engines):

  pair_fail_prob   correlated dual failures — when node i fails, its pair
                   partner (2i <-> 2i+1) fails at the same tick with this
                   probability (shared rack / power domain).
  restart_period   scheduled maintenance: every `restart_period` ticks
                   the next wave of nodes (in id order, wrapping) is
                   taken down for its configured downtime.
  wave_width       nodes per restart wave; 1 = serial rolling restart
                   (§5.3), >1 = batched maintenance that can swallow a
                   whole roster at once.
  p_node           (n,) per-node failure probability — heterogeneous
                   MTTF.  Implemented as one geometric CDF table per
                   *distinct* probability (per-class tables, selected by
                   node masks), so keep the number of tiers small.
  downtime_node    (n,) per-node downtime ticks (flapping nodes recover
                   fast, slow hardware lingers); overrides the scalar
                   `downtime`.

Each scenario is a function (n, rf, p) -> extra keyword arguments for
the engines; ``grid`` carries the (rf, p) points the sweep evaluates by
default.  Scenarios only ever *add* kwargs on top of the i.i.d.
baseline — never sweep-owned ones like n/rf/p/backend/devices
(``Scenario.kwargs`` enforces this) — so every registered name runs
under every batched backend (numpy / jax / pallas) and shards across
devices unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np

_KwargsFn = Callable[..., dict]


@dataclass(frozen=True)
class Scenario:
    name: str
    summary: str
    grid: Tuple[Tuple[int, float], ...]   # default (rf, p) sweep points
    make_kwargs: _KwargsFn = field(repr=False, compare=False, default=None)

    def kwargs(self, *, n: int, rf: int, p: float) -> dict:
        """simulate_availability_batched kwargs beyond (n, rf, p)."""
        kw = self.make_kwargs(n=n, rf=rf, p=p)
        for k in ("n", "rf", "p", "partitions", "trials", "backend",
                  "devices", "seed", "dupres_ticks", "rebuild_steps",
                  "voters"):
            if k in kw:
                raise ValueError(f"scenario {self.name!r} may not override "
                                 f"sweep-owned kwarg {k!r}")
        return kw


SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(name: str, summary: str,
                      grid: Tuple[Tuple[int, float], ...]):
    def deco(fn: _KwargsFn) -> _KwargsFn:
        if name in SCENARIOS:
            raise ValueError(f"duplicate scenario {name!r}")
        SCENARIOS[name] = Scenario(name=name, summary=summary,
                                   grid=tuple(grid), make_kwargs=fn)
        return fn
    return deco


def scenario_names() -> Tuple[str, ...]:
    return tuple(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(SCENARIOS)}") from None


# ---------------------------------------------------------------------------
# Registered scenarios
# ---------------------------------------------------------------------------

@register_scenario(
    "independent",
    "i.i.d. geometric node failures — the paper's §5.1 grid model",
    grid=((2, 1e-3), (3, 3e-3), (4, 1e-2)))
def _independent(*, n: int, rf: int, p: float) -> dict:
    return {}


@register_scenario(
    "rack-pairs",
    "correlated rack/power-domain failures: a failing node takes its pair "
    "partner (2i <-> 2i+1) down at the same tick half the time",
    grid=((2, 3e-3), (3, 1e-2), (4, 1e-2)))
def _rack_pairs(*, n: int, rf: int, p: float) -> dict:
    return {"pair_fail_prob": 0.5}


@register_scenario(
    "rolling-restart",
    "serial maintenance: one node restarted every 2000 ticks — §5.3's "
    "zero-downtime rolling-restart claim as a Monte Carlo scenario",
    grid=((2, 1e-3), (3, 3e-3), (4, 3e-3)))
def _rolling_restart(*, n: int, rf: int, p: float) -> dict:
    return {"restart_period": 2_000, "wave_width": 1}


@register_scenario(
    "maintenance-wave",
    "batched maintenance: waves of 3 id-consecutive nodes restarted "
    "together every 3000 ticks (a wave can swallow a whole roster)",
    grid=((3, 1e-3), (4, 3e-3)))
def _maintenance_wave(*, n: int, rf: int, p: float) -> dict:
    return {"restart_period": 3_000, "wave_width": min(3, n)}


@register_scenario(
    "flapping",
    "every 8th node flaps: 20x the base failure rate with a 2-tick "
    "recovery (crash-loop / NIC-flap behavior)",
    grid=((2, 1e-3), (3, 3e-3)))
def _flapping(*, n: int, rf: int, p: float) -> dict:
    flappy = np.zeros(n, dtype=bool)
    flappy[::8] = True
    return {"p_node": np.where(flappy, np.minimum(20.0 * p, 0.5), p),
            "downtime_node": np.where(flappy, 2, 10)}


@register_scenario(
    "hetero-mttf",
    "heterogeneous hardware: node thirds at 0.5x / 1x / 4x the base "
    "failure rate (mixed-generation fleet)",
    grid=((2, 1e-3), (3, 3e-3), (4, 1e-2)))
def _hetero_mttf(*, n: int, rf: int, p: float) -> dict:
    scale = np.array([0.5, 1.0, 4.0])[np.arange(n) % 3]
    return {"p_node": np.minimum(scale * p, 0.5)}
