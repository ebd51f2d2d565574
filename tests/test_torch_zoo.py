"""The port's protocol zoo (Hermes, Spinnaker) against the reference.

The ``hermes-fixed`` and ``zoo-reconfig`` configurations of
``tests/test_conformance.py`` run on the port, packed and unpacked, and
every gated output — pause fractions, events, histograms, per-trial
fractions of every engine, trajectory columns — must equal the
reference's numpy backend bitwise.  The degenerate limits are pinned
(lease_ticks=0 is LARK, view_change_ticks=0 the reconfig quorum), the
zoo must leave the lark/quorum outputs untouched (it draws no
randomness), each ``_disable_predicates`` hook must be load-bearing and
match the reference's run with the same hook, and invalid engine knobs
raise the reference's errors."""
import numpy as np
import pytest
import torch

from repro.core import downtime_batched as R
from repro_torch.core import downtime_batched as T

# the tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

_KW = dict(n=13, partitions=32, rf=2, p=5e-3, trials=3, max_ticks=4_000,
           min_ticks=10 ** 9, chunk_steps=64, max_steps=600, seed=11,
           trajectory=True)

CONFIGS = {
    "hermes-fixed": dict(engines=("lark", "quorum", "hermes"),
                         lease_ticks=40),
    "zoo-reconfig": dict(engines=T.ENGINES, rebuild_model="reconfig",
                         rebuild_ticks_per_gib=64, lease_ticks=40,
                         view_change_ticks=200),
}


def _fingerprint(r):
    fp = {"pause_lark": r.pause_lark, "pause_quorum": r.pause_quorum,
          "lark_events": r.lark_events, "quorum_events": r.quorum_events,
          "hist_lark": r.hist_lark, "hist_quorum": r.hist_quorum,
          "pause_lark_trials": r.pause_lark_trials,
          "pause_quorum_trials": r.pause_quorum_trials,
          "engines": r.engines, "lease_ticks": r.lease_ticks,
          "view_change_ticks": r.view_change_ticks}
    for k, v in (r.trajectory or {}).items():
        fp[f"traj:{k}"] = v
    for engine in r.engines:
        s = r.engine_stats(engine)
        for k, v in s.items():
            fp[f"{engine}:{k}"] = v
        fp[f"{engine}:ci"] = s["ci_pause"]
    return fp


def _assert_identical(want, got):
    fw, fg = _fingerprint(want), _fingerprint(got)
    assert fw.keys() == fg.keys(), set(fw) ^ set(fg)
    for k in fw:
        w, g = np.asarray(fw[k]), np.asarray(fg[k])
        assert w.dtype == g.dtype and np.array_equal(w, g), k


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_zoo_matches_reference(config, packed):
    kw = dict(_KW, packed=packed, **CONFIGS[config])
    got = T.simulate_downtime_batched(device="cpu", **kw)
    assert got.trajectory["paused_hermes"].max() > 0
    assert got.hermes_events > 0
    _assert_identical(R.simulate_downtime_batched(backend="numpy", **kw),
                      got)


def test_hermes_lease_zero_pins_lark_exactly():
    r = T.simulate_downtime_batched(device="cpu", **dict(
        _KW, dupres_ticks=0, engines=("lark", "quorum", "hermes"),
        lease_ticks=0))
    s = r.engine_stats("hermes")
    assert s["pause"] == r.pause_lark
    assert s["events"] == r.lark_events
    assert np.array_equal(s["hist"], r.hist_lark)
    assert np.array_equal(s["pause_trials"], r.pause_lark_trials)
    assert np.array_equal(r.trajectory["paused_hermes"],
                          r.trajectory["paused_lark"])


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_spinnaker_vc_zero_pins_reconfig_quorum_exactly(packed):
    r = T.simulate_downtime_batched(device="cpu", **dict(
        _KW, packed=packed, rebuild_model="reconfig",
        rebuild_ticks_per_gib=64, engines=("lark", "quorum", "spinnaker"),
        view_change_ticks=0))
    s = r.engine_stats("spinnaker")
    assert s["pause"] == r.pause_quorum
    assert s["events"] == r.quorum_events
    assert np.array_equal(s["hist"], r.hist_quorum)
    assert np.array_equal(s["pause_trials"], r.pause_quorum_trials)
    assert np.array_equal(r.trajectory["paused_spinnaker"],
                          r.trajectory["paused_quorum"])


def test_zoo_engines_leave_base_outputs_untouched():
    """The zoo draws no randomness (invariant 3): switching it on leaves
    every lark/quorum output and trajectory column as it was."""
    kw = dict(_KW, rebuild_model="reconfig", rebuild_ticks_per_gib=64,
              node_bandwidth_gibps=1.0, device="cpu")
    base = T.simulate_downtime_batched(**kw)
    zoo = T.simulate_downtime_batched(engines=T.ENGINES, lease_ticks=40,
                                      view_change_ticks=200, **kw)
    for k in ("pause_lark", "pause_quorum", "lark_events", "quorum_events",
              "ci_lark", "ci_quorum", "ticks"):
        assert getattr(zoo, k) == getattr(base, k), k
    for k in ("hist_lark", "hist_quorum", "pause_lark_trials",
              "pause_quorum_trials"):
        assert np.array_equal(getattr(zoo, k), getattr(base, k)), k
    for k in base.trajectory:
        assert np.array_equal(zoo.trajectory[k], base.trajectory[k]), k


#: the reference's necessity tile (tests/test_condition_necessity.py)
_ZOO_KW = dict(n=13, partitions=32, rf=3, p=5e-3, trials=3,
               max_ticks=4_000, min_ticks=10 ** 9, chunk_steps=32,
               max_steps=400, seed=7, rebuild_model="reconfig",
               lease_ticks=40, view_change_ticks=500, engines=T.ENGINES)


def _outputs(r):
    return {"pause_lark": r.pause_lark, "pause_quorum": r.pause_quorum,
            "pause_hermes": r.pause_hermes,
            "pause_spinnaker": r.pause_spinnaker,
            "hermes_events": r.hermes_events,
            "spinnaker_events": r.spinnaker_events}


def test_disable_predicates_match_reference():
    assert T.DISABLE_PREDICATES == R.DISABLE_PREDICATES


@pytest.mark.parametrize("predicate", T.DISABLE_PREDICATES)
def test_zoo_predicate_is_load_bearing(predicate):
    """Flipping one predicate off moves a gated output, the port's run
    equals the reference's with the same predicate off, and the lease and
    view-change predicates move only their own engine."""
    base = _outputs(T.simulate_downtime_batched(device="cpu", **_ZOO_KW))
    run = T.simulate_downtime_batched(device="cpu",
                                      _disable_predicates=(predicate,),
                                      **_ZOO_KW)
    flipped = _outputs(run)
    assert flipped != base, (predicate, base)
    _assert_identical(R.simulate_downtime_batched(
        backend="numpy", _disable_predicates=(predicate,), **_ZOO_KW), run)
    # the lease and view-change hooks are local to their engine
    own = {"lease-expiry": "hermes",
           "view-change-trigger": "spinnaker"}.get(predicate)
    if own is not None:
        for k in base:
            if own not in k:
                assert flipped[k] == base[k], (predicate, k)
        grow = flipped[f"pause_{own}"] - base[f"pause_{own}"]
        assert grow > 0 if own == "hermes" else grow < 0


@pytest.mark.parametrize("kw", [
    dict(engines=("lark", "raft")),
    dict(engines=("lark", "lark")),
    dict(engines=()),
    dict(lease_ticks=5),
    dict(view_change_ticks=5),
    dict(engines=("lark", "quorum", "spinnaker")),
    dict(engines=("lark", "hermes"), lease_ticks=-1),
    dict(_disable_predicates=("bogus",)),
], ids=["unknown", "duplicate", "empty", "lease-no-hermes",
        "vc-no-spinnaker", "spinnaker-fixed", "negative", "predicate"])
def test_engine_validation_errors_are_the_reference(kw):
    base = dict(n=7, partitions=8, trials=1, max_steps=2)
    with pytest.raises(ValueError) as want:
        R.simulate_downtime_batched(backend="numpy", **base, **kw)
    with pytest.raises(ValueError) as got:
        T.simulate_downtime_batched(device="cpu", **base, **kw)
    assert str(got.value) == str(want.value)
