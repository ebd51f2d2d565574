"""The port's scalar §5.1 event engine (``core/availability.py``) and the
numpy PAC it runs (``kernels/pac_np.py``) against the reference: the
same ``AvailabilityResult`` field by field, and the same outputs of every
helper on random states."""
from dataclasses import asdict

import numpy as np
import pytest

from repro.core import availability as ref_av
from repro.kernels import pac_np as ref_np
from repro_torch.core import availability as port_av
from repro_torch.kernels import pac_np as port_np

SPECS = {
    # tests/test_sims.py's fast spec
    "rf2_sims": dict(n=31, partitions=128, rf=2, p=5e-3, min_ticks=20_000,
                     max_ticks=60_000, seed=1),
    "rf3": dict(n=31, partitions=128, rf=3, p=1e-2, min_ticks=10_000,
                max_ticks=40_000, seed=2),
    "rf4_long_downtime": dict(n=23, partitions=64, rf=4, p=2e-2,
                              downtime=40, min_ticks=5_000,
                              max_ticks=30_000, seed=5),
    # stops on its confidence interval at min_ticks, far from max_ticks
    "early_stop": dict(n=31, partitions=128, rf=2, p=1e-2, min_ticks=5_000,
                       max_ticks=400_000, check_every=1_000, eps_rel=0.3,
                       min_events=100, seed=4),
    # too few events to stop: runs to max_ticks
    "runs_to_max": dict(n=31, partitions=128, rf=2, p=1e-3,
                        min_ticks=10_000, max_ticks=40_000, seed=6),
}


def _eq(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return np.asarray(a).dtype == np.asarray(b).dtype and \
        np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_simulate_availability_matches_reference(name):
    want = ref_av.simulate_availability(**SPECS[name])
    got = port_av.simulate_availability(**SPECS[name])
    assert asdict(got) == asdict(want)
    assert got.improvement == want.improvement
    assert got.stopped_early == (name != "runs_to_max")


def _random_state(rng, R, n_real, n_pad):
    up = rng.random((R, n_pad)) < 0.8
    full = rng.random((R, n_pad)) < 0.4
    return up, full


@pytest.mark.parametrize("rf,n_real,n_pad", [(2, 9, 9), (3, 31, 32),
                                             (4, 13, 16), (2, 5, 64)])
def test_pac_eval_rank_np_matches_reference(rf, n_real, n_pad):
    rng = np.random.default_rng(rf * 100 + n_pad)
    up, full = _random_state(rng, 200, n_real, n_pad)
    voters = 2 * rf - 1
    assert _eq(port_np.pac_eval_rank_np(up, full, rf=rf, voters=voters,
                                        n_real=n_real),
               ref_np.pac_eval_rank_np(up, full, rf=rf, voters=voters,
                                       n_real=n_real))


@pytest.mark.parametrize("roster", [False, True])
@pytest.mark.parametrize("rf,n_real,n_pad", [(2, 9, 9), (3, 31, 32),
                                             (4, 13, 16)])
def test_downtime_eval_rank_np_matches_reference(rf, n_real, n_pad,
                                                 roster):
    rng = np.random.default_rng(rf * 7 + n_pad)
    up, full = _random_state(rng, 150, n_real, n_pad)
    kw = dict(rf=rf, n_real=n_real, want_repmask=True)
    if roster:
        kw.update(roster=rng.integers(0, n_real, size=(150, rf),
                                      dtype=np.int32), want_rleader=True)
    assert _eq(port_np.downtime_eval_rank_np(up, full, **kw),
               ref_np.downtime_eval_rank_np(up, full, **kw))


def test_rebuild_node_counts_np_matches_reference():
    rng = np.random.default_rng(3)
    recruit = rng.integers(-2, 12, size=(4, 300)).astype(np.int32)
    active = rng.random((4, 300)) < 0.6
    assert _eq(port_np.rebuild_node_counts_np(recruit, active, n_real=10),
               ref_np.rebuild_node_counts_np(recruit, active, n_real=10))
    with pytest.raises(ValueError):
        port_np.rebuild_node_counts_np(recruit, active[:, :5], n_real=10)


@pytest.mark.parametrize("rf", [2, 3])
def test_evaluate_rank_state_matches_reference(rf):
    """Random up masks over a succession matrix; the holder refresh
    mutates full_succ in place, identically over a chain of steps."""
    rng = np.random.default_rng(rf)
    n, P = 17, 64
    succ = np.stack([rng.permutation(n) for _ in range(P)])
    full_ref = np.zeros((P, n), dtype=bool)
    full_ref[:, :rf] = True
    full_port = full_ref.copy()
    for _ in range(20):
        up = rng.random(n) < 0.75
        want = ref_av.evaluate_rank_state(up, succ, full_ref, rf=rf,
                                          voters=2 * rf - 1)
        got = port_av.evaluate_rank_state(up, succ, full_port, rf=rf,
                                          voters=2 * rf - 1)
        assert got[:2] == want[:2]
        assert np.array_equal(got[2], want[2])
        assert np.array_equal(full_port, full_ref)


def test_ci_helpers_match_reference():
    rng = np.random.default_rng(9)
    for bw in (1, 7, 64):
        bl_r, bm_r = np.zeros(200), np.zeros(200)
        bl_p, bm_p = np.zeros(200), np.zeros(200)
        t = 0
        while t < 150 * bw:
            t1 = t + int(rng.integers(1, 3 * bw))
            unl, unm = (int(v) for v in rng.integers(0, 5, size=2))
            ref_av._accumulate_buckets(bl_r, bm_r, t, t1, unl, unm, bw)
            port_av._accumulate_buckets(bl_p, bm_p, t, t1, unl, unm, bw)
            t = t1
        assert np.array_equal(bl_p, bl_r) and np.array_equal(bm_p, bm_r)
        assert port_av.block_ci_halfwidth(bl_p, bm_p, t, bw, 128) == \
            ref_av.block_ci_halfwidth(bl_r, bm_r, t, bw, 128)
    for dof in (1, 9, 16, 25, 31, 400):
        assert port_av.t975(dof) == ref_av.t975(dof)


def test_chip_smoke_pins_the_reference_event_rows():
    """chip_smoke.py checks the port runner's smoke rows under backend
    "event" on the card machine, which has no JAX, against pinned
    strings: they are the reference runner's rows."""
    import json
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro.experiments import runner as ref_runner
    from repro.experiments.spec import ExperimentSpec as RefSpec
    want = [json.dumps(ref_runner._json_safe(r), sort_keys=True)
            for r in ref_runner.iter_rows(RefSpec.create(smoke=True))]
    assert chip_smoke.EVENT_SMOKE_ROWS == want
