"""The port's batched availability engine against the reference, bitwise.

``simulate_availability_batched(device="cpu", trajectory=True)`` must
reproduce the reference's numpy and jax backends exactly — results,
per-trial unavailabilities, event counts and every trajectory column —
packed and unpacked, for the i.i.d. model and every registered scenario.
A mid-run restart through ``carry_from_numpy`` must continue exactly as
the reference does."""
import numpy as np
import pytest
import torch

from repro.core import availability_batched as R
from repro.core.scenarios import get_scenario, scenario_names
from repro.kernels.ops import StepSpec as RefStepSpec
from repro.kernels.ops import step_eval as ref_step_eval
from repro_torch.core import availability_batched as T
from repro_torch.kernels.ops import StepSpec, step_eval

# the tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N = 13
KW = dict(n=N, partitions=32, rf=2, p=5e-3, trials=3, max_ticks=4_000,
          min_ticks=10 ** 9, chunk_steps=64, max_steps=300, seed=11,
          trajectory=True)


def _assert_same(a, b):
    assert set(a.trajectory) == set(b.trajectory)
    for k in a.trajectory:
        assert np.array_equal(a.trajectory[k], b.trajectory[k]), k
    assert (a.u_lark, a.u_maj, a.ticks) == (b.u_lark, b.u_maj, b.ticks)
    assert (a.lark_events, a.maj_events) == (b.lark_events, b.maj_events)
    assert (a.ci_lark, a.ci_maj) == (b.ci_lark, b.ci_maj)
    assert a.stopped_early == b.stopped_early
    assert np.array_equal(a.u_lark_trials, b.u_lark_trials)
    assert np.array_equal(a.u_maj_trials, b.u_maj_trials)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("scenario", ["iid", *scenario_names()])
def test_trajectories_match_reference_numpy_and_jax(scenario, packed):
    kw = dict(KW, packed=packed)
    if scenario != "iid":
        kw.update(get_scenario(scenario).kwargs(n=N, rf=2, p=5e-3))
    got = T.simulate_availability_batched(device="cpu", **kw)
    assert got.trajectory["times"].shape == (320, 3)
    assert got.lark_events > 0
    for backend in ("numpy", "jax"):
        _assert_same(R.simulate_availability_batched(backend=backend, **kw),
                     got)


def test_early_stop_and_horizon_follow_reference():
    # min_ticks reachable: the pooled-CI stop and the horizon stop both
    # decide on the reference's chunk boundaries
    kw = dict(n=11, partitions=16, rf=2, p=2e-2, trials=4, max_ticks=3_000,
              min_ticks=500, min_events=20, eps_rel=0.5, chunk_steps=32,
              seed=3, trajectory=True)
    for extra in ({}, {"max_ticks": 400, "min_ticks": 10 ** 9}):
        want = R.simulate_availability_batched(backend="numpy",
                                               **{**kw, **extra})
        got = T.simulate_availability_batched(device="cpu",
                                              **{**kw, **extra})
        _assert_same(want, got)
    assert got.ticks == 400 and not got.stopped_early


def test_devices_request_runs_one_batch():
    kw = dict(KW, trials=4)
    one = T.simulate_availability_batched(device="cpu", **kw)
    two = T.simulate_availability_batched(device="cpu", devices=2, **kw)
    _assert_same(one, two)
    assert two.devices == 2
    with pytest.raises(ValueError, match="divide"):
        T.simulate_availability_batched(device="cpu", devices=3, **kw)


_KNOBS = dict(pair_fail_prob=0.5, restart_period=150, wave_width=2,
              p_node=np.array([5e-3, 2e-2, 1e-3])[np.arange(N) % 3],
              downtime_node=np.where(np.arange(N) % 4 == 0, 3, 10))
#: the restart test runs 40 nodes, so holder word 0 has a live bit 31
NC = 40
_KNOBS_C = dict(_KNOBS, p_node=np.array([5e-3, 2e-2, 1e-3])[np.arange(NC) % 3],
                downtime_node=np.where(np.arange(NC) % 4 == 0, 3, 10))


def _ref_engine(packed, n=NC, knobs=_KNOBS_C):
    """The reference numpy engine's step and t=0 carry (its internals, as
    simulate_availability_batched assembles them)."""
    B, P, horizon = 3, 32, 4_000
    (xp, succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     _, _) = R._engine_setup(
        "numpy", n=n, partitions=P, seed=5, p=5e-3, downtime=10,
        p_node=knobs["p_node"], downtime_node=knobs["downtime_node"],
        max_ticks=horizon)
    spec = RefStepSpec(metric="availability", rf=2, voters=3, n_real=n,
                       packed=packed)

    def pac_fn(u, f):
        o = ref_step_eval(spec, u, f, backend="numpy")
        return o.lark, o.maj, o.creps

    step = R._make_step(
        np, pac_fn, succ, n=n, P=P, horizon=horizon, dt_vec=dt_vec,
        geo_masks=geo_masks, geo_tables=geo_tables, seed_mix=seed_mix,
        pair_fail_prob=knobs["pair_fail_prob"], pair_perm=pair_perm,
        restart_period=knobs["restart_period"],
        wave_width=knobs["wave_width"], packed=packed)
    lane0, up0, ev0, rr_t0 = R._initial_node_state(
        np, B=B, n=n, seed_mix=seed_mix, geo_masks=geo_masks,
        geo_tables=geo_tables, restart_period=knobs["restart_period"],
        horizon=horizon)
    full0, (lark0, maj0, _) = R._initial_full_state(
        np, "numpy", pac_fn, up0, succ, B=B, P=P, n=n, rf=2, packed=packed)
    zi, zf = np.zeros(B, np.int32), np.zeros(B, np.float32)
    carry = (zi, up0, ev0, full0, ~lark0.reshape(B, P),
             ~maj0.reshape(B, P), zf, zf, zi, zi, rr_t0, zi, lane0)
    return step, carry


def _port_step(packed, n=NC, knobs=_KNOBS_C):
    P, horizon = 32, 4_000
    (succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     _, _) = T._engine_setup(
        n=n, partitions=P, seed=5, p=5e-3, downtime=10,
        p_node=knobs["p_node"], downtime_node=knobs["downtime_node"],
        max_ticks=horizon, device="cpu")
    spec = StepSpec(metric="availability", rf=2, voters=3, n_real=n,
                    packed=packed)

    def pac_fn(u, f):
        o = step_eval(spec, u, f)
        return o.lark, o.maj, o.creps

    return T._make_step(
        pac_fn, succ, n=n, P=P, horizon=horizon, dt_vec=dt_vec,
        geo_masks=geo_masks, geo_tables=geo_tables, seed_mix=seed_mix,
        pair_fail_prob=knobs["pair_fail_prob"], pair_perm=pair_perm,
        restart_period=knobs["restart_period"],
        wave_width=knobs["wave_width"], packed=packed)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_mid_run_restart_from_reference_carry(packed):
    ref_step, carry = _ref_engine(packed)
    carry, _ = R._run_chunk_numpy(ref_step, carry, 1, 64)      # mid-run
    # frozen holder sets of any shape are states the engine can reach in
    # principle; plant some (bit 31 included) so the exchange carries them
    rng = np.random.default_rng(4)
    full = carry[3].copy()
    if packed:
        full[:, :, :8] = rng.integers(0, 2 ** 32, full[:, :, :8].shape,
                                      dtype=np.uint64).astype(np.uint32)
    else:
        full[:, :8, :] = rng.random(full[:, :8, :].shape) < 0.5
    carry = carry[:3] + (full,) + carry[4:]
    want_carry, want_ys = R._run_chunk_numpy(ref_step, carry, 65, 96)

    tcarry = T.carry_from_numpy(carry, device="cpu")
    if packed:
        assert tcarry[3].dtype == torch.int32
        assert (carry[3] >= 2 ** 31).any()     # bit-31 words carried over
    back = T.carry_to_numpy(tcarry)
    for a, b in zip(carry, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    got_carry, got_ys = T._run_chunk(_port_step(packed), tcarry, 65, 96)
    for w, g in zip(want_ys, got_ys):
        assert np.array_equal(w, g)
    for w, g in zip(want_carry, T.carry_to_numpy(got_carry)):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert int(want_ys[1].sum()) > 0          # some partitions went down
