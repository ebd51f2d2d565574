"""The Monte Carlo's trials sharded across ranks, bitwise.

One spawn of 4 ``gloo`` ranks (joined through a ``file://`` store under
the test's tmp dir, so no port can clash between test workers) runs every
path of ``_torch_ranks.PATHS`` with devices = 4, unpacked and packed: the
§5.1 engine with the early stop live and without it, the §6 fixed model,
reconfig with zipf sizes under shared bandwidth, the protocol zoo and the
client-latency layer.  Every rank's result must equal the port's
single-process devices = 1 run and the reference's ``backend="numpy"`` run
field for field and trajectory for trajectory.  In process: the
``use_shard_map`` knob at devices = 1, with and without a one-rank group,
the validation errors, and the meshes' size checks.  And the experiment
runner on 2 ranks: rank 0 alone writes, rows equal to one process's."""

import json
import pickle
import threading

import pytest
import torch

import _torch_ranks as TR
from repro.core import availability_batched as RA
from repro.core import client_latency as RC
from repro.core import downtime_batched as RD
from repro_torch.experiments.runner import ExperimentRunner
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.launch import dist as rdist
from repro_torch.launch import mesh as rmesh

torch.set_num_threads(1)

WORLD = 4
REF = {"availability": RA.simulate_availability_batched,
       "downtime": RD.simulate_downtime_batched,
       "latency": RC.simulate_client_latency}
#: a hung collective fails the spawn inside this bound
SPAWN_TIMEOUT_S = 110


def _spawn_beside(fn, world, tmp, work):
    """fn's `world` ranks (joined through a file store in `tmp`) in a
    thread while this process runs work(); returns work's result once
    the ranks have ended, and raises what the spawn raised."""
    failure = []

    def spawn():
        try:
            rdist.spawn(fn, world, (world, str(tmp / "store"), str(tmp)),
                        timeout_s=SPAWN_TIMEOUT_S)
        except Exception as e:             # re-raised below
            failure.append(e)

    th = threading.Thread(target=spawn)
    th.start()
    try:
        out = work()
    finally:
        th.join(SPAWN_TIMEOUT_S + 10)
    assert not th.is_alive(), "the spawn outlived its deadline"
    if failure:
        raise failure[0]
    return out


def _one_process_and_reference():
    single = {c: TR.fingerprint(TR.run_path(*c)) for c in TR.CASES}
    ref = {}
    for name, packed in TR.CASES:
        engine, knobs = TR.PATHS[name]
        ref[name, packed] = TR.fingerprint(REF[engine](
            backend="numpy", packed=packed, **knobs))
    return single, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(per-rank fingerprints, devices = 1 fingerprints, reference
    fingerprints) per case; the one-process runs overlap the spawn."""
    tmp = tmp_path_factory.mktemp("ranks")
    single, ref = _spawn_beside(TR.rank_main, WORLD, tmp,
                                _one_process_and_reference)
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
             for r in range(WORLD)]
    return ranks, single, ref


def _assert_same(want, got, skip=("devices", "downtime.devices")):
    assert set(want) == set(got)
    bad = [k for k in want if k not in skip and not TR.same(want[k], got[k])]
    assert not bad, bad


@pytest.mark.parametrize("case", TR.CASES,
                         ids=[f"{n}-{'packed' if p else 'bool'}"
                              for n, p in TR.CASES])
def test_four_ranks_equal_one_rank_and_reference(runs, case):
    ranks, single, ref = runs
    for r, got in enumerate(ranks):
        assert got[case]["devices"] == WORLD, r
        _assert_same(single[case], got[case])
    _assert_same(ref[case], ranks[0][case])
    assert single[case]["devices"] == 1


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_early_stop_at_the_same_step(runs, packed):
    ranks, single, _ = runs
    case = ("availability_stop", packed)
    assert single[case]["stopped_early"]
    steps = len(single[case]["trajectory:times"])
    assert steps < TR.PATHS["availability_stop"][1]["max_steps"]
    for got in ranks:
        assert got[case]["stopped_early"]
        assert len(got[case]["trajectory:times"]) == steps


def test_world_must_divide_devices(runs):
    """Each rank also asked for devices = 2 on its world of 4."""
    ranks, _, _ = runs
    assert all(got["devices_2_raises"] for got in ranks)


@pytest.mark.parametrize("case", [("availability", False), ("zoo", True),
                                  ("latency", False)],
                         ids=["availability", "zoo-packed", "latency"])
def test_use_shard_map_at_one_device(tmp_path, case):
    want = TR.fingerprint(TR.run_path(*case))
    # no process group: the sharded path over a world of one
    _assert_same(want, TR.fingerprint(TR.run_path(*case,
                                                  use_shard_map=True)))
    # a one-rank group: the gathers run through it
    rdist.init(f"file://{tmp_path / 'store'}", rank=0, world_size=1,
               timeout_s=60)
    try:
        got = TR.fingerprint(TR.run_path(*case, use_shard_map=True))
    finally:
        torch.distributed.destroy_process_group()
    _assert_same(want, got)


def test_validation_errors(monkeypatch):
    with pytest.raises(ValueError, match="divide"):
        TR.run_path("availability", False, devices=3)
    with pytest.raises(ValueError, match="devices"):
        TR.run_path("fixed", False, devices=0)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        rdist.init()
    with pytest.raises(ValueError, match="rank and world_size"):
        rdist.init("tcp://localhost:1")
    with pytest.raises(ValueError, match="does not divide"):
        rdist.check_divides(2, 4)
    assert (rdist.rank(), rdist.world_size()) == (0, 1)
    assert rdist.local_device("cpu") == torch.device("cpu")


def test_meshes_need_enough_ranks():
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        rmesh.make_trials_mesh(2)
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        rmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        rmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        rmesh.make_host_mesh()


def test_runner_on_two_ranks_writes_from_rank_0(tmp_path):
    """The experiment runner on 2 gloo ranks: rank 0 alone prints,
    streams events and writes the summary, whose rows equal a
    one-process run's and whose provenance records the world size."""
    want = _spawn_beside(
        TR.sweep_rank_main, 2, tmp_path,
        lambda: ExperimentRunner(ExperimentSpec.create(**TR.SWEEP_SPEC),
                                 emit=None, device="cpu").summary())
    got = json.loads((tmp_path / "summary0.json").read_text())
    assert got["rows"] == json.loads(json.dumps(want["rows"]))
    assert got["meta"]["provenance"]["observed"]["world_size"] == 2
    assert want["meta"]["provenance"]["observed"]["world_size"] == 1
    assert not (tmp_path / "summary1.json").exists()
    assert not (tmp_path / "events1.jsonl").exists()
    assert (tmp_path / "events0.jsonl").read_text().count("\n") == \
        len(got["rows"]) + 2                     # run_start, rows, run_end
    assert json.loads((tmp_path / "lines1.json").read_text()) == []
    assert len(json.loads((tmp_path / "lines0.json").read_text())) == \
        len(got["rows"])
