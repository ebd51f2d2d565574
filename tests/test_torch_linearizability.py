"""The port's linearizability checker (``core/linearizability.py``)
against the reference's: the same verdict on every history that
``tests/test_linearizability.py`` builds (its unit tests rerun with both
checkers, the randomized protocol schedules, seeded sequential
histories) and on seeded arbitrary ones; and the port's own ``LarkSim``
produces linearizable histories, as ``tests/test_system.py`` shows for
the reference's."""
import random

import pytest

import test_linearizability as ref_tests
from repro.core import linearizability as ref_lin
from repro.core.simulator import LarkSim as RefSim
from repro_torch.core import linearizability as port_lin
from repro_torch.core.simulator import LarkSim as PortSim

INF = float("inf")

#: the reference's checker unit tests: plain functions of no argument
UNIT_TESTS = sorted(
    name for name, fn in vars(ref_tests).items()
    if name.startswith("test_") and callable(fn)
    and not hasattr(fn, "pytestmark") and not hasattr(fn, "hypothesis")
    and fn.__code__.co_argcount == 0
    and name != "test_replicated_versions_form_chain")


def _agree(ops, initial=None):
    want = ref_lin.check_linearizable(ops, initial)
    port_ops = [port_lin.Op(o.op_id, o.kind, o.value, o.inv, o.resp,
                            o.mandatory) for o in ops]
    assert port_lin.check_linearizable(port_ops, initial) == want
    return want


def test_unit_tests_collected():
    assert len(UNIT_TESTS) >= 14


@pytest.mark.parametrize("name", UNIT_TESTS)
def test_reference_unit_histories_same_verdict(name, monkeypatch):
    """Each reference unit test, its checker calls answered by both
    checkers (which must agree), passes as it does on the reference."""
    monkeypatch.setattr(ref_tests, "check_linearizable", _agree)
    getattr(ref_tests, name)()


def _history_verdicts(hist):
    want = ref_lin.check_history(hist)
    got = port_lin.check_history(hist)
    keys = sorted({e.key for e in hist})
    for k in keys:
        assert [(o.op_id, o.kind, o.value, o.inv, o.resp, o.mandatory)
                for o in port_lin.history_to_ops(hist, k)] == \
            [(o.op_id, o.kind, o.value, o.inv, o.resp, o.mandatory)
             for o in ref_lin.history_to_ops(hist, k)]
    assert got == want
    return got


@pytest.mark.parametrize("seed", range(25))
def test_reference_schedules_same_verdict(seed):
    """The reference's randomized protocol schedules (rf 2; rf 3 for
    every fifth seed), checked by both checkers."""
    if seed % 5 == 4:
        hist = ref_tests.run_random_schedule(seed + 1000, n=6, rf=3,
                                             events=24)
    else:
        hist = ref_tests.run_random_schedule(seed)
    assert all(_history_verdicts(hist).values())


@pytest.mark.parametrize("seed", range(10))
def test_port_sim_schedules_linearizable(seed, monkeypatch):
    """The same schedules driven through the port's LarkSim: its
    histories equal the reference sim's and check linearizable."""
    monkeypatch.setattr(ref_tests, "LarkSim", PortSim)
    got = ref_tests.run_random_schedule(seed)
    monkeypatch.setattr(ref_tests, "LarkSim", RefSim)
    want = ref_tests.run_random_schedule(seed)
    assert _events(got) == _events(want)
    assert all(port_lin.check_history(got).values())


def _events(hist):
    """A history's events with op ids renumbered in order of first
    appearance (each module's simulator draws ids from its own counter;
    -1, no leader, stays)."""
    ids = {-1: -1}
    out = []
    for e in hist:
        ev = dict(vars(e))
        ev["op_id"] = ids.setdefault(e.op_id, len(ids))
        out.append(ev)
    return out


@pytest.mark.parametrize("seed", range(25))
def test_sequential_histories_same_verdict(seed):
    """The reference's property test's sequential histories (seeded):
    linearizable under both checkers."""
    rng = random.Random(seed)
    t, last, ops, vcount = 0.0, None, [], 0
    for i in range(rng.randint(1, 12)):
        t += 1.0
        roll = rng.random()
        if roll < 0.45:
            vcount += 1
            ops.append(ref_lin.Op(i, "write", f"v{vcount}", t, t + 0.5,
                                  True))
            last = f"v{vcount}"
        elif roll < 0.6:
            vcount += 1
            applied = rng.random() < 0.5
            ops.append(ref_lin.Op(i, "write", f"v{vcount}", t,
                                  t + 0.5 if rng.random() < 0.5 else INF,
                                  False))
            if applied:
                last = f"v{vcount}"
        else:
            ops.append(ref_lin.Op(i, "read", last, t, t + 0.5, True))
    rng.shuffle(ops)
    assert _agree(ops)


@pytest.mark.parametrize("seed", range(10))
def test_arbitrary_histories_same_verdict(seed):
    """Random overlapping intervals, random read values, optional writes:
    both verdicts occur, and the checkers agree on each."""
    rng = random.Random(1000 + seed)
    verdicts = set()
    for _ in range(30):
        ops = []
        for i in range(rng.randint(1, 9)):
            inv = rng.uniform(0, 10)
            resp = inv + rng.uniform(0, 4)
            if rng.random() < 0.5:
                ops.append(ref_lin.Op(i, "write", f"v{i}", inv,
                                      resp if rng.random() < 0.8 else INF,
                                      rng.random() < 0.7))
            else:
                val = rng.choice([None] + [f"v{j}" for j in range(i + 1)])
                ops.append(ref_lin.Op(i, "read", val, inv, resp, True))
        verdicts.add(_agree(ops))
    assert verdicts == {True, False}


def test_port_failover_history_linearizable():
    """tests/test_system.py's failover, on the port's LarkSim and
    checker."""
    sim = PortSim(num_nodes=5, rf=2, num_partitions=2)
    sim.recluster(); sim.settle(); sim.run_migrations()
    assert sim.client_write(0, "k", "v1") > 0
    sim.settle()
    leader = sim.leader_of(0)
    sim.fail_node(leader)
    sim.settle(); sim.run_migrations()
    assert sim.leader_of(0) is not None and sim.leader_of(0) != leader
    w2 = sim.client_write(0, "k", "v2"); sim.settle()
    assert sim.result(w2).ok
    r = sim.client_read(0, "k"); sim.settle()
    assert sim.result(r).value == "v2"
    hist = sim.finalize_history()
    assert all(port_lin.check_history(hist).values())
    assert _history_verdicts(hist) == {"k": True}


def test_history_too_large_raises():
    ops = [port_lin.Op(i, "write", i, i, i + 0.5, True) for i in range(18)]
    with pytest.raises(ValueError, match="too large"):
        port_lin.check_linearizable(ops)
