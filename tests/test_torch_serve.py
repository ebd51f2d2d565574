"""The port's serve path against the reference, on the CPU.

``ServeLoop.generate`` on ``reduced_config("xlstm_350m")`` with the
reference's weights gives the reference's greedy tokens; a session
resumed from the LARK store after ``fail_server(0)`` continues exactly
as the uninterrupted run (the mirror of
``test_framework.py::test_serve_resume_matches_uninterrupted``, on
xlstm); the port's ``LarkStore`` gives the reference's (ok, value)
sequence on a put/get/fail/recover script; and the serve CLI runs."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.lark_store import LarkStore as RefStore
from repro.configs import reduced_config as ref_reduced
from repro.models import build_model as ref_build
from repro.serving import LarkSessionStore as RefSessions
from repro.serving import ServeLoop as RefLoop
from repro_torch.checkpoint import LarkStore
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving import LarkSessionStore, ServeLoop

torch.set_num_threads(1)

ARCH = "xlstm_350m"


@pytest.fixture(scope="module")
def weights():
    cfg = ref_reduced(ARCH)
    pj = ref_build(cfg)["init_params"](jax.random.PRNGKey(0))
    tcfg = reduced_config(ARCH)
    return cfg, pj, tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray, pj))


def _prompt(cfg, batch=2, seq=8):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def test_generate_matches_reference(weights):
    cfg, pj, tcfg, pt = weights
    tok = _prompt(cfg)
    want = RefLoop(cfg, pj, max_len=48).generate(
        {"tokens": jnp.asarray(tok)}, steps=8)
    got = ServeLoop(tcfg, pt, max_len=48, device="cpu").generate(
        {"tokens": tok}, steps=8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_resume_matches_uninterrupted(weights):
    _, _, tcfg, pt = weights
    sess = LarkSessionStore(num_nodes=4, rf=2)
    loop = ServeLoop(tcfg, pt, max_len=48, session_store=sess,
                     checkpoint_every=4, device="cpu")
    batch = {"tokens": _prompt(tcfg)}
    full = loop.generate(batch, steps=8, session_id="s")
    # session checkpointed at step 8: resume must match continued generation
    sess.fail_server(0)                         # failover
    resumed = loop.resume("s", steps=4)
    assert resumed is not None
    np.testing.assert_array_equal(resumed[:, :8], full)
    longer = ServeLoop(tcfg, pt, max_len=48, device="cpu").generate(
        batch, steps=12)
    np.testing.assert_array_equal(resumed, longer)


def test_session_state_round_trips_bit_exact():
    """bfloat16 leaves (the full width's conv states) come back in their
    own dtype, bit for bit, and never alias the caller's tensors."""
    sess = LarkSessionStore(num_nodes=4, rf=2)
    state = [{"cell": {"conv": torch.randn(2, 3, 8).to(torch.bfloat16),
                       "C": torch.randn(2, 4, 4, 4)}}]
    assert sess.save_session("x", state, np.zeros((2, 1), np.int32), 9)
    sess.fail_server(0)
    ok, blob = sess.load_session("x")
    assert ok and blob["pos"] == 9
    for name in ("conv", "C"):
        got, want = blob["state"][0]["cell"][name], state[0]["cell"][name]
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert got.data_ptr() != want.data_ptr()


def _store_script(store):
    """Writes and reads across a failure the cluster rides out (2 of 3
    nodes up), one that takes the majority away (1 of 3), and the
    recoveries."""
    out = [store.put("a", 1), store.get("a")]
    store.fail_node(0)
    out += [store.get("a"), store.put("b", 2), store.get("b"),
            store.available_fraction(), store.regime]
    store.fail_node(1)
    out += [store.get("a"), store.get("b"), store.put("c", 3),
            store.available_fraction()]
    store.recover_node(0)
    out += [store.get("a"), store.get("c"), store.put("a", 4),
            store.get("a"), store.available_fraction(), store.regime]
    store.recover_node(1)
    out += [store.get("b"), store.get("a"), store.available_fraction()]
    return out


def test_lark_store_matches_reference():
    want = _store_script(RefStore(3, rf=2, num_partitions=16))
    got = _store_script(LarkStore(3, rf=2, num_partitions=16))
    assert got == want
    assert (False, None) in got and 0.0 in got      # the outage was seen


def test_sessions_match_reference_store():
    """The session wrapper routes keys as the reference's does: each
    session id is available (or not) on both sides alike, through a
    failure the cluster rides out and one it does not."""
    ref, port = RefSessions(num_nodes=3, rf=2), LarkSessionStore(3, rf=2)
    seen = []
    for s in (ref, port):
        for i in range(6):
            s.save_session(f"r{i}", {}, np.zeros((1, 1), np.int32), i)
        s.fail_server(0)
        up = [s.load_session(f"r{i}")[0] for i in range(6)]
        s.fail_server(1)
        seen.append((up, [s.load_session(f"r{i}")[0] for i in range(6)]))
    assert seen[0] == seen[1]
    assert seen[1] == ([True] * 6, [False] * 6)


@pytest.mark.parametrize("module", ["core/pac.py", "core/messages.py",
                                    "core/node.py", "core/simulator.py",
                                    "configs/base.py"])
def test_protocol_and_config_modules_are_verbatim_copies(module):
    root = Path(__file__).resolve().parents[1] / "src"
    assert (root / "repro_torch" / module).read_bytes() == \
        (root / "repro" / module).read_bytes()


def test_serve_cli_runs_on_cpu():
    toks, resumed = serve.main(["--device", "cpu", "--batch", "2",
                                "--prompt-len", "12", "--gen", "8",
                                "--fail-server"])
    assert toks.shape == (2, 4) and resumed.shape == (2, 8)
    np.testing.assert_array_equal(resumed[:, :4], toks)


def test_serve_cli_reaches_the_full_config(monkeypatch):
    """--no-reduced takes the full config and the default the reduced one
    (the reference's store_true flag with default=True never reaches the
    full one), and the default arch is smollm_360m, the reference's.  The
    model and the loop are stubbed: the full model is not built here."""
    called = []
    monkeypatch.setattr(serve, "get_config", lambda a: called.append(
        ("full", a)) or get_config(a))
    monkeypatch.setattr(serve, "reduced_config", lambda a: called.append(
        ("reduced", a)) or reduced_config(a))
    built = []
    monkeypatch.setattr(serve, "build_model", lambda cfg: built.append(
        cfg) or {"init_params": lambda gen: {}})

    class StubLoop:
        def __init__(self, cfg, params, max_len, **kw):
            self.max_len = max_len

        def generate(self, batch, steps, session_id):
            return np.zeros((len(batch["tokens"]), steps), np.int32)

        def resume(self, session_id, steps):
            return np.zeros((2, 2 * steps), np.int32)
    monkeypatch.setattr(serve, "ServeLoop", StubLoop)
    for flags in (["--no-reduced"], []):
        serve.main(flags + ["--device", "cpu"])
    assert called == [("full", "smollm_360m"), ("reduced", "smollm_360m")]
    assert built[0] is get_config("smollm_360m")
    assert (built[0].num_layers, built[0].d_model) == (32, 960)
    assert repr(built[1]) == repr(reduced_config("smollm_360m"))
    assert built[1].d_model == 64
