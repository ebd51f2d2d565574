"""Tensor- and sequence-parallel execution (``launch/tp.py``,
``training/sharded.py``) on a 2 x 2 ("data", "model") gloo mesh against
one process of the port, which the other tests hold against the
reference.

Four ranks (a ``file://`` store under the test's tmp dir) run every case
of ``_torch_tp.CASES``: six reduced tensor-parallel archs (GQA with fewer
KV heads than ways, experts tensor-parallel on their hidden width,
expert parallelism with Adafactor, MLA split mid-head with a vocabulary
that shards d_model, Adafactor with FSDP, RG-LRU with one KV head) and
the sequence-parallel ones (smollm, whisper and qwen2-vl with the
sequence over "model"; xlstm's one-row decode with its state over data x
model; recurrentgemma's and mixtral's too, tensor-parallel): two train
steps, a prefill and four greedy decode steps.  The six tensor-parallel
archs train again with ZeRO moments (``_torch_tp.ZERO``: distributed
under ``opt_state_shardings``, Adafactor's factored moments for qwen3-moe
and nemotron), each rank holding its shard.

Tolerance: float32 sums split across ranks move by rounding alone.  Held:
every parameter leaf and every logit within ``_torch_lm.close_deep``
(rtol 1e-3, atol 1e-3 of the leaf's largest magnitude), the loss and
grad norm within rtol 1e-3, the greedy tokens equal; float32 optimizer
moments within close_deep too, and Adafactor's bfloat16 momentum within
one bfloat16 rounding (2^-8 relative) more, since a float32 difference
at the last bit can flip its rounding.  Measured (CPU): parameters within
1.8e-7 of their largest, logits within 1.1e-6, losses within 1.8e-7
relative.  Also: the global norm of gradients whose shards' norms differ
equals one process's."""
import pickle

import numpy as np
import pytest
import torch

import _torch_lm as lm
import _torch_tp as T
from repro_torch.launch import dist as rdist
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import batch_shardings
from repro_torch.models.model import make_batch
from repro_torch.configs.base import ShapeConfig
from repro_torch.training import sharded as SH

torch.set_num_threads(1)

TRAIN = [n for n, c in T.CASES.items() if "train" in c[3]]
SERVE = [n for n, c in T.CASES.items() if {"serve", "prefill"} & set(c[3])]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    rdist.spawn(T.rank_main, 4, (4, str(tmp / "store"), str(tmp)),
                timeout_s=150)
    return pickle.loads((tmp / "tp.pkl").read_bytes())


@pytest.fixture(scope="module")
def one_process():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = T.run(name)
        return cache[name]
    return get


@pytest.mark.parametrize("name", TRAIN)
def test_train_steps_match_one_process(ranks, one_process, name):
    _train_matches(ranks[name], one_process(name))


@pytest.mark.parametrize("name", T.ZERO)
def test_zero_train_steps_match_one_process(ranks, one_process, name):
    """The ZeRO step: moments stored under opt_state_shardings, each rank
    holding its shard only (data on a free dim beside the model
    shards)."""
    got = ranks[name, "zero"]
    assert all(local == want for local, want in got["shapes"])
    assert any(local != want for local, want in zip(
        [s for s, _ in got["shapes"]],
        [tuple(o.shape) for o in got["opt_state"]]))
    _train_matches(got, one_process(name))


def _train_matches(got, want):
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        assert g.shape == w.shape
        lm.close_deep(g, w)
    for g, w, dt in zip(got["opt_state"], want["opt_state"],
                        want["opt_dtypes"]):
        if dt == "torch.bfloat16":
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=1e-3 + 2.0 ** -8,
                                       atol=1e-3 * scale)
        else:
            lm.close_deep(g, w)
    # the first step moved the parameters: the second loss differs
    assert got["metrics"][1]["loss"] != got["metrics"][0]["loss"]


@pytest.mark.parametrize("name", SERVE)
def test_prefill_and_decode_match_one_process(ranks, one_process, name):
    got, want = ranks[name], one_process(name)
    assert len(got["logits"]) == len(want["logits"])
    for g, w in zip(got["logits"], want["logits"]):
        lm.close_deep(g, w)
        assert np.array_equal(g.argmax(-1), w.argmax(-1))


@pytest.fixture
def fake4():
    fake_world(4)
    try:
        yield make_host_mesh(*T.MESH)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", ["smollm_360m_sp", "whisper_small_sp",
                                  "qwen2_vl_2b_sp"])
def test_sp_cases_shard_the_sequence(fake4, name):
    """The "_sp" cases' batch specs put the rows on "data" and the
    sequence on "model", so their steps ran sequence-parallel."""
    cfg = T.config(name)
    rows = T.CASES[name][2]
    batch = make_batch(cfg, ShapeConfig("t", T.TRAIN_SEQ, rows, "train"),
                       np.random.default_rng(0))
    specs = SH.batch_specs(cfg, fake4, batch,
                           batch_shardings(cfg, fake4, batch, rows))
    assert SH.main_spec(specs)[:2] == ("data", "model")


def test_one_row_states_are_sharded_over_data_and_model(fake4):
    dm = ("data", "model")
    store, _ = SH.layer_state_specs(T.config("xlstm_350m_b1"), fake4, 1,
                                    T.MAX_LEN)
    assert store[0]["cell"]["C"] == (None, None, "data", "model")
    assert store[-1]["cell"]["h"] == (None, dm)
    store, _ = SH.layer_state_specs(T.config("recurrentgemma_9b_b1"),
                                    fake4, 1, T.MAX_LEN)
    assert store[0]["cell"]["h"] == (None, dm)
    assert store[2]["kv"]["k"] == (None, dm, None, None)
    store, _ = SH.layer_state_specs(T.config("mixtral_8x7b_b1"), fake4, 1,
                                    T.MAX_LEN)
    assert store[0]["kv"]["k"] == (None, dm, None, None)


def test_clip_global_norm_across_shards(ranks):
    norm, clipped = T.clip_case()
    got_norm, got = ranks["clip"]
    np.testing.assert_allclose(got_norm, norm, rtol=1e-6)
    assert norm > 1.0                                  # the clip acted
    for g, w in zip(got, clipped):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)



def test_moves_and_bucketed_collectives(ranks):
    """``tp.to_spec`` where an axis moves between dims (one all-to-all),
    and the ZeRO step's bucketed reduce-scatter (summed over "data": a
    leaf cut on both axes keeps its model-axis cut locally, a leaf whose
    spec adds no summed axis is all-reduced) and all-gather back, whole
    and in pieces of at most ``tp.CHUNK`` elements, equal to slices of
    the whole tensors on rank 0."""
    got = ranks["collectives"]
    assert len(got) == len(T.MOVES) + 4 * len(T.BUCKETS)
    for g, w in got:
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
