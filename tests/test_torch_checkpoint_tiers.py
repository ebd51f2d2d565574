"""The port's checkpoint tiers and elastic trainer against the
reference's: the disk tier (npz shards and a JSON manifest; a bf16 leaf
stored as its 16-bit words and restored bit for bit; the reference's
manifest fields), ``AsyncCheckpointer``, ``QuorumLogStore``'s commit
windows against the reference's on the same script of failures, time
and keys, ``LarkStore.put_pytree``/``get_pytree`` with the reference's
keys, and ``ElasticTrainer``'s remesh and restore, also on a real train
step, bitwise equal to an uninterrupted run."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import LarkStore as RefLark
from repro.checkpoint import QuorumLogStore as RefQuorum
from repro.checkpoint import save_pytree as ref_save
from repro_torch import tree as T
from repro_torch.checkpoint import (AsyncCheckpointer, LarkStore,
                                    QuorumLogStore, load_pytree,
                                    save_pytree)
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.training import ElasticTrainer, make_train_step

torch.set_num_threads(1)


def _tree():
    g = torch.Generator()
    g.manual_seed(0)
    return {"a": torch.arange(4.0),
            "b": {"c": torch.randn((2, 3), generator=g)
                  .to(torch.bfloat16),
                  "d": torch.arange(6, dtype=torch.int32)},
            "layers": [torch.randn(5, generator=g), np.float32(1.5)]}


def test_disk_roundtrip_restores_bf16_bit_for_bit(tmp_path):
    tree = _tree()
    save_pytree(tmp_path, tree, step=7, regime=3)
    back, manifest = load_pytree(tmp_path, tree)
    assert manifest["step"] == 7 and manifest["regime"] == 3
    assert manifest["paths"] == ["a", "b/c", "b/d", "layers/[0]",
                                 "layers/[1]"]
    assert manifest["dtypes"][1] == "torch:bfloat16"
    for g, w in zip(T.leaves(back), T.leaves(tree)):
        if torch.is_tensor(w):
            assert g.dtype == w.dtype and torch.equal(g, w)
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        else:
            assert g == w
    # the bf16 leaf went to disk as its 16-bit words
    with np.load(tmp_path / "shards_00000007.npz") as data:
        assert data["leaf_00001"].dtype == np.int16
        assert np.array_equal(data["leaf_00001"],
                              tree["b"]["c"].view(torch.int16).numpy())


def test_manifest_keys_match_reference(tmp_path):
    """The reference's manifest fields (step, regime, paths, time), its
    shard and manifest names and its ``latest`` file; the paths name a
    leaf as the reference's do."""
    save_pytree(tmp_path / "t", {"a": torch.ones(2), "b": {"c": torch.ones(1)}},
                step=3, regime=2)
    ref_save(tmp_path / "j", {"a": jnp.ones(2), "b": {"c": jnp.ones(1)}},
             step=3, regime=2)
    got = json.loads((tmp_path / "t" / "manifest_00000003.json").read_text())
    want = json.loads((tmp_path / "j" / "manifest_00000003.json").read_text())
    assert set(want) <= set(got)
    assert got["paths"] == want["paths"]
    assert (tmp_path / "t" / "latest").read_text() == "3"
    assert (tmp_path / "t" / "shards_00000003.npz").exists()


def test_async_checkpointer_snapshots_before_queueing(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    tree = {"x": torch.full((8,), 3.0)}
    for step in (0, 1, 2):
        ck.save(tree, step=step, regime=1)
        tree["x"].add_(1.0)      # a later change does not reach the save
    ck.close()
    assert not ck.errors
    back, manifest = load_pytree(tmp_path, tree)
    assert manifest["step"] == 2
    assert torch.equal(back["x"], torch.full((8,), 5.0))


@pytest.mark.parametrize("rf,fail_at,recover_at", [(2, 3, -1), (2, 2, 30),
                                                   (3, 5, 12)])
def test_quorum_log_commit_windows_match_reference(rf, fail_at, recover_at):
    stores = [QuorumLogStore(5, rf=rf, num_partitions=16,
                             partition_bytes=1e8, bandwidth=5e6),
              RefQuorum(5, rf=rf, num_partitions=16, partition_bytes=1e8,
                        bandwidth=5e6)]
    flags = [[], []]
    for step in range(60):
        for s, f in zip(stores, flags):
            if step == fail_at:
                s.fail_node(4)
            if step == fail_at + 1:
                s.fail_node(1)
            if step == recover_at:
                s.recover_node(4)
            s.advance(1.0)
            f.append((s.put(f"ckpt/{step}", step), s.get(f"ckpt/{step}")))
    assert flags[0] == flags[1]
    assert not all(ok for ok, _ in flags[0])      # the window shows


def test_lark_pytree_keys_and_roundtrip_match_reference():
    tree = _tree()
    lark, ref = LarkStore(4, rf=2, num_partitions=8), \
        RefLark(4, rf=2, num_partitions=8)
    assert lark.put_pytree("ckpt", tree) == (5, 5)
    ref_tree = {"a": np.zeros(1), "b": {"c": np.zeros(1), "d": np.zeros(1)},
                "layers": [np.zeros(1), np.zeros(1)]}
    assert ref.put_pytree("ckpt", ref_tree) == (5, 5)
    good, back = lark.get_pytree("ckpt", tree)
    assert good
    for g, w in zip(T.leaves(back), T.leaves(tree)):
        assert (torch.equal(g, w) if torch.is_tensor(w) else g == w)
    for path, _ in T.leaves_with_paths(tree):
        ok, _ = ref.get("ckpt/" + T.path_name(path))
        assert ok                # the reference wrote the same key
    lark.fail_node(0)
    assert lark.get_pytree("ckpt", tree)[0]      # PAC keeps it readable


def test_elastic_trainer_remesh_and_restore():
    calls = []

    def make_step(workers):
        calls.append(tuple(workers))
        return lambda x: x + len(workers)

    et = ElasticTrainer(4, make_step)
    state = {"x": np.float32(1.0)}
    assert et.checkpoint(state)
    assert et.run_step(1) == 5
    restored = et.on_membership_change([0, 1, 2], state, state)
    assert et.state.regime == 2
    assert calls[-1] == (0, 1, 2)
    assert float(restored["x"]) == 1.0          # restored from LARK store
    assert et.run_step(1) == 4                  # remeshed to 3 workers


def test_elastic_restore_continues_bitwise_like_an_uninterrupted_run():
    """Train 2 steps, checkpoint to the LARK store, take a worker out,
    restore (the live state thrown away) and train 2 more: the parameters
    and optimizer state equal 4 uninterrupted steps bit for bit."""
    cfg = reduced_config("smollm_360m")
    data = SyntheticLMData(cfg, batch=2, seq=16)
    init_fn, step_fn, _ = make_train_step(cfg, peak_lr=1e-2)

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        return init_fn(gen)

    state = fresh()
    for i in range(4):
        state = step_fn(*state, batch(i))[:2]
    et = ElasticTrainer(4, lambda workers: step_fn)
    run = fresh()
    for i in range(2):
        run = et.run_step(*run, batch(i))[:2]
    assert et.checkpoint(run)
    like = run
    run = tuple(T.map_leaves(torch.zeros_like, r) for r in run)  # lost
    run = et.on_membership_change([0, 1, 2], run, like)
    assert et.state.regime == 2 and et.state.restores == 1
    assert 3 not in et.store.sim.alive
    for i in range(2, 4):
        run = et.run_step(*run, batch(i))[:2]
    for g, w in zip(T.leaves(run), T.leaves(state)):
        assert torch.equal(g, w)
