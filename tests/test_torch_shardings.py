"""The port's sharding specs equal the reference's, value for value.

One subprocess with 512 forced host devices writes the reference's specs
(``_torch_ref_specs``) for every registry arch on both production meshes
(16x16 and 2x16x16): parameters (with and without FSDP), float32
gradient accumulators, AdamW and Adafactor states, and per supported
shape the batch axes and the batch, token and decode-state specs.  The
port builds the same meshes on a fake process group of 512 ranks and
its trees in the reference's layout on meta tensors
(``launch/dryrun.abstract_*``); each leaf's shape and spec must be equal.
Also: DTensor placements of a spec and ``shard_shape``."""
import json

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_ref_specs as REF
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import make_optimizer


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return REF.dump(tmp_path_factory.mktemp("specs") / "ref.json",
                    ARCH_IDS)["specs"]


@pytest.fixture(scope="module")
def meshes():
    D.fake_world(512)
    try:
        yield {False: make_production_mesh(multi_pod=False),
               True: make_production_mesh(multi_pod=True)}
    finally:
        torch.distributed.destroy_process_group()


def _leaves(struct, shards):
    """[[shape], [entries]] per leaf, as the reference's dump lists them
    (tuples as lists)."""
    return [[list(x.shape), json.loads(json.dumps(list(s.spec)))]
            for x, s in S.with_shardings(struct, shards)]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(ref, meshes, arch, multi_pod):
    want = ref[f"{arch}|{int(multi_pod)}"]
    cfg, mesh = get_config(arch), meshes[multi_pod]
    params = D.abstract_params(cfg)
    assert _leaves(params, S.param_shardings(cfg, mesh, params)) == \
        want["params"]
    assert _leaves(params, S.param_shardings(
        cfg, mesh, params, fsdp=cfg.tensor_parallel)) == \
        want["params_fsdp_tp"]
    assert _leaves(params, S.grad_shardings(cfg, mesh, params)) == \
        want["grads"]
    for name in ("adamw", "adafactor"):
        st = make_optimizer(name).init(params)
        assert _leaves(st, S.opt_state_shardings(cfg, mesh, params, st)) \
            == want[f"opt_{name}"], name
    shapes = [s for s in SHAPES_BY_NAME.values() if cfg.supports(s)]
    assert sorted(s.name for s in shapes) == \
        sorted(k for k in want if k in SHAPES_BY_NAME)
    for shape in shapes:
        w, B = want[shape.name], shape.global_batch
        assert list(S.batch_axes(cfg, mesh, B)) == w["batch_axes"]
        b = D.abstract_batch(cfg, shape)
        assert _leaves(b, S.batch_shardings(cfg, mesh, b, B)) == w["batch"]
        if shape.kind != "train":
            dec = D.abstract_decode_inputs(cfg, shape)
            assert _leaves(dec["state"], S.state_shardings(
                cfg, mesh, dec["state"], B)) == w["state"], shape.name
            tok = {"t": dec["tokens"]}
            assert _leaves(tok, S.batch_shardings(cfg, mesh, tok, B)) == \
                w["tokens"]


def test_placements_and_shard_shape(meshes):
    mesh = meshes[True]                     # (pod 2, data 16, model 16)
    assert S.placements((None, ("data", "model")), mesh) == \
        (Replicate(), Shard(1), Shard(1))
    assert S.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        S.placements((("model", "data"),), mesh)
    assert S.shard_shape((64, 48, 32), (("pod", "data"), None, "model"),
                         mesh) == (2, 48, 2)
    with pytest.raises(ValueError, match="do not divide"):
        S.shard_shape((24,), ("model",), mesh)
    shards = S.batch_shardings(get_config("smollm_360m"), mesh,
                               {"x": torch.empty(512, 8, device="meta")},
                               512)
    assert tree.leaves(shards)[0] == S.NamedSharding(
        mesh, (("pod", "data", "model"), None))
