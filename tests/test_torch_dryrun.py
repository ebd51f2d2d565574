"""The dry run (``launch/dryrun.py``) on a fake process group, and the
step analysis it records (``launch/op_analysis.py``).

Every cell of the single-pod mesh and one multi-pod cell, built without
the op analysis: ``batch_axes``, ``param_count``,
``param_bytes_global`` and every per-rank byte count must equal the
reference's numbers from ``jax.eval_shape`` and
``NamedSharding.shard_shape`` (``_torch_ref_specs``), and an unsupported
cell is skipped with the reference's reason.  Three cells are traced:
smollm-360m train_4k on 16x16, data parallel over all 256 ranks (the
ZeRO step: its float32 gradients reduce-scattered into the ranks'
``grad_shardings`` blocks, the parameters all-gathered, the loss an
all-reduced scalar; the bytes a rank keeps agree with
``per_device_bytes``); internlm2-20b train_4k, tensor-parallel over the
model axis (one rank's flops a small share of the whole step's,
activations all-reduced over "model", one reduce-scatter over "data"); and
smollm-360m decode_32k, whose cache's sequence is sharded over "model"
(the step combines its softmax across ranks and gathers no cache).  The
CLI writes a record per cell.  ``op_analysis`` counts a matmul as
2·M·N·K, a loop of k matmuls as k times that (as
``tests/test_hlo_analysis.py`` holds ``analyze_hlo``), bytes as inputs
plus outputs with views free, and a collective's payload; on DTensors it
counts one rank's local work and no autograd wrapper as a
collective."""
import json

import pytest
import torch

import _torch_ref_specs as REF
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis
from repro_torch.launch import tp as TP

CELLS = [(a, s, False) for a in ARCH_IDS for s in SHAPES_BY_NAME
         if get_config(a).supports(SHAPES_BY_NAME[s])] + \
    [("internlm2_20b", "decode_32k", True),
     ("qwen3_moe_235b_a22b", "train_4k", True)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    got = REF.dump(tmp_path_factory.mktemp("dry") / "ref.json", [], CELLS)
    return {(c["arch"], c["shape"], c["multi_pod"]): c for c in got["cells"]}


@pytest.fixture
def fake512():
    D.fake_world(512)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_cells_equal_reference(ref, fake512):
    for cell in CELLS:
        rec = D.run_cell(*cell, trace=False)
        want = ref[cell]
        assert rec["status"] == "ok", cell
        for k in ("batch_axes", "param_count", "param_bytes_global",
                  "per_device_bytes"):
            assert rec[k] == want[k], (cell, k)
        assert rec["mesh"] == ("pod2x16x16" if cell[2] else "pod16x16")
        assert rec["kind"] == SHAPES_BY_NAME[cell[1]].kind
        assert "not measured" in rec["memory"]["temp_bytes"]


def test_unsupported_cell_is_skipped(fake512):
    rec = D.run_cell("smollm_360m", "long_500k", False)
    assert rec["status"] == "skipped" and rec["reason"] == D.SKIP_REASON
    assert not get_config("smollm_360m").supports(
        SHAPES_BY_NAME["long_500k"])


def _norm_elements(cfg):
    """(elements of the per-layer tree's 1-D leaves, of those inside the
    layer blocks)."""
    from repro_torch import tree
    layers = D.per_layer_params(cfg, D.abstract_params(cfg))

    def ones(t):
        return sum(x.numel() for x in tree.leaves(t) if x.dim() == 1)
    return ones(layers), ones(layers["blocks"])


def test_traced_train_cell(ref, fake512):
    rec = D.run_cell("smollm_360m", "train_4k", False)
    oa = rec["op_analysis"]
    assert oa["status"] == "ok"
    n = rec["param_count"]
    n1, n1_blocks = _norm_elements(get_config("smollm_360m"))
    n2 = n - n1
    # one rank of 256 (data x model, the batch axes): one row of 4096
    # tokens.  The ZeRO step: the 2-D leaves' float32 gradients in one
    # reduce-scatter over data+model (their specs cut them 256 ways), the
    # 1-D leaves' (d_model, cut over data only) in one over data and
    # their blocks all-reduced over model; the bf16 parameters gathered
    # back the same ways; the loss and the clip's sums of squares
    # all-reduced as scalars.  No whole gradient is all-reduced.
    # (a flat collective moves at most tp.CHUNK elements a rank, so the
    # 2-D bucket goes in pieces)
    pieces = -(-(n2 // 256) // (TP.CHUNK // 256))
    by = oa["collectives_by_axis"]
    assert by["data+model"] == {
        "_reduce_scatter_base_": {"bytes": 4 * n2, "count": pieces},
        "_allgather_base_": {"bytes": 2 * n2 // 256, "count": pieces},
        "allreduce_": {"bytes": 8, "count": 2}}
    assert by["data"] == {
        "_reduce_scatter_base_": {"bytes": 4 * n1, "count": 1},
        "_allgather_base_": {"bytes": 2 * n1 // 16, "count": 1},
        "allreduce_": {"bytes": 4, "count": 1}}
    assert by["model"] == {"allreduce_": {"bytes": 4 * n1 // 16,
                                          "count": 1}}
    assert oa["collective_bytes_total"] == 4 * n + 2 * n2 // 256 + \
        2 * n1 // 16 + 12 + 4 * n1 // 16
    # the gradient bytes a rank keeps (a reduce-scatter books its input,
    # of which the rank keeps 1/size) are per_device_bytes' grads, but
    # for the blocks' 1-D leaves, which the reference's stacked layout
    # also cuts over model along the layer dim: 256 ways, not 16
    kept = 4 * n2 // 256 + 4 * n1 // 16
    assert kept == rec["per_device_bytes"]["grads"] + \
        4 * n1_blocks // 16 - 4 * n1_blocks // 256
    # forward, remat recompute and backward: at least 8 flops per
    # parameter and token
    assert oa["flops"] > 8 * n * 4096
    assert oa["bytes"] > rec["param_bytes_global"]
    rec = D.run_cell("internlm2_20b", "train_4k", False)
    tp = rec["op_analysis"]
    assert tp["status"] == "ok", tp
    n = rec["param_count"]
    # the whole step: forward and backward over 256 x 4096 tokens; one
    # rank (1/16 of the rows, 1/16 of the model) does ~1/256 of it, plus
    # the remat recompute
    whole = 6 * n * 256 * 4096
    assert whole / 1024 < tp["flops"] < whole / 16
    model = tp["collectives_by_axis"]["model"]["allreduce_"]
    assert model["count"] > 0 and model["bytes"] > 0
    # over data, the batch axis: one reduce-scatter of the rank's model
    # shards of every float32 gradient, of which it keeps exactly
    # per_device_bytes' grads; the scalars (loss, a clip sum) all-reduced
    data = tp["collectives_by_axis"]["data"]
    scattered = data["_reduce_scatter_base_"]["bytes"]
    assert data["_reduce_scatter_base_"]["count"] == \
        -(-(scattered // 4) // TP.CHUNK)
    assert scattered // 16 == rec["per_device_bytes"]["grads"]
    assert data["allreduce_"] == {"bytes": 8, "count": 2}


def test_traced_decode_cell_gathers_no_cache(ref, fake512):
    rec = D.run_cell("smollm_360m", "decode_32k", False)
    oa = rec["op_analysis"]
    assert oa["status"] == "ok", oa
    # the cache's sequence is this rank's 2048 of 32,768 slots: the step
    # all-reduces the softmax's max, sum and weighted values, and gathers
    # no cache
    assert all(not op.startswith("_allgather") for ops in
               oa["collectives_by_axis"].values() for op in ops)
    assert 0 < oa["collective_bytes_total"] < \
        rec["per_device_bytes"]["decode_state"] / 100


def test_cli_writes_a_record_per_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "RESULTS_DIR", tmp_path)
    assert D.main(["--arch", "whisper_small", "--singlepod"]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"whisper_small__{s}__pod16x16.json"
                           for s in SHAPES_BY_NAME)
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["arch"] == "whisper_small" and "op_analysis" in rec


def test_op_analysis_counts_matmuls_loops_bytes_and_collectives():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    one = op_analysis.analyze(lambda: a @ b)
    assert one["flops"] == 2 * 8 * 4 * 16
    assert one["bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)

    def loop(k):
        for _ in range(k):
            a @ b
    five = op_analysis.analyze(loop, 5)
    assert five["flops"] == 5 * one["flops"]
    assert five["bytes"] == 5 * one["bytes"]
    am, bm = a.to("meta"), b.to("meta")
    meta = op_analysis.analyze(lambda: (am @ bm).t())      # a view: free
    assert meta["flops"] == one["flops"] and meta["bytes"] == one["bytes"]
    D.fake_world(8)
    try:
        x = torch.empty(4, 8, device="meta")
        got = op_analysis.analyze(torch.distributed.all_reduce, x)
    finally:
        torch.distributed.destroy_process_group()
    assert got["collectives"] == {"allreduce_": {"bytes": 128, "count": 1}}
    assert got["flops"] == 0


def test_op_analysis_counts_a_dtensor_step_per_rank():
    """(16,256)[S0,R] @ (256,128)[R,S1] @ (128,256)[R,S0] on a 2 x 2
    ("data", "model") mesh, then redistributed to [S0, R]: one rank's two
    local matmuls (2·8·256·64 + 2·8·64·256 = 524,288 flops; the global
    shapes would give 2,097,152) and the one all-reduce of its (8, 256)
    float32 partial sum, with no autograd wrapper counted."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import distribute
    D.fake_world(4)
    try:
        mesh = make_host_mesh((2, 2), ("data", "model"))
        a, b, c = distribute(
            [torch.empty(s, device="meta")
             for s in ((16, 256), (256, 128), (128, 256))],
            [("data", None), (None, "model"), ("model", None)], mesh)

        def step():
            return ((a @ b) @ c).redistribute(mesh, [Shard(0), Replicate()])
        got = op_analysis.analyze(step)
    finally:
        torch.distributed.destroy_process_group()
    assert got["flops"] == 524_288
    assert got["collectives"] == {"all_reduce": {"bytes": 8192, "count": 1}}
    assert got["collective_bytes_total"] == 8192
