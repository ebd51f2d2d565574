"""The mLSTM backward's sm90 route (csrc/mlstm_chunk_bwd_sm90.cu) as far as
the CPU reaches it: the route predicate ``bwd_route`` (the forward's sm90
predicate and the backward's own shared memory), the card-side check's
planted faults (each text once in the new source; the SIMT source keeps
its own in ``tests/test_torch_mlstm_bwd.py``), the launcher's argtypes
and workspace, the launch counters by route, and the wgmma helpers the
source uses.  The kernel itself runs only on the card (``chip_smoke.py``
phase ``mlstm_bwd``, ``python -m repro_torch.kernels.mlstm_check``)."""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import mlstm_check as MC
from repro_torch.kernels import mlstm_chunk as T

SOURCE = _build.CSRC / "mlstm_chunk_bwd_sm90.cu"
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,Dq,Dv,chunk,want", [
    (BF, 512, 512, 256, "sm90"),      # the xlstm-350m train shape
    (BF, 64, 64, 64, "sm90"),
    (BF, 192, 320, 192, "sm90"),      # 64-multiples off 128 and 256
    (BF, 512, 512, 448, "sm90"),      # the forward's largest chunk there
    (BF, 512, 512, 512, "simt"),      # past the forward's shared memory
    (BF, 64, 64, 1024, "sm90"),       # 32 positions a lane in the gates
    (BF, 256, 256, 1024, "sm90"),
    (BF, 64, 64, 2048, "sm90"),       # 64 a lane
    (F32, 512, 512, 256, "simt"),     # float32 stays on the SIMT source
    (BF, 40, 72, 96, "simt"),         # dims and chunk off the 64 grid
    (BF, 512, 576, 256, "simt"),      # Dv past 512
    (BF, 32, 32, 256, "simt"),        # the reduced xlstm's head dim
])
def test_route_follows_the_forward_and_its_shared_memory(dtype, Dq, Dv,
                                                          chunk, want):
    assert T.bwd_route(dtype, Dq, Dv, chunk) == want
    if want == "sm90":
        assert T._route(dtype, Dq, Dv, chunk) == "sm90"
        assert T.bwd_sm90_smem_bytes(Dq, Dv, chunk) + T.SM90_STATIC <= \
            T.SMEM_LIMIT


def test_card_cases_take_their_routes():
    """The bf16 train-width cases go to the sm90 source, the float32 ones
    and the off-grid dims to the SIMT source, so each route has cases."""
    routes = {case: T.bwd_route(dtype, Dq, Dv, L)
              for case, dtype, _, _, _, Dq, Dv, L, _ in MC.BWD_CASES}
    assert routes["train_bf16"] == routes["clamp"] == "sm90"
    assert routes["train_f32"] == routes["odd_dims"] == "simt"
    assert routes["one_position"] == routes["short_100"] == "sm90"
    assert routes["train_cpu_f32"] == "simt"
    # sm90 shapes off the 256 grid: 64-wide column tiles and 64-column
    # walks, 64-row S and dP tiles, a chunk past 512 (32 positions a lane
    # in the gate scans)
    assert routes["dims_128_192"] == routes["chunk_192"] == \
        routes["chunk_1024"] == "sm90"
    assert T._tile_of(192) == T._tile_of(320) == 64
    # the SIMT source runs every case its shared memory holds, so not the
    # chunk of 1024 (it raises there, as its entry point would)
    takes = {case: MC.bwd_takes("mlstm_chunk_bwd", dtype, Dq, Dv, L)
             for case, dtype, _, _, _, Dq, Dv, L, _ in MC.BWD_CASES}
    assert not takes["chunk_1024"]
    assert all(t for case, t in takes.items() if case != "chunk_1024")
    for src in MC.BWD_SOURCE_ROUTE:
        assert any(MC.bwd_takes(src, dtype, Dq, Dv, L)
                   for _, dtype, _, _, _, Dq, Dv, L, _ in MC.BWD_CASES)


def _edits(edits):
    return [edits] if isinstance(edits[0], str) else edits


@pytest.mark.parametrize("fault", sorted(MC.BWD_FAULTS_SM90))
def test_each_sm90_backward_fault_text_occurs_once(fault):
    text = SOURCE.read_text()
    for old, new in _edits(MC.BWD_FAULTS_SM90[fault]):
        assert old != new and text.count(old) == 1, old


def test_sm90_faults_cover_the_simt_kinds_and_a_lo_product():
    assert set(MC.BWD_FAULTS) < set(MC.BWD_FAULTS_SM90)
    assert any(name.endswith("_lo_dropped") for name in MC.BWD_FAULTS_SM90)
    assert MC.BWD_SOURCE_FAULTS == {"mlstm_chunk_bwd": MC.BWD_FAULTS,
                                    "mlstm_chunk_bwd_sm90":
                                    MC.BWD_FAULTS_SM90}


def test_sm90_launcher_argtypes_and_workspace(monkeypatch):
    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    assert "mlstm_chunk_bwd_sm90" in _build.SOURCES
    text = SOURCE.read_text()
    m = re.search(r"int mlstm_chunk_bwd_sm90_launch\((.*?)\)", text, re.S)
    want = tuple(ctypes.c_void_p if "*" in prm else ctypes.c_longlong
                 if "long long" in prm else ctypes.c_int
                 for prm in m.group(1).split(","))
    assert tuple(T.BWD_ARGTYPES_SM90) == want
    assert T.BWD_ROUTES["sm90"] == ("mlstm_chunk_bwd_sm90",
                                    "mlstm_chunk_bwd_sm90_launch",
                                    T.BWD_ARGTYPES_SM90)
    rng = np.random.default_rng(3)
    B, H, S, D, L = 2, 3, 300, 128, 128
    q, k, v, dh = (torch.from_numpy(rng.standard_normal((B, H, S, D))
                                    .astype(np.float32)).to(BF)
                   for _ in range(4))
    lf, li = (torch.from_numpy(rng.standard_normal((B, H, S))
                               .astype(np.float32)) for _ in range(2))
    args, outs, tensors = T.bwd_launch_args(q, k, v, lf, li, dh, L,
                                            route="sm90", fill=float("nan"))
    assert len(args) == len(T.BWD_ARGTYPES_SM90)
    nbytes = T.bwd_sm90_workspace_bytes(B * H, S, D, D, L)
    assert args[-7:-1] == (nbytes, B * H, S, D, D, L)
    assert tensors[-1].dtype == torch.uint8 and tensors[-1].numel() == nbytes
    assert [o.dtype for o in outs] == [BF] * 3 + [F32] * 2
    assert all(o.isnan().all() for o in outs)
    with pytest.raises(ValueError, match="sm90 backward"):
        T.bwd_launch_args(q.float(), k.float(), v.float(), lf, li, dh, L,
                          route="sm90")


def test_workspace_holds_every_region():
    """At the train shape: three chunk-sized float32 matrices (S, dP and
    C_c dh) and six bf16 weight halves, four bf16 state halves, the
    per-position rows; 256-byte aligned regions."""
    BH, S, D, L = 16, 1024, 512, 256
    nC = S // L
    Z = BH * nC
    regions = (8 * 4 * BH * S + 4 * BH * nC + 4 * BH * (nC + 1) +
               4 * 2 * Z * D * D + 2 * 4 * Z * D + 2 * 4 * Z * L * L +
               4 * Z * L * D + 6 * 2 * Z * L * L + 2 * 4 * BH * S * 2)
    got = T.bwd_sm90_workspace_bytes(BH, S, D, D, L)
    assert regions <= got < regions + 26 * 256
    assert got % 256 == 0
    # a ragged S pads its last chunk
    assert T.bwd_sm90_workspace_bytes(BH, 1000, D, D, L) == got


def test_counters_by_route_stay_on_the_cpu():
    rng = np.random.default_rng(4)
    q, k, v, dh = (torch.from_numpy(rng.standard_normal((1, 2, 70, 64))
                                    .astype(np.float32)).to(BF)
                   for _ in range(4))
    lf, li = (torch.from_numpy(rng.standard_normal((1, 2, 70))
                               .astype(np.float32)) for _ in range(2))
    before = (T.mlstm_chunkwise_bwd.launches,
              T.mlstm_chunkwise_bwd.sm90_launches,
              T.mlstm_chunkwise_bwd.simt_launches,
              T.mlstm_chunkwise_bwd_plain.calls)
    got = T.mlstm_chunkwise_bwd(q, k, v, lf, li, dh, chunk=64)
    assert (T.mlstm_chunkwise_bwd.launches,
            T.mlstm_chunkwise_bwd.sm90_launches,
            T.mlstm_chunkwise_bwd.simt_launches) == before[:3]
    assert T.mlstm_chunkwise_bwd_plain.calls == before[3] + 1
    want = T.mlstm_chunkwise_bwd_plain(q, k, v, lf, li, dh, chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wgmma_helpers_cover_k_major_b_at_every_width():
    """The source's A B^T products take B K-major at N = 64, 128 and 256
    (sm90.cuh: wgmma_m64k16_ss_kb), with the transpose bits off."""
    header = (_build.CSRC / "sm90.cuh").read_text()
    for n in (64, 128, 256):
        assert f"wgmma_m64k16_ss_kb<{n}>" in header
        assert f"m64n{n}k16.f32.bf16.bf16" in header
    # the three, and wgmma_m64n64k16_ss with its accumulate flag
    assert header.count("p, 1, 1, 0, 0;") == 4
    assert "sm90.cuh" in [p.name for p in _build.local_headers(
        SOURCE.read_bytes())]
    assert "--use_fast_math" not in _build.NVCC_FLAGS
