"""Error-feedback int8 compression of the cross-pod gradient all-reduce
(``training/compression.py``).

With one pod it is the identity (the analogue of
``tests/test_framework.py::test_compression_error_feedback_identity``).
Two ``gloo`` ranks as two pods (a ``file://`` store under the test's tmp
dir) must give, over two steps with the error carried, exactly the
reference's arithmetic written in numpy: ``x = g + e``, the per-tensor
scale ``max(max|x|, 1e-12) / 127``, the int8 round and clip, the sum of
``q·scale`` over pods divided by the pod count, and the new error
``x − q·scale``, all float32."""
import pickle

import numpy as np
import pytest
import torch

import _torch_ranks as TR
from repro_torch import tree
from repro_torch.launch import dist as rdist
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training.compression import (compressed_pod_psum,
                                              init_error_state)


def _quantize(x):
    scale = np.maximum(np.abs(x).max(), np.float32(1e-12)) / np.float32(127)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _reference_step(gs, es):
    """One step of the reference's formula for every pod's (g, e) leaf
    lists: (reduced, new errors per pod)."""
    red, new_e = [], [[] for _ in gs]
    for i in range(len(gs[0])):
        xs = [g[i] + e[i] for g, e in zip(gs, es)]
        qs = [_quantize(x) for x in xs]
        total = qs[0][0].astype(np.float32) * qs[0][1]
        for q, s in qs[1:]:
            total = total + q.astype(np.float32) * s
        red.append(total / np.float32(len(gs)))
        for p, (x, (q, s)) in enumerate(zip(xs, qs)):
            new_e[p].append(x - q.astype(np.float32) * s)
    return red, new_e


def test_two_pods_equal_the_reference_formula(tmp_path):
    rdist.spawn(TR.compress_rank_main, 2, (2, str(tmp_path / "store"),
                                           str(tmp_path)), timeout_s=110)
    got = [pickle.loads((tmp_path / f"pod{r}.pkl").read_bytes())
           for r in range(2)]
    trees = [TR.pod_grads(r) for r in range(2)]
    gs = [tree.leaves(g) for g, _ in trees]
    es = [tree.leaves(e) for _, e in trees]
    for step in range(2):
        red, es = _reference_step(gs, es)
        n = len(red)
        for r in range(2):
            out = got[r][step]
            for a, b in zip(out[:n], red):
                assert a.dtype == b.dtype and np.array_equal(a, b), step
            for a, b in zip(out[n:], es[r]):
                assert a.dtype == b.dtype and np.array_equal(a, b), step
    # leaves in order b[0], b[1], w: the all-zero b[1] stays zero, and
    # w's new error is nonzero where the rounding cut
    assert not got[0][0][1].any()
    assert np.abs(got[0][0][-1]).max() > 0


@pytest.mark.parametrize("shape,axes", [((1, 1), ("data", "model")),
                                        ((1, 1, 1), ("pod", "data",
                                                     "model"))],
                         ids=["no-pod-axis", "one-pod"])
def test_one_pod_is_the_identity(tmp_path, shape, axes):
    rdist.init(f"file://{tmp_path / 'store'}", rank=0, world_size=1,
               timeout_s=60)
    try:
        mesh = make_host_mesh(shape, axes)
        g = {"w": torch.tensor([1.0, -2.0, 3.0])}
        e = init_error_state(g)
        assert torch.equal(e["w"], torch.zeros(3))
        out, e2 = compressed_pod_psum(g, e, mesh)
    finally:
        rdist.shutdown()
    assert out is g and e2 is e
