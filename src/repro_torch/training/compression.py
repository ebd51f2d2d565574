"""Error-feedback int8 gradient compression for the cross-pod all-reduce
(port of ``repro/training/compression.py``).

Reductions inside a pod stay full precision; the pod axis crosses the
slow links between pods, so the cross-pod gradient traffic is quantized
to int8 with a per-tensor scale and an error-feedback accumulator (the
residual is carried to the next step: standard EF-SGD).  The reduction
runs over the mesh's ``"pod"`` dimension only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree


def _quantize(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _npod(mesh) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.mesh.shape[names.index("pod")] if "pod" in names else 1


def compressed_pod_psum(grads, err, mesh):
    """The mean over pods of `grads` with an int8 payload and error
    feedback: per leaf ``x = g + e``, ``scale = max(max|x|, 1e-12) /
    127``, ``q = clip(round(x / scale), -127, 127)`` as int8, the sum of
    ``q·scale`` over pods (in pod order) divided by the pod count, and
    the new error ``x − q·scale``.

    grads / err: trees of float32 tensors already reduced within the
    pod.  Returns (reduced grads, new err); with one pod, the inputs."""
    npod = _npod(mesh)
    if npod == 1:
        return grads, err
    group = mesh.get_group("pod")

    def leaf(g, e):
        x = g + e
        q, scale = _quantize(x)
        qs = [torch.empty_like(q) for _ in range(npod)]
        scales = [torch.empty_like(scale) for _ in range(npod)]
        dist.all_gather(qs, q, group=group)          # int8 payload
        dist.all_gather(scales, scale.reshape(()), group=group)
        summed = qs[0].to(torch.float32) * scales[0]
        for qp, sp in zip(qs[1:], scales[1:]):
            summed = summed + qp.to(torch.float32) * sp
        return summed / npod, x - q.to(torch.float32) * scale

    out = [leaf(g, e) for g, e in zip(tree.leaves(grads),
                                      tree.flatten_up_to(grads, err))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))


def init_error_state(grads):
    return tree.map_leaves(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)
