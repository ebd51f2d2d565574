"""Device meshes over the ranks of the default process group (port of
``repro/launch/mesh.py``), on ``torch.distributed.device_mesh``.

Functions, not module constants, so importing this module touches no
process group.  Single pod: (data=16, model=16) = 256 ranks; multi-pod:
(pod=2, data=16, model=16) = 512 ranks.  Each mesh takes the first
ranks of the world, and raises, as the reference does, when the world
is smaller than the mesh.  Every mesh's device type is ``cpu``: the
port's groups are gloo (``launch/dist.py``), which also carries the
data-parallel step's device tensors.  The dry run (``launch/dryrun.py``)
builds the production meshes on a ``"fake"`` group of 256 or 512 ranks
in one process.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape, axes, what: str, device_type: str = "cpu") -> DeviceMesh:
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for {what} {tuple(shape)}; the default process "
            f"group has {world} (launch/dist.init, or the dry run's fake "
            "group)")
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "mesh")


def make_trials_mesh(devices: int) -> DeviceMesh:
    """1-D mesh over the first `devices` ranks, axis name "trials".

    The batched Monte Carlo engines shard their independent trials over
    it (``core/availability_batched.py``, ``core/downtime_batched.py``):
    every carried tensor has trials as its leading axis, the counter RNG
    keys each lane by its *global* trial index, and no reduction crosses
    trials inside a step, so splitting the leading axis commutes with
    every step.  Its group carries host arrays (the drains) over gloo.
    """
    return _mesh((devices,), ("trials",), "a trials mesh")


def make_host_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu") -> DeviceMesh:
    """Small mesh over the first ranks of the world (tests, and ranks
    sharing one card)."""
    return _mesh(tuple(shape), axes, "mesh", device_type)
