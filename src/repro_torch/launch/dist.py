"""Process groups for the port's runs across ranks.

A run across R ranks is R processes, one per rank.  ``init`` joins them
into the default group, from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
an explicit ``init_method`` (``tcp://host:port`` or ``file:///path``)
with the rank and world size given.  Nothing falls back: a join that
fails raises, and so does a world that does not divide the Monte
Carlo's ``devices`` (``check_divides``).

Rank r's card is ``cuda:LOCAL_RANK % device_count``, so several ranks
may share one card.  The Monte Carlo's drains are host numpy arrays,
gathered by ``all_gather_numpy``; the group's backend is therefore
``gloo`` whatever the device: it carries CPU tensors (and stages the
data-parallel train step's device tensors through the host) and, unlike
NCCL, accepts two ranks on one card.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init(init_method: Optional[str] = None, *, rank: Optional[int] = None,
         world_size: Optional[int] = None, timeout_s: float = 600.0) -> None:
    """Join the default process group over ``gloo``.  Without
    `init_method` the ``torchrun`` environment must be set; with it,
    `rank` and `world_size` must be given."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    if init_method is None:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"no init_method and the torchrun "
                               f"environment lacks {missing}")
        init_method, rank, world_size = "env://", -1, -1
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the default process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank in the default group (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device=None) -> torch.device:
    """This rank's device: ``cpu`` when asked for, else
    ``cuda:LOCAL_RANK % device_count`` (``None`` means the card, as
    every entry point)."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_divides(devices: int, world: int) -> None:
    if devices % world:
        raise ValueError(f"a world of {world} ranks does not divide "
                         f"devices ({devices})")


def all_gather_numpy(arrays: Sequence[np.ndarray], axes: Sequence[int],
                     group=None) -> List[np.ndarray]:
    """Every rank's `arrays`, each concatenated along its entry of `axes`
    in rank order; the same list on every rank."""
    per_rank = [None] * dist.get_world_size(group)
    dist.all_gather_object(per_rank, [np.asarray(a) for a in arrays],
                           group=group)
    return [np.concatenate([r[i] for r in per_rank], axis=ax)
            for i, ax in enumerate(axes)]


def spawn(fn, nprocs: int, args=(), timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in `nprocs` fresh processes (``spawn``
    start method; `fn` must be importable by its module path).  Raises
    if a process fails or the deadline passes; no process outlives the
    call."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
