"""Helpers of the port's tests across ranks: the Monte Carlo paths at a
small tile, a flat fingerprint of a result, and the rank main that runs
the paths on a ``gloo`` world joined through a ``file://`` store.  It
imports the port only, so the spawned ranks start without jax."""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import availability_batched as TA
from repro_torch.core import client_latency as TC
from repro_torch.core import downtime_batched as TD
from repro_torch.launch import dist as rdist

#: the availability and downtime tile (tests/test_sharded.py's, cut to
#: 256 steps): chunks of 64 steps, 4 trials
_MC = dict(n=13, partitions=32, rf=2, p=5e-3, trials=4, max_ticks=4_000,
           min_ticks=10 ** 9, chunk_steps=64, max_steps=256, seed=11,
           trajectory=True)
#: the reference's latency tile (tests/test_sharded.py's)
_LAT = dict(n=6, rf=2, p=2e-4, partitions=64, trials=4, max_ticks=8_000,
            min_ticks=8_000, chunk_steps=64, seed=11, dupres_ticks=4,
            requests_per_tick=8.0, key_zipf=1.0, read_frac=0.8,
            slo_ticks=2)
_DT = dict(_MC, rebuild_steps=30, rebuild_ticks_per_gib=64,
           pair_fail_prob=0.3, restart_period=900)

#: name -> (engine, knobs); every path runs unpacked and packed
PATHS = {
    # the early stop live: a loose CI that the 4 trials meet mid-run
    "availability_stop": ("availability", dict(
        _MC, min_ticks=3_000, min_events=20, eps_rel=0.5, max_steps=10**6,
        max_ticks=400_000)),
    "availability": ("availability", dict(_MC, pair_fail_prob=0.3,
                                          restart_period=900)),
    "fixed": ("downtime", _DT),
    "reconfig_bw": ("downtime", dict(_DT, rebuild_model="reconfig",
                                     size_dist="zipf", size_skew=1.2,
                                     node_bandwidth_gibps=1.0)),
    "zoo": ("downtime", dict(_DT, rebuild_model="reconfig",
                             engines=TD.ENGINES, lease_ticks=40,
                             view_change_ticks=200)),
    "latency": ("latency", dict(_LAT, write_skew=1.0,
                                node_bandwidth_gibps=0.5,
                                slo_curve_bins=8)),
}
ENGINES = {"availability": TA.simulate_availability_batched,
           "downtime": TD.simulate_downtime_batched,
           "latency": TC.simulate_client_latency}
CASES = [(name, packed) for name in PATHS for packed in (False, True)]


def run_path(name: str, packed: bool, **kw):
    engine, knobs = PATHS[name]
    return ENGINES[engine](device="cpu", packed=packed, **knobs, **kw)


def fingerprint(result, prefix: str = "") -> dict:
    """Every field of a result dataclass (nested results, trajectory and
    raw-accumulator dicts flattened), without the device or backend
    name."""
    out = {}
    for f in dataclasses.fields(result):
        if f.name in ("device", "backend"):
            continue
        v = getattr(result, f.name)
        if dataclasses.is_dataclass(v):
            out.update(fingerprint(v, f"{prefix}{f.name}."))
        elif isinstance(v, dict):
            out.update({f"{prefix}{f.name}:{k}": x for k, x in v.items()})
        else:
            out[prefix + f.name] = v
    return out


def same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.asarray(a).dtype == np.asarray(b).dtype and \
            np.array_equal(a, b)
    return a == b


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """Join a `world`-rank gloo group through the file store, run every
    case with devices = world, and pickle the fingerprints (and whether
    devices = 2, which the world does not divide, raised)."""
    torch.set_num_threads(1)
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=100)
    try:
        got = {case: fingerprint(run_path(*case, devices=world))
               for case in CASES}
        try:
            run_path("availability", False, devices=2)
            got["devices_2_raises"] = False
        except ValueError as e:
            got["devices_2_raises"] = "does not divide" in str(e)
    finally:
        torch.distributed.destroy_process_group()
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(got))


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

#: reduced configs the data-parallel test trains: arch -> (rows, seq,
#: microbatches)
TRAIN_ARCHS = {"smollm_360m": (4, 32, 2), "xlstm_350m": (4, 32, 1)}
TRAIN_STEPS = 2


def train_setup(arch: str):
    """(cfg, params, opt_state, batch) of a reduced arch, the weights
    from seed 0 and the batch from numpy seed 0 (the same on every
    rank)."""
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import make_batch
    from repro_torch.training import make_train_step
    rows, seq, nmb = TRAIN_ARCHS[arch]
    cfg = reduced_config(arch).replace(microbatches_train=nmb)
    batch = make_batch(cfg, ShapeConfig("t", seq, rows, "train"),
                       np.random.default_rng(0))
    init_fn, _, _ = make_train_step(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params, opt_state = init_fn(gen)
    return cfg, params, opt_state, batch


def train(step_fn, params, opt_state, batch):
    """TRAIN_STEPS steps; (params, opt_state, [metrics per step])."""
    metrics = []
    for _ in range(TRAIN_STEPS):
        params, opt_state, m = step_fn(params, opt_state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt_state, metrics


def train_rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """Train every TRAIN_ARCHS config for TRAIN_STEPS data-parallel steps
    on a (world, 1) ("data", "model") mesh and pickle the results."""
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import batch_shardings, grad_shardings
    from repro_torch.training import make_train_step
    torch.set_num_threads(1)
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=100)
    try:
        mesh = make_host_mesh((world, 1), ("data", "model"))
        got = {}
        for arch in TRAIN_ARCHS:
            cfg, params, opt_state, batch = train_setup(arch)
            _, step_fn, _ = make_train_step(
                cfg, grad_shardings=grad_shardings(cfg, mesh, params),
                batch_shardings=batch_shardings(
                    cfg, mesh, batch, next(iter(batch.values())).shape[0]))
            params, opt_state, metrics = train(step_fn, params, opt_state,
                                               batch)
            got[arch] = ([t.numpy() for t in tree.leaves(params)],
                         [t.float().numpy() for t in tree.leaves(opt_state)],
                         metrics)
    finally:
        torch.distributed.destroy_process_group()
    Path(out_dir, f"train{rank}.pkl").write_bytes(pickle.dumps(got))


# ---------------------------------------------------------------------------
# the cross-pod int8 gradient compression
# ---------------------------------------------------------------------------

def pod_grads(rank: int):
    """Rank `rank`'s float32 gradient and error trees (numpy)."""
    rng = np.random.default_rng(100 + rank)
    g = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32) * 1e-3,
               np.zeros(3, np.float32)]}
    e = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 1e-2,
         "b": [rng.standard_normal(7).astype(np.float32) * 1e-5,
               np.zeros(3, np.float32)]}
    return g, e


def compress_rank_main(rank: int, world: int, store: str,
                       out_dir: str) -> None:
    """Two steps of compressed_pod_psum with each rank a pod of a
    (world, 1, 1) ("pod", "data", "model") mesh; pickle the results."""
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.compression import compressed_pod_psum
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=100)
    try:
        mesh = make_host_mesh((world, 1, 1), ("pod", "data", "model"))
        g, e = (tree.map_leaves(torch.from_numpy, t)
                for t in pod_grads(rank))
        out = []
        for _ in range(2):
            red, e = compressed_pod_psum(g, e, mesh)
            out.append([t.numpy() for t in tree.leaves((red, e))])
    finally:
        torch.distributed.destroy_process_group()
    Path(out_dir, f"pod{rank}.pkl").write_bytes(pickle.dumps(out))


# ---------------------------------------------------------------------------
# the experiment runner across ranks
# ---------------------------------------------------------------------------

#: the smoke availability spec (n 31, P 128) the runner test drives
SWEEP_SPEC = dict(smoke=True, backend="jax", trials=2, devices=2)


def sweep_rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """Run SWEEP_SPEC on a `world`-rank gloo group, every rank asked to
    write its events, summary and printed lines to files named by its
    rank; what it printed is saved after the group is left."""
    import json
    from repro_torch.experiments.runner import ExperimentRunner
    from repro_torch.experiments.spec import ExperimentSpec
    torch.set_num_threads(1)
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=100)
    lines = []
    try:
        runner = ExperimentRunner(
            ExperimentSpec.create(**SWEEP_SPEC),
            events_path=str(Path(out_dir, f"events{rank}.jsonl")),
            emit=lines.append, device="cpu")
        runner.run()
        runner.write_summary(str(Path(out_dir, f"summary{rank}.json")))
    finally:
        torch.distributed.destroy_process_group()
    Path(out_dir, f"lines{rank}.json").write_text(json.dumps(lines))
