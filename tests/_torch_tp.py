"""Helpers of the tensor- and sequence-parallel tests: the reduced
configurations, one run of each (a train step, prefill and greedy
decode) on one process or on a mesh, and the rank main that runs them all
on a 2 x 2 ("data", "model") gloo mesh.  It imports the port only, so the
spawned ranks start without jax."""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree
from repro_torch.launch import dist as rdist

#: name -> (arch, config overrides, rows, what runs).  mixtral keeps 3
#: experts, which do not divide 2 ways, so its experts are tensor-parallel
#: on their hidden width as at 16 ways; minicpm3 keeps 3 heads, which
#: split mid-head over 2 ways as its 40 do over 16, and a vocabulary of
#: 255, which does not divide, so its embedding is sharded on d_model as
#: its 73,448 are; recurrentgemma's RG-LRU is cut to 64 channels (the
#: reduced config keeps 4096); whisper keeps its remat, whose recompute
#: must run in its forward's layout.  The "_sp" cases have 2 rows, which the
#: data axis takes, so the sequence goes over "model"; the "_b1" cases
#: decode one row with their state sharded over data x model (long_500k's
#: layout: xlstm's C and n, recurrentgemma's RG-LRU state, the caches'
#: sequence).
CASES = {
    "internlm2_20b": ("internlm2_20b", {}, 2, ("train", "serve")),
    "mixtral_8x7b": ("mixtral_8x7b", {"experts": 3}, 2, ("train", "serve")),
    "qwen3_moe_235b_a22b": ("qwen3_moe_235b_a22b", {}, 2,
                            ("train", "serve")),
    "minicpm3_4b": ("minicpm3_4b", {"num_heads": 3, "num_kv_heads": 3,
                                    "vocab_size": 255}, 2,
                    ("train", "serve")),
    "nemotron_4_340b": ("nemotron_4_340b", {}, 2, ("train", "serve")),
    "recurrentgemma_9b": ("recurrentgemma_9b", {"lru_width": 64}, 2,
                          ("train", "serve")),
    "smollm_360m_sp": ("smollm_360m", {}, 2, ("train", "serve")),
    "whisper_small_sp": ("whisper_small", {"remat": True}, 2,
                         ("train", "serve")),
    "qwen2_vl_2b_sp": ("qwen2_vl_2b", {}, 2, ("train", "prefill")),
    "xlstm_350m_b1": ("xlstm_350m", {}, 1, ("serve",)),
    "recurrentgemma_9b_b1": ("recurrentgemma_9b", {"lru_width": 64}, 1,
                             ("serve",)),
    "mixtral_8x7b_b1": ("mixtral_8x7b", {"experts": 3}, 1, ("serve",)),
}
TRAIN_STEPS, DECODE_STEPS = 2, 4
TRAIN_SEQ, PROMPT, MAX_LEN = 16, 12, 20
MESH = ((2, 2), ("data", "model"))


def config(name, reduced_config=None):
    """The case's config: `reduced_config` (the port's by default) of its
    arch with its overrides."""
    if reduced_config is None:
        from repro_torch.configs import reduced_config
    arch, over, _, _ = CASES[name]
    over = dict(over)
    cfg = reduced_config(arch)
    if "experts" in over:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_experts=over.pop("experts")))
    return cfg.replace(**over)


def _full(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().to(torch.float32).numpy()


def run(name, mesh=None):
    """{"metrics", "params", "logits"} of the case: TRAIN_STEPS steps
    from seed 0 on a numpy-seeded batch, then a prefill of the initial
    weights and DECODE_STEPS greedy steps; on a mesh the parameters are
    distributed under the reference's specs."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.shardings import (batch_shardings, distribute,
                                              grad_shardings,
                                              param_shardings)
    from repro_torch.models import build_model
    from repro_torch.models.model import make_batch
    from repro_torch.training import make_serve_steps, make_train_step
    cfg = config(name)
    _, _, rows, what = CASES[name]
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg)["init_params"](gen)
    out = {}
    if "train" in what:
        batch = make_batch(cfg, ShapeConfig("t", TRAIN_SEQ, rows, "train"),
                           np.random.default_rng(0))
        if mesh is None:
            p, (_, step_fn, opt) = params, make_train_step(cfg)
        else:
            p = distribute(params, param_shardings(cfg, mesh, params), mesh)
            _, step_fn, opt = make_train_step(
                cfg, grad_shardings=grad_shardings(cfg, mesh, params),
                batch_shardings=batch_shardings(cfg, mesh, batch, rows))
        st = opt.init(p)
        metrics = []
        for _ in range(TRAIN_STEPS):
            p, st, m = step_fn(p, st, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out["metrics"] = metrics
        out["params"] = [_full(t) for t in tree.leaves(p)]
        out["opt_state"] = [_full(t) for t in tree.leaves(st)]
        out["opt_dtypes"] = [str(t.dtype) for t in tree.leaves(st)]
    if "serve" in what or "prefill" in what:
        batch = make_batch(cfg, ShapeConfig("p", PROMPT, rows, "prefill"),
                           np.random.default_rng(1))
        prefill_fn, decode_fn, _ = make_serve_steps(cfg, mesh)
        p = params if mesh is None else distribute(params, param_shardings(
            cfg, mesh, params, fsdp=cfg.tensor_parallel), mesh)
        logits, state = prefill_fn(p, batch, MAX_LEN)
        out["logits"] = [_full(logits)]
        for i in range(DECODE_STEPS if "serve" in what else 0):
            tok = torch.from_numpy(out["logits"][-1].argmax(-1)
                                   .astype(np.int32))
            logits, state = decode_fn(p, state, tok, PROMPT + i)
            out["logits"].append(_full(logits))
    return out


#: the gradient-clipping case: global shapes and specs of the leaves
CLIP_LEAVES = (((8, 6), (None, "model")), ((4, 8), ("data", "model")),
               ((5,), ()), ((6, 4), ("model", None)))


def clip_case(mesh=None):
    """(global norm, clipped leaves) of CLIP_LEAVES' random gradients,
    whose shards' norms differ, clipped to 1.0 as DTensors on the mesh
    or whole."""
    from repro_torch.launch.shardings import distribute
    from repro_torch.optim import clip_by_global_norm
    rng = np.random.default_rng(3)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                              * (1 + np.arange(s[-1], dtype=np.float32)))
             for s, _ in CLIP_LEAVES]
    if mesh is not None:
        grads = distribute(grads, [spec for _, spec in CLIP_LEAVES], mesh)
    clipped, norm = clip_by_global_norm(grads, 1.0)
    return float(norm), [_full(g) for g in clipped]


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """Join a gloo group through the file store, run every case and the
    clipping case on MESH, and pickle rank 0's results."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=100)
    try:
        mesh = make_host_mesh(*MESH)
        got = {name: run(name, mesh) for name in CASES}
        got["clip"] = clip_case(mesh)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        Path(out_dir, "tp.pkl").write_bytes(pickle.dumps(got))
