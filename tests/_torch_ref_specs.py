"""The reference's sharding specs and dry-run numbers, dumped to JSON by
a subprocess that forces 512 host devices (jax fixes its device count at
its first import, which a test process is long past).

``dump(out, archs, cells)`` runs ``python -c SCRIPT``: for every arch in
`archs` and both production meshes, the leaf shapes and specs of the
parameters (with and without FSDP), the float32 gradient accumulators and
the AdamW and Adafactor states; for every supported shape, the batch
axes and the batch and decode-state specs; and for each (arch, shape,
multi_pod) of `cells`, the dry run's spec-derived fields and per-rank
bytes from ``jax.eval_shape`` and ``NamedSharding.shard_shape``.  Leaves
are listed in flattening order, which the port's trees share."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math, sys
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import SHAPES_BY_NAME, get_config
from repro.launch import shardings as S
from repro.launch.mesh import make_production_mesh
from repro.models import batch_specs, build_model, decode_input_specs
from repro.optim import make_optimizer

out_path, archs, cells = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])
is_sh = lambda x: isinstance(x, NamedSharding)

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def leaves(structs, shards):
    s_leaves = jax.tree.leaves(structs)
    h_leaves = jax.tree.leaves(shards, is_leaf=is_sh)
    assert len(s_leaves) == len(h_leaves)
    return [[list(s.shape), [entry(e) for e in h.spec]]
            for s, h in zip(s_leaves, h_leaves)]

def nbytes(structs, shards):
    return sum(math.prod(h.shard_shape(s.shape)) * s.dtype.itemsize
               for s, h in zip(jax.tree.leaves(structs),
                               jax.tree.leaves(shards, is_leaf=is_sh)))

meshes = {False: make_production_mesh(multi_pod=False),
          True: make_production_mesh(multi_pod=True)}
res = {"specs": {}, "cells": []}
for arch in archs:
    cfg = get_config(arch)
    model = build_model(cfg)
    params = jax.eval_shape(model["init_params"], jax.random.PRNGKey(0))
    f32 = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32),
                       params)
    opts = {n: jax.eval_shape(make_optimizer(n).init, params)
            for n in ("adamw", "adafactor")}
    for mp, mesh in meshes.items():
        rec = {
            "params": leaves(params, S.param_shardings(cfg, mesh, params)),
            "params_fsdp_tp": leaves(params, S.param_shardings(
                cfg, mesh, params, fsdp=cfg.tensor_parallel)),
            "grads": leaves(params, S.grad_shardings(cfg, mesh, params)),
        }
        for n, st in opts.items():
            rec[f"opt_{n}"] = leaves(st, S.opt_state_shardings(
                cfg, mesh, params, st))
        for name, shape in SHAPES_BY_NAME.items():
            if not cfg.supports(shape):
                continue
            B = shape.global_batch
            b = batch_specs(cfg, shape)
            one = {"batch_axes": list(S.batch_axes(cfg, mesh, B)),
                   "batch": leaves(b, S.batch_shardings(cfg, mesh, b, B))}
            if shape.kind != "train":
                st = model["decode_state_shape"](B, shape.seq_len)
                one["state"] = leaves(st, S.state_shardings(cfg, mesh, st, B))
                tok = {"t": decode_input_specs(cfg, shape)["tokens"]}
                one["tokens"] = leaves(tok, S.batch_shardings(cfg, mesh, tok,
                                                              B))
            rec[name] = one
        res["specs"][f"{arch}|{int(mp)}"] = rec
for arch, shape_name, mp in cells:
    cfg, shape, mesh = get_config(arch), SHAPES_BY_NAME[shape_name], \
        meshes[mp]
    model = build_model(cfg)
    params = jax.eval_shape(model["init_params"], jax.random.PRNGKey(0))
    B = shape.global_batch
    dev = {}
    if shape.kind == "train":
        opt = jax.eval_shape(make_optimizer(cfg.optimizer).init, params)
        f32 = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape,
                                                          jnp.float32), params)
        b = batch_specs(cfg, shape)
        dev["params"] = nbytes(params, S.param_shardings(cfg, mesh, params))
        dev["grads"] = nbytes(f32, S.grad_shardings(cfg, mesh, params))
        dev["opt_state"] = nbytes(opt, S.opt_state_shardings(cfg, mesh,
                                                             params, opt))
        dev["batch"] = nbytes(b, S.batch_shardings(cfg, mesh, b, B))
    else:
        dev["params"] = nbytes(params, S.param_shardings(
            cfg, mesh, params, fsdp=cfg.tensor_parallel))
        st = model["decode_state_shape"](B, shape.seq_len)
        dev["decode_state"] = nbytes(st, S.state_shardings(cfg, mesh, st, B))
        if shape.kind == "prefill":
            b = batch_specs(cfg, shape)
            dev["batch"] = nbytes(b, S.batch_shardings(cfg, mesh, b, B))
        else:
            tok = {"t": decode_input_specs(cfg, shape)["tokens"]}
            dev["batch"] = nbytes(tok, S.batch_shardings(cfg, mesh, tok, B))
    res["cells"].append({
        "arch": arch, "shape": shape_name, "multi_pod": mp,
        "batch_axes": list(S.batch_axes(cfg, mesh, B)),
        "param_count": sum(math.prod(l.shape)
                           for l in jax.tree.leaves(params)),
        "param_bytes_global": sum(math.prod(l.shape) * l.dtype.itemsize
                                  for l in jax.tree.leaves(params)),
        "per_device_bytes": dev})
with open(out_path, "w") as fh:
    json.dump(res, fh)
'''


def dump(out: Path, archs, cells=(), timeout: float = 110) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out), json.dumps(list(archs)),
         json.dumps([list(c) for c in cells])],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())
