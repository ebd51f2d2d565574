"""Multi-pod dry run: the specs and per-rank bytes of every (arch x shape
x mesh) cell, on a fake process group (port of
``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multipod|--singlepod]

The reference lowers and compiles each cell on 512 placeholder host
devices.  The port builds the production mesh (``launch/mesh.py``) on a
``"fake"`` process group of 256 or 512 ranks in this one process
(PyTorch's internal ``FakeStore``; a torch without it raises), and
computes, as host arithmetic on meta tensors (the counterpart of
``jax.eval_shape``, so no model is allocated), per cell
(``results/dryrun_torch/<arch>__<shape>__<mesh>.json``):

* the reference's fields that do not come from XLA: ``arch``, ``shape``,
  ``mesh``, ``kind``, ``status`` (``"skipped"`` with the reference's
  reason where ``cfg.supports(shape)`` is false), ``batch_axes``,
  ``param_count`` and ``param_bytes_global``;
* ``per_device_bytes``: each argument's bytes on one rank under the
  specs of ``launch/shardings.py`` — params, float32 grads and optimizer
  state (train), the batch, and the decode state (prefill's output,
  decode's input);
* ``op_analysis`` (``launch/op_analysis.py``): one rank's step traced on
  meta tensors: the parameters, optimizer state and decode state as meta
  DTensors under the cell's specs (``shardings.distribute``), so the
  step is the sharded one (``training/train_loop.py``,
  ``training/sharded.py``).  A train cell's step is the ZeRO step of the
  per-layer tree: the moments under ``opt_state_shardings``, each
  gradient reduce-scattered over the batch axes into its
  ``grad_shardings`` block, the update on that block, the parameters
  all-gathered into ``param_shardings``.  Its collectives also by mesh
  axis (``collectives_by_axis``).  A reduce-scatter books its input, the
  flat buffer of every rank's blocks (the rank keeps 1/size of it); an
  all-gather books its input too, this rank's blocks (it receives size
  times that).  A cell that cannot be traced records ``"not traced"``,
  the op and the reason.

XLA's ``memory_analysis`` temporaries have no counterpart here and are
recorded as not measured.  Every byte count is host arithmetic on
shapes, not a device measurement.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import traceback
from pathlib import Path

import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.layers import DTYPES
from repro_torch.models.model import batch_specs
from repro_torch.models.transformer import encoder_config
from repro_torch.optim import make_optimizer

from . import op_analysis
from .mesh import make_production_mesh
from .shardings import (NamedSharding, batch_axes, batch_shardings,
                        distribute, grad_shardings, opt_state_shardings,
                        param_shardings, shard_shape, state_shardings)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
SKIP_REASON = ("long_500k needs sub-quadratic attention; skipped for pure "
               "full-attention archs (DESIGN.md)")
META = torch.device("meta")


class _MetaGen(torch.Generator):
    """A generator whose ``device`` is meta: the models' initializers
    allocate on ``gen.device``, so ``init_params`` builds meta tensors."""

    @property
    def device(self):
        return META


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _stack(layout, layers):
    """Per-layer trees -> the reference's tuple of segments of tuples of
    trees stacked over each segment's repeats."""
    segs, li = [], 0
    for pattern, repeats in layout:
        per_pos = [[] for _ in pattern]
        for _ in range(repeats):
            for bi in range(len(pattern)):
                per_pos[bi].append(layers[li])
                li += 1
        segs.append(tuple(tree.map_leaves(
            lambda a, *_: _meta((len(trees),) + tuple(a.shape), a.dtype),
            trees[0]) for trees in per_pos))
    return tuple(segs)


def _unstack(layout, segs, fn):
    """The inverse of _stack: per-layer trees, each leaf through fn."""
    out = []
    for si, (pattern, repeats) in enumerate(layout):
        for _ in range(repeats):
            for bi in range(len(pattern)):
                out.append(tree.map_leaves(fn, segs[si][bi]))
    return out


def _layouts(cfg: ModelConfig):
    """{params entry: layout} of the stacked entries: ``blocks``, an
    encoder-decoder's ``encoder`` and ``decoder``."""
    out = {"blocks": cfg.layout, "decoder": cfg.layout}
    if cfg.is_encoder_decoder:
        out["encoder"] = encoder_config(cfg).layout
    return out


def _drop_stack_dim(a):
    return _meta(a.shape[1:], a.dtype)


def abstract_params(cfg: ModelConfig):
    """The parameters as meta tensors in the reference's layout (the
    per-layer ``blocks`` / ``encoder`` / ``decoder`` stacked by
    segment): the tree ``jax.eval_shape(init_params)`` gives."""
    params = build_model(cfg)["init_params"](_MetaGen())
    lay = _layouts(cfg)
    return {k: _stack(lay[k], v) if k in lay else v
            for k, v in params.items()}


def per_layer_params(cfg: ModelConfig, stacked):
    """``abstract_params``' tree as the port's per-layer parameters."""
    lay = _layouts(cfg)
    return {k: _unstack(lay[k], v, _drop_stack_dim) if k in lay else v
            for k, v in stacked.items()}


def _specs_to_meta(t):
    """A tree with (shape, dtype) leaves as meta tensors."""
    if isinstance(t, dict):
        return {k: _specs_to_meta(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_specs_to_meta(v) for v in t]
    shape, dtype = t
    return _meta(shape, DTYPES[dtype] if isinstance(dtype, str) else dtype)


def abstract_state(cfg: ModelConfig, batch: int, max_len: int):
    """The decode state as meta tensors in the reference's layout."""
    per_layer = _specs_to_meta(
        build_model(cfg)["decode_state_shape"](batch, max_len))
    return _stack(cfg.layout, per_layer)


def abstract_batch(cfg: ModelConfig, shape):
    return {k: _meta(s, torch.int32 if d == "int32" else DTYPES[d])
            for k, (s, d) in batch_specs(cfg, shape).items()}


def abstract_decode_inputs(cfg: ModelConfig, shape):
    """{"state", "tokens", "pos"} of a decode cell (the reference's
    ``decode_input_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.embeds_input and not cfg.is_encoder_decoder:
        tok = _meta((B, cfg.d_model), DTYPES[cfg.act_dtype])
    else:
        tok = _meta((B,), torch.int32)
    return {"state": abstract_state(cfg, B, S), "tokens": tok,
            "pos": _meta((), torch.int32)}


def tree_bytes(t) -> int:
    return sum(math.prod(x.shape) * x.element_size() for x in tree.leaves(t))


def tree_params(t) -> int:
    return sum(math.prod(x.shape) for x in tree.leaves(t))


def sharded_bytes(t, shardings, mesh) -> int:
    """One rank's bytes of tree `t` under its NamedShardings."""
    return sum(math.prod(shard_shape(x.shape, s.spec, mesh))
               * x.element_size()
               for x, s in zip(tree.leaves(t),
                               tree.flatten_up_to(t, shardings)))


def _f32(t):
    return tree.map_leaves(lambda x: _meta(x.shape, torch.float32), t)


def _axis_names(mesh):
    """{process group name: mesh axes} of every set of `mesh`'s axes in
    mesh order, one axis or a flattened run (``tp.axis``)."""
    from . import tp
    dims = mesh.mesh_dim_names
    return {tp.group(mesh, names).group_name: "+".join(names)
            for k in range(1, len(dims) + 1)
            for names in itertools.combinations(dims, k)}


def _trace(cfg, shape, mesh, inputs, bshard, gshard=None):
    """op_analysis of one rank's step, or "not traced", the op and why."""
    from repro_torch.training import make_serve_steps, make_train_step
    try:
        if shape.kind == "train":
            params, opt_state, batch = inputs
            _, step_fn, _ = make_train_step(cfg, grad_shardings=gshard,
                                            batch_shardings=bshard)
            res = op_analysis.analyze(step_fn, params, opt_state, batch)
        elif shape.kind == "prefill":
            params, batch = inputs
            prefill_fn, _, _ = make_serve_steps(cfg, mesh)
            res = op_analysis.analyze(prefill_fn, params, batch,
                                      shape.seq_len)
        else:
            params, dec = inputs
            _, decode_fn, _ = make_serve_steps(cfg, mesh)
            res = op_analysis.analyze(decode_fn, params, dec["state"],
                                      dec["tokens"], shape.seq_len - 1)
    except Exception as e:               # recorded, the dry run goes on
        where = traceback.extract_tb(e.__traceback__)[-1]
        return {"status": "not traced",
                "reason": f"{type(e).__name__}: {e}",
                "op": f"{Path(where.filename).name}:{where.lineno} "
                      f"{where.line}"}
    names = _axis_names(mesh)
    res["collectives_by_axis"] = {
        names.get(g, g): ops
        for g, ops in res.pop("collectives_by_group").items()}
    return {"status": "ok", **res}


def _specs_per_layer(cfg, specs_stacked):
    """A stacked state's shardings as per-layer NamedShardings (the
    stacked dim's entry dropped)."""
    return _unstack(cfg.layout, specs_stacked, lambda sh:
                    NamedSharding(sh.mesh, sh.spec[1:]))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             trace: bool = True) -> dict:
    """One cell's record; the fake group of the mesh's size must be the
    default group (``fake_world``)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "ok"}
    if not cfg.supports(shape):
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    B = shape.global_batch
    baxes = batch_axes(cfg, mesh, B)
    rec["batch_axes"] = list(baxes)
    params = abstract_params(cfg)
    rec["param_count"] = tree_params(params)
    rec["param_bytes_global"] = tree_bytes(params)
    dev = {}
    if shape.kind == "train":
        opt_state = make_optimizer(cfg.optimizer).init(params)
        pshard = param_shardings(cfg, mesh, params)
        gshard = grad_shardings(cfg, mesh, params)
        oshard = opt_state_shardings(cfg, mesh, params, opt_state)
        batch = abstract_batch(cfg, shape)
        bshard = batch_shardings(cfg, mesh, batch, B)
        dev["params"] = sharded_bytes(params, pshard, mesh)
        dev["grads"] = sharded_bytes(_f32(params), gshard, mesh)
        dev["opt_state"] = sharded_bytes(opt_state, oshard, mesh)
        dev["batch"] = sharded_bytes(batch, bshard, mesh)
        if trace:
            # the ZeRO step on the per-layer tree, as the reference's jit
            # places it: the parameters under param_shardings, the moments
            # under opt_state_shardings, the gradients reduce-scattered
            # into grad_shardings
            whole = per_layer_params(cfg, params)
            moments = make_optimizer(cfg.optimizer).init(whole)
            rec["op_analysis"] = _trace(
                cfg, shape, mesh,
                (distribute(whole, param_shardings(cfg, mesh, whole), mesh),
                 distribute(moments, opt_state_shardings(
                     cfg, mesh, whole, moments), mesh), batch),
                bshard, grad_shardings(cfg, mesh, whole))
    else:
        pshard = param_shardings(cfg, mesh, params, fsdp=cfg.tensor_parallel)
        dev["params"] = sharded_bytes(params, pshard, mesh)
        if trace:
            local = per_layer_params(cfg, params)
            local = distribute(local, param_shardings(
                cfg, mesh, local, fsdp=cfg.tensor_parallel), mesh)
        if shape.kind == "prefill":
            batch = abstract_batch(cfg, shape)
            bshard = batch_shardings(cfg, mesh, batch, B)
            dev["batch"] = sharded_bytes(batch, bshard, mesh)
            state = abstract_state(cfg, B, shape.seq_len)
            dev["decode_state"] = sharded_bytes(
                state, state_shardings(cfg, mesh, state, B), mesh)
            if trace:
                rec["op_analysis"] = _trace(cfg, shape, mesh,
                                            (local, batch), bshard)
        else:
            dec = abstract_decode_inputs(cfg, shape)
            sshard = state_shardings(cfg, mesh, dec["state"], B)
            tshard = batch_shardings(cfg, mesh, {"t": dec["tokens"]}, B)["t"]
            dev["decode_state"] = sharded_bytes(dec["state"], sshard, mesh)
            dev["batch"] = sharded_bytes(dec["tokens"], tshard, mesh)
            if trace:
                # the per-layer state as meta DTensors under its specs
                state = distribute(
                    _unstack(cfg.layout, dec["state"], _drop_stack_dim),
                    _specs_per_layer(cfg, sshard), mesh)
                rec["op_analysis"] = _trace(
                    cfg, shape, mesh,
                    (local, {"state": state, "tokens": dec["tokens"]}),
                    None)
    rec["per_device_bytes"] = dev
    rec["memory"] = {"temp_bytes": "not measured (XLA's memory_analysis "
                     "has no counterpart in an eager step)"}
    return rec


def fake_world(size: int) -> None:
    """Make a ``"fake"`` process group of `size` ranks (this process is
    rank 0) the default group; collectives on it do nothing."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs PyTorch's internal "
                           "torch.testing._internal.distributed.fake_pg "
                           "(FakeStore), which this torch lacks") from e
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=size)


def cell_path(arch, shape_name, multi_pod) -> Path:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    return RESULTS_DIR / f"{arch}__{shape_name}__{mesh_name}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--singlepod", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES_BY_NAME) if (args.all or args.shape in
                                      (None, "all")) else [args.shape]
    pods = [False, True]
    if args.multipod and not args.singlepod:
        pods = [True]
    if args.singlepod and not args.multipod:
        pods = [False]

    failures = 0
    fake_world(512 if True in pods else 256)
    try:
        for arch in archs:
            for shape_name in shapes:
                for mp in pods:
                    out = cell_path(arch, shape_name, mp)
                    if out.exists() and not args.force:
                        print(f"[cached] {out.name}")
                        continue
                    try:
                        rec = run_cell(arch, shape_name, mp)
                    except Exception:         # recorded per cell
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": "pod2x16x16" if mp else "pod16x16",
                               "status": "error",
                               "traceback": traceback.format_exc()}
                        failures += 1
                    out.write_text(json.dumps(rec, indent=2))
                    trace = rec.get("op_analysis", {}).get("status", "-")
                    print(f"[dryrun] {arch} x {shape_name} x "
                          f"{rec['mesh']}: {rec['status']} (op analysis "
                          f"{trace})", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
