"""Training driver (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --fail-worker-at 3
  PYTHONPATH=src python -m repro_torch.launch.train     # on the card

The driver demonstrates the integrated stack: synthetic pipeline -> train
step (microbatch accumulation, at most 2 microbatches as in the
reference) -> LARK-replicated checkpoint store (+ the quorum-log baseline
store for comparison) -> async disk shards -> a simulated worker failure
mid-run: LARK keeps committing checkpoints, the baseline pauses for its
hydration window.  Every step prints one JSON record {"step", "loss",
"grad_norm"}, with "lark_commit" and "baseline_commit" on checkpoint
steps; the records land in ``<out>/<arch>/metrics.json`` and the
parameters' shards under ``<out>/<arch>/ckpt``.

The reference's flags and defaults (``--arch smollm_360m``, 20 steps of
batch 4 by 64 tokens, lr 1e-3, a checkpoint every 5 steps, 4 workers at
rf 2); ``--reduced`` is off by default, as there, and a
``BooleanOptionalAction``.  Runs on the card unless ``--device cpu``;
weights are random, from seed 0.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, LarkStore, \
    QuorumLogStore
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.training import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--fail-worker-at", type=int, default=-1)
    ap.add_argument("--recover-worker-at", type=int, default=-1)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rf", type=int, default=2)
    ap.add_argument("--out", default="results/train")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(microbatches_train=min(cfg.microbatches_train, 2))
    data = SyntheticLMData(cfg, args.batch, args.seq)
    init_fn, step_fn, _ = make_train_step(cfg, peak_lr=args.lr)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params, opt_state = init_fn(gen)

    lark = LarkStore(args.workers, rf=args.rf, num_partitions=16)
    base = QuorumLogStore(args.workers, rf=args.rf, num_partitions=16,
                          partition_bytes=1e8, bandwidth=5e6)
    out_dir = Path(args.out) / args.arch
    disk = AsyncCheckpointer(out_dir / "ckpt")
    metrics_log = []

    t_start = time.time()
    for step in range(args.steps):
        if step == args.fail_worker_at:
            lark.fail_node(args.workers - 1)
            base.fail_node(args.workers - 1)
            print(f"[step {step}] worker {args.workers-1} failed; "
                  f"LARK availability {lark.available_fraction():.2f}, "
                  f"regime {lark.regime}")
        if step == args.recover_worker_at:
            lark.recover_node(args.workers - 1)
            base.recover_node(args.workers - 1)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        base.advance(1.0)  # 1 simulated second per step
        rec = {"step": step, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"])}
        if step % args.checkpoint_every == 0:
            ok_l, tot = lark.put_pytree(f"ckpt/{step}",
                                        {"loss": np.float32(rec["loss"])})
            ok_b = base.put(f"ckpt/{step}", rec["loss"])
            disk.save({"p": params}, step=step, regime=lark.regime)
            rec.update(lark_commit=ok_l == tot, baseline_commit=bool(ok_b))
        metrics_log.append(rec)
        print(json.dumps(rec))
    disk.close()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "metrics.json").write_text(json.dumps(metrics_log))
    print(f"done in {time.time()-t_start:.1f}s; final loss "
          f"{metrics_log[-1]['loss']:.4f} (first {metrics_log[0]['loss']:.4f})")
    return metrics_log


if __name__ == "__main__":
    main()
