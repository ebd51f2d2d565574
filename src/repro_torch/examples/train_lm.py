"""End-to-end training: train a small LM for a few hundred steps
with LARK-replicated checkpointing and a mid-run worker failure (port of
the reference's ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--big] [--device cpu]

The reduced smollm (batch 8 x 128 tokens, lr 3e-3) through
``launch/train.py``: worker 3 fails at steps // 2 and recovers 20 steps
later; LARK commits every checkpoint through the failure while the
quorum-log baseline pauses for its hydration window.  ``--big`` passes
``--batch 4`` after the default batch, as the reference does (argparse
keeps the last).  Records go to ``results/train/smollm_360m`` under the
working directory, where ``launch/train.py`` writes them.
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.train import main as train_main


def run(steps: int = 200, big: bool = False, device=None,
        emit=print) -> dict:
    """{"metrics": ``launch.train``'s per-step records, "first", "last": the
    first and last losses}."""
    dev = resolve_device(device)
    argv = ["--arch", "smollm_360m", "--reduced", "--steps", str(steps),
            "--batch", "8", "--seq", "128", "--lr", "3e-3",
            "--fail-worker-at", str(steps // 2),
            "--recover-worker-at", str(steps // 2 + 20)]
    if big:
        argv += ["--batch", "4"]
    metrics = train_main(argv + ["--device", str(dev)])
    first, last = metrics[0]["loss"], metrics[-1]["loss"]
    emit(f"loss {first:.3f} -> {last:.3f} "
         f"({'OK' if last < first else 'WARN'})")
    return {"metrics": metrics, "first": first, "last": last}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                 "train_lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, args.big, args.device)


if __name__ == "__main__":
    main()
