"""Serving driver: batched prefill/decode with LARK session failover (port
of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --prompt-len 16 --gen 24 --fail-server
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
      --batch 4 --prompt-len 1024 --gen 32 --fail-server     # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch whisper_small --device cpu --fail-server

The default arch is ``smollm_360m``, as in the reference; every arch of
``configs/registry.py`` serves, except that qwen2_vl_2b (a decoder over
input embeddings) raises a ``ValueError`` before its first decode step:
greedy decoding of argmax token ids cannot supply the next embedding
(``serving/serve_loop.py``).  ``--reduced`` defaults to on as in the
reference, but is a ``BooleanOptionalAction``, so ``--no-reduced``
reaches the full config (the reference's ``store_true`` with
``default=True`` never can).  Runs on the card unless ``--device cpu``;
weights are random, from seed 0.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import LarkSessionStore, ServeLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--fail-server", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model["init_params"](gen)
    sessions = LarkSessionStore(num_nodes=4, rf=2)
    loop = ServeLoop(cfg, params, max_len=args.prompt_len + args.gen,
                     session_store=sessions, checkpoint_every=4,
                     device=device)

    data = SyntheticLMData(cfg, args.batch, args.prompt_len)
    batch = {k: v for k, v in data.batch_at(0).items() if k != "labels"}
    toks = loop.generate(batch, steps=args.gen // 2, session_id="req-0")
    print("generated (phase 1):", toks[:, :8], "...")

    if args.fail_server:
        sessions.fail_server(0)
        print("server 0 failed; sessions available:",
              sessions.store.available_fraction())
    resumed = loop.resume("req-0", steps=args.gen // 2)
    print("resumed generation:", None if resumed is None else resumed.shape)
    return toks, resumed


if __name__ == "__main__":
    main()
