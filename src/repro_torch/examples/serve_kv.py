"""Serving example: batched decode with LARK-replicated session state
(port of the reference's ``examples/serve_kv.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_kv [--device cpu]

A decode session survives the failure of the server holding it: the
session store (the paper's protocol) fails over per key with a dup-res
round trip, and generation resumes from the last committed decode state.
The reduced smollm serves on the device (``launch/serve.py`` with the
reference's argv).
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main

ARGV = ["--arch", "smollm_360m", "--fail-server"]


def run(device=None) -> dict:
    """{"generated": the first phase's tokens, "resumed": the resumed
    generation (None if the session was lost)}."""
    dev = resolve_device(device)
    toks, resumed = serve_main(ARGV + ["--device", str(dev)])
    return {"generated": toks, "resumed": resumed}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                 "serve_kv")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
