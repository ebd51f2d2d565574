"""Where a serve step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.profile_serve \\
        [--arch xlstm_350m] [--batch 4 --prompt-len 1024 --decode-steps 16] \\
        [--reduced | --no-reduced] [--json OUT]
    PYTHONPATH=src python -m repro_torch.profile_serve \\
        --arch recurrentgemma_9b --no-reduced --prompt-len 3072
    PYTHONPATH=src python -m repro_torch.profile_serve --arch smollm_360m

Builds the model at full width (the default, ``--no-reduced``;
``--reduced`` for the CPU-test size) with random weights from seed 0 on
cuda, warms up with one prefill and one decode step, then times a
prefill and ``--decode-steps`` greedy decode steps on the host clock
(synchronized), and profiles one more prefill under ``torch.profiler``.
The attention caches hold the prompt and the decoded tokens.  Prints one
JSON object: prefill and decode tokens per second, the prefill's
unprofiled wall time, its device-busy seconds (the sum of the CUDA
kernel events) and idle share, device time by kernel group (the mLSTM
and RG-LRU kernels, GEMMs, the rest) and by kernel name, and the host
time inside each block kind's range (``block:mlstm``, ``block:slstm``,
``block:rglru``, ``block:local``, ``block:attn``; the sLSTM's per-token
loop is in the second).  Every registry arch runs: whisper prefills its
stub frames with the tokens, and qwen2-vl decodes the data's next
embeddings and (t, h, w) ids.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .configs import get_config, reduced_config
from .data import SyntheticLMData
from .models import batch_prefix, build_model, decode_input
from .profile_step import _device_self_us


def kernel_group(name: str) -> str:
    """mlstm or rglru (the hand-written kernels), gemm (cuBLAS/CUTLASS
    matrix products, cuBLASLt's ``nvjet`` kernels included) or other
    (elementwise, softmax, reductions, copies)."""
    low = name.lower()
    for kernel in ("mlstm", "rglru"):
        if f"{kernel}_" in low:
            return kernel
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
        return "gemm"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm_350m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card; torch sees none")
    dev = torch.device("cuda")
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model["init_params"](gen)
    S = args.prompt_len
    max_len = S + args.decode_steps
    # the decode steps' inputs: the argmax token, or for an embeds-input
    # model (qwen2-vl) the data's next embedding and ids
    data = SyntheticLMData(cfg, args.batch, max_len).batch_at(0)
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in data.items()
              if k != "labels"}
    batch = batch_prefix(inputs, S)

    def step(state, logits, i):
        inp, kw = decode_input(inputs, S + i) if cfg.embeds_input and \
            not cfg.is_encoder_decoder else (logits.argmax(-1), {})
        return model["decode_step"](params, state, inp, S + i, **kw)

    with torch.no_grad():
        logits, state = model["prefill"](params, batch, max_len)  # warm-up
        step(state, logits, 0)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, state = model["prefill"](params, batch, max_len)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        t0 = time.monotonic()
        for i in range(args.decode_steps):
            logits, state = step(state, logits, i)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
        del logits, state
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model["prefill"](params, batch, max_len)
            torch.cuda.synchronize()

    kernels, ranges = {}, {}
    for evt in prof.key_averages():
        if evt.key.startswith("block:"):
            # the named ranges also appear as device-side annotations,
            # which span kernels and are no kernels themselves
            if evt.device_type == DeviceType.CPU:
                ranges[evt.key] = {"calls": evt.count,
                                   "host_ms": evt.cpu_time_total / 1e3}
        elif evt.device_type == DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                _device_self_us(evt)
    groups = {}
    for name, us in kernels.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    out = {"device": torch.cuda.get_device_name(0), "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "batch": args.batch, "prompt_len": args.prompt_len,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": args.batch * args.prompt_len / prefill_s,
           "decode_steps": args.decode_steps,
           "decode_tokens_per_s": args.batch * args.decode_steps / decode_s,
           "prefill_device_busy_s": busy,
           "prefill_idle_share": 1.0 - busy / prefill_s,
           "device_ms_by_group": groups, "host_ranges": ranges,
           "kernels_ms": [{"name": k[:120], "ms": v / 1e3} for k, v in top]}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
