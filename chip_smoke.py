#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its main paths at the paper tile (n = 155 nodes, P = 4096
partitions, 8 trials): the §5.1 availability Monte Carlo, the §6
commit-pause engine, its client-latency layer and its protocol zoo; the
LM serve paths at full width: xlstm-350m, recurrentgemma-9b and
smollm-360m behind the LARK session store, and every other architecture
of the registry; the §5.2 micro-simulator's Tables 3-4 at the
reference's 520,000 ticks; and training: the backward kernels of the
mLSTM and RG-LRU cells, and the train step of xlstm-350m,
recurrentgemma-9b (cut to 3 layers) and smollm-360m at full width behind
the LARK and quorum-log checkpoint stores; and across ranks on the one
card: the Monte Carlo's trials sharded over 2 and 4 processes,
smollm-360m's data-parallel train step on 2, and recurrentgemma-9b
tensor-parallel over 2.
One JSON line per phase:

1. ``nvidia-smi``: the card's name and power limit.
2. ``build``: nvcc for sm_90a, one process per source, all at once, and
   their seconds, and the registers, spill bytes and serialized-wgmma
   flag of each instantiation of ``flash_attention_sm90.cu`` (per head
   dim), ``mlstm_chunk_sm90.cu`` (per kernel and Dv block) and
   ``downtime_eval.cu`` (per mode, with and without the counts); beside
   them, at the same time, the copies of ``downtime_eval.cu``,
   ``latency_charge.cu``, ``fused_downtime.cu``, ``rglru_scan.cu``, both
   flash sources, both mLSTM sources, both mLSTM backward sources and
   ``microsim_scan.cu`` with one planted fault each
   (``mc_check.FAULTS``, ``rglru_check.FAULTS``, ``flash_check.FAULTS``,
   ``mlstm_check.FAULTS``, ``mlstm_check.BWD_SOURCE_FAULTS``,
   ``microsim_scan.FAULTS``); and the registers and spills of
   ``microsim_scan.cu`` and of each instantiation of
   ``mlstm_chunk_bwd_sm90.cu`` (walks per NV and direction, A B^T per
   NT and hi/lo, the weight products per mode and NT).
3. ``kernel``: each kernel against its plain PyTorch version on the
   card, ``torch.equal`` on random tiles at the paper tile (rf 2, 3, 4;
   n_pad 155 and 160; rosters, extras and counts on and off), the packed
   kernels against the unpacked ones on the same state; ``pac_eval``,
   ``downtime_eval`` (with and without its counts), ``node_count``,
   ``latency_charge``, ``fused_downtime_eval`` and
   ``fused_pac_eval`` also on the edges of their tiling
   (``mc_check``: ragged last tiles and blocks, n_pad 31 and 63, inputs
   as views at a byte offset, voters across a word and past n_real, W 1 /
   5 / 8 / 9 with a ragged P and active all false or all true; for the
   counts, tiles across trials, B 1 / 8 / 9, n_real 1 to 300, the ids
   that count nowhere and every row on node 0), where
   each planted fault of their sources must fail a case (``pac_eval``
   its own, ``mc_check.PAC_FAULTS``; ``fused_pac_eval`` the
   ``fused_downtime.cu`` faults of its code, ``mc_check.
   FUSED_PAC_FAULTS``); plus each kernel's time per call beside the
   plain version's
   (``kernel_time``: ``ms`` back-to-back launches by CUDA events, and for
   the Monte Carlo kernels and ``rglru_scan`` ``device_ms`` from
   the profiler's kernel durations, ``graph_ms`` from a CUDA graph's
   replay and ``cold_ms`` with the L2 cold).
4. ``engine``: ``simulate_availability_batched`` on cuda, unpacked and
   packed, 512 steps with the trajectory kept.  The two runs must
   agree exactly, the first 128 steps must equal a ``device="cpu"`` run,
   and both §5.1 kernels must have launched over this path.
5. ``bench_row``: the BENCH_sweep i.i.d. row and the hetero-mttf row at
   rf = 2, p = 1e-3, rebuilt by the port's runner on cuda, packed and
   unpacked, must equal the committed rows of
   ``benchmarks/BENCH_sweep.json`` byte for byte.
6. ``downtime``: ``simulate_downtime_batched`` on cuda at rf = 2,
   p = 1e-3, 512 steps with the trajectory kept, for the fixed model
   (default knobs, and with 1 GiB/s shared bandwidth) and for reconfig
   with zipf sizes (skew 1) and 1 GiB/s shared bandwidth, each unpacked
   and packed; the layouts must agree exactly, each §6 kernel of a
   configuration must have launched over its run (under shared bandwidth
   the counts mode of ``downtime_eval``, and ``node_count`` alone
   never), and a 128-step run on cuda must equal the same run on the
   CPU.
7. ``downtime_bench_row``: the i.i.d. row at rf = 2, p = 3e-3 of
   BENCH_downtime.json, BENCH_downtime_reconfig.json and
   BENCH_downtime_skew.json, rebuilt on cuda, packed and unpacked, must
   equal the committed row byte for byte.
8. ``latency``: ``simulate_client_latency`` on cuda at rf = 2, p = 1e-3,
   the fixed model, 512 steps, unpacked and packed; the layouts must
   agree exactly, ``latency_charge`` must have launched on this path
   (and the §6 eval kernels beside it), and a 128-step run on cuda must
   equal the same run on the CPU.  ``latency_charge`` itself is held
   against its plain version in phase 3, on adversarial inputs.
9. ``zoo``: the reconfig engine with hermes and spinnaker
   (lease_ticks = 40, view_change_ticks = 200) at the same tile, the same
   checks.
10. ``zoo_bench_row``: the i.i.d. rf = 2, p = 3e-3 row of
   BENCH_latency.json and the three rows of that grid point in
   BENCH_shootout.json (downtime, hermes, spinnaker), rebuilt on cuda,
   packed and unpacked, byte for byte.
11. ``mlstm`` / ``kernel_time``: ``mlstm_chunkwise`` against
   ``mlstm_chunkwise_plain`` on both CUDA sources at the xlstm-350m serve
   shape (B = 4, H = 4, S = 1024, Dq = Dv = 512, chunk 256) in bf16 and
   f32, a ragged S = 1000, a carried-in state, and gates that make the
   stabilizer matter (log_f near 0, log_i over +-10): h and the final
   (C, n, m), element by element within what float32 rounding allows
   (``repro_torch.kernels.mlstm_check``), and a bitwise repeat.  The
   entry point takes the bf16 cases on the sm90 source
   (``mlstm_chunk_sm90.cu``) and the f32 case on the simt source
   (``mlstm_chunk.cu``), each route's launches counted; the simt source
   also runs the bf16 cases by its launcher; each planted fault of each
   source must fail a case.  Then both sources' times, and each kernel of
   the sm90 source on its own.
12. ``serve``: xlstm-350m at full width (24 layers, d_model 1024, vocab
   50304, bf16, random weights from seed 0) serves 4 prompts of 1024
   tokens from ``SyntheticLMData`` through ``ServeLoop``: 32 tokens with
   a session checkpoint every 8 into a ``LarkSessionStore`` (4 nodes,
   rf 2), ``fail_server(0)``, 8 more from the store; the resumed tokens
   must equal an uninterrupted 40-token run bitwise, every logit must be
   finite, and ``mlstm_chunkwise`` must launch 21 times per prefill on
   the sm90 route, never on the simt route, with the plain version
   never run.  Prints prefill and decode tokens/s
   (one of each warms up first).
13. ``serve_cpu``: the reduced xlstm config (float32: the simt route)
   through the same path on the CPU (plain) and on the card (kernel):
   prefill logits within a stated tolerance, and equal tokens.
14. ``rglru`` / ``kernel_time``: ``rglru_scan`` against
   ``rglru_scan_plain`` on the card at the recurrentgemma-9b serve shape
   (B = 4, S = 3072, W = 4096), a ragged S = 3000 with W = 4000, the
   RG-LRU block's own gate range, and log_a near 0 and far below it:
   every element within its float32 rounding allowance against the
   plain version in float64 (``rglru_check``), and a bitwise repeat; each
   planted fault (run on outputs filled with NaN) must fail at least one
   case.  Then its time: ``ms``, and the device and L2-cold times of the
   launch that ``rglru_check --parent`` times.
15. ``flash`` / ``kernel_time``: ``ops.flash_attention`` (the kernel's
   entry point; no model path calls it, as in the reference) against
   ``flash_attention_plain`` on both CUDA sources.  At the local-attention
   shape (B = 4, 16 heads, S = 3072, D = 256, bf16, causal, window 2048),
   window 0, a ragged S = 3000 and scores spread x30 the entry point
   takes the sm90 source (``flash_attention_sm90.cu``); the simt source
   (``flash_attention.cu``) runs the same cases by its launcher, and a
   float32 and a D = 32 case through the entry point.  Every element
   within its allowance against the plain version on float64 copies
   (``flash_check``), a bitwise repeat, each route's launches counted,
   the plain version never run, and each planted fault of each source
   failing a case.  Then both sources' times beside
   ``F.scaled_dot_product_attention``'s with the same boolean mask and
   with ``is_causal``.
16. ``serve_rg``: recurrentgemma-9b at full width and depth (38 layers,
   d_model 4096, vocab 256000, bf16 with float32 RG-LRU gates, random
   weights from seed 0) serves 4 prompts of 3072 tokens (past the 2048
   window, so the ring wraps) through ``ServeLoop``: 32 tokens with a
   checkpoint every 8, ``fail_server(0)``, 8 more from the store; bitwise
   equal to an uninterrupted 40-token run, finite logits, and
   ``rglru_scan`` launched 26 times per prefill with its plain version
   never run.  Prints prefill and decode tokens/s, the decode state's
   bytes and the peak of device memory.
17. ``serve_rg_cpu``: a 5-layer reduced recurrentgemma (the remainder
   segment included) on the CPU (plain) and on the card (kernel), a
   48-token prompt over the 32-token window: prefill logits within a
   stated tolerance, and equal tokens.
18. ``microsim`` / ``microsim_tables``: ``microsim_scan`` against
   ``_simulate_batch_plain`` on the card, all 12 grid rows of Tables 3
   and 4, LARK and baseline, ``torch.equal`` on every output, at the
   paper's constants over 2,600 ticks and with a short outage (failure
   at 200, return at 1,200, partitions 1,000 times smaller) over 4,000
   ticks, one launch a table and one of both tables' grids together;
   each planted fault (``microsim_scan.FAULTS``: the outage count
   unfused, the RTT dropped, the key chain read a tick late, a lane's
   partial dropped from the warp sum) must fail a case; one dependent
   Threefry hash's latency, times 520,000, the key chain's floor.  Then
   the main path: both tables at 520,000 ticks through
   ``microsim_tables.run``, one launch for both and the plain loop never
   run, whose 24 lines must equal
   ``experiments/microsim_tables_ref.csv`` (the reference's own output)
   byte for byte; the launch's device time (its memset and kernel, every
   event of a run counted, profiled again if one was lost), the check
   case's time per table and the plain loop's per tick; and the runner's
   two smoke rows under backend "event" (the scalar §5.1 engine, host
   numpy) equal to the reference's, pinned in ``EVENT_SMOKE_ROWS``.
19. ``serve_dense``: smollm-360m (the reference's serve default) at full
   width and depth (32 layers, d_model 960, 15 heads over 5 KV heads of
   64, vocab 49152, bf16, tied embeddings, seed-0 weights) with the serve
   phase's traffic: 4 prompts of 1024 tokens, 32 greedy tokens with a
   checkpoint every 8, ``fail_server(0)``, 8 more; tokens and every decode
   step's logits bitwise equal to an uninterrupted run, finite logits.
   Prints prefill and decode tokens/s, parameter and KV-cache bytes.
20. ``families``: internlm2-20b (48 layers), minicpm3-4b (62, MLA),
   qwen2-vl-2b (28, M-RoPE over embeddings), whisper-small (12 + 12),
   mixtral-8x7b, qwen3-moe-235b-a22b and nemotron-4-340b (each cut to 2
   layers: the card cannot hold their weights), every width as in the
   config, bf16, seed-0 weights.  4 prompts of 1024 (mixtral 2 of 5120,
   past its 4096 window; whisper 256 tokens over 1500 stub frames, served
   through ``ServeLoop`` with a failover, bitwise; qwen2-vl decoding the
   data's next embeddings through ``decode_step``), 8 greedy decode
   steps.  Checks: (a) every logit finite; (b) the decode logits at S-1
   after a prefill of S-1 within ``DECODE_TOL`` of the largest logit of
   a prefill of S (MoE with its capacity taking every slot), and a decode
   one position off beyond it; (c) the reduced float32 config on the card
   against the CPU, logits within rtol 1e-3 / atol 1e-3 of the largest
   and greedy ids equal.  Prints every depth cut, tokens/s and bytes.
   No kernel runs on these paths (attention is the dense masked softmax,
   as in the reference), and none may launch.
21. ``rglru_bwd`` / ``kernel_time``: ``rglru_scan_bwd``
   (csrc/rglru_scan_bwd.cu) against ``rglru_scan_bwd_plain`` in float64
   on ``rglru_check.BWD_CASES`` (the train shape B = 2, S = 2048,
   W = 4096; ragged S and W; S below the chunk; S = 1; the reduced
   width; long memory; log_a near 0, where 1 - exp(2 log_a) rounds to 0),
   every element within ``rglru_check.rglru_bwd_allowance``, a bitwise
   repeat, each planted fault (``rglru_check.BWD_FAULTS``) failing a
   case; its time at each of ``rglru_check.BWD_TIMED_SHAPES``: B = 2,
   and B = 1, the train path's microbatch, whose record the kernels line
   carries.
22. ``mlstm_bwd`` / ``kernel_time``: ``mlstm_chunkwise_bwd`` against
   ``mlstm_chunkwise_bwd_plain`` in float64 on ``mlstm_check.BWD_CASES``
   (the train shape B = 4, H = 4, S = 1024, Dq = Dv = 512, chunk 256 in
   bf16 and float32, the reduced float32 shapes, ragged S, S below the
   chunk, S = 1, head dims and a chunk off the tile, the stabilizer
   stress, rows where the clamp holds, and sm90 shapes off the 256 grid:
   Dq 128 / Dv 192 at chunk 128, Dq 320 at chunk 192, chunk 1024), within
   ``mlstm_check.mlstm_bwd_rounding_scale``, through the entry point
   (``mlstm_chunk.bwd_route``: the bf16 cases at 64-multiple dims on
   csrc/mlstm_chunk_bwd_sm90.cu, the rest on csrc/mlstm_chunk_bwd.cu)
   with a bitwise repeat and each route's launches counted, and the SIMT
   source by its launcher on every case its shared memory holds; each
   source's planted faults (``mlstm_check.BWD_FAULTS``,
   ``BWD_FAULTS_SM90``, ``w_lo_dropped`` among them) failing a case; each
   source's time at its main path's shape (sm90: the xlstm-350m train
   shape in bf16; SIMT: the reduced xlstm's, B = 2, H = 4, S = 300,
   Dq = Dv = 32, float32).
23. ``train``, ``train_rg``, ``train_dense``: ``make_train_step`` (AdamW,
   remat as configured) on xlstm-350m (24 layers, B = 4, S = 1024, 4
   steps), recurrentgemma-9b at full width cut to 3 layers (B = 2,
   S = 2048, 4 steps in 2 microbatches) and smollm-360m (32 layers,
   B = 4, S = 1024, 8 steps), bf16, seed-0 weights, ``SyntheticLMData``.
   Off the main path, step 0: every gradient leaf finite and not all
   zero, the step again bitwise equal (torch's deterministic algorithms
   on), and the step with the cells' plain forward and backward within
   ``LOSS_ATOL`` / ``GRAD_RTOL`` / ``GRAD_FLOOR``.  The main path (counters
   at 0 first): the steps, a checkpoint every 2 into a LARK store and a
   quorum-log store (4 workers, rf 2), worker 3 lost mid-run; the cells'
   forward kernels launched (remat recomputes included) and backward
   kernels as predicted, the plain versions never; LARK committing every
   checkpoint, the baseline pausing.  Prints the loss per step, warm
   ms per step and train tokens/s, peak memory, and the kernels' shares
   of one profiled step's device time, beside the card's name and power
   limit.
24. ``train_cpu``: the reduced xlstm (float32) and 5-layer reduced
   recurrentgemma: loss and every gradient leaf on the card against the
   CPU within the tests' whole-model tolerance; the main path of the
   SIMT mLSTM backward (float32), whose launches it counts.
25. ``elastic``: the reduced xlstm on the card through
   ``ElasticTrainer``: checkpoint, a worker leaves, restore, continue;
   bitwise equal to an uninterrupted run.
26. ``sharded``: the Monte Carlo's trials over worlds of 2 and 4 ranks
   on the one card (``torch.multiprocessing`` spawn, ``gloo`` through a
   ``file://`` store, ``devices = 8``): every path of phases 4, 6, 8 and
   9, unpacked and packed, on every rank equal to those phases' own
   one-process runs in every field and trajectory, every kernel of the
   path launched on every rank (at 4 and 2 trials a grid); a §5.1 run
   with the early stop live (default min_ticks, p = 2e-4) stopping at
   the same step in 4 ranks as in one process.  Prints each rank's
   steps/s and the spawn cost (start to a ready CUDA context).
27. ``train_dp``: smollm-360m at full width and depth in float32, 4 x
   1024 tokens, 2 steps: one process, then 2 ranks on the card each
   taking 2 rows through ``make_train_step``'s data parallelism (gloo
   all-reduce of the gradients): the loss, grad norm and every parameter
   leaf within the float32 reduction-order tolerance of
   ``tests/test_torch_train_dp.py``, the ranks' replicas equal.
28. ``tp``: recurrentgemma-9b at full width cut to ``train_rg``'s 3
   layers, bf16, seed 0, tensor-parallel over a (1, 2) ("data", "model")
   mesh of 2 ranks on the card (gloo, DTensor parameters under the
   reference's specs) against one process on the card, run first and
   saved: a prefill of 1 x 2048 tokens, 8 greedy decode steps, then 2
   AdamW steps on 1 x 2048.  Held: the prefill and decode logits within
   ``DECODE_TOL`` of the largest logit, the greedy tokens equal, the
   loss and grad norm within rtol 1e-3, every parameter leaf within 2 %
   of its largest magnitude; each rank launches ``rglru_scan`` and
   ``rglru_scan_bwd`` at the local width 2048, as often as the one
   process does at 4096; both kernels at the local shape (1, 2048, 2048),
   on the RG-LRU block's own gates, each element within its
   ``rglru_check`` allowance of the plain version in float64.  Prints
   each rank's step ms beside the one process's and the kernels' µs at
   the local shape; the phase must end within ``TP_BOX_S``.
29. ``kernels``: every ported kernel with its launches on its main path,
   time, plain time, bound, error and, where one PyTorch call computes
   the same function, that call's time.  ``node_count``'s launches are
   those of the counts mode, which does its work on the main path; its
   time is node_count alone.

Any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS's deterministic workspace, read when cuBLAS starts: the train
# phases check that a step repeats bit for bit
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch import microsim_tables, tree  # noqa: E402
from repro_torch.checkpoint import LarkStore, QuorumLogStore  # noqa: E402
from repro_torch.configs.base import MLSTM, RGLRU  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import availability_batched as ab  # noqa: E402
from repro_torch.core import client_latency as cl  # noqa: E402
from repro_torch.core import downtime_batched as db  # noqa: E402
from repro_torch.core import microsim  # noqa: E402
from repro_torch.experiments import runner  # noqa: E402
from repro_torch.experiments.spec import ExperimentSpec  # noqa: E402
from repro_torch.kernels import _build, bitpack, ops  # noqa: E402
from repro_torch.kernels import fused_step as fk  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_check as fc  # noqa: E402
from repro_torch.kernels import mc_check as mcc  # noqa: E402
from repro_torch.kernels import mlstm_check as mc  # noqa: E402
from repro_torch.kernels import microsim_scan as msk  # noqa: E402
from repro_torch.kernels import mlstm_chunk as mk  # noqa: E402
from repro_torch.kernels import pac_eval as pk  # noqa: E402
from repro_torch.kernels import rglru_check as rc  # noqa: E402
from repro_torch.kernels import rglru_scan as rk  # noqa: E402
from repro_torch.models import (batch_prefix, build_model,  # noqa: E402
                                decode_input)
from repro_torch.serving import LarkSessionStore, ServeLoop  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa
from repro_torch.profile_train import (leaf_distances,  # noqa: E402
                                       plain_cells, profile_step)
from repro_torch.training import (ElasticTrainer,  # noqa: E402
                                  accumulate_grads, make_train_step)

#: paper tile (runner.py --full scale): nodes, partitions, trials
N, P, B = 155, 4096, 8
#: steps of each Monte Carlo main-path run, in chunks of MC_CHUNK steps
#: (2048 steps in 512-step chunks until the sharded phase reused these
#: runs as its one-process side): every main path and every sharded
#: path crosses three chunk boundaries, where the drains, the gathers
#: across ranks and the accumulator resets run
MC_STEPS, MC_CHUNK = 512, 128
DEVICE = "cuda"
#: published HBM rates by card (NVIDIA data sheets), bytes/s
HBM_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
          "H100": 3.35e12}
#: 32-bit integer lane rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT_OPS = 132 * 64 * 1.98e9
#: integer ops per element, counted from the kernels' inner loops:
#: pac_eval / downtime_eval per (row, column) byte lane, fused kernels
#: per word, node_count per partition
OPS_PER_LANE = {"pac_eval": 10, "fused_pac_eval": 16, "downtime_eval": 12,
                "downtime_eval_roster": 12, "downtime_eval_counts": 12,
                "downtime_eval_roster_counts": 12, "node_count": 6,
                "fused_downtime_eval": 20}
#: where each kernel's source lives and which TPU kernel body it replaces
SOURCES = {
    "pac_eval": ("src/repro_torch/kernels/csrc/downtime_eval.cu",
                 "src/repro/kernels/pac_eval.py:23"),
    "fused_pac_eval": ("src/repro_torch/kernels/csrc/fused_downtime.cu",
                       "src/repro/kernels/fused_step.py:62"),
    "downtime_eval": ("src/repro_torch/kernels/csrc/downtime_eval.cu",
                      "src/repro/kernels/pac_eval.py:87"),
    "downtime_eval_roster": ("src/repro_torch/kernels/csrc/downtime_eval.cu",
                             "src/repro/kernels/pac_eval.py:131"),
    "downtime_eval_counts": ("src/repro_torch/kernels/csrc/downtime_eval.cu",
                             "src/repro/kernels/pac_eval.py:87"),
    "downtime_eval_roster_counts": (
        "src/repro_torch/kernels/csrc/downtime_eval.cu",
        "src/repro/kernels/pac_eval.py:131"),
    "node_count": ("src/repro_torch/kernels/csrc/downtime_eval.cu",
                   "src/repro/kernels/pac_eval.py:200"),
    "fused_downtime_eval": ("src/repro_torch/kernels/csrc/fused_downtime.cu",
                            "src/repro/kernels/fused_step.py:121"),
    "latency_charge": ("src/repro_torch/kernels/csrc/latency_charge.cu",
                       "src/repro/kernels/pac_eval.py:263"),
    "mlstm_chunkwise": ("src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                        "src/repro/kernels/mlstm_chunk.py:22"),
    "mlstm_chunkwise_sm90": (
        "src/repro_torch/kernels/csrc/mlstm_chunk_sm90.cu",
        "src/repro/kernels/mlstm_chunk.py:22"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:20"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:27"),
    "flash_attention_fwd_sm90": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:27"),
    "microsim_scan": ("src/repro_torch/kernels/csrc/microsim_scan.cu",
                      "repro/core/microsim.py: _simulate_batch (lax.scan)"),
    "rglru_scan_bwd": (
        "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
        "src/repro/kernels/rglru_scan.py:47 (its gradient: no Pallas "
        "backward; jax.value_and_grad through ref.rglru_scan_ref)"),
    "mlstm_chunkwise_bwd": (
        "src/repro_torch/kernels/csrc/mlstm_chunk_bwd.cu",
        "src/repro/kernels/mlstm_chunk.py:76 (its gradient: no Pallas "
        "backward; jax.value_and_grad through ref.mlstm_chunkwise)"),
    "mlstm_chunkwise_bwd_sm90": (
        "src/repro_torch/kernels/csrc/mlstm_chunk_bwd_sm90.cu",
        "src/repro/kernels/mlstm_chunk.py:76 (its gradient: no Pallas "
        "backward; jax.value_and_grad through ref.mlstm_chunkwise)"),
}
#: dense peak float rates of one H100 SXM (NVIDIA data sheet, 700 W) by
#: the mLSTM kernel's input type: bf16 on the tensor cores, f32 on the
#: CUDA cores (f32 work has no faster exact path)
FLOAT_PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: the serve phase: xlstm-350m, 4 prompts of 1024 tokens, 32 tokens then
#: 8 more after a failover, a session checkpoint every 8 tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_RESUME = 4, 1024, 32, 8
#: the recurrentgemma serve phase: 4 prompts of 3072 tokens (past the
#: 2048-token window, under mha's dense limit), then as above
RG_PROMPT = 3072
#: the reference runner's two smoke-spec rows under its default backend
#: "event" (the scalar §5.1 engine), serialized as the runner dumps them;
#: tests/test_torch_event.py holds these strings against the reference
EVENT_SMOKE_ROWS = [
    '{"analytic_ratio": 3, "analytic_u_lark": 0.0008483363182203787, '
    '"ci_lark": 0.00017649349208520115, "ci_maj": 0.00043866468406298124, '
    '"kind": "iid", "p": 0.003, "ratio": 2.6925714285714286, "rf": 2, '
    '"ticks": 15002, "u_lark": 0.000911336821757099, '
    '"u_maj": 0.0024538394880682574}',
    '{"analytic_ratio": 10, "analytic_u_lark": 0.0007513148009015778, '
    '"ci_lark": 0.00013314734214479014, "ci_maj": 0.0006493328557669195, '
    '"kind": "iid", "p": 0.01, "ratio": 8.233144621718992, "rf": 3, '
    '"ticks": 20003, "u_lark": 0.0007588705444183373, '
    '"u_maj": 0.006247890941358796}']
#: the sources whose planted faults the kernel, mlstm, rglru and flash
#: phases run: (faults, C symbol or symbols, argtypes)
FAULT_SOURCES = {**{src: (faults, mcc.SYMBOLS[src], mcc.ARGTYPES[src])
                    for src, faults in mcc.FAULTS.items()},
                 "rglru_scan": (rc.FAULTS, "rglru_scan_launch",
                                rk._ARGTYPES),
                 "microsim_scan": (msk.FAULTS, "microsim_scan_launch",
                                   msk._ARGTYPES),
                 "rglru_scan_bwd": (rc.BWD_FAULTS, "rglru_scan_bwd_launch",
                                    rk.BWD_ARGTYPES),
                 **{src: (faults, *mk.BWD_ROUTES[mc.BWD_SOURCE_ROUTE[src]][1:])
                    for src, faults in mc.BWD_SOURCE_FAULTS.items()},
                 **{src: (faults, *fa.ROUTES[fc.SOURCE_ROUTE[src]][1:])
                    for src, faults in fc.FAULTS.items()},
                 **{src: (faults, *mk.ROUTES[mc.SOURCE_ROUTE[src]][1:])
                    for src, faults in mc.FAULTS.items()}}


#: the script's start, for each emitted line's seconds since it
T_START = time.monotonic()


def emit(obj):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": time.monotonic() - T_START},
                     sort_keys=True), flush=True)


def hbm_bw(name: str) -> float:
    for key, bw in HBM_BW.items():
        if key in name:
            return bw
    raise RuntimeError(f"no HBM rate on record for {name!r}")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
        err = max(err, float(d))
    return err


def check_kernels(bw, faults, fused_faults):
    """Phase 3: bitwise agreement with the plain versions at the paper
    tile, ``pac_eval`` on the edges of its tiling (``mc_check.
    pac_checks``) with each of ``mc_check.PAC_FAULTS`` (copies of
    downtime_eval.cu in `faults`) failing a case, ``fused_pac_eval`` on
    ``mc_check.FUSED_PAC_CASES`` (W 1, 5, 8 and 9, voters across a word
    and past n_real) with each of ``mc_check.FUSED_PAC_FAULTS`` (copies
    of fused_downtime.cu in `fused_faults`) failing one, and per-call
    times.  Returns the timing/bound records."""
    dev = torch.device(DEVICE)
    worst = {"pac_eval": 0.0, "fused_pac_eval": 0.0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    R = B * P
    for n_pad in (155, 160):
        for rf in (2, 3, 4):
            voters = 2 * (rf - 1) + 1
            up = torch.rand((R, n_pad), generator=gen, device=dev) < 0.9
            full = torch.rand((R, n_pad), generator=gen, device=dev) < 0.3
            got = pk.pac_eval(up, full, rf=rf, voters=voters, n_real=N)
            torch.cuda.synchronize()
            want = pk.pac_eval_plain(up, full, rf=rf, voters=voters,
                                     n_real=N)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            # the packed kernel on the same state gives the same bits
            upw = bitpack.pack_words(up.reshape(B, P, n_pad)) \
                .movedim(-1, 1).contiguous()
            fullw = bitpack.pack_words(full.reshape(B, P, n_pad)) \
                .movedim(-1, 1).contiguous()
            pgot = fk.fused_pac_eval(upw, fullw, rf=rf, voters=voters,
                                     n_real=N)
            torch.cuda.synchronize()
            creps_w = bitpack.pack_words(got[2].reshape(B, P, n_pad)) \
                .movedim(-1, 1)
            ok = ok and torch.equal(pgot[0].reshape(R), got[0]) \
                and torch.equal(pgot[1].reshape(R), got[1]) \
                and torch.equal(pgot[2], creps_w)
            err = max_abs_err(got, want)
            worst["pac_eval"] = max(worst["pac_eval"], err)
            emit({"phase": "kernel", "kernel": "pac_eval", "n_pad": n_pad,
                  "rf": rf, "equal": ok, "max_abs_err": err,
                  "lark_frac": got[0].float().mean().item()})
            if not ok:
                raise SystemExit(f"pac_eval disagrees (n_pad={n_pad}, "
                                 f"rf={rf})")
    W = bitpack.n_words(N)
    for rf in (2, 3, 4):
        voters = 2 * (rf - 1) + 1
        # words with every bit pattern, bit 31 included
        upw = torch.randint(-2 ** 31, 2 ** 31, (B, W, P), generator=gen,
                            device=dev, dtype=torch.int64).to(torch.int32)
        fullw = torch.randint(-2 ** 31, 2 ** 31, (B, W, P), generator=gen,
                              device=dev, dtype=torch.int64) \
            .to(torch.int32)
        got = fk.fused_pac_eval(upw, fullw, rf=rf, voters=voters, n_real=N)
        torch.cuda.synchronize()
        want = fk.fused_pac_eval_plain(upw, fullw, rf=rf, voters=voters,
                                       n_real=N)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max_abs_err(got, want)
        worst["fused_pac_eval"] = max(worst["fused_pac_eval"], err)
        emit({"phase": "kernel", "kernel": "fused_pac_eval", "W": W,
              "rf": rf, "equal": ok, "max_abs_err": err,
              "lark_frac": got[0].float().mean().item()})
        if not ok:
            raise SystemExit(f"fused_pac_eval disagrees (rf={rf})")
    caught = {name: [] for name in mcc.PAC_FAULTS}
    for rec in mcc.pac_checks(gen, {f: faults[f] for f in caught}):
        emit({"phase": "kernel", **rec})
        worst["pac_eval"] = max(worst["pac_eval"], rec["max_abs_err"])
        if not rec["equal"]:
            raise SystemExit(f"pac_eval disagrees ({rec['case']}, "
                             f"rf={rec['rf']}, voters={rec['voters']})")
        for f in rec["faults_failed"]:
            caught[f].append(f"{rec['case']}:rf{rec['rf']}:v{rec['voters']}")
    held_faults("pac_eval", caught)
    caught = {name: [] for name in mcc.FUSED_PAC_FAULTS}
    for rec in mcc.fused_pac_checks(gen, {f: fused_faults[f]
                                          for f in caught}):
        emit({"phase": "kernel", **rec})
        worst["fused_pac_eval"] = max(worst["fused_pac_eval"],
                                      rec["max_abs_err"])
        if not rec["equal"]:
            raise SystemExit(f"fused_pac_eval disagrees ({rec['case']}, "
                             f"rf={rec['rf']}, voters={rec['voters']})")
        for f in rec["faults_failed"]:
            caught[f].append(f"{rec['case']}:rf{rec['rf']}:v{rec['voters']}")
    held_faults("fused_pac_eval", caught)

    # times at the main path's shapes: rf = 2, n_pad = n = 155 unpacked,
    # (8, 5, 4096) words packed.  The raw launcher is timed (the kernel),
    # and the wrapper (checks + allocation + launch) beside it.
    rf, voters = 2, 3
    up = torch.rand((R, N), generator=gen, device=dev) < 0.9
    full = torch.rand((R, N), generator=gen, device=dev) < 0.3
    upw = bitpack.pack_words(up.reshape(B, P, N)).movedim(-1, 1).contiguous()
    fullw = bitpack.pack_words(full.reshape(B, P, N)) \
        .movedim(-1, 1).contiguous()
    outs = pk.pac_eval(up, full, rf=rf, voters=voters, n_real=N)
    raw = _build.function("downtime_eval", "pac_eval_launch", pk._ARGTYPES)
    ptrs = [t.data_ptr() for t in (up, full, *outs)]

    def pac_launch(stream):
        return raw(*ptrs, R, N, N, rf, voters, stream)

    pac_ms = mcc.event_ms(pac_launch)
    pac_wrap_ms = time_ms(lambda: pk.pac_eval(up, full, rf=rf,
                                              voters=voters, n_real=N), 200)
    pac_plain_ms = time_ms(lambda: pk.pac_eval_plain(
        up, full, rf=rf, voters=voters, n_real=N), 20)
    fouts = fk.fused_pac_eval(upw, fullw, rf=rf, voters=voters, n_real=N)
    fraw = _build.function("fused_downtime", "fused_pac_eval_launch",
                           fk._ARGTYPES)
    fptrs = [t.data_ptr() for t in (upw, fullw, *fouts)]

    def fused_launch(stream):
        return fraw(*fptrs, B, W, P, N, rf, voters, stream)

    fused_ms = mcc.event_ms(fused_launch)
    fused_wrap_ms = time_ms(lambda: fk.fused_pac_eval(
        upw, fullw, rf=rf, voters=voters, n_real=N), 200)
    fused_plain_ms = time_ms(lambda: fk.fused_pac_eval_plain(
        upw, fullw, rf=rf, voters=voters, n_real=N), 20)

    pac_bytes = mcc.pac_bytes(R, N)
    fused_bytes = mcc.fused_pac_bytes(B, W, P)
    return {
        "pac_eval": record("pac_eval", pac_bytes, R * N, pac_ms, pac_wrap_ms,
                           pac_plain_ms, worst["pac_eval"], bw,
                           launch=pac_launch),
        "fused_pac_eval": record("fused_pac_eval", fused_bytes, B * W * P,
                                 fused_ms, fused_wrap_ms, fused_plain_ms,
                                 worst["fused_pac_eval"], bw,
                                 launch=fused_launch)}


def record(name, nbytes, lanes, ms, wrap_ms, plain_ms, err, bw, ops=None,
           rate=INT_OPS, launch=None, events=None, shape=None):
    """One kernel's timing record: its bound is the larger of its bytes
    over the HBM rate and its ops (`ops`, or lanes x OPS_PER_LANE) over
    `rate` (the 32-bit lane rate unless given).  `ms` is back-to-back
    launches by CUDA events, launch rate and device time together; with
    `launch` (one raw launch on a given stream) the record adds
    ``mc_check.device_times``: device_ms (the profiler's kernel duration),
    graph_ms (a CUDA graph's replay) and cold_ms (L2 cold).  `shape`, where
    given, tags the emitted line."""
    bytes_ms = nbytes / bw * 1e3
    if ops is None:
        ops = lanes * OPS_PER_LANE[name]
    ops_ms = ops / rate * 1e3
    rec = {"ms": ms, "wrapper_ms": wrap_ms, "plain_ms": plain_ms,
           "max_abs_err": err, "bytes": nbytes,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if launch is not None:
        rec.update(mcc.device_times(launch, events=events))
    if shape is not None:
        rec["shape"] = list(shape)
    emit({"phase": "kernel_time", "kernel": name, **rec})
    return rec


def random_rosters(gen, R, rf, dev):
    """(R, rf) int32 rosters of distinct ranks in [0, N), some seats out of
    range (those read as down)."""
    ro = torch.argsort(torch.rand((R, N), generator=gen, device=dev),
                       dim=1)[:, :rf].to(torch.int32)
    ro[::7, 0] = N + 3
    return ro.contiguous()


def check_downtime_kernels(bw, faults, fused_faults):
    """Phase 3 for the §6 kernels: bitwise agreement with the plain
    versions at the paper tile (the counts mode and node_count alone
    among them), packed against unpacked, then ``downtime_eval`` on the
    edges of its tiling (``mc_check.DOWNTIME_CASES``: a ragged last tile,
    n_pad 31 and 63, views at a byte offset) with each planted fault of
    its source (`faults`) failing a case, the counts mode and node_count
    on ``mc_check.COUNTS_CASES`` (tiles across trials, B 1 / 8 / 9,
    n_real 1 to 300, the ids that count nowhere, every row on node 0)
    with each of ``mc_check.COUNTS_FAULTS`` failing one,
    ``fused_downtime_eval`` on ``mc_check.FUSED_CASES`` (W 1, 5, 8 and 9,
    a ragged P, rosters at an offset, active all false and all true) with
    each of its source's (`fused_faults`), and times at the §6 main
    path's shapes.  Returns the timing/bound records."""
    dev = torch.device(DEVICE)
    names = ("downtime_eval", "downtime_eval_roster", "downtime_eval_counts",
             "downtime_eval_roster_counts", "node_count",
             "fused_downtime_eval")
    worst = dict.fromkeys(names, 0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    R, W = B * P, bitpack.n_words(N)

    def agree(name, got, want, **tags):
        ok = len(got) == len(want) and \
            all(torch.equal(g, w) for g, w in zip(got, want))
        err = max_abs_err(got, want)
        worst[name] = max(worst[name], err)
        emit({"phase": "kernel", "kernel": name, "equal": ok,
              "max_abs_err": err, **tags})
        if not ok:
            raise SystemExit(f"{name} disagrees ({tags})")

    for n_pad in (155, 160):
        for rf in (2, 3, 4):
            up = torch.rand((R, n_pad), generator=gen, device=dev) < 0.9
            full = torch.rand((R, n_pad), generator=gen, device=dev) < 0.3
            up[:64] = False                   # rows with no node up
            roster = random_rosters(gen, R, rf, dev)
            rec = torch.randint(-2, N + 3, (B, P), generator=gen,
                                device=dev, dtype=torch.int32)
            act = torch.rand((B, P), generator=gen, device=dev) < 0.3
            want_cnt = pk.node_count_plain(rec, act, n_real=N)
            for with_roster in (False, True):
                for extras in (False, True):
                    kw = dict(rf=rf, n_real=N, want_repmask=extras,
                              want_rleader=extras and with_roster,
                              roster=roster if with_roster else None)
                    name = "downtime_eval_roster" if with_roster \
                        else "downtime_eval"
                    got = pk.downtime_eval(up, full, **kw)
                    counted = pk.downtime_eval(up, full, recruit=rec,
                                               active=act, **kw)
                    torch.cuda.synchronize()
                    want = pk.downtime_eval_plain(up, full, **kw)
                    agree(name, got, want, n_pad=n_pad, rf=rf, extras=extras)
                    agree(name + "_counts", counted, want + (want_cnt,),
                          n_pad=n_pad, rf=rf, extras=extras)
            # packed on the same state, roster, counts: the same bits
            upw = bitpack.pack_words(up.reshape(B, P, n_pad)) \
                .movedim(-1, 1).contiguous()
            fullw = bitpack.pack_words(full.reshape(B, P, n_pad)) \
                .movedim(-1, 1).contiguous()
            flat = pk.downtime_eval(up, full, rf=rf, n_real=N, roster=roster,
                                    want_repmask=True, want_rleader=True,
                                    recruit=rec, active=act)
            cnt = pk.node_count(rec, act, n_real=N)
            packed = fk.fused_downtime_eval(
                upw, fullw, rf=rf, n_real=N,
                roster=roster.reshape(B, P, rf), recruit=rec, active=act,
                want_repmask=True, want_rleader=True)
            torch.cuda.synchronize()
            creps_w = bitpack.pack_words(flat[-2].reshape(B, P, n_pad)) \
                .movedim(-1, 1)
            same = all(torch.equal(pw.reshape(R), f)
                       for pw, f in zip(packed[:7], flat[:7])) \
                and torch.equal(packed[7], creps_w) \
                and torch.equal(packed[8], flat[8])
            emit({"phase": "kernel", "kernel": "fused_downtime_eval",
                  "packed_equals_unpacked": same, "n_pad": n_pad, "rf": rf})
            if not same:
                raise SystemExit(f"packed and unpacked §6 kernels disagree "
                                 f"(n_pad={n_pad}, rf={rf})")
            agree("node_count", (cnt,), (want_cnt,), n_pad=n_pad, rf=rf)
    for rf in (2, 3, 4):
        # words with every bit pattern, bit 31 included
        upw = torch.randint(-2 ** 31, 2 ** 31, (B, W, P), generator=gen,
                            device=dev, dtype=torch.int64).to(torch.int32)
        fullw = torch.randint(-2 ** 31, 2 ** 31, (B, W, P), generator=gen,
                              device=dev, dtype=torch.int64) \
            .to(torch.int32)
        roster = random_rosters(gen, R, rf, dev).reshape(B, P, rf)
        rec = torch.randint(-2, N + 3, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)
        act = torch.rand((B, P), generator=gen, device=dev) < 0.3
        for with_roster in (False, True):
            for counts in (False, True):
                for extras in (False, True):
                    kw = dict(rf=rf, n_real=N, want_repmask=extras,
                              want_rleader=extras and with_roster,
                              roster=roster if with_roster else None)
                    if counts:
                        kw.update(recruit=rec, active=act)
                    got = fk.fused_downtime_eval(upw, fullw, **kw)
                    torch.cuda.synchronize()
                    agree("fused_downtime_eval", got,
                          fk.fused_downtime_eval_plain(upw, fullw, **kw),
                          rf=rf, roster=with_roster, counts=counts,
                          extras=extras)
    caught = {name: [] for name in mcc.DOWNTIME_FAULTS}
    for rec in mcc.downtime_checks(gen, {f: faults[f] for f in caught}):
        emit({"phase": "kernel", **rec})
        worst[rec["kernel"]] = max(worst[rec["kernel"]], rec["max_abs_err"])
        if not rec["equal"]:
            raise SystemExit(f"{rec['kernel']} disagrees ({rec['case']}, "
                             f"rf={rec['rf']})")
        for f in rec["faults_failed"]:
            caught[f].append(f"{rec['kernel']}:{rec['case']}:rf{rec['rf']}")
    held_faults("downtime_eval", caught)
    caught = {name: [] for name in mcc.COUNTS_FAULTS}
    for rec in mcc.counts_checks(gen, {f: faults[f] for f in caught}):
        emit({"phase": "kernel", **rec})
        worst[rec["kernel"]] = max(worst[rec["kernel"]], rec["max_abs_err"])
        if not rec["equal"]:
            raise SystemExit(f"{rec['kernel']} disagrees ({rec['case']})")
        for f in rec["faults_failed"]:
            caught[f].append(f"{rec['kernel']}:{rec['case']}")
    held_faults("downtime_eval counts", caught)
    caught = {name: [] for name in mcc.FUSED_DOWNTIME_FAULTS}
    for rec in mcc.fused_checks(gen, {f: fused_faults[f] for f in caught}):
        emit({"phase": "kernel", **rec})
        worst[rec["kernel"]] = max(worst[rec["kernel"]], rec["max_abs_err"])
        if not rec["equal"]:
            raise SystemExit(f"fused_downtime_eval disagrees ({rec['case']}, "
                             f"rf={rec['rf']}, roster={rec['roster']}, "
                             f"counts={rec['counts']})")
        for f in rec["faults_failed"]:
            caught[f].append(f"{rec['case']}:rf{rec['rf']}")
    held_faults("fused_downtime_eval", caught)

    # times at the §6 main path's shapes: rf = 2, n_pad = n = 155, the
    # state of a mostly-up cluster; the raw launchers are timed (the
    # kernels), the wrappers beside them
    rf = 2
    up = torch.rand((R, N), generator=gen, device=dev) < 0.99
    full = torch.rand((R, N), generator=gen, device=dev) < 0.02
    roster = random_rosters(gen, R, rf, dev)
    rec = torch.randint(0, N + 1, (B, P), generator=gen, device=dev,
                        dtype=torch.int32)
    act = torch.rand((B, P), generator=gen, device=dev) < 0.05
    upw = bitpack.pack_words(up.reshape(B, P, N)).movedim(-1, 1).contiguous()
    fullw = bitpack.pack_words(full.reshape(B, P, N)) \
        .movedim(-1, 1).contiguous()
    rost3 = roster.reshape(B, P, rf)
    times, launches = {}, {}
    for name, ro in (("downtime_eval", None),
                     ("downtime_eval_roster", roster)):
        sym = "downtime_eval_launch" if ro is None \
            else "downtime_roster_launch"
        raw = _build.function("downtime_eval", sym, pk._DT_ARGTYPES)
        launches[name], _ = mcc.downtime_launch(raw, up, full, ro, rf=rf)
        times[name] = (
            mcc.event_ms(launches[name]),
            time_ms(lambda: pk.downtime_eval(up, full, rf=rf, n_real=N,
                                             roster=ro), 200),
            time_ms(lambda: pk.downtime_eval_plain(up, full, rf=rf,
                                                   n_real=N, roster=ro), 20))
    # the counts mode at the bandwidth steps' shapes: 5 % of the rows in
    # flight on a node in [0, N] (N, the no-recruit sentinel, counts
    # nowhere); its plain version is the plain eval and the plain counts
    for name, ro in (("downtime_eval_counts", None),
                     ("downtime_eval_roster_counts", roster)):
        sym = "downtime_eval_counts_launch" if ro is None \
            else "downtime_roster_counts_launch"
        raw = _build.function("downtime_eval", sym, pk._DTC_ARGTYPES)
        launches[name], _ = mcc.counts_launch(raw, up, full, ro, rec, act,
                                              rf=rf)

        def plain(ro=ro):
            pk.downtime_eval_plain(up, full, rf=rf, n_real=N, roster=ro)
            pk.node_count_plain(rec, act, n_real=N)

        times[name] = (
            mcc.event_ms(launches[name]),
            time_ms(lambda ro=ro: pk.downtime_eval(
                up, full, rf=rf, n_real=N, roster=ro, recruit=rec,
                active=act), 200),
            time_ms(plain, 20))
    raw = _build.function("downtime_eval", "node_count_launch",
                          pk._NC_ARGTYPES)
    launches["node_count"], _ = mcc.node_count_launch(raw, rec, act)
    times["node_count"] = (
        mcc.event_ms(launches["node_count"]),
        time_ms(lambda: pk.node_count(rec, act, n_real=N), 200),
        time_ms(lambda: pk.node_count_plain(rec, act, n_real=N), 20))
    # the fused kernel at the reconfig-with-bandwidth shape (roster and
    # counts, the BENCH_downtime_skew step); the fixed model's shape (no
    # roster, no counts) is timed beside it
    fouts = fk.fused_downtime_eval(upw, fullw, rf=rf, n_real=N, roster=rost3,
                                   recruit=rec, active=act)
    fraw = _build.function("fused_downtime", "fused_downtime_eval_launch",
                           fk._FDT_ARGTYPES)
    fargs = (upw.data_ptr(), fullw.data_ptr(), rost3.data_ptr(),
             rec.data_ptr(), act.data_ptr(),
             *(o.data_ptr() for o in fouts[:5]), None, None,
             fouts[5].data_ptr(), fouts[6].data_ptr(), B, W, P, N, rf)

    def fused_launch(stream):
        return fraw(*fargs, stream)

    launches["fused_downtime_eval"] = fused_launch
    times["fused_downtime_eval"] = (
        mcc.event_ms(fused_launch),
        time_ms(lambda: fk.fused_downtime_eval(
            upw, fullw, rf=rf, n_real=N, roster=rost3, recruit=rec,
            active=act), 200),
        time_ms(lambda: fk.fused_downtime_eval_plain(
            upw, fullw, rf=rf, n_real=N, roster=rost3, recruit=rec,
            active=act), 20))
    fixed_args = fargs[:2] + (None, None, None) + fargs[5:13] + (None,) + \
        fargs[14:]

    def fixed_launch(stream):
        return fraw(*fixed_args, stream)

    fixed_bytes = mcc.fused_bytes(B, W, P)
    emit({"phase": "kernel_time", "kernel": "fused_downtime_eval",
          "shape": "fixed (no roster, no counts)",
          "ms": mcc.event_ms(fixed_launch), **mcc.device_times(fixed_launch),
          "bytes": fixed_bytes, "bound_ms": fixed_bytes / bw * 1e3})

    nbytes = {
        "downtime_eval": mcc.downtime_bytes(R, N),
        "downtime_eval_roster": mcc.downtime_bytes(R, N, rf),
        "downtime_eval_counts": mcc.downtime_bytes(R, N, B=B, n_real=N),
        "downtime_eval_roster_counts": mcc.downtime_bytes(R, N, rf, B=B,
                                                          n_real=N),
        "node_count": mcc.counts_bytes(B, P, N),
        "fused_downtime_eval": mcc.fused_bytes(B, W, P, rf=rf, n_real=N,
                                               counts=True),
    }
    lanes = {"downtime_eval": R * N, "downtime_eval_roster": R * N,
             "downtime_eval_counts": R * N,
             "downtime_eval_roster_counts": R * N,
             "node_count": B * P, "fused_downtime_eval": B * W * P}
    return {name: record(name, nbytes[name], lanes[name], *times[name],
                         worst[name], bw, launch=launches[name])
            for name in names}


def check_latency_kernel(bw, faults):
    """Phase 3 for latency_charge: bitwise agreement with the plain
    version on adversarial state (``mc_check.LATENCY_CASES``: the paper
    tile at slo_ticks 0 and 8, a ragged last block, dirty and the decay
    tables as views at a byte offset), each planted fault of its source
    (`faults`) failing a case, then times at the main path's shape (the
    paper workload's tables, state as the engine carries it).  Returns
    the timing/bound record."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    worst = 0.0
    nbins = 16
    caught = {name: [] for name in faults}
    for rec in mcc.latency_checks(gen, faults, nbins=nbins):
        emit({"phase": "kernel", **rec})
        worst = max(worst, rec["max_abs_err"])
        if not rec["equal"]:
            raise SystemExit(f"latency_charge disagrees ({rec['case']})")
        for f in rec["faults_failed"]:
            caught[f].append(rec["case"])
    held_faults("latency_charge", caught)

    args = mcc.paper_latency(gen)
    NB, nbits = args["kf"].shape[0], args["pow_tables"].shape[0]
    raw = _build.function("latency_charge", "latency_charge_launch",
                          pk._LC_ARGTYPES)
    launch, _ = mcc.latency_launch(raw, args, nbins=nbins)
    ms = mcc.event_ms(launch)
    wrap_ms = time_ms(lambda: pk.latency_charge(**args, nbins=nbins,
                                                slo_ticks=8), 200)
    plain_ms = time_ms(lambda: pk.latency_charge_plain(
        **args, nbins=nbins, slo_ticks=8), 20)
    # bytes this call must move: each input once (only the pow tables of
    # the bits some trial's dt sets), each output once
    R = B * P
    dts = args["dt_i"].tolist()
    nbytes = mcc.latency_bytes(B, P, NB, nbins,
                               mcc.tables_touched(dts, nbits))
    # ops per row: the chain's multiplies for each set bit, ~6 per bucket,
    # ~10 per histogram lane, ~20 for the scalars
    per_row = sum(bin(d).count("1") for d in dts) / B * NB \
        + 6 * NB + 10 * nbins + 20
    return record("latency_charge", nbytes, R, ms, wrap_ms, plain_ms, worst,
                  bw, ops=R * per_row, launch=launch)


def counters():
    """Every ported kernel's launch counter, by the kernel's name."""
    return {"pac_eval": (pk.pac_eval, "launches"),
            "fused_pac_eval": (fk.fused_pac_eval, "launches"),
            "downtime_eval": (pk.downtime_eval, "launches"),
            "downtime_eval_roster": (pk.downtime_eval, "roster_launches"),
            "downtime_eval_counts": (pk.downtime_eval, "counts_launches"),
            "downtime_eval_roster_counts": (pk.downtime_eval,
                                            "roster_counts_launches"),
            "node_count": (pk.node_count, "launches"),
            "fused_downtime_eval": (fk.fused_downtime_eval, "launches"),
            "latency_charge": (pk.latency_charge, "launches"),
            "mlstm_chunkwise": (mk.mlstm_chunkwise, "simt_launches"),
            "mlstm_chunkwise_sm90": (mk.mlstm_chunkwise, "sm90_launches"),
            "mlstm_chunkwise_plain": (mk.mlstm_chunkwise_plain, "calls"),
            "rglru_scan": (rk.rglru_scan, "launches"),
            "rglru_scan_plain": (rk.rglru_scan_plain, "calls"),
            "rglru_scan_bwd": (rk.rglru_scan_bwd, "launches"),
            "rglru_scan_bwd_plain": (rk.rglru_scan_bwd_plain, "calls"),
            "mlstm_chunkwise_bwd": (mk.mlstm_chunkwise_bwd, "simt_launches"),
            "mlstm_chunkwise_bwd_sm90": (mk.mlstm_chunkwise_bwd,
                                         "sm90_launches"),
            "mlstm_chunkwise_bwd_plain": (mk.mlstm_chunkwise_bwd_plain,
                                          "calls"),
            "flash_attention_fwd": (fa.flash_attention_fwd,
                                    "simt_launches"),
            "flash_attention_fwd_sm90": (fa.flash_attention_fwd,
                                         "sm90_launches"),
            "flash_attention_plain": (fa.flash_attention_plain, "calls"),
            "microsim_scan": (msk.microsim_scan, "launches"),
            "microsim_plain": (microsim._simulate_batch_plain, "calls")}


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts(names):
    c = counters()
    return {name: getattr(*c[name]) for name in names}


def check_engine():
    """Phase 4, the §5.1 main path: the engine on cuda, unpacked and
    packed.  Returns each §5.1 kernel's launches over the two runs, and
    the runs by packed."""
    kw = dict(n=N, partitions=P, rf=2, p=1e-3, trials=B, min_ticks=10 ** 9,
              max_steps=MC_STEPS, chunk_steps=MC_CHUNK, seed=0,
              trajectory=True)
    reset_counts()
    runs = {}
    for packed in (False, True):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        runs[packed] = ab.simulate_availability_batched(
            packed=packed, device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        steps = len(runs[packed].trajectory["times"])
        emit({"phase": "engine", "packed": packed, "steps": steps,
              "wall_s": wall, "steps_per_s": steps / wall,
              "ticks": runs[packed].ticks, "u_lark": runs[packed].u_lark,
              "u_maj": runs[packed].u_maj,
              "lark_events": runs[packed].lark_events})
    launches = read_counts(("pac_eval", "fused_pac_eval"))
    a, b = runs[False], runs[True]
    same = all(np.array_equal(a.trajectory[k], b.trajectory[k])
               for k in a.trajectory) and a.u_lark == b.u_lark \
        and a.u_maj == b.u_maj and a.lark_events == b.lark_events \
        and a.maj_events == b.maj_events \
        and np.array_equal(a.u_lark_trials, b.u_lark_trials)
    lark_down = int(a.trajectory["unavail_lark"].sum())
    emit({"phase": "engine", "packed_equals_unpacked": same,
          "launches": launches, "unavail_lark_partition_steps": lark_down})
    if not same:
        raise SystemExit("packed and unpacked engine runs disagree")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched on the main path: "
                         f"{launches}")

    # a first chunk of 128 steps on the CPU, through the plain versions
    t0 = time.monotonic()
    cpu = ab.simulate_availability_batched(
        packed=False, device="cpu", **{**kw, "chunk_steps": 128,
                                       "max_steps": 2})
    cpu_wall = time.monotonic() - t0
    k = len(cpu.trajectory["times"])
    cpu_same = all(np.array_equal(cpu.trajectory[c], a.trajectory[c][:k])
                   for c in cpu.trajectory)
    emit({"phase": "engine", "cpu_prefix_steps": k, "cpu_equal": cpu_same,
          "cpu_wall_s": cpu_wall})
    if not cpu_same:
        raise SystemExit("cuda run disagrees with the cpu run over the "
                         "first chunk")
    return launches, runs


def check_bench_rows():
    """Phase 5: two committed BENCH_sweep rows, rebuilt on cuda."""
    base = json.loads((ROOT / "benchmarks" / "BENCH_sweep.json").read_text())
    spec = runner.ExperimentSpec.from_file(
        str(ROOT / "benchmarks" / "configs" / "sweep.toml"))

    def committed(kind, scenario=None):
        for r in base["rows"]:
            if r["kind"] == kind and r["rf"] == 2 and r["p"] == 1e-3 and \
                    r.get("scenario") == scenario:
                return json.dumps(r, sort_keys=True)
        raise SystemExit(f"no committed {kind} {scenario} row")

    seeds = tuple(range(spec.seed, spec.seed + spec.trials))
    for packed in (False, True):
        t0 = time.monotonic()
        iid = next(runner._gen_run(full=spec.full, seeds=seeds,
                                   backend=spec.backend,
                                   devices=spec.devices, smoke=spec.smoke,
                                   packed=packed, device=DEVICE))
        sc = next(runner._gen_run_scenarios(
            ["hetero-mttf"], full=spec.full, trials=spec.trials,
            seed=spec.seed, devices=spec.devices, smoke=spec.smoke,
            packed=packed, device=DEVICE))
        wall = time.monotonic() - t0
        for row, want in ((iid, committed("iid")),
                          (sc, committed("scenario", "hetero-mttf"))):
            got = json.dumps(runner._json_safe(row), sort_keys=True)
            emit({"phase": "bench_row", "packed": packed,
                  "kind": row["kind"], "scenario": row.get("scenario"),
                  "identical": got == want, "u_lark": row["u_lark"],
                  "ticks": row["ticks"], "wall_s_pair": wall})
            if got != want:
                raise SystemExit(f"row differs from BENCH_sweep.json:\n"
                                 f"got  {got}\nwant {want}")


#: the three §6 configurations of the main path, each with the kernels it
#: must launch: the fixed model at its default knobs, the same with 1
#: GiB/s shared per-node bandwidth, and reconfig with zipf-skewed sizes
#: and that bandwidth (the BENCH_downtime_skew knobs).  Under shared
#: bandwidth the unpacked step counts in its one row-eval launch, so
#: node_count alone must not launch there.
DOWNTIME_CONFIGS = {
    "fixed": ({}, ("downtime_eval", "fused_downtime_eval")),
    "fixed-bw": (dict(node_bandwidth_gibps=1.0),
                 ("downtime_eval_counts", "fused_downtime_eval")),
    "reconfig-skew-bw": (dict(rebuild_model="reconfig", size_dist="zipf",
                              size_skew=1.0, node_bandwidth_gibps=1.0),
                         ("downtime_eval_roster_counts",
                          "fused_downtime_eval")),
}


DOWNTIME_KERNELS = ("downtime_eval", "downtime_eval_roster",
                    "downtime_eval_counts", "downtime_eval_roster_counts",
                    "node_count", "fused_downtime_eval")


def check_downtime_engine():
    """Phase 6, the §6 main path: the commit-pause engine on cuda at the
    paper tile, every configuration, unpacked and packed.  Returns each
    kernel's launches summed over those runs; node_count's are the
    launches that counted in flight, node_count alone never among them
    (the counts mode does its work on this path).  The roster eval
    without counts does not launch here; phase 9 drives it.  Also
    returns the runs by (config, packed)."""
    launches, runs = {}, {}
    for name, (knobs, kernels) in DOWNTIME_CONFIGS.items():
        pair, got = check_engine_pair(
            "downtime", db.simulate_downtime_batched, downtime_fingerprint,
            kernels, dict(knobs, trajectory=True), config=name)
        runs.update({(name, k): v for k, v in pair.items()})
        r = pair[False]
        if r.quorum_events <= 0 or r.lark_events <= 0:
            raise SystemExit(f"no pause events in the §6 run ({name})")
        if got["node_count"] != 0:
            raise SystemExit(f"node_count launched apart from the row "
                             f"eval ({name}): {got}")
        for k in DOWNTIME_KERNELS:
            launches[k] = launches.get(k, 0) + got[k]
    launches["node_count"] = launches["downtime_eval_counts"] + \
        launches["downtime_eval_roster_counts"]
    return launches, runs


def check_downtime_bench_rows():
    """Phase 7: the i.i.d. rf = 2, p = 3e-3 row of each committed §6
    baseline, rebuilt on cuda, packed and unpacked."""
    for name in ("downtime", "downtime_reconfig", "downtime_skew"):
        base = json.loads((ROOT / "benchmarks" /
                           f"BENCH_{name}.json").read_text())
        want = [r for r in base["rows"] if r["kind"] == "downtime" and
                r["rf"] == 2 and r["p"] == 3e-3]
        if len(want) != 1:
            raise SystemExit(f"no committed i.i.d. row in BENCH_{name}")
        want = json.dumps(want[0], sort_keys=True)
        spec = runner.ExperimentSpec.from_file(
            str(ROOT / "benchmarks" / "configs" / f"{name}.toml"))
        for packed in (False, True):
            t0 = time.monotonic()
            row = next(runner._gen_run_downtime(
                full=spec.full, trials=spec.trials, seed=spec.seed,
                devices=spec.devices, smoke=spec.smoke,
                params=spec.downtime_params(), packed=packed,
                device=DEVICE))
            wall = time.monotonic() - t0
            got = json.dumps(runner._json_safe(row), sort_keys=True)
            emit({"phase": "downtime_bench_row", "config": name,
                  "packed": packed, "identical": got == want,
                  "pause_quorum": row["pause_quorum"],
                  "ticks": row["ticks"], "wall_s": wall})
            if got != want:
                raise SystemExit(f"row differs from BENCH_{name}.json:\n"
                                 f"got  {got}\nwant {want}")


#: the client-latency layer's main path: the fixed model under the paper
#: workload (zipf keys, 32 requests/tick, 80 % reads, an 8-tick SLO)
LATENCY_KNOBS = dict(key_zipf=1.0, read_frac=0.8, requests_per_tick=32.0,
                     slo_ticks=8)
#: the protocol zoo's main path: reconfig with all four engines, the
#: BENCH_shootout knobs
ZOO_KNOBS = dict(rebuild_model="reconfig", engines=db.ENGINES,
                 lease_ticks=40, view_change_ticks=200)


def latency_fingerprint(r):
    """Every number a latency run reports, and its raw accumulators."""
    fp = {k: v for k, v in vars(r).items()
          if k not in ("downtime", "device")}
    fp.update({f"raw:{k}": v for k, v in r.downtime.latency_raw.items()})
    return fp


def downtime_fingerprint(r):
    """Every engine's stats, the elapsed ticks and the trajectory."""
    fp = {f"traj:{k}": v for k, v in r.trajectory.items()}
    for engine in r.engines:
        fp.update({f"{engine}:{k}": v
                   for k, v in r.engine_stats(engine).items()})
    fp["ticks"] = r.ticks
    return fp


def same_fingerprint(a, b) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def check_engine_pair(phase, simulate, fingerprint, kernels, knobs, *,
                      steps=MC_STEPS, config=None):
    """Drive one §6 path on cuda at the paper tile for `steps` steps in
    MC_CHUNK-step chunks, unpacked and packed, with the launch
    counts set to 0 just before and read just after: the layouts must
    agree exactly, every kernel of `kernels` must have launched, and a
    128-step run on cuda must equal the CPU's.  Returns the runs by
    packed and every kernel's launches over the two runs."""
    kw = dict(n=N, partitions=P, rf=2, p=1e-3, trials=B, min_ticks=10 ** 9,
              max_steps=steps, chunk_steps=MC_CHUNK, seed=0, **knobs)
    tag = {"phase": phase, "config": config}
    reset_counts()
    runs = {}
    for packed in (False, True):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        r = simulate(packed=packed, device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        runs[packed] = r
        emit({**tag, "packed": packed, "steps": steps, "wall_s": wall,
              "steps_per_s": steps / wall,
              **{k: v for k, v in fingerprint(r).items()
                 if isinstance(v, (int, float)) and math.isfinite(v)}})
    launches = read_counts(counters())
    same = same_fingerprint(fingerprint(runs[False]), fingerprint(runs[True]))
    emit({**tag, "launches": launches, "packed_equals_unpacked": same})
    if not same:
        raise SystemExit(f"packed and unpacked {phase} runs disagree "
                         f"({config})")
    if min(launches[k] for k in kernels) <= 0:
        raise SystemExit(f"a kernel of {kernels} was not launched on the "
                         f"{phase} path ({config}): {launches}")
    short = dict(kw, chunk_steps=128, max_steps=2)
    gpu = simulate(device=DEVICE, **short)
    t0 = time.monotonic()
    cpu = simulate(device="cpu", **short)
    cpu_wall = time.monotonic() - t0
    same = same_fingerprint(fingerprint(gpu), fingerprint(cpu))
    emit({**tag, "cpu_steps": 128, "cpu_equal": same, "cpu_wall_s": cpu_wall})
    if not same:
        raise SystemExit(f"cuda {phase} run disagrees with the cpu run "
                         f"({config})")
    return runs, launches


def check_latency_engine():
    """Phase 8, the client-latency path: returns the launches and the
    runs by packed."""
    runs, launches = check_engine_pair(
        "latency", cl.simulate_client_latency, latency_fingerprint,
        ("latency_charge", "downtime_eval", "fused_downtime_eval"),
        dict(LATENCY_KNOBS, trajectory=True))
    r = runs[False]
    raw = r.downtime.latency_raw
    finite = all(np.isfinite(v).all() for v in raw.values())
    emit({"phase": "latency", "finite": finite,
          "dup_total": float(raw["dup"].sum()),
          "qsum_total": float(raw["qsum"].sum()),
          "p999_quorum": r.p999_quorum, "lat_lark": r.lat_lark})
    if not finite or r.lat_lark <= 0 or r.lat_quorum <= 0 or \
            not r.p50_quorum <= r.p99_quorum <= r.p999_quorum:
        raise SystemExit("the latency run charged nothing or is not finite")
    return launches, runs


def check_zoo_engine():
    """Phase 9, the protocol zoo: returns the launches and the runs by
    packed."""
    runs, launches = check_engine_pair(
        "zoo", db.simulate_downtime_batched, downtime_fingerprint,
        ("downtime_eval_roster", "fused_downtime_eval"),
        dict(ZOO_KNOBS, trajectory=True))
    r = runs[False]
    if r.hermes_events <= 0 or r.spinnaker_events <= 0:
        raise SystemExit("no hermes or spinnaker pause events in the zoo run")
    return launches, runs


def check_zoo_bench_rows():
    """Phase 10: the i.i.d. rf = 2, p = 3e-3 rows of BENCH_latency.json
    and BENCH_shootout.json, rebuilt on cuda, packed and unpacked."""
    for name, gen in (("latency", runner._gen_run_latency),
                      ("shootout", runner._gen_run_downtime)):
        base = json.loads((ROOT / "benchmarks" /
                           f"BENCH_{name}.json").read_text())
        want = [json.dumps(r, sort_keys=True) for r in base["rows"]
                if r["scenario"] == "iid" and r["rf"] == 2
                and r["p"] == 3e-3]
        spec = runner.ExperimentSpec.from_file(
            str(ROOT / "benchmarks" / "configs" / f"{name}.toml"))
        for packed in (False, True):
            t0 = time.monotonic()
            rows = gen(full=spec.full, trials=spec.trials, seed=spec.seed,
                       devices=spec.devices, smoke=spec.smoke,
                       params=spec.downtime_params(), packed=packed,
                       device=DEVICE)
            got = [json.dumps(runner._json_safe(next(rows)), sort_keys=True)
                   for _ in want]
            wall = time.monotonic() - t0
            emit({"phase": "zoo_bench_row", "config": name, "packed": packed,
                  "rows": len(want), "identical": got == want,
                  "wall_s": wall})
            if not want or got != want:
                raise SystemExit(f"rows differ from BENCH_{name}.json:\n"
                                 f"got  {got}\nwant {want}")


# ---------------------------------------------------------------------------
# the LM serve path: mlstm_chunkwise and xlstm-350m behind the session store
# ---------------------------------------------------------------------------

def mlstm_abs_err(got, want):
    """Largest |got - want| in float32."""
    return (got.float() - want.float()).abs().max().item()


def mlstm_flops(B, H, S, Dq, Dv, chunk):
    """Float ops one call needs: per (b, h, chunk of l positions) q C and
    the C update (2 l Dq Dv each), and the causal half of q k^T and W v
    (l (l + 1) / 2 pairs, 2 (Dq + Dv) each); the masked upper triangle
    is not work."""
    total = 0
    for c0 in range(0, S, chunk):
        ln = min(chunk, S - c0)
        total += 2 * ln * Dq * Dv * 2 + ln * (ln + 1) * (Dq + Dv)
    return B * H * total


def mlstm_bytes(B, H, S, Dq, Dv, dtype, initial=False):
    """Each input read once, each output written once: q, k, v and h in
    `dtype`, the two gates in f32, the final (C, n, m) in f32 (and the
    initial one, when given)."""
    isz = torch.tensor([], dtype=dtype).element_size()
    state = 4 * B * H * (Dq * Dv + Dq + 1)
    return isz * B * H * S * (2 * Dq + 2 * Dv) + 8 * B * H * S + \
        state * (2 if initial else 1)


def mlstm_sm90_mix(B, H, S, Dq, Dv, chunk) -> int:
    """Tensor-core float ops that csrc/mlstm_chunk_sm90.cu issues at these
    shapes without an initial state, S a multiple of the chunk: the
    states kernel's (wv k)^T v over every position and q C_c for every
    chunk after the first, each split in two; per 64-row warpgroup of a
    chunk, q k^T (once per Dv block) and the split W v over its key tiles
    up to the diagonal."""
    nC, n = S // chunk, chunk // 64
    nv = 256 if Dv % 256 == 0 else 128 if Dv % 128 == 0 else 64
    tiles = n * (n + 1) // 2
    per_chunk = tiles * 64 * 64 * 2 * (Dq * (Dv // nv) + 2 * Dv)
    return B * H * (4 * nC * chunk * Dq * Dv + 4 * (nC - 1) * chunk * Dq *
                    Dv + nC * per_chunk)


def check_mlstm_kernel(bw, faults):
    """Phase 11: mlstm_chunkwise through its entry point against its plain
    version on the card, on both sources, their planted faults, then their
    times at the serve shape.  Each output is held element by element
    against the scale of its own float32 rounding (the same sums over
    absolute values, ``mlstm_check.mlstm_rounding_scale``): h within
    2^-16 of it plus 2^-7 of |h| for one rounding of h to bf16; C, n, m
    within 2^-12 (their carry weights are exp of gate sums ~10^2).
    Returns the timing records by the kernels line's names."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    B, H, S, D, L = SERVE_BATCH, 4, SERVE_PROMPT, 512, 256
    names = {"sm90": "mlstm_chunkwise_sm90", "simt": "mlstm_chunkwise"}
    worst = {"sm90": 0.0, "simt": 0.0}
    caught = {src: {name: [] for name in mc.FAULTS[src]} for src in mc.FAULTS}
    simt_fn = _build.function(*mk.ROUTES["simt"])

    def held(name, route, dtype, s, h, state, same, want, scales, **extra):
        want_h, want_state = want
        errs = mc.mlstm_errors(h, state, want_h, want_state, scales)
        ok = h.dtype == dtype and h.shape == want_h.shape and \
            all(e <= 1.0 for e in errs.values())
        abs_err = {"h": mlstm_abs_err(h, want_h.to(dtype))}
        abs_err.update({n: mlstm_abs_err(g, w)
                        for n, g, w in zip("Cnm", state, want_state)})
        worst[route] = max(worst[route], abs_err["h"])
        emit({"phase": "kernel", "kernel": "mlstm_chunkwise", "case": name,
              "route": route, "source": SOURCES[names[route]][0],
              "dtype": str(dtype), "S": s, "within_rounding": ok,
              "deterministic": same, "errors_over_allowed": errs,
              "gamma": mc.GAMMA, "out_step": mc.OUT_STEP[dtype],
              "max_abs_err": abs_err, **extra})
        if not (ok and same):
            raise SystemExit(f"mlstm_chunkwise ({route}) disagrees with its "
                             f"plain version ({name}): {errs}")

    for name, dtype, s, initial, stress in mc.CASES:
        args, init = mc.mlstm_inputs(gen, B, H, s, D, D, dtype,
                                     stress=stress, initial=initial)
        route = mk._route(dtype, D, D, L)
        reset_counts()
        h, state = mk.mlstm_chunkwise(*args, chunk=L, initial=init)
        torch.cuda.synchronize()
        h2, state2 = mk.mlstm_chunkwise(*args, chunk=L, initial=init)
        same = torch.equal(h, h2) and all(
            torch.equal(a, b) for a, b in zip(state, state2))
        got = read_counts((*names.values(), "mlstm_chunkwise_plain"))
        if got[names[route]] != 2 or sum(got.values()) != 2:
            raise SystemExit(f"mlstm: the entry point took the wrong route "
                             f"({route} expected): {got}")
        want, scales = mc.reference(args, L, init)
        fault_errs = {}
        for src in mc.FAULTS:
            if not mc.takes(src, dtype):
                continue
            for fname, fn in faults[src].items():
                fh, fstate = mk.launch_with(fn, *args, L, init,
                                            route=mc.SOURCE_ROUTE[src])
                errs = mc.mlstm_errors(fh, fstate, *want, scales)
                fault_errs[f"{src}:{fname}"] = max(errs.values())
                if not all(e <= 1.0 for e in errs.values()):
                    caught[src][fname].append(name)
        held(name, route, dtype, s, h, state, same, want, scales,
             by="entry point", faults_error_over_allowed=fault_errs)
        if route == "sm90":
            # the simt source on the same case, by its launcher
            h, state = mk.launch_with(simt_fn, *args, L, init)
            torch.cuda.synchronize()
            h2, state2 = mk.launch_with(simt_fn, *args, L, init)
            same = torch.equal(h, h2) and all(
                torch.equal(a, b) for a, b in zip(state, state2))
            held(name, "simt", dtype, s, h, state, same, want, scales,
                 by="launcher")
        del args, init, h, state, h2, state2, want, scales
    for src in mc.FAULTS:
        held_faults(f"mlstm_chunkwise ({src}.cu)", caught[src])

    # times at the serve shape: both sources' raw launchers, in turns, and
    # each kernel of the sm90 source alone (on the scratch a full launch
    # left)
    (q, k, v, lf, li), _ = mc.mlstm_inputs(gen, B, H, S, D, D,
                                           torch.bfloat16)
    sm90_fn = _build.function(*mk.ROUTES["sm90"])
    a90, _, keep90 = mk.launch_args(q, k, v, lf, li, L, None, route="sm90")
    asimt, _, keepsimt = mk.launch_args(q, k, v, lf, li, L, None)
    simt_ms = time_ms(lambda: simt_fn(*asimt), 10)
    ms = time_ms(lambda: sm90_fn(*a90), 50)
    parts_ms = {part: time_ms(lambda: sm90_fn(*a90[:-2], bit, a90[-1]), 50)
                for part, bit in mk.PARTS.items()}
    ms_again = time_ms(lambda: sm90_fn(*a90), 50)
    simt_ms_again = time_ms(lambda: simt_fn(*asimt), 10)
    wrap_ms = time_ms(lambda: mk.mlstm_chunkwise(q, k, v, lf, li, chunk=L),
                      50)
    plain_ms = time_ms(lambda: mk.mlstm_chunkwise_plain(q, k, v, lf, li,
                                                        chunk=L), 5)
    flops = mlstm_flops(B, H, S, D, D, L)
    mix = mlstm_sm90_mix(B, H, S, D, D, L)
    nbytes = mlstm_bytes(B, H, S, D, D, torch.bfloat16)
    rec = {route: record(names[route], nbytes, 0, t, wt, plain_ms,
                         worst[route], bw, ops=flops,
                         rate=FLOAT_PEAK[torch.bfloat16])
           for route, t, wt in (("sm90", ms, wrap_ms),
                                ("simt", simt_ms, None))}
    # the C_c hi and lo (BH, nC - 1 chunks, Dq, Dv) the states kernel
    # writes and the output kernel reads, and the n_c
    scratch_bytes = 2 * 2 * B * H * (S // L - 1) * D * D + \
        4 * B * H * (S // L) * D
    emit({"phase": "kernel_time", "kernel": "mlstm_chunkwise",
          "shape": [B, H, S, D, D, L], "dtype": "bfloat16",
          "sm90_ms": ms, "sm90_ms_again": ms_again,
          "sm90_parts_ms": parts_ms, "simt_ms": simt_ms,
          "simt_ms_again": simt_ms_again, "wrapper_ms": wrap_ms,
          "plain_ms": plain_ms, "flops": flops, "tensor_core_flops": mix,
          "sm90_tflops_function": flops / ms / 1e9,
          "sm90_tflops_mix": mix / ms / 1e9,
          "simt_tflops_function": flops / simt_ms / 1e9,
          "mix_bound_ms": mix / FLOAT_PEAK[torch.bfloat16] * 1e3,
          "chunk_state_bytes": scratch_bytes,
          "f32_cuda_core_bound_ms": flops / FLOAT_PEAK[torch.float32] * 1e3})
    del keep90, keepsimt
    return {names[route]: r for route, r in rec.items()}


def watch_logits(loop, finite):
    """Wrap the loop's model entry points so each call's logits add one
    on-device all-finite flag to `finite` (read once, at the end)."""
    for key in ("prefill", "decode_step"):
        fn = loop.model[key]

        def checked(*a, _fn=fn, **kw):
            logits, state = _fn(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, state
        loop.model[key] = checked


def state_bytes(state):
    return sum(t.numel() * t.element_size() for t in tree.leaves(state))


def check_serve():
    """Phase 12, the LM serve path at full width.  Returns the mLSTM
    kernel's launches over the main path."""
    t_phase = time.monotonic()
    cfg = get_config("xlstm_350m")
    model = build_model(cfg)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model["init_params"](gen)
    n_params, p_bytes = param_count(params)
    data = SyntheticLMData(cfg, SERVE_BATCH, SERVE_PROMPT)
    batch = {"tokens": data.batch_at(0)["tokens"]}
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    # tokens/s, timed before the counted run: a first prefill and a first
    # decode step warm up, then one prefill and SERVE_GEN decode steps
    with torch.no_grad():
        logits, state = model["prefill"](params, {"tokens": tokens})
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, state = model["prefill"](params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        cur = logits.argmax(-1)
        logits, state = model["decode_step"](params, state, cur)
        cur = logits.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(SERVE_GEN):
            logits, state = model["decode_step"](params, state, cur)
            cur = logits.argmax(-1)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
    sbytes = state_bytes(state)
    del logits, state, cur

    sessions = LarkSessionStore(num_nodes=4, rf=2)
    max_len = SERVE_PROMPT + SERVE_GEN + SERVE_RESUME
    loop = ServeLoop(cfg, params, max_len=max_len, session_store=sessions,
                     checkpoint_every=8, device=DEVICE)
    whole = ServeLoop(cfg, params, max_len=max_len, device=DEVICE)
    finite = []
    watch_logits(loop, finite)
    watch_logits(whole, finite)
    names = ("mlstm_chunkwise_sm90", "mlstm_chunkwise",
             "mlstm_chunkwise_plain")
    reset_counts()
    t0 = time.monotonic()
    toks = loop.generate(batch, steps=SERVE_GEN, session_id="req-0")
    first = read_counts(names)
    sessions.fail_server(0)
    available = sessions.store.available_fraction()
    resumed = loop.resume("req-0", steps=SERVE_RESUME)
    after_resume = read_counts(names)
    uninterrupted = whole.generate(batch, steps=SERVE_GEN + SERVE_RESUME)
    torch.cuda.synchronize()
    main_wall = time.monotonic() - t0
    launches = read_counts(names)
    all_finite = bool(torch.stack(finite).all().item())
    n_layers_mlstm = sum(k == "mlstm" for p, r in cfg.layout
                         for _ in range(r) for k in p)
    checks = {
        "prefix_equal": resumed is not None and
        np.array_equal(resumed[:, :SERVE_GEN], toks),
        "resume_equals_uninterrupted": resumed is not None and
        np.array_equal(resumed, uninterrupted),
        "logits_finite": all_finite,
        "launches_per_prefill":
        first["mlstm_chunkwise_sm90"] == n_layers_mlstm
        and after_resume["mlstm_chunkwise_sm90"] == n_layers_mlstm
        and launches["mlstm_chunkwise_sm90"] == 2 * n_layers_mlstm,
        "simt_never_ran": launches["mlstm_chunkwise"] == 0,
        "plain_never_ran": launches["mlstm_chunkwise_plain"] == 0}
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "dtype": cfg.act_dtype, "params": n_params, "param_bytes": p_bytes,
          "decode_state_bytes": sbytes, "batch": SERVE_BATCH,
          "prompt_len": SERVE_PROMPT, "generated": SERVE_GEN,
          "resumed": SERVE_RESUME, "available_after_failure": available,
          "prefill_s": prefill_s,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
          "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / decode_s,
          "main_path_wall_s": main_wall, "launches": launches,
          "tokens_head": toks[:, :6].tolist(), **checks,
          "wall_s": time.monotonic() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"the serve phase failed: {checks}")
    return launches["mlstm_chunkwise_sm90"]


def check_serve_cpu():
    """Phase 13: the reduced xlstm config on the CPU (plain) and on the
    card (kernel).  Logit tolerance: rtol 1e-3 and atol 1e-3 of the
    largest logit (float32 on both sides; each of the 8 layers amplifies
    an input difference, as tests/test_torch_xlstm.py measures).  Returns
    the simt route's launches over the phase (the config is float32)."""
    cfg = reduced_config("xlstm_350m")
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model["init_params"](gen)
    gpu_params = tree.map_leaves(lambda t: t.to(DEVICE), params)
    prompt = SyntheticLMData(cfg, 2, 300).batch_at(0)["tokens"]
    tok = torch.from_numpy(prompt)
    reset_counts()
    with torch.no_grad():
        lc, _ = model["prefill"](params, {"tokens": tok})
        lg, _ = model["prefill"](gpu_params, {"tokens": tok.to(DEVICE)})
        launched = mk.mlstm_chunkwise.simt_launches
    scale = max(1.0, lc.abs().max().item())
    close = torch.allclose(lg.cpu(), lc, atol=1e-3 * scale, rtol=1e-3)
    got = ServeLoop(cfg, params, device=DEVICE).generate(
        {"tokens": prompt}, steps=8)
    want = ServeLoop(cfg, params, device="cpu").generate(
        {"tokens": prompt}, steps=8)
    same = np.array_equal(got, want)
    counts = read_counts(("mlstm_chunkwise", "mlstm_chunkwise_sm90",
                          "mlstm_chunkwise_plain"))
    emit({"phase": "serve_cpu", "prompt_len": 300, "logits_close": close,
          "max_abs_err": mlstm_abs_err(lg.cpu(), lc), "tokens_equal": same,
          "kernel_launches": launched, "launches": counts})
    if not (close and same and launched == 7 and
            counts["mlstm_chunkwise_sm90"] == 0):
        raise SystemExit("the reduced serve path on cuda disagrees with "
                         "the cpu run")
    return counts["mlstm_chunkwise"]


# ---------------------------------------------------------------------------
# recurrentgemma: rglru_scan, flash_attention_fwd and the 9b serve path
# ---------------------------------------------------------------------------

def start_fault_builds():
    """nvcc on each planted-fault copy of the mlstm, rglru and flash
    sources, started now and awaited by ``finish_fault_builds``."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    return {name: _build.start_variants(name, faults, out_dir,
                                        with_source=False)
            for name, (faults, _, _) in FAULT_SOURCES.items()}


def finish_fault_builds(procs):
    """{source name: {fault: ctypes launcher}}."""
    return {name: _build.finish_variants(procs[name], symbol, argtypes)
            for name, (_, symbol, argtypes) in FAULT_SOURCES.items()}


def held_faults(kernel, caught):
    """Emit which cases each planted fault failed; raise if one failed
    none."""
    missed = [name for name, cases in caught.items() if not cases]
    emit({"phase": "faults", "kernel": kernel, "caught_in": caught,
          "missed": missed})
    if missed:
        raise SystemExit(f"{kernel}: planted faults {missed} passed the "
                         f"check")


def check_rglru_kernel(bw, faults):
    """Phase 14: rglru_scan against its plain version on the card, its
    planted faults, then its time at the serve shape.  Each element of h
    must lie within ``rglru_check.rglru_allowance`` of the plain version
    in float64: the recurrence over |b| (each element's rounding scale),
    run once more over 2^-20 of it per step plus b's own rounding where
    1 - exp(2 log_a) cancels."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    worst = 0.0
    caught = {name: [] for name in faults}
    for case, S, W, kind in rc.CASES:
        x, la = rc.rglru_inputs(gen, rc.BATCH, S, W, kind)
        h = rk.rglru_scan(x, la)
        torch.cuda.synchronize()
        same = torch.equal(h, rk.rglru_scan(x, la))
        want, allowed = rc.reference(x, la)
        err = rc.rglru_error(h, want, allowed)
        ok = h.dtype == torch.float32 and h.shape == x.shape and err <= 1.0
        abs_err = (h.double() - want).abs().max().item()
        worst = max(worst, abs_err)
        fault_errs = {}
        for name, fn in faults.items():
            fault_errs[name] = rc.rglru_error(
                rc.run(fn, rk.launch_args, x, la), want, allowed)
            if fault_errs[name] > 1.0:
                caught[name].append(case)
        emit({"phase": "rglru", "case": case, "shape": [rc.BATCH, S, W],
              "error_over_allowed": err, "within_rounding": ok,
              "deterministic": same, "max_abs_err": abs_err,
              "gamma": rc.GAMMA, "faults_error_over_allowed": fault_errs})
        if not (ok and same):
            raise SystemExit(f"rglru_scan disagrees with its plain version "
                             f"({case}): {err}")
        del x, la, h, want, allowed
    held_faults("rglru_scan", caught)

    Bq, S, W = rc.TIMED_SHAPE
    x, la = rc.rglru_inputs(gen, Bq, S, W, "uniform")
    fn = _build.function("rglru_scan", "rglru_scan_launch", rk._ARGTYPES)
    _, args, keep = rk.launch_args(x, la)     # the call rglru_check times

    def launch(stream):
        return fn(*args, stream)

    ms = mcc.event_ms(launch, reps=50)
    wrap_ms = time_ms(lambda: rk.rglru_scan(x, la), 50)
    plain_ms = time_ms(lambda: rk.rglru_scan_plain(x, la), 3)
    n = Bq * S * W
    # x and log_a in, h out, float32; two exp, a sqrt and ~7 other float
    # ops per element on the float32 CUDA cores.  The record adds device
    # and L2-cold times (mc_check.device_times) of the same launch.
    rec = record("rglru_scan", 3 * 4 * n, 0, ms, wrap_ms, plain_ms, worst,
                 bw, ops=10 * n, rate=FLOAT_PEAK[torch.float32],
                 launch=launch)
    del keep
    return rec


def flash_pairs(Sq, Sk, causal, window) -> int:
    """(q, k) pairs the masks keep, per (batch, head)."""
    return int(fa.attention_mask(Sq, Sk, causal=causal, window=window)
               .sum().item())


def sdpa_ms(q, k, v, *, window, reps):
    """ms per call of F.scaled_dot_product_attention with the same mask:
    is_causal without a window (top-left aligned, as the kernel's), an
    explicit boolean mask with one.  A yardstick only: the port never
    calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return time_ms(lambda: sdpa(q, k, v, is_causal=True), reps)
    mask = fa.attention_mask(q.shape[2], k.shape[2], causal=True,
                             window=window, device=q.device)
    return time_ms(lambda: sdpa(q, k, v, attn_mask=mask), reps)


#: the instantiations whose registers the build phase reports: the
#: mangled name's kernel and first template argument (and "_pac" for the
#: pac mode of fused_downtime_kernel), to a label
PTXAS_LABELS = {"flash_sm90_kernel": "D", "mlstm_states_kernel": "states_NV",
                "mlstm_output_kernel": "output_NV",
                "fused_downtime_kernel": "W", "rglru_scan_kernel": "chained",
                "row_eval_kernel": "mode", "node_count_kernel": "node_count",
                "microsim_scan_kernel": "ticks",
                "rglru_scan_bwd_kernel": "reverse_chained",
                "bwd90_walk_kernel": "walk_NV", "bwd90_abt_kernel": "abt_NT",
                "bwd90_apply_kernel": "apply_mode",
                "bwd90_gates_kernel": "gates", "bwd90_rows_kernel": "rows",
                "bwd90_weights_kernel": "weights",
                "bwd90_dgates_kernel": "dgates",
                "bwd_gates_kernel": "gates", "bwd_dgates_kernel": "dgates",
                **{f"bwd_{k}_kernelI{t}": f"{k}_{n}"
                   for k in ("fstates", "rows", "dstates", "cols")
                   for t, n in (("f", "f32"), ("13__nv_bfloat16", "bf16"))}}
#: what a bool second template argument set to true adds to the label
PTXAS_FLAGS = {"fused_downtime_kernel": "_pac", "row_eval_kernel": "_counts",
               "bwd90_walk_kernel": "_rev", "bwd90_abt_kernel": "_lo"}


def ptxas_usage(log: str) -> dict:
    """Per template instantiation of a source, from ``-Xptxas -v``: the
    registers a thread gets, the spill bytes and the stack frame, and
    whether ptxas serialized the kernel's wgmma (its "wgmma.mma_async
    instructions are serialized" notes, C7510-C7520: for want of
    registers, or an accumulator live across divergent paths).  Labels:
    ``PTXAS_LABELS`` and the template argument (``D256``,
    ``states_NV256``, ``W5_pac``, ``mode2_counts``, ``apply_mode1_256``
    (a second int argument after an underscore); ``W0`` is the loop)."""
    def label(text):
        for kernel, tag in PTXAS_LABELS.items():
            m = re.search(kernel + r"(?:ILi(\d+)E(?:Li(\d+)E)?(Lb1E)?)?",
                          text)
            if m:
                return tag + (m.group(1) or "") + \
                    (f"_{m.group(2)}" if m.group(2) else "") + \
                    (PTXAS_FLAGS[kernel] if m.group(3) else "")
        return None

    usage, head = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            head = label(m.group(1))
            if head:
                usage[head] = {"wgmma_serialized": False}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and head:
            usage[head].update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and head:
            usage[head]["registers"] = int(m.group(1))
    for line in log.splitlines():
        if "wgmma.mma_async instructions are serialized" in line:
            key = label(line)
            if key in usage:
                usage[key]["wgmma_serialized"] = True
    return usage


def check_flash_kernel(bw, faults):
    """Phase 15: flash_attention_fwd through its entry point
    ``ops.flash_attention`` against its plain version on the card, on both
    sources, their planted faults, then their times beside SDPA's.
    Returns (the timing records, the phase's launches, both by the
    kernels line's names: no model path launches this kernel, in the
    reference or here, so its launches are this phase's entry-point
    calls).  Each element of o must lie within ``flash_check``'s allowance
    of the plain version on float64 copies: 2^-16 of the same sums over
    absolute values (each score's own scale included) plus 2^-7 |o| for
    the rounding to bf16."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    B, H, D = fc.SHAPE["B"], fc.SHAPE["H"], fc.SHAPE["D"]
    names = {"sm90": "flash_attention_fwd_sm90", "simt": "flash_attention_fwd"}
    worst = {"sm90": 0.0, "simt": 0.0}
    caught = {src: {name: [] for name in fc.FAULTS[src]} for src in fc.FAULTS}
    counted = {name: 0 for name in (*names.values(), "flash_attention_plain")}
    simt_fn = _build.function(*fa.ROUTES["simt"])

    def entry(q, k, v, window, route):
        """o and its repeat through the entry point, counting launches."""
        reset_counts()
        o = ops.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        same = torch.equal(o, ops.flash_attention(q, k, v, causal=True,
                                                  window=window))
        got = read_counts(counted)
        for name in counted:
            counted[name] += got[name]
        if got[names[route]] != 2 or got["flash_attention_plain"]:
            raise SystemExit(f"flash: the entry point took the wrong route "
                             f"({route} expected): {got}")
        return o, same

    def held(case, route, o, same, want, allowed, **extra):
        err = fc.flash_error(o, want, allowed)
        ok = o.shape == want.shape and err <= 1.0
        abs_err = (o.double() - want).abs().max().item()
        worst[route] = max(worst[route], abs_err)
        emit({"phase": "flash", "case": case, "route": route,
              "source": SOURCES[names[route]][0],
              "shape": list(o.shape), "dtype": str(o.dtype),
              "error_over_allowed": err, "within_rounding": ok,
              "deterministic": same, "max_abs_err": abs_err,
              "gamma": fc.GAMMA, "out_step": fc.OUT_STEP[o.dtype], **extra})
        if not (ok and same):
            raise SystemExit(f"flash_attention_fwd ({route}) disagrees with "
                             f"its plain version ({case}): {err}")

    for case, S, window, q_scale in fc.CASES:
        q, k, v = fc.flash_inputs(gen, B, H, S, D, torch.bfloat16, q_scale)
        o, same = entry(q, k, v, window, "sm90")
        want, allowed = fc.reference(q, k, v, causal=True, window=window)
        fault_errs = {}
        for src in fc.FAULTS:
            route = fc.SOURCE_ROUTE[src]
            for name, fn in faults[src].items():
                err = fc.flash_error(fa.launch_with(
                    fn, q, k, v, causal=True, window=window, scale=None,
                    route=route), want, allowed)
                fault_errs[f"{src}:{name}"] = err
                if err > 1.0:
                    caught[src][name].append(case)
        held(case, "sm90", o, same, want, allowed, window=window,
             q_scale=q_scale, faults_error_over_allowed=fault_errs)
        # the simt source on the same case, by its launcher
        o = fa.launch_with(simt_fn, q, k, v, causal=True, window=window,
                           scale=None, route="simt")
        torch.cuda.synchronize()
        same = torch.equal(o, fa.launch_with(simt_fn, q, k, v, causal=True,
                                             window=window, scale=None,
                                             route="simt"))
        held(case, "simt", o, same, want, allowed, window=window,
             q_scale=q_scale, by="launcher")
        del q, k, v, o, want, allowed
    for case, dtype, Dc, S, window, q_scale in fc.SIMT_CASES:
        q, k, v = fc.flash_inputs(gen, B, H, S, Dc, dtype, q_scale)
        o, same = entry(q, k, v, window, "simt")
        want, allowed = fc.reference(q, k, v, causal=True, window=window)
        held(case, "simt", o, same, want, allowed, window=window,
             q_scale=q_scale, by="entry point")
        del q, k, v, o, want, allowed
    for src in fc.FAULTS:
        held_faults(f"flash_attention_fwd ({src}.cu)", caught[src])
    emit({"phase": "flash", "launches": counted})

    S, window = RG_PROMPT, 2048
    q, k, v = fc.flash_inputs(gen, B, H, S, D, torch.bfloat16)
    sm90_fn = _build.function(*fa.ROUTES["sm90"])
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, o)]
    scale = 1.0 / math.sqrt(D)
    ms = {w: time_ms(lambda: sm90_fn(*ptrs, B * H, S, S, D, scale, 1, w,
                                     stream), 20) for w in (window, 0)}
    simt_ms = {w: time_ms(lambda: simt_fn(*ptrs, B * H, S, S, D, D, scale, 1,
                                          w, 1, stream), 5)
               for w in (window, 0)}
    wrap_ms = time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, causal=True, window=window), 20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, window=window), 3)
    lib_ms = {w: sdpa_ms(q, k, v, window=w, reps=20) for w in (window, 0)}
    causal_mask = fa.attention_mask(S, S, causal=True, window=0, device=dev)
    lib_mask_causal_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_mask), 20)
    mask = fa.attention_mask(S, S, causal=True, window=window, device=dev)
    sm90_fn(*ptrs, B * H, S, S, D, scale, 1, window, stream)
    sdpa_err = (torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask).float() - o.float()).abs().max().item()
    pairs = {w: flash_pairs(S, S, True, w) * B * H for w in (window, 0)}
    # the function's work: 4 D float ops per kept pair; the sm90 kernel's
    # tensor-core mix: q k^T (2 D) and p v twice (4 D) per kept pair
    flops = {w: 4 * D * pairs[w] for w in (window, 0)}
    mix = {w: 6 * D * pairs[w] for w in (window, 0)}
    nbytes = 4 * 2 * B * H * S * D
    rec = {
        "sm90": record(names["sm90"], nbytes, 0, ms[window], wrap_ms,
                       plain_ms, worst["sm90"], bw, ops=flops[window],
                       rate=FLOAT_PEAK[torch.bfloat16]),
        "simt": record(names["simt"], nbytes, 0, simt_ms[window], None,
                       plain_ms, worst["simt"], bw, ops=flops[window],
                       rate=FLOAT_PEAK[torch.bfloat16])}
    for r in rec.values():
        r["library_ms"] = lib_ms[window]
    emit({"phase": "kernel_time", "kernel": "flash_attention_fwd",
          "shape": [B, H, S, D], "dtype": "bfloat16", "window": window,
          "sm90_ms": ms[window], "simt_ms": simt_ms[window],
          "library_ms": lib_ms[window],
          "library": "F.scaled_dot_product_attention (boolean mask)",
          "library_vs_sm90_max_abs": sdpa_err,
          "pairs": pairs[window], "function_flops": flops[window],
          "tensor_core_flops": mix[window],
          "sm90_tflops_function": flops[window] / ms[window] / 1e9,
          "sm90_tflops_mix": mix[window] / ms[window] / 1e9,
          "simt_tflops_function": flops[window] / simt_ms[window] / 1e9,
          "mix_bound_ms": mix[window] / FLOAT_PEAK[torch.bfloat16] * 1e3,
          "causal_no_window": {
              "sm90_ms": ms[0], "simt_ms": simt_ms[0],
              "library_is_causal_ms": lib_ms[0],
              "library_boolean_mask_ms": lib_mask_causal_ms,
              "sm90_tflops_function": flops[0] / ms[0] / 1e9,
              "sm90_tflops_mix": mix[0] / ms[0] / 1e9,
              "bound_ms": flops[0] / FLOAT_PEAK[torch.bfloat16] * 1e3}})
    launches = {names[r]: counted[names[r]] for r in names}
    return {names[r]: rec[r] for r in names}, launches


def keep_decode_logits(loop, kept):
    """Wrap the loop's decode step so each step's logits are appended to
    `kept` (on the device)."""
    fn = loop.model["decode_step"]

    def kept_step(*a, **kw):
        logits, state = fn(*a, **kw)
        kept.append(logits)
        return logits, state
    loop.model["decode_step"] = kept_step


def check_serve_rg():
    """Phase 16, recurrentgemma-9b at full width and depth.  Returns the
    rglru_scan kernel's launches over the main path.  Greedy tokens of
    random weights repeat often, so beside the tokens every decode step's
    logits of the resumed run must equal the uninterrupted run's
    bitwise."""
    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("recurrentgemma_9b")
    model = build_model(cfg)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model["init_params"](gen)
    n_params, p_bytes = param_count(params)
    data = SyntheticLMData(cfg, SERVE_BATCH, RG_PROMPT)
    batch = {"tokens": data.batch_at(0)["tokens"]}
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    max_len = RG_PROMPT + SERVE_GEN + SERVE_RESUME
    # tokens/s, timed before the counted run: a first prefill and a first
    # decode step warm up, then one prefill and SERVE_GEN decode steps
    with torch.no_grad():
        logits, state = model["prefill"](params, {"tokens": tokens}, max_len)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, state = model["prefill"](params, {"tokens": tokens}, max_len)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        cur = logits.argmax(-1)
        logits, state = model["decode_step"](params, state, cur, RG_PROMPT)
        cur = logits.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i in range(SERVE_GEN):
            logits, state = model["decode_step"](params, state, cur,
                                                 RG_PROMPT + 1 + i)
            cur = logits.argmax(-1)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
    sbytes = state_bytes(state)
    del logits, state, cur

    sessions = LarkSessionStore(num_nodes=4, rf=2)
    loop = ServeLoop(cfg, params, max_len=max_len, session_store=sessions,
                     checkpoint_every=8, device=DEVICE)
    whole = ServeLoop(cfg, params, max_len=max_len, device=DEVICE)
    finite, resumed_logits, whole_logits = [], [], []
    watch_logits(loop, finite)
    watch_logits(whole, finite)
    keep_decode_logits(loop, resumed_logits)
    keep_decode_logits(whole, whole_logits)
    names = ("rglru_scan", "rglru_scan_plain")
    reset_counts()
    t0 = time.monotonic()
    toks = loop.generate(batch, steps=SERVE_GEN, session_id="req-0")
    first = read_counts(names)
    sessions.fail_server(0)
    available = sessions.store.available_fraction()
    resumed = loop.resume("req-0", steps=SERVE_RESUME)
    after_resume = read_counts(names)
    uninterrupted = whole.generate(batch, steps=SERVE_GEN + SERVE_RESUME)
    torch.cuda.synchronize()
    main_wall = time.monotonic() - t0
    launches = read_counts(names)
    all_finite = bool(torch.stack(finite).all().item())
    n_rglru = sum(k == "rglru" for p, r in cfg.layout for _ in range(r)
                  for k in p)
    checks = {
        "prefix_equal": resumed is not None and
        np.array_equal(resumed[:, :SERVE_GEN], toks),
        "resume_equals_uninterrupted": resumed is not None and
        np.array_equal(resumed, uninterrupted),
        "decode_logits_equal": len(resumed_logits) == len(whole_logits)
        == SERVE_GEN + SERVE_RESUME and all(
            torch.equal(a, b) for a, b in zip(resumed_logits, whole_logits)),
        "logits_finite": all_finite,
        "launches_per_prefill": n_rglru == 26
        and first["rglru_scan"] == n_rglru
        and after_resume["rglru_scan"] == n_rglru
        and launches["rglru_scan"] == 2 * n_rglru,
        "plain_never_ran": launches["rglru_scan_plain"] == 0}
    emit({"phase": "serve_rg", "arch": cfg.name, "layers": cfg.num_layers,
          "layout": [[list(p), r] for p, r in cfg.layout],
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "dtype": cfg.act_dtype, "params": n_params, "param_bytes": p_bytes,
          "decode_state_bytes": sbytes, "batch": SERVE_BATCH,
          "prompt_len": RG_PROMPT, "max_len": max_len,
          "generated": SERVE_GEN, "resumed": SERVE_RESUME,
          "available_after_failure": available, "prefill_s": prefill_s,
          "prefill_tokens_per_s": SERVE_BATCH * RG_PROMPT / prefill_s,
          "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / decode_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "main_path_wall_s": main_wall, "launches": launches,
          "tokens_head": toks[:, :6].tolist(), **checks,
          "wall_s": time.monotonic() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"the recurrentgemma serve phase failed: {checks}")
    return launches["rglru_scan"]


def check_serve_rg_cpu():
    """Phase 17: a 5-layer reduced recurrentgemma (layout (R, R, L) + (R,
    R); lru_width 4096 as the reference's reduced config keeps it) on the
    CPU (plain) and on the card (kernel), prompt 48 over window 32.  Logit
    tolerance: rtol 1e-3 and atol 1e-3 of the largest logit (float32 on
    both sides; each layer amplifies an input difference, as
    tests/test_torch_recurrentgemma.py measures against the reference)."""
    cfg = reduced_config("recurrentgemma_9b").replace(num_layers=5)
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model["init_params"](gen)
    gpu_params = tree.map_leaves(lambda t: t.to(DEVICE), params)
    prompt = SyntheticLMData(cfg, 2, 48).batch_at(0)["tokens"]
    tok = torch.from_numpy(prompt)
    max_len = 56
    with torch.no_grad():
        lc, _ = model["prefill"](params, {"tokens": tok}, max_len)
        before = rk.rglru_scan.launches
        lg, _ = model["prefill"](gpu_params, {"tokens": tok.to(DEVICE)},
                                 max_len)
        launched = rk.rglru_scan.launches - before
    scale = max(1.0, lc.abs().max().item())
    close = torch.allclose(lg.cpu(), lc, atol=1e-3 * scale, rtol=1e-3)
    got = ServeLoop(cfg, params, max_len=max_len, device=DEVICE).generate(
        {"tokens": prompt}, steps=8)
    want = ServeLoop(cfg, params, max_len=max_len, device="cpu").generate(
        {"tokens": prompt}, steps=8)
    same = np.array_equal(got, want)
    emit({"phase": "serve_rg_cpu", "layers": cfg.num_layers,
          "prompt_len": 48, "window": cfg.local_window,
          "logits_close": close,
          "max_abs_err": mlstm_abs_err(lg.cpu(), lc), "tokens_equal": same,
          "kernel_launches": launched})
    if not (close and same and launched == 4):
        raise SystemExit("the reduced recurrentgemma serve path on cuda "
                         "disagrees with the cpu run")


def microsim_equal(got, want) -> bool:
    return all(torch.equal(got[m][k], want[m][k])
               for m in msk.MODES for k in want[m])


def microsim_abs_err(got, want) -> float:
    return max((got[m][k].double() - want[m][k].double()).abs().max().item()
               for m in msk.MODES for k in want[m])


def check_microsim(bw, faults):
    """Phase 18: the §5.2 micro-simulator.  ``microsim_scan`` against
    ``_simulate_batch_plain`` on the card, all 12 grid rows of both
    tables, LARK and baseline, ``torch.equal`` on every output, for each
    of ``microsim_scan.CASES`` (the paper's constants over 2,600 ticks; a
    short outage over 4,000 ticks with small partitions, so the backfill
    ends inside the run): one launch a table, and one launch of both
    tables' grids concatenated (``rows_per_table`` 12, as the main path
    runs them), each planted fault (copies of microsim_scan.cu in
    `faults`) failing a case of the two-table launch; one dependent
    Threefry hash's latency (the key chain's floor).  Then the main path:
    Tables 3-4 at 520,000 ticks through ``microsim_tables.run``, counts
    read around it, one launch, its 24 lines equal to the committed
    reference's byte for byte; the launch's device time (memset and
    kernel, every event of a run counted), the two-table launch's time at
    the check case beside the plain loop's (both tables, both modes, one
    pass a case) and the bounds;
    and the port runner's two smoke rows under backend "event" (host
    numpy) equal to the pinned reference rows.  Returns (the kernels-line
    record, the main path's launches)."""
    t_phase = time.monotonic()
    dev = torch.device(DEVICE)
    caught = {name: [] for name in faults}
    worst, plain_s, timed = 0.0, {}, None
    tables = sorted(microsim.TABLES)    # t3, t4: the main path's order
    rows = len(microsim.TABLE_GRID)
    for case, ticks, fail_t, recover_t, scale in msk.CASES:
        with msk.outage(fail_t, recover_t):
            # the plain loop once over both tables' grids (each table's
            # own draws), sliced per table
            both = [torch.cat(cs) for cs in zip(
                *(msk.case_configs(t, scale, dev) for t in tables))]

            def split(out):
                return {t: {m: {k: v[rows * i:rows * (i + 1)]
                                for k, v in out[m].items()}
                            for m in msk.MODES}
                        for i, t in enumerate(tables)}

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = {m: microsim._simulate_batch_plain(
                         *both, m == "lark", ticks, 0, draw_rows=rows)
                     for m in msk.MODES}
            end.record()
            torch.cuda.synchronize()
            plain_s[case] = start.elapsed_time(end) / 1e3
            wants = split(plain)
            per = {}
            for table in tables:
                x = msk.case_configs(table, scale, dev)
                got = msk.microsim_scan(*x, ticks=ticks)
                want = wants[table]
                same = microsim_equal(got, want)
                worst = max(worst, microsim_abs_err(got, want))
                per[table] = same
                # with the return inside the run, every row's backfill ends
                backfill_ends = bool(
                    (want["lark"]["pending_ts"][:, -1] < 0.5).all()) \
                    if recover_t < ticks else None
                emit({"phase": "microsim", "case": case, "table": table,
                      "ticks": ticks, "fail_t": fail_t,
                      "recover_t": recover_t, "ps_scale": scale,
                      "equal": same, "backfill_ends": backfill_ends,
                      "completions": want["lark"]["per_tick_done"]
                      .sum().item()})
            # both tables in one launch, as the main path runs them
            joint = split(msk.microsim_scan(*both, ticks=ticks,
                                            rows_per_table=rows))
            joint_same = all(microsim_equal(joint[t], wants[t])
                             for t in tables)
            for name, fn in faults.items():
                out, args, keep = msk.launch_args(*both, ticks=ticks,
                                                  rows_per_table=rows)
                _build.check(fn(*args, torch.cuda.current_stream()
                                .cuda_stream), f"microsim_scan {name}")
                torch.cuda.synchronize()
                if not all(microsim_equal(o, wants[t])
                           for t, o in split(out).items()):
                    caught[name].append(case)
                del keep
            emit({"phase": "microsim", "case": case, "tables": tables,
                  "one_launch": True, "equal": joint_same,
                  "plain_s": plain_s[case]})
            if not (all(per.values()) and joint_same):
                raise SystemExit(f"microsim_scan disagrees with its "
                                 f"plain version ({case}): {per}, "
                                 f"two tables {joint_same}")
            if case == "paper_constants":
                timed = (both, ticks, plain_s[case])
    held_faults("microsim_scan", caught)
    chain = msk.chain_ns_per_hash(dev)
    latency_bound_ms = chain["ns_per_hash"] * microsim_tables.TICKS / 1e6
    emit({"phase": "microsim_chain", **chain,
          "ticks": microsim_tables.TICKS,
          "latency_bound_ms": latency_bound_ms})
    if not chain["key_equal"]:
        raise SystemExit("the key chain's end key differs from "
                         "threefry.split_chain's")

    # the main path: both tables through the entry point a user calls
    names = ("microsim_scan", "microsim_plain")
    reset_counts()
    t0 = time.monotonic()
    lines = microsim_tables.lines(microsim_tables.run(device=DEVICE))
    tables_s = time.monotonic() - t0
    launches = read_counts(names)
    same_lines = lines == microsim_tables.reference_lines()

    # the check case's launch: both tables at 2,600 ticks
    x, ticks, plain_t = timed
    ms = time_ms(lambda: msk.microsim_scan(*x, ticks=ticks,
                                           rows_per_table=rows), 10)
    fn = _build.function("microsim_scan", "microsim_scan_launch",
                         msk._ARGTYPES)
    _, args, keep = msk.launch_args(*x, ticks=ticks, rows_per_table=rows)

    def launch(stream):
        return fn(*args, stream)
    # the main path's launch: both tables' 24 rows at 520,000 ticks
    xt = microsim._config_tensors(
        [c for t in tables for c in microsim.table_configs(
            *microsim.TABLES[t])], dev)
    _, targs, tkeep = msk.launch_args(*xt, ticks=microsim_tables.TICKS,
                                      rows_per_table=rows)

    def table_launch(stream):
        return fn(*targs, stream)
    # every device event of a run counted: its memset and its kernel
    main = mcc.device_times(table_launch, reps=3, cold_reps=1, events=2)
    R = x[0].shape[0]                 # both tables' rows
    nbytes, flops, iops = msk.work(R, ticks)
    # the record adds the profiler's device time, a CUDA graph's replay
    # and the L2-cold time of the same launch (mc_check.device_times)
    rec = record("microsim_scan", nbytes, 0, ms, ms, plain_t * 1e3, worst,
                 bw, ops=max(flops / FLOAT_PEAK[torch.float32],
                             iops / INT_OPS) * INT_OPS, launch=launch,
                 events=2)
    del keep, tkeep
    tb, tf, ti = msk.work(R, microsim_tables.TICKS)

    # the runner's event branch (host numpy) on this machine
    t0 = time.monotonic()
    rows_ev = [json.dumps(runner._json_safe(r), sort_keys=True)
               for r in runner.iter_rows(ExperimentSpec.create(smoke=True),
                                         device=DEVICE)]
    event_s = time.monotonic() - t0
    checks = {"tables_equal_reference": same_lines,
              "launches": launches["microsim_scan"] == 1,
              "plain_never_ran": launches["microsim_plain"] == 0,
              "event_rows_equal_reference": rows_ev == EVENT_SMOKE_ROWS}
    emit({"phase": "microsim_tables", "ticks": microsim_tables.TICKS,
          "rows": R, "tables_s": tables_s, "launches": launches,
          "main_launch": main,
          "kernel_us_per_tick": main["device_ms"] * 1e3 /
          microsim_tables.TICKS,
          "plain_ms_per_tick": plain_t * 1e3 / ticks,
          "table_bytes": tb, "table_bytes_bound_ms": tb / bw * 1e3,
          "table_ops_bound_ms": max(tf / FLOAT_PEAK[torch.float32],
                                    ti / INT_OPS) * 1e3,
          "latency_bound_ms": latency_bound_ms,
          "check_ticks": ticks, "check_ms": ms,
          "event_rows_s": event_s, "lines_head": lines[:2], **checks,
          "wall_s": time.monotonic() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"the microsim phase failed: {checks}")
    return rec, launches["microsim_scan"]


# ---------------------------------------------------------------------------
# every other registry architecture: serve_dense and families
# ---------------------------------------------------------------------------

#: serve_dense: smollm-360m (the reference's serve default) at full width
#: and depth, with the serve phase's traffic
DENSE_ARCH = "smollm_360m"
#: the families phase, in order; the depth of the three models whose bf16
#: weights the card cannot hold (mixtral ~93 GB, qwen3-moe ~470 GB,
#: nemotron ~680 GB whole) is cut to 2 layers, every width kept
FAMILIES = ("internlm2_20b", "minicpm3_4b", "qwen2_vl_2b", "whisper_small",
            "mixtral_8x7b", "qwen3_moe_235b_a22b", "nemotron_4_340b")
FAMILY_DEPTH = {"mixtral_8x7b": 2, "qwen3_moe_235b_a22b": 2,
                "nemotron_4_340b": 2}
#: (prompts, prompt length): 4 of 1024 unless named; mixtral's 5120 pass
#: its 4096-token window (the ring wraps, mha's local q-chunk branch
#: runs); whisper's 256 decoder tokens attend to 1500 stub frames
FAMILY_TRAFFIC = {"mixtral_8x7b": (2, 5120), "whisper_small": (4, 256)}
FAMILY_DECODE = 8
#: check (b): decode logits at S-1 after a prefill of S-1 inputs against
#: the prefill of S inputs, max |difference| over the largest |logit|,
#: in bf16 at full width.  Measured on an H100: 0.0072-0.0187 at the
#: right position (2-5 bf16 steps of the largest logit), 0.0296-0.6649
#: one position off (qwen2-vl's least: its random input embeddings
#: outweigh attention); tests/test_torch_dense.py shows on the CPU that
#: a decode one position off exceeds it on every family
DECODE_TOL = 0.025
#: check (c): the reduced float32 config, prompt 48 (past its 32-token
#: window where it has one), on the card against the CPU
FAMILY_CPU_PROMPT = 48


def init_model(cfg, device=None):
    """The model's entry points and its seed-0 weights on `device` (the
    card by default)."""
    model = build_model(cfg)
    gen = torch.Generator(device=device or DEVICE)
    gen.manual_seed(0)
    return model, model["init_params"](gen)


def param_count(params):
    """(elements, bytes) of every tensor leaf."""
    leaves = tree.leaves(params)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def serve_batch(cfg, batch: int, prompt: int, extra: int = 0, device=None):
    """SyntheticLMData's batch 0 without labels, on `device`: tokens (and
    whisper's stub frames), or qwen2-vl's embeddings and (t, h, w) ids,
    over prompt + extra positions (the extra feed qwen2-vl's decode)."""
    raw = SyntheticLMData(cfg, batch, prompt + extra).batch_at(0)
    return {k: torch.from_numpy(v).to(device or DEVICE)
            for k, v in raw.items() if k != "labels"}


def decode_parity(model, params, batch, logits_full, offs=(0,)):
    """Check (b): prefill the batch's first S-1 positions, decode position
    S-1 at S-1+off for each off (0 is the right position), and return
    each max |decode - prefill| over max |prefill logits|, where
    logits_full is the prefill of all S.  The caches hold S+1 positions,
    so a decode one past S-1 has a slot."""
    S = batch["embeds" if "embeds" in batch else "tokens"].shape[1]
    _, state = model["prefill"](params, batch_prefix(batch, S - 1), S + 1)
    last, kw = decode_input(batch, S - 1)
    full = logits_full.float()
    errs = []
    for off in offs:
        if "positions" in kw:
            kw = dict(kw, positions=batch["positions"][:, :, S - 1:S] + off)
        logits, _ = model["decode_step"](params, state, last, S - 1 + off,
                                         **kw)
        errs.append(((logits.float() - full).abs().max()
                     / full.abs().max()).item())
    return errs


def no_drop(cfg):
    """An MoE config whose capacity takes every slot: cf = E / K gives
    C = S, the most slots one row can send an expert (a token's K experts
    are distinct), the same outputs as the reference test's cf = E."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.experts_per_token))


def greedy_decode(model, params, state, logits, batch, S: int, steps: int):
    """steps greedy decode steps after a prefill of S positions.  A token
    model feeds back its argmax; qwen2-vl feeds the batch's next
    embeddings and ids.  Returns (argmax ids (B, steps), per-step logits,
    state)."""
    ids, kept = [], []
    cur = logits.argmax(-1).to(torch.int32)
    for i in range(steps):
        if "embeds" in batch:
            inp, kw = decode_input(batch, S + i)
        else:
            inp, kw = cur, {}
        logits, state = model["decode_step"](params, state, inp, S + i, **kw)
        cur = logits.argmax(-1).to(torch.int32)
        ids.append(cur)
        kept.append(logits)
    return torch.stack(ids, 1), kept, state


def serve_failover(cfg, params, batch, max_len, gen, resume, every):
    """ServeLoop: gen tokens with a session checkpoint every `every` into
    a 4-node rf 2 LarkSessionStore, fail_server(0), resume more from the
    store; against an uninterrupted run of gen + resume.  Returns the
    checks, the first run's tokens and the main path's seconds."""
    sessions = LarkSessionStore(num_nodes=4, rf=2)
    loop = ServeLoop(cfg, params, max_len=max_len, session_store=sessions,
                     checkpoint_every=every, device=DEVICE)
    whole = ServeLoop(cfg, params, max_len=max_len, device=DEVICE)
    finite, resumed_logits, whole_logits = [], [], []
    watch_logits(loop, finite)
    watch_logits(whole, finite)
    keep_decode_logits(loop, resumed_logits)
    keep_decode_logits(whole, whole_logits)
    t0 = time.monotonic()
    toks = loop.generate(batch, steps=gen, session_id="req-0")
    sessions.fail_server(0)
    resumed = loop.resume("req-0", steps=resume)
    uninterrupted = whole.generate(batch, steps=gen + resume)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    checks = {
        "prefix_equal": resumed is not None and
        np.array_equal(resumed[:, :gen], toks),
        "resume_equals_uninterrupted": resumed is not None and
        np.array_equal(resumed, uninterrupted),
        "decode_logits_equal": len(resumed_logits) == len(whole_logits)
        == gen + resume and all(
            torch.equal(a, b) for a, b in zip(resumed_logits, whole_logits)),
        "logits_finite": bool(torch.stack(finite).all().item())}
    return checks, toks, wall


def timed_serve(model, params, batch, S: int, max_len: int, steps: int):
    """A warm-up prefill, a timed prefill of the batch's first S
    positions and `steps` timed greedy decode steps after one warm-up
    step.  Returns (prefill s, decode s, the timed prefill's logits, the
    final state, every logit's finite flag)."""
    finite = []
    prompt = batch_prefix(batch, S)
    with torch.no_grad():
        model["prefill"](params, prompt, max_len)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, state = model["prefill"](params, prompt, max_len)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        finite.append(torch.isfinite(logits).all())
        _, kept, state = greedy_decode(model, params, state, logits, batch,
                                       S, 1)
        finite.append(torch.isfinite(kept[0]).all())
        torch.cuda.synchronize()
        t0 = time.monotonic()
        _, kept, state = greedy_decode(model, params, state, kept[0], batch,
                                       S + 1, steps)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
        finite += [torch.isfinite(k).all() for k in kept]
    return prefill_s, decode_s, logits, state, finite


def check_serve_dense():
    """Phase 19, smollm-360m at full width and depth, the serve phase's
    traffic: 4 prompts of 1024 tokens, 32 greedy tokens with a checkpoint
    every 8, fail_server(0), 8 more, bitwise equal to an uninterrupted
    run (tokens and every decode step's logits)."""
    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(DENSE_ARCH)
    model, params = init_model(cfg)
    n_params, p_bytes = param_count(params)
    batch = serve_batch(cfg, SERVE_BATCH, SERVE_PROMPT)
    max_len = SERVE_PROMPT + SERVE_GEN + SERVE_RESUME
    prefill_s, decode_s, _, state, finite = timed_serve(
        model, params, batch, SERVE_PROMPT, max_len, SERVE_GEN)
    kv_bytes = state_bytes(state)
    del state
    reset_counts()
    checks, toks, main_wall = serve_failover(
        cfg, params, {k: v.cpu().numpy() for k, v in batch.items()},
        max_len, SERVE_GEN, SERVE_RESUME, 8)
    launches = {k: v for k, v in read_counts(counters()).items() if v}
    checks["logits_finite"] = checks["logits_finite"] and bool(
        torch.stack(finite).all().item())
    checks["no_kernel_on_path"] = not launches
    emit({"phase": "serve_dense", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "vocab": cfg.vocab_size, "dtype": cfg.act_dtype,
          "params": n_params, "param_bytes": p_bytes,
          "kv_cache_bytes": kv_bytes, "batch": SERVE_BATCH,
          "prompt_len": SERVE_PROMPT, "max_len": max_len,
          "generated": SERVE_GEN, "resumed": SERVE_RESUME,
          "prefill_s": prefill_s,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
          "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / decode_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "main_path_wall_s": main_wall, "launches": launches,
          "tokens_head": toks[:, :6].tolist(), **checks,
          "wall_s": time.monotonic() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"the smollm serve phase failed: {checks}")


def family_cpu_check(arch: str):
    """Check (c): the reduced float32 config with the same seed-0 weights
    on the card and on the CPU.  Prefill logits within rtol 1e-3 and atol
    1e-3 of the largest, and FAMILY_DECODE greedy argmax ids equal."""
    cfg = reduced_config(arch)
    model, params = init_model(cfg, "cpu")
    gpu_params = tree.map_leaves(lambda t: t.to(DEVICE), params)
    S = FAMILY_CPU_PROMPT
    max_len = S + FAMILY_DECODE
    out = {}
    for dev, p in (("cpu", params), (DEVICE, gpu_params)):
        batch = serve_batch(cfg, 2, S, FAMILY_DECODE, dev)
        with torch.no_grad():
            logits, state = model["prefill"](p, batch_prefix(batch, S),
                                             max_len)
            ids, _, _ = greedy_decode(model, p, state, logits, batch, S,
                                      FAMILY_DECODE)
        out[dev] = (logits.cpu(), ids.cpu())
    (lc, ic), (lg, ig) = out["cpu"], out[DEVICE]
    scale = max(1.0, lc.abs().max().item())
    return {"cpu_logits_close": torch.allclose(lg, lc, atol=1e-3 * scale,
                                               rtol=1e-3),
            "cpu_max_abs_err": mlstm_abs_err(lg, lc),
            "cpu_tokens_equal": torch.equal(ig, ic)}


def check_family(arch: str):
    """One architecture of phase 20 at full width: (a) every logit
    finite, (b) decode against prefill within DECODE_TOL, (c) the reduced
    config on the card against the CPU; whisper also serves through
    ServeLoop with a failover, bitwise."""
    t_arch = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = full.replace(num_layers=FAMILY_DEPTH.get(arch, full.num_layers))
    model, params = init_model(cfg)
    n_params, p_bytes = param_count(params)
    Bn, S = FAMILY_TRAFFIC.get(arch, (SERVE_BATCH, SERVE_PROMPT))
    batch = serve_batch(cfg, Bn, S, FAMILY_DECODE + 1)
    prompt = batch_prefix(batch, S)
    max_len = S + FAMILY_DECODE + 1
    reset_counts()
    prefill_s, decode_s, logits, state, finite = timed_serve(
        model, params, batch, S, max_len, FAMILY_DECODE)
    sbytes = state_bytes(state)
    del state
    with torch.no_grad():
        if cfg.moe is None:
            pmodel, full_logits = model, logits
        else:
            pmodel = build_model(no_drop(cfg))
            full_logits, _ = pmodel["prefill"](params, prompt, S + 1)
        parity, *one_off = decode_parity(pmodel, params, prompt,
                                         full_logits, offs=(0, -1, 1))
        del full_logits
    checks = {"logits_finite": bool(torch.stack(finite).all().item()),
              "decode_matches_prefill": parity <= DECODE_TOL,
              "one_off_fails": min(one_off) > DECODE_TOL}
    rec = {}
    if cfg.is_encoder_decoder:
        np_batch = {k: v.cpu().numpy() for k, v in prompt.items()}
        served, toks, rec["main_path_wall_s"] = serve_failover(
            cfg, params, np_batch, S + 2 * FAMILY_DECODE, FAMILY_DECODE,
            FAMILY_DECODE, FAMILY_DECODE)
        checks.update(served)
        rec["tokens_head"] = toks[:, :6].tolist()
    launches = {k: v for k, v in read_counts(counters()).items() if v}
    del params, model, pmodel
    torch.cuda.empty_cache()
    cpu = family_cpu_check(arch)
    checks["cpu_logits_close"] = cpu.pop("cpu_logits_close")
    checks["cpu_tokens_equal"] = cpu.pop("cpu_tokens_equal")
    checks["no_kernel_on_path"] = not launches
    rec.update({
        "arch": arch, "layers": cfg.num_layers,
        "depth_cut": None if cfg.num_layers == full.num_layers else
        f"{full.num_layers} -> {cfg.num_layers} layers",
        "enc_layers": cfg.enc_layers or None, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "window": cfg.window or None,
        "experts": None if cfg.moe is None else
        [cfg.moe.num_experts, cfg.moe.experts_per_token],
        "mla": None if cfg.mla is None else dataclasses.asdict(cfg.mla),
        "mrope_sections": list(cfg.mrope_sections) or None,
        "dtype": cfg.act_dtype, "params": n_params, "param_bytes": p_bytes,
        "decode_state_bytes": sbytes, "batch": Bn, "prompt_len": S,
        "prefill_s": prefill_s, "prefill_tokens_per_s": Bn * S / prefill_s,
        "decode_tokens_per_s": Bn * FAMILY_DECODE / decode_s,
        "decode_parity": parity, "decode_one_off": one_off,
        "decode_tol": DECODE_TOL, **cpu,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, **checks,
        "wall_s": time.monotonic() - t_arch})
    return rec, checks


def check_families():
    """Phase 20: every other registry architecture at full width."""
    t_phase = time.monotonic()
    failed = {}
    for arch in FAMILIES:
        rec, checks = check_family(arch)
        emit({"phase": "families", **rec})
        failed.update({f"{arch}.{k}": v for k, v in checks.items() if not v})
    emit({"phase": "families_total", "archs": len(FAMILIES),
          "depth_cuts": {a: f"{get_config(a).num_layers} -> {d}"
                         for a, d in FAMILY_DEPTH.items()},
          "failed": sorted(failed), "wall_s": time.monotonic() - t_phase})
    if failed:
        raise SystemExit(f"the families phase failed: {sorted(failed)}")


# ---------------------------------------------------------------------------
# training: the backward kernels, the train step and its stores
# ---------------------------------------------------------------------------

def mlstm_bwd_flops(B, H, S, Dq, Dv, chunk):
    """Float ops the mLSTM gradient needs from q, k, v, the gates and dh:
    per (b, h, chunk of l positions) the causal pairs' q k^T and dh v^T
    (once each), their weights times k for dq, q for dk and delta for dv
    (2 (Dq + Dv + Dq + Dq + Dv) per pair); and per chunk the state terms,
    2 l Dq Dv each: the chunk-start state C (every chunk but the last),
    C dh (num's carry, reused for dq's) and G's update (every chunk but
    the first), G v and G^T k (every chunk but the last).  The kernel's
    second q k^T and dh v^T (its columns pass) are not counted."""
    total, nC = 0, -(-S // chunk)
    for c in range(nC):
        ln = min(chunk, S - c * chunk)
        pairs = ln * (ln + 1) // 2
        total += 2 * pairs * (3 * Dq + 2 * Dv)
        states = (c + 1 < nC) * 3 + (c > 0) * 2
        total += states * 2 * ln * Dq * Dv
    return B * H * total


def mlstm_bwd_bytes(B, H, S, Dq, Dv, dtype):
    """Each input read once, each output written once: q, k, v, dh in and
    dq, dk, dv out in `dtype`, log_f and log_i in and their gradients out
    in float32."""
    isz = torch.tensor([], dtype=dtype).element_size()
    return isz * B * H * S * (4 * Dq + 3 * Dv) + 16 * B * H * S


def check_rglru_bwd_kernel(bw, faults):
    """Phase 22: rglru_scan_bwd against its plain version in float64 on
    the card (``rglru_check.BWD_CASES``: the train shape, ragged S and W,
    S below the chunk, S = 1, the reduced width, long memory and log_a
    near 0), each element within ``rglru_check.rglru_bwd_allowance``, a
    bitwise repeat, each planted fault (``rglru_check.BWD_FAULTS``, run on
    outputs filled with NaN) failing a case; then its time at each of
    ``rglru_check.BWD_TIMED_SHAPES``, each on a kernel_time line of its
    own.  Returns the record at the last, the train path's microbatch
    (B = 1), for the kernels line."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(24)
    caught = {name: [] for name in faults}
    worst = 0.0
    for case, S, W, kind in rc.BWD_CASES:
        x, la, h, dh = rc.rglru_bwd_inputs(gen, rc.BWD_BATCH, S, W, kind)
        got = rk.rglru_scan_bwd(x, la, h, dh)
        torch.cuda.synchronize()
        again = rk.rglru_scan_bwd(x, la, h, dh)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want, allowed = rc.bwd_reference(x, la, h, dh)
        err = rc.rglru_bwd_error(got, want, allowed)
        abs_err = max((g.double() - w).abs().max().item()
                      for g, w in zip(got, want))
        if case == "train":           # the kernels line's max_abs_err
            worst = abs_err
        fault_errs = {}
        for name, fn in faults.items():
            fault_errs[name] = rc.rglru_bwd_error(
                rc.run_bwd(fn, x, la, h, dh), want, allowed)
            if fault_errs[name] > 1.0:
                caught[name].append(case)
        ok = err <= 1.0 and same
        emit({"phase": "rglru_bwd", "case": case,
              "shape": [rc.BWD_BATCH, S, W], "gates": kind,
              "error_over_allowed": err, "deterministic": same,
              "max_abs_err": abs_err, "faults_error_over_allowed":
              fault_errs})
        if not ok:
            raise SystemExit(f"rglru_scan_bwd disagrees with its plain "
                             f"version ({case}): {err}, {same}")
        del x, la, h, dh, got, again, want, allowed
    held_faults("rglru_scan_bwd", caught)

    fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd_launch",
                         rk.BWD_ARGTYPES)
    for shape in rc.BWD_TIMED_SHAPES:
        x, la, h, dh = rc.rglru_bwd_inputs(gen, *shape, "model")
        _, args, keep = rk.bwd_launch_args(x, la, h, dh)

        def launch(stream):
            return fn(*args, stream)

        ms = mcc.event_ms(launch, reps=50)
        wrap_ms = time_ms(lambda: rk.rglru_scan_bwd(x, la, h, dh), 50)
        plain_ms = time_ms(lambda: rk.rglru_scan_bwd_plain(x, la, h, dh), 2)
        n = math.prod(shape)
        # x, log_a, h, dh in, dx, dla out, float32; three exp, a sqrt, a
        # divide and ~10 other float ops per element on the float32 CUDA
        # cores
        rec = record("rglru_scan_bwd", 6 * 4 * n, 0, ms, wrap_ms, plain_ms,
                     worst, bw, ops=15 * n, rate=FLOAT_PEAK[torch.float32],
                     launch=launch, shape=shape)
        del x, la, h, dh, keep
    return rec


def check_mlstm_bwd_kernel(bw, faults):
    """Phase 23: mlstm_chunkwise_bwd against its plain version in float64
    on the card (``mlstm_check.BWD_CASES``: the train shape in bf16 and
    float32, the reduced float32 shapes, ragged S, S below the chunk, S =
    1, head dims and a chunk off the 64-wide tile, the stabilizer stress,
    rows where the clamp holds, and sm90 shapes off the 256 grid), each
    output within
    ``mlstm_check.mlstm_bwd_rounding_scale``: through the entry point,
    which takes the route of ``mlstm_chunk.bwd_route`` (the bf16 cases
    at 64-multiple dims: csrc/mlstm_chunk_bwd_sm90.cu; the float32 ones:
    csrc/mlstm_chunk_bwd.cu), with a bitwise repeat and each route's
    launches counted; the SIMT source also by its launcher on every case
    its shared memory holds; each source's planted faults
    (``mlstm_check.BWD_SOURCE_FAULTS``, in `faults` by source) failing a
    case it takes; then each source's time at its main path's shape.
    Returns {kernel: record}."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(25)
    caught = {src: {name: [] for name in faults[src]}
              for src in mc.BWD_SOURCE_FAULTS}
    worst = {"mlstm_chunkwise_bwd": 0.0, "mlstm_chunkwise_bwd_sm90": 0.0}
    simt = _build.function(*mk.BWD_ROUTES["simt"])
    reset_counts()
    routes = {}
    for case, dtype, B, H, S, Dq, Dv, L, kind in mc.BWD_CASES:
        args = mc.mlstm_bwd_inputs(gen, B, H, S, Dq, Dv, dtype, kind)
        route = mk.bwd_route(dtype, Dq, Dv, L)
        routes[case] = route
        got = mk.mlstm_chunkwise_bwd(*args, chunk=L)
        torch.cuda.synchronize()
        again = mk.mlstm_chunkwise_bwd(*args, chunk=L)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want, scales = mc.bwd_reference((*args, L))
        errs = mc.mlstm_bwd_errors(got, want, scales)
        simt_errs = errs if route == "simt" else mc.mlstm_bwd_errors(
            mc.run_bwd(simt, *args, L), want, scales) \
            if mc.bwd_takes("mlstm_chunk_bwd", dtype, Dq, Dv, L) else {}
        abs_err = {n: (g.double() - w).abs().max().item() for n, g, w in
                   zip(("dq", "dk", "dv", "dlog_f", "dlog_i"), got, want)}
        # the kernels line's max_abs_err: each source at its main path's
        # shape (the xlstm-350m train step's, the reduced xlstm's)
        if case == "train_bf16":
            worst["mlstm_chunkwise_bwd_sm90"] = max(abs_err.values())
        if case == "train_cpu_f32":
            worst["mlstm_chunkwise_bwd"] = max(abs_err.values())
        fault_errs = {}
        for src, fns in faults.items():
            if not mc.bwd_takes(src, dtype, Dq, Dv, L):
                continue
            for name, fn in fns.items():
                e = mc.mlstm_bwd_errors(
                    mc.run_bwd(fn, *args, L, mc.BWD_SOURCE_ROUTE[src]),
                    want, scales)
                fault_errs[f"{src}:{name}"] = max(e.values())
                if fault_errs[f"{src}:{name}"] > 1.0:
                    caught[src][name].append(case)
        ok = all(e <= 1.0 for e in errs.values()) and same and \
            all(e <= 1.0 for e in simt_errs.values())
        emit({"phase": "mlstm_bwd", "case": case, "dtype": str(dtype),
              "shape": [B, H, S, Dq, Dv, L], "gates": kind, "route": route,
              "clamp_rows": mc.clamp_rows(*args, L),
              "errors_over_allowed": errs,
              "simt_errors_over_allowed": simt_errs, "gamma": mc.BWD_GAMMA,
              "out_step": mc.OUT_STEP[dtype], "deterministic": same,
              "max_abs_err": abs_err,
              "faults_error_over_allowed": fault_errs})
        if not ok:
            raise SystemExit(f"mlstm_chunkwise_bwd disagrees with its plain "
                             f"version ({case}, {route}): {errs}, "
                             f"simt {simt_errs}, {same}")
        del args, got, again, want, scales
    counts = read_counts(("mlstm_chunkwise_bwd", "mlstm_chunkwise_bwd_sm90"))
    want_counts = {"mlstm_chunkwise_bwd": 2 * sum(
                       r == "simt" for r in routes.values()),
                   "mlstm_chunkwise_bwd_sm90": 2 * sum(
                       r == "sm90" for r in routes.values())}
    emit({"phase": "mlstm_bwd", "routes": routes, "launches": counts,
          "predicted_launches": want_counts})
    if counts != want_counts or want_counts["mlstm_chunkwise_bwd_sm90"] == 0:
        raise SystemExit(f"mlstm_chunkwise_bwd's routes launched {counts}, "
                         f"not {want_counts}")
    for src, got in caught.items():
        held_faults(src, got)

    recs = {}
    # each source at its main path's shape through the entry point: the
    # sm90 route at the xlstm-350m train step's (bf16, bound by the bf16
    # tensor-core rate; the float32 CUDA-core figure printed beside it),
    # the SIMT source at the reduced xlstm's (train_cpu: float32, bound
    # by the float32 CUDA-core rate)
    for kname, route, (B, H, S, D, L), dtype in (
            ("mlstm_chunkwise_bwd_sm90", "sm90", (4, 4, 1024, 512, 256),
             torch.bfloat16),
            ("mlstm_chunkwise_bwd", "simt", (2, 4, 300, 32, 256),
             torch.float32)):
        args = mc.mlstm_bwd_inputs(gen, B, H, S, D, D, dtype, "gates")
        assert mk.bwd_route(dtype, D, D, L) == route
        plain_ms = time_ms(
            lambda: mk.mlstm_chunkwise_bwd_plain(*args, chunk=L), 3)
        flops = mlstm_bwd_flops(B, H, S, D, D, L)
        fn = _build.function(*mk.BWD_ROUTES[route])
        a, _, keep = mk.bwd_launch_args(*args, L, route=route)

        def launch(stream, fn=fn, a=a):
            return fn(*a[:-1], stream)

        ms = mcc.event_ms(launch, reps=20)
        wrap_ms = time_ms(lambda: mk.mlstm_chunkwise_bwd(*args, chunk=L), 20)
        recs[kname] = record(kname, mlstm_bwd_bytes(B, H, S, D, D, dtype),
                             0, ms, wrap_ms, plain_ms, worst[kname], bw,
                             ops=flops, rate=FLOAT_PEAK[dtype], launch=launch)
        emit({"phase": "kernel_time", "kernel": kname, "route": route,
              "shape": [B, H, S, D, D, L], "dtype": str(dtype),
              "flops": flops, "tflops": flops / ms / 1e9,
              "f32_cuda_core_bound_ms":
              flops / FLOAT_PEAK[torch.float32] * 1e3})
        del args, keep
    return recs


#: the train phases: (arch, depth or None for the config's, batch, seq,
#: steps, microbatches or None for the config's, the step at which
#: worker 3 is lost).  xlstm-350m whole, 4 steps: a step takes ~12 s,
#: 330,000 kernel launches of the sLSTM's per-token loop (forward, remat
#: recompute, backward; measured on one H100);
#: recurrentgemma-9b at full width cut to one (RGLRU, RGLRU, LOCAL_ATTN)
#: pattern (its 9.40 B parameters with float32 gradients and AdamW's
#: float32 moments need about 131 GB; 3 layers need ~40), in the train
#: launcher's 2 microbatches; smollm-360m whole
TRAIN_CELLS = {"train": ("xlstm_350m", None, 4, 1024, 4, None, 1),
               "train_rg": ("recurrentgemma_9b", 3, 2, 2048, 4, 2, 1),
               "train_dense": ("smollm_360m", None, 4, 1024, 8, None, 4)}
#: the stores of the launch.train loop: 4 workers at rf 2, a checkpoint
#: every TRAIN_EVERY steps; keys ckpt/2 and ckpt/6 have worker 3 as a
#: data replica, so the baseline's hydration window (20 steps) shows
TRAIN_EVERY, TRAIN_LR = 2, 1e-3
#: kernels against plain versions on step 0 (bf16 models with a cell
#: kernel), all gated: the loss within LOSS_ATOL (~1e-3 of ~10.8); at the
#: cells, on step 0's own inputs and upstream gradients (``CellSpy``),
#: each kernel's forward and backward within the float32 allowance of
#: ``rglru_check`` / ``mlstm_check`` against its plain version in
#: float64, at the first, middle and last call of each cell kind; and the
#: whole gradient, against the plain versions with float32 sums (g_plain)
#: and with float64 sums (g_f64).  Over the leaves, the median of |g -
#: g_f64| / |g_f64| within GRAD_MEDIAN_FACTOR times the plain versions'
#: own median: at full depth in bf16 rounding alone moves xlstm-350m's
#: leaves by a median 24.5 % (``python -m repro_torch.profile_train
#: --conditioning``, measured on one H100), the kernels 30.6 %, so no
#: per-leaf tolerance there tells a wrong kernel from rounding.  In the
#: phases of LEAF_GATE, where rounding moves no leaf by more than ~1 %
#: (recurrentgemma: 0.63 % median, 0.88 % largest), also every leaf:
#: |g - g_plain| within GRAD_RTOL |g_plain| plus GRAD_FLOOR times the
#: whole plain gradient's norm (the floor: an mLSTM head's h does not
#: change when all its log_i shift together, so b_i's gradient is a sum
#: that cancels)
LOSS_ATOL, GRAD_MEDIAN_FACTOR = 1e-2, 2.0
GRAD_RTOL, GRAD_FLOOR = 0.05, 1e-3
LEAF_GATE = {"train_rg"}
#: the kernels each cell's blocks launch: (forward counter, backward
#: counter, plain forward, plain backward)
CELL_KERNELS = {"mLSTM": ("mlstm_chunkwise_sm90", "mlstm_chunkwise_bwd_sm90",
                          "mlstm_chunkwise_plain",
                          "mlstm_chunkwise_bwd_plain"),
                "RG-LRU": ("rglru_scan", "rglru_scan_bwd",
                           "rglru_scan_plain", "rglru_scan_bwd_plain")}


class deterministic:
    """Within: torch's deterministic algorithms (an op without one warns),
    so that a train step repeats bit for bit."""

    def __enter__(self):
        self.was = torch.are_deterministic_algorithms_enabled()
        self.fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.use_deterministic_algorithms(True, warn_only=True)
        # torch.empty's buffers stay unfilled: every kernel writes its own
        torch.utils.deterministic.fill_uninitialized_memory = False

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was)
        torch.utils.deterministic.fill_uninitialized_memory = self.fill


class CellSpy:
    """Within: ``ops.mlstm_chunkwise`` and ``ops.rglru_scan`` record, while
    ``on`` (inside the loss function ``loss_fn`` wraps, not in a remat
    recompute), each call's inputs and, by a hook on its output, the
    gradient that reaches h; ``check`` then holds the kernels against
    their plain versions in float64 on those inputs."""

    def __enter__(self):
        self.saved = (ops.mlstm_chunkwise, ops.rglru_scan)
        self.on, self.calls = False, []
        ops.mlstm_chunkwise = self._spy(self.saved[0], "mLSTM")
        ops.rglru_scan = self._spy(self.saved[1], "RG-LRU")
        return self

    def __exit__(self, *exc):
        ops.mlstm_chunkwise, ops.rglru_scan = self.saved

    def _spy(self, fn, kind):
        def spy(*args, **kw):
            out = fn(*args, **kw)
            if self.on:
                entry = {"kind": kind, "args": [a.detach() for a in args]}
                h = out[0] if kind == "mLSTM" else out
                if h.requires_grad:
                    h.register_hook(
                        lambda g, e=entry: e.__setitem__("dh", g.detach()))
                self.calls.append(entry)
            return out
        return spy

    def loss_fn(self, fn):
        def wrapped(params, batch):
            self.on = True
            try:
                return fn(params, batch)
            finally:
                self.on = False
        return wrapped

    def check(self):
        """{kind: [per checked call: largest error over its allowance of
        the forward and of the backward]}, at the first, middle and last
        call of each kind."""
        out = {}
        for kind in ("mLSTM", "RG-LRU"):
            calls = [c for c in self.calls if c["kind"] == kind]
            picks = sorted({0, len(calls) // 2, len(calls) - 1}) \
                if calls else []
            out[kind] = [self._held(kind, calls[i]) for i in picks]
        self.calls = []
        return {k: v for k, v in out.items() if v}

    @staticmethod
    def _held(kind, call):
        """The kernels' errors over their allowances ("fwd", "bwd"), and
        the plain versions' in float32 beside them ("*_plain").  For the
        mLSTM, whose forward is held against the plain float32 h, also
        the share of bf16 h elements that differ from the float64 sums'
        h rounded to bf16, for the kernel and for the plain version."""
        dh = call["dh"]
        with torch.no_grad():
            if kind == "mLSTM":
                args = call["args"]
                h, state = mk.mlstm_chunkwise(*args)
                (wh, wst), scales = mc.reference(args, 256, None)
                fwd = mc.mlstm_errors(h, state, wh, wst, scales)
                h_plain = mk.mlstm_chunkwise_plain(*args)[0]
                with plain_cells(f64=True):
                    h64 = mk.mlstm_chunkwise_plain(*args)[0]
                want, bsc = mc.bwd_reference((*args, dh, 256))
                bwd = mc.mlstm_bwd_errors(mk.mlstm_chunkwise_bwd(*args, dh),
                                          want, bsc)
                bwd_p = mc.mlstm_bwd_errors(
                    mk.mlstm_chunkwise_bwd_plain(*args, dh), want, bsc)
                return {"fwd": max(fwd.values()), "bwd": max(bwd.values()),
                        "bwd_plain": max(bwd_p.values()),
                        "h_differs_kernel": (h != h64).float().mean().item(),
                        "h_differs_plain": (h_plain != h64).float().mean()
                        .item(),
                        "clamp_rows": mc.clamp_rows(*args, dh, 256)}
            x, la = call["args"]
            h = rk.rglru_scan(x, la)
            want, allowed = rc.reference(x, la)
            fwd = rc.rglru_error(h, want, allowed)
            fwd_p = rc.rglru_error(rk.rglru_scan_plain(x, la), want, allowed)
            want, allowed = rc.bwd_reference(x, la, h, dh)
            bwd = rc.rglru_bwd_error(rk.rglru_scan_bwd(x, la, h, dh), want,
                                     allowed)
            bwd_p = rc.rglru_bwd_error(rk.rglru_scan_bwd_plain(x, la, h, dh),
                                       want, allowed)
            return {"fwd": fwd, "bwd": bwd, "fwd_plain": fwd_p,
                    "bwd_plain": bwd_p}


def train_batch(data, step):
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in data.batch_at(step).items()}


def step0_checks(model, params, batch, nmb, leaf_gate):
    """Step 0's gradient, checked off the main path: every leaf finite
    and not all zero; the same step again bitwise equal; where the model
    has a cell kernel, the kernels at the cells against their plain
    versions on this step's inputs and upstream gradients (``CellSpy``)
    and the same step with the cells' plain forward and backward, with
    float32 and with float64 sums: the loss and the gradient as the
    comment on LOSS_ATOL says, every leaf too with `leaf_gate`."""
    def grads(fn=model["loss_fn"]):
        return accumulate_grads(fn, params, batch, nmb)

    with CellSpy() as spy:
        loss, g = grads(spy.loss_fn(model["loss_fn"]))
        cells = spy.check()
    flat = tree.leaves_with_paths(g)
    arrived = {tree.path_name(p): bool(torch.isfinite(x).all().item() and
                                       (x != 0).any().item())
               for p, x in flat}
    loss2, g2 = grads()
    same = torch.equal(loss, loss2) and all(
        torch.equal(a, b) for a, b in zip(tree.leaves(g), tree.leaves(g2)))
    del g2
    out = {"grads_arrive": all(arrived.values()),
           "missing_grads": sorted(k for k, v in arrived.items() if not v),
           "leaves": len(arrived), "deterministic": same,
           "loss_kernel": loss.item()}
    if not cells:
        # no cell kernel: a plain pass would repeat this one
        return out
    with plain_cells():
        loss_p, g_p = grads()
    with plain_cells(f64=True):
        loss_64, g_64 = grads()
    rows = leaf_distances(g, g_p, g_64)
    del g, g_p, g_64
    total = math.sqrt(sum(r["plain_norm"] ** 2 for r in rows))
    moved = sorted(r["leaf"] for r in rows if r["kernels_vs_plain"] >
                   GRAD_RTOL * r["plain_norm"] + GRAD_FLOOR * total)
    rel = sorted(r["kernels_vs_plain"] / max(r["plain_norm"], 1e-30)
                 for r in rows)
    med_k = statistics.median(r["kernels_vs_f64"] for r in rows)
    med_p = statistics.median(r["plain_vs_f64"] for r in rows)
    cells_ok = all(e["fwd"] <= 1.0 and e["bwd"] <= 1.0
                   for v in cells.values() for e in v)
    loss_ok = abs(loss.item() - loss_p.item()) <= LOSS_ATOL
    median_ok = med_k <= GRAD_MEDIAN_FACTOR * med_p
    out.update({
        "loss_plain": loss_p.item(), "loss_plain_f64": loss_64.item(),
        "loss_vs_plain": abs(loss.item() - loss_p.item()),
        "cells_vs_plain_f64": cells, "cells_match_plain": cells_ok,
        "grad_norm_plain": total,
        "grad_median_kernels_vs_f64": med_k,
        "grad_median_plain_vs_f64": med_p,
        "grad_rel_vs_plain_median": rel[len(rel) // 2],
        "grad_rel_vs_plain_max": rel[-1],
        "leaves_moved": len(moved), "leaf_gate": leaf_gate,
        "kernels_match_plain": loss_ok and cells_ok and median_ok and
        (not leaf_gate or not moved)})
    return out


def check_train(phase, gpu):
    """The train phases: one cell of ``TRAIN_CELLS`` at full width through
    ``make_train_step`` with AdamW and remat as configured, random seed-0
    weights and ``SyntheticLMData`` traffic.  Step 0 off the main path
    (``step0_checks``); then the main path, every counter at 0 first:
    the steps (the last under the profiler), a checkpoint every
    TRAIN_EVERY steps into the LARK store and the quorum-log baseline,
    worker 3 lost at the cell's step; the cells' kernel launches as the
    layers, remat and microbatches predict, their plain versions never
    run; LARK committing every checkpoint, the baseline pausing.
    Returns the cells' launches."""
    t_phase = time.monotonic()
    arch, depth, Bn, S, steps, nmb, fail_at = TRAIN_CELLS[phase]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = full.replace(num_layers=depth or full.num_layers,
                       microbatches_train=nmb or full.microbatches_train)
    nmb = max(1, cfg.microbatches_train)
    model = build_model(cfg)
    init_fn, step_fn, _ = make_train_step(cfg, peak_lr=TRAIN_LR)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params, opt_state = init_fn(gen)
    n_params, p_bytes = param_count(params)
    data = SyntheticLMData(cfg, Bn, S)
    t_checks = time.monotonic()
    checks = step0_checks(model, params, train_batch(data, 0), nmb,
                          phase in LEAF_GATE)
    checks_wall = time.monotonic() - t_checks

    kinds = layer_kinds(cfg)
    cells = {"mLSTM": kinds.count(MLSTM), "RG-LRU": kinds.count(RGLRU)}
    lark = LarkStore(4, rf=2, num_partitions=16)
    base = QuorumLogStore(4, rf=2, num_partitions=16, partition_bytes=1e8,
                          bandwidth=5e6)
    records, walls = [], []
    reset_counts()
    torch.cuda.synchronize()
    t_main = time.monotonic()
    for step in range(steps):
        if step == fail_at:
            lark.fail_node(3)
            base.fail_node(3)
        t0 = time.monotonic()
        batch = train_batch(data, step)
        if step < steps - 1:
            params, opt_state, m = step_fn(params, opt_state, batch)
        else:                       # the last step, under the profiler
            out = []
            prof = profile_step(lambda: out.append(
                step_fn(params, opt_state, batch)), top=8)
            (params, opt_state, m), = out
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        base.advance(1.0)
        rec = {"step": step, "loss": m["loss"].item(),
               "grad_norm": m["grad_norm"].item()}
        if step % TRAIN_EVERY == 0:
            ok, tot = lark.put_pytree(f"ckpt/{step}",
                                      {"loss": np.float32(rec["loss"])})
            rec.update(lark_commit=ok == tot,
                       baseline_commit=base.put(f"ckpt/{step}", rec["loss"]))
        records.append(rec)
    main_wall = time.monotonic() - t_main
    counts = read_counts(counters())
    launches = {k: v for k, v in counts.items() if v}
    remat = 2 if cfg.remat else 1
    want = {}
    for cell, n in cells.items():
        if n:
            fwd, bwd, pf, pb = CELL_KERNELS[cell]
            want.update({fwd: steps * nmb * n * remat, bwd: steps * nmb * n,
                         pf: 0, pb: 0})
    checks["launches_as_predicted"] = \
        all(counts[k] == v for k, v in want.items()) and \
        set(launches) == {k for k, v in want.items() if v}
    commits = [r for r in records if "lark_commit" in r]
    checks["lark_commits_through_failure"] = all(r["lark_commit"]
                                                 for r in commits)
    checks["baseline_pauses"] = any(not r["baseline_commit"]
                                    for r in commits if r["step"] >=
                                    fail_at)
    checks["losses_finite"] = all(math.isfinite(r["loss"]) for r in records)
    # step 0 is cold, the last step profiled: the rest are warm
    warm = walls[1:-1]
    shares = {"wall_s": prof["wall_s"], "trace_s": prof["trace_s"],
              "device_busy_s": prof["device_busy_s"],
              "idle_share_of_warm_step": 1 - prof["device_busy_s"] *
              len(warm) / sum(warm),
              "shares": prof["cell_shares"], "top": prof["top"]}
    gated = ["grads_arrive", "deterministic", "launches_as_predicted",
             "lark_commits_through_failure", "baseline_pauses",
             "losses_finite"] + (["kernels_match_plain"] if
                                 "kernels_match_plain" in checks else [])
    ok = all(checks[k] for k in gated)
    emit({"phase": phase, "gpu": gpu, "arch": arch, "layers": cfg.num_layers,
          "depth_cut": None if cfg.num_layers == full.num_layers else
          f"{full.num_layers} -> {cfg.num_layers} layers",
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "dtype": cfg.act_dtype, "params": n_params, "param_bytes": p_bytes,
          "optimizer": cfg.optimizer, "remat": cfg.remat,
          "microbatches": nmb, "batch": Bn, "seq": S, "steps": steps,
          "worker_lost_at": fail_at,
          "cells": cells, "predicted_launches": want, "launches": launches,
          "records": records,
          "loss_per_step": [r["loss"] for r in records],
          "ms_per_step_warm": 1e3 * sum(warm) / len(warm),
          "train_tokens_per_s_warm": Bn * S * len(warm) / sum(warm),
          "step0_wall_s": walls[0], "main_path_wall_s": main_wall,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "profiled_step": shares, "step0_checks_wall_s": checks_wall,
          "loss_atol": LOSS_ATOL, "grad_median_factor": GRAD_MEDIAN_FACTOR,
          "grad_rtol": GRAD_RTOL, "grad_floor": GRAD_FLOOR, **checks,
          "gated": gated, "wall_s": time.monotonic() - t_phase})
    if not ok:
        raise SystemExit(f"the {phase} phase failed: {checks}")
    del params, opt_state
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want if want[k]}


def check_train_cpu():
    """Phase train_cpu: the reduced xlstm config (float32: the forward
    takes the simt route, the backward kernel its float32 path) over 300
    positions (two chunks) and the 5-layer reduced recurrentgemma over 48
    (past its 32-token window): loss and every gradient leaf on the card
    against the CPU, within the whole-model tolerance of
    ``tests/_torch_lm.py`` (rtol 1e-3, atol 1e-3 of the leaf's largest
    magnitude).  Returns the card's launches of the kernels (the
    xlstm's SIMT backward among them)."""
    failed, total = [], {}
    for arch, S in (("xlstm_350m", 300), ("recurrentgemma_9b", 48)):
        cfg = reduced_config(arch)
        model, params = init_model(cfg, "cpu")
        batch = SyntheticLMData(cfg, 2, S).batch_at(0)
        out = {}
        for dev in ("cpu", DEVICE):
            p = tree.map_leaves(lambda t: t.to(dev), params)
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            reset_counts()
            loss, grads = accumulate_grads(model["loss_fn"], p, b)
            out[dev] = (loss.cpu(),
                        tree.map_leaves(lambda t: t.cpu(), grads),
                        {k: v for k, v in read_counts(counters()).items()
                         if v})
        (lc, gc, _), (lg, gg, launches) = out["cpu"], out[DEVICE]
        worst = 0.0
        close = torch.allclose(lg, lc, rtol=1e-3, atol=1e-3)
        for g, w in zip(tree.leaves(gg), tree.leaves(gc)):
            scale = max(1.0, w.abs().max().item())
            worst = max(worst, ((g - w).abs().max().item()) / scale)
            close &= torch.allclose(g, w, rtol=1e-3, atol=1e-3 * scale)
        emit({"phase": "train_cpu", "arch": arch, "layers": cfg.num_layers,
              "seq": S, "loss_cpu": lc.item(), "loss_cuda": lg.item(),
              "worst_abs_over_scale": worst, "close": close,
              "launches": launches})
        if not close:
            failed.append(arch)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    if failed:
        raise SystemExit(f"train_cpu: the card's gradients differ from the "
                         f"CPU's for {failed}")
    if not total.get("mlstm_chunkwise_bwd"):
        raise SystemExit(f"train_cpu: the SIMT mLSTM backward did not "
                         f"launch: {total}")
    return total


def check_elastic():
    """Phase elastic: the reduced xlstm (float32, the kernels on the
    card) through ``ElasticTrainer``: 2 steps, a checkpoint to the LARK
    store, worker 3 leaves (store membership follows), the live state
    lost and restored from the store, 2 more steps; parameters and
    optimizer state bitwise equal to 4 uninterrupted steps."""
    cfg = reduced_config("xlstm_350m")
    data = SyntheticLMData(cfg, 2, 300)
    init_fn, step_fn, _ = make_train_step(cfg, peak_lr=1e-2)

    def fresh():
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(0)
        return init_fn(gen)

    whole = fresh()
    for i in range(4):
        whole = step_fn(*whole, train_batch(data, i))[:2]
    et = ElasticTrainer(4, lambda workers: step_fn)
    run = fresh()
    for i in range(2):
        run = et.run_step(*run, train_batch(data, i))[:2]
    committed = et.checkpoint(run)
    like = run
    run = tuple(tree.map_leaves(torch.zeros_like, r) for r in run)
    run = et.on_membership_change([0, 1, 2], run, like)
    for i in range(2, 4):
        run = et.run_step(*run, train_batch(data, i))[:2]
    equal = all(torch.equal(a, b) for a, b in zip(tree.leaves(run),
                                                   tree.leaves(whole)))
    checks = {"committed": committed, "regime": et.state.regime == 2,
              "restored": et.state.restores == 1,
              "bitwise_equal_to_uninterrupted": equal}
    emit({"phase": "elastic", "arch": cfg.name, "steps": 4,
          "workers_after": et.state.workers, **checks})
    if not all(checks.values()):
        raise SystemExit(f"the elastic phase failed: {checks}")


# ---------------------------------------------------------------------------
# Across ranks: the Monte Carlo's trials and the data-parallel train step
# ---------------------------------------------------------------------------

#: the sharded phase: worlds of ranks on the one card (gloo), and the
#: `devices` every run asks for (the committed configs' 8, which both
#: worlds divide)
SHARD_WORLDS, SHARD_DEVICES = (2, 4), 8
#: the §5.1 run with the early stop live (default min_ticks 50,000, 200
#: events): p = 2e-4 reaches 50,000 ticks in ~3,100 steps, with ~1,300
#: LARK and majority outage events over the 8 trials by then
SHARD_STOP = dict(n=N, partitions=P, rf=2, p=2e-4, trials=B, seed=0,
                  trajectory=True)
#: the data-parallel train step: smollm-360m at full width and depth in
#: float32 (so the CPU test's float32 tolerance applies), 4 x 1024
#: tokens split over 2 ranks, 2 steps
DP_ARCH, DP_WORLD, DP_ROWS, DP_SEQ, DP_STEPS = "smollm_360m", 2, 4, 1024, 2


def shard_paths():
    """name -> (simulate, knobs, (unpacked kernels, packed kernels)):
    every Monte Carlo path of the engine, downtime, latency and zoo
    phases with their knobs (paper tile, MC_STEPS steps in MC_CHUNK-step
    chunks, trajectory kept)."""
    base = dict(n=N, partitions=P, rf=2, p=1e-3, trials=B,
                min_ticks=10 ** 9, max_steps=MC_STEPS, chunk_steps=MC_CHUNK,
                seed=0, trajectory=True)
    paths = {"engine": (ab.simulate_availability_batched, base,
                        (("pac_eval",), ("fused_pac_eval",)))}
    for name, (knobs, (unpacked, packed)) in DOWNTIME_CONFIGS.items():
        paths[f"downtime:{name}"] = (db.simulate_downtime_batched,
                                     dict(base, **knobs),
                                     ((unpacked,), (packed,)))
    paths["latency"] = (cl.simulate_client_latency,
                        dict(base, **LATENCY_KNOBS),
                        (("latency_charge", "downtime_eval"),
                         ("latency_charge", "fused_downtime_eval")))
    paths["zoo"] = (db.simulate_downtime_batched, dict(base, **ZOO_KNOBS),
                    (("downtime_eval_roster",), ("fused_downtime_eval",)))
    return paths


def result_fingerprint(r, prefix=""):
    """Every field of a Monte Carlo result (nested results and dicts
    flattened) but the device and the requested `devices`."""
    out = {}
    for f in dataclasses.fields(r):
        if f.name in ("device", "devices"):
            continue
        v = getattr(r, f.name)
        if dataclasses.is_dataclass(v):
            out.update(result_fingerprint(v, f"{prefix}{f.name}."))
        elif isinstance(v, dict):
            out.update({f"{prefix}{f.name}:{k}": x for k, x in v.items()})
        else:
            out[prefix + f.name] = v
    return out


def run_shard_case(simulate, knobs, packed, devices, device):
    """(fingerprint, launches of every kernel that launched, steps,
    wall s) of one run, the counts set to 0 just before."""
    reset_counts()
    torch.cuda.synchronize(device)
    t0 = time.monotonic()
    r = simulate(packed=packed, devices=devices, device=device, **knobs)
    torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    fp = result_fingerprint(r)
    steps = len(fp.get("trajectory:times", fp.get("downtime.trajectory:times",
                                                  ())))
    return fp, {k: v for k, v in read_counts(counters()).items() if v}, \
        steps, wall


def sharded_rank(rank, world, store, out_dir, t_spawn):
    """One rank of the sharded phase: every path of ``shard_paths``,
    unpacked and packed, with its share of the trials (and, in the
    largest world, the early-stop run); pickles what it saw."""
    import pickle
    from repro_torch.launch import dist as rdist
    # the chip's machine has no network: gloo's pairs use the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=300)
    try:
        dev = rdist.local_device()
        torch.empty(1, device=dev)
        ready = time.time() - t_spawn
        got = {"ready_s": ready}
        for name, (simulate, knobs, _) in shard_paths().items():
            for packed in (False, True):
                got[name, packed] = run_shard_case(
                    simulate, knobs, packed, SHARD_DEVICES, dev)
        if world == max(SHARD_WORLDS):
            got["stop"] = run_shard_case(ab.simulate_availability_batched,
                                         SHARD_STOP, False, SHARD_DEVICES,
                                         dev)
    finally:
        rdist.shutdown()
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(got))


def check_sharded(one_process):
    """Phase sharded: the Monte Carlo's trials over 2 and 4 ranks on the
    one card (gloo through a file store), every path of the engine,
    downtime, latency and zoo phases, unpacked and packed (MC_STEPS
    steps in MC_CHUNK-step chunks): every rank's result equal to the
    one-process devices = 1 run in every field and trajectory
    (`one_process`: those phases' own runs by (path, packed)), every
    kernel of the path launched on every rank; and a §5.1 run with the
    early stop live stopping at the same step as one process."""
    import pickle
    import tempfile
    from repro_torch.launch import dist as rdist
    paths = shard_paths()
    single = {key: (result_fingerprint(one_process[key]),)
              for key in ((name, packed) for name in paths
                          for packed in (False, True))}
    t0 = time.monotonic()
    single["stop"] = run_shard_case(ab.simulate_availability_batched,
                                    SHARD_STOP, False, 1, DEVICE)
    emit({"phase": "sharded", "world": 1, "wall_s": time.monotonic() - t0,
          "stop_steps": single["stop"][2],
          "stop_steps_per_s": single["stop"][2] / single["stop"][3],
          "stopped_early": bool(single["stop"][0]["stopped_early"])})
    if not single["stop"][0]["stopped_early"]:
        raise SystemExit("sharded: the early-stop run did not stop early")
    bad = []
    for world in SHARD_WORLDS:
        with tempfile.TemporaryDirectory() as tmp:
            t_spawn = time.time()
            rdist.spawn(sharded_rank, world,
                        (world, str(Path(tmp, "store")), tmp, t_spawn),
                        timeout_s=600)
            wall = time.time() - t_spawn
            ranks = [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes())
                     for r in range(world)]
        for r, got in enumerate(ranks):
            rates, equal, launched = {}, True, True
            for key, val in got.items():
                if key == "ready_s":
                    continue
                fp, launches, steps, rwall = val
                same = same_fingerprint(single[key][0], fp)
                kernels = ("pac_eval",) if key == "stop" else \
                    paths[key[0]][2][key[1]]
                ok = all(launches.get(k, 0) > 0 for k in kernels)
                tag = key if key == "stop" else \
                    f"{key[0]}:{'packed' if key[1] else 'bool'}"
                rates[tag] = steps / rwall
                equal &= same
                launched &= ok
                if not (same and ok):
                    bad.append((world, r, tag, same, launches))
            emit({"phase": "sharded", "world": world, "rank": r,
                  "trials": B // world, "devices": SHARD_DEVICES,
                  "ready_s": got["ready_s"], "steps_per_s": rates,
                  "equal_to_one_process": equal,
                  "every_kernel_launched": launched,
                  **({"stop_steps": got["stop"][2]} if "stop" in got
                     else {})})
        emit({"phase": "sharded", "world": world, "spawn_s": max(
            g["ready_s"] for g in ranks), "wall_s": wall})
    emit({"phase": "sharded", "total_wall_s": time.monotonic() - t0})
    if bad:
        raise SystemExit(f"sharded: ranks differ from one process or a "
                         f"kernel did not launch: {bad}")


def dp_config():
    return get_config(DP_ARCH).replace(param_dtype="float32",
                                       act_dtype="float32")


def dp_batches(cfg, device):
    data = SyntheticLMData(cfg, DP_ROWS, DP_SEQ)
    return [{k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(s).items()} for s in range(DP_STEPS)]


def dp_train(step_fn, params, opt_state, batches, device):
    """(params, opt_state, [loss], [grad_norm], [ms per step])."""
    losses, norms, ms = [], [], []
    for b in batches:
        torch.cuda.synchronize(device)
        t0 = time.monotonic()
        params, opt_state, m = step_fn(params, opt_state, b)
        torch.cuda.synchronize(device)
        ms.append((time.monotonic() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, opt_state, losses, norms, ms


def dp_rank(rank, world, store, out_dir):
    """One rank of the train_dp phase: the data-parallel step on a
    (world, 1) ("data", "model") mesh; rank 0 saves the parameters and
    the optimizer state, and every rank the sums of its parameter leaves
    (the replicas must agree)."""
    import pickle
    from repro_torch.launch import dist as rdist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import (batch_shardings,
                                              grad_shardings)
    # the chip's machine has no network: gloo's pairs use the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=300)
    try:
        dev = rdist.local_device()
        cfg = dp_config()
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model["init_params"](gen)
        mesh = make_host_mesh((world, 1), ("data", "model"))
        batches = dp_batches(cfg, dev)
        init_fn, step_fn, opt = make_train_step(
            cfg, grad_shardings=grad_shardings(cfg, mesh, params),
            batch_shardings=batch_shardings(cfg, mesh, batches[0], DP_ROWS))
        params, opt_state, losses, norms, ms = dp_train(
            step_fn, params, opt.init(params), batches, dev)
        sums = [float(t.double().sum()) for t in tree.leaves(params)]
        if rank == 0:
            torch.save([[t.cpu() for t in tree.leaves(x)]
                        for x in (params, opt_state)],
                       Path(out_dir, "params.pt"))
    finally:
        rdist.shutdown()
    Path(out_dir, f"dp{rank}.pkl").write_bytes(pickle.dumps(
        {"losses": losses, "norms": norms, "ms": ms, "sums": sums}))


def rel_err(got, want):
    """max |got - want| over max |want| (0 where both are 0)."""
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale else diff


def check_train_dp(smi):
    """Phase train_dp: smollm-360m at full width and depth (float32), 2
    steps on 4 x 1024 tokens, one process against 2 ranks on the card
    (gloo), each rank taking 2 rows and all-reduce-averaging the
    gradients.  Held: the loss and grad norm within rtol 1e-3 and every
    parameter leaf within rtol 1e-3 / atol 1e-3 of its largest magnitude
    (tests/test_torch_train_dp.py's float32 reduction-order tolerance);
    the AdamW moments m and v, which are linear in the averaged
    gradients and their squares, each leaf within 1e-3 of its own
    largest magnitude; the update (parameters after less before) of
    every leaf within 1e-2 of its own norm in L2, and not zero where
    one process moved the leaf (per
    element the update is ~lr sign(g), so an element whose gradient is
    within rounding of 0 may flip, which the max-norm error, reported,
    cannot tell from a fault); the two ranks' replicas equal."""
    import pickle
    import tempfile
    from repro_torch.launch import dist as rdist
    t_phase = time.monotonic()
    cfg = dp_config()
    model, params = init_model(cfg)
    start = [t.cpu() for t in tree.leaves(params)]
    batches = dp_batches(cfg, DEVICE)
    _, step_fn, opt = make_train_step(cfg)
    want, want_opt, losses, norms, ms = dp_train(
        step_fn, params, opt.init(params), batches, DEVICE)
    want = [t.cpu() for t in tree.leaves(want)]
    want_opt = [t.cpu() for t in tree.leaves(want_opt)]
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        rdist.spawn(dp_rank, DP_WORLD, (DP_WORLD, str(Path(tmp, "store")),
                                        tmp), timeout_s=600)
        wall = time.monotonic() - t0
        ranks = [pickle.loads(Path(tmp, f"dp{r}.pkl").read_bytes())
                 for r in range(DP_WORLD)]
        got, got_opt = torch.load(Path(tmp, "params.pt"))
    worst, close = 0.0, True
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        worst = max(worst, (g - w).abs().max().item() / scale)
        close &= torch.allclose(g, w, rtol=1e-3, atol=1e-3 * scale)
    moment_worst = max(rel_err(g, w) for g, w in zip(got_opt, want_opt)
                       if w.is_floating_point())
    counts_equal = all(torch.equal(g, w) for g, w in zip(got_opt, want_opt)
                       if not w.is_floating_point())
    update_l2, update_max, moved = 0.0, 0.0, []
    for g, w, s0 in zip(got, want, start):
        dg, dw = g - s0, w - s0
        norm = dw.norm().item()
        if norm:
            moved.append(dg.norm().item() > 0)
        update_l2 = max(update_l2, (dg - dw).norm().item() / norm
                        if norm else (dg - dw).norm().item())
        update_max = max(update_max, rel_err(dg, dw))
    moved = bool(moved) and all(moved)
    update_ok = moved and update_l2 <= 1e-2 and moment_worst <= 1e-3 \
        and counts_equal
    r0 = ranks[0]
    metrics_close = np.allclose(r0["losses"], losses, rtol=1e-3) and \
        np.allclose(r0["norms"], norms, rtol=1e-3)
    replicated = all(r["sums"] == r0["sums"] and r["losses"] ==
                     r0["losses"] for r in ranks)
    emit({"phase": "train_dp", "arch": DP_ARCH, "dtype": "float32",
          "world": DP_WORLD, "rows": DP_ROWS, "seq": DP_SEQ, "gpu": smi,
          "loss_one_process": losses, "loss_ranks": r0["losses"],
          "grad_norm_one_process": norms, "grad_norm_ranks": r0["norms"],
          "ms_one_process": ms, "ms_ranks": [r["ms"] for r in ranks],
          "worst_abs_over_scale": worst, "leaves_close": close,
          "moment_worst_over_own_max": moment_worst,
          "update_worst_l2_over_own_l2": update_l2,
          "update_worst_max_over_own_max": update_max,
          "every_leaf_moved": moved, "update_close": update_ok,
          "metrics_close": metrics_close, "replicated": replicated,
          "spawn_and_run_s": wall, "wall_s": time.monotonic() - t_phase})
    if not (close and update_ok and metrics_close and replicated):
        raise SystemExit("train_dp: the data-parallel step differs from "
                         "one process")


#: the tp phase: 2 ranks of one card, recurrentgemma-9b cut to train_rg's
#: layers, a 1 x TP_PROMPT prefill, TP_DECODE greedy steps, TP_STEPS AdamW
#: steps on 1 x TP_PROMPT; the phase's time box in seconds
TP_WORLD, TP_PROMPT, TP_DECODE, TP_STEPS, TP_BOX_S = 2, 2048, 8, 2, 150.0
#: every parameter leaf after the steps within this share of its largest
#: magnitude (bf16 parameters whose float32 sums split across ranks)
TP_LEAF_TOL = 0.02


def tp_config():
    arch, layers = TRAIN_CELLS["train_rg"][:2]
    return get_config(arch).replace(num_layers=layers, microbatches_train=1)


class ScanWidths:
    """Within: the widths of ``rglru_scan``'s and ``rglru_scan_bwd``'s
    launches (their launchers' argument builders, called once a
    launch)."""

    def __enter__(self):
        self.saved = (rk.launch_args, rk.bwd_launch_args)
        self.fwd, self.bwd = [], []

        def fwd(x, *a, **kw):
            self.fwd.append(x.shape[-1])
            return self.saved[0](x, *a, **kw)

        def bwd(x, *a, **kw):
            self.bwd.append(x.shape[-1])
            return self.saved[1](x, *a, **kw)
        rk.launch_args, rk.bwd_launch_args = fwd, bwd
        return self

    def __exit__(self, *exc):
        rk.launch_args, rk.bwd_launch_args = self.saved


def tp_run(cfg, params, mesh, device):
    """The tp phase's work on one process (mesh None) or on a rank:
    {"logits": prefill and decode logits (float32, CPU), "tokens",
    "loss", "grad_norm", "ms", "launches", "widths"}, and the parameters
    after the steps."""
    from repro_torch.launch.shardings import (batch_shardings,
                                              grad_shardings)
    from repro_torch.training import make_serve_steps
    data = SyntheticLMData(cfg, 1, TP_PROMPT)
    raw = data.batch_at(0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    prompt = {"tokens": batch["tokens"]}
    prefill_fn, decode_fn, _ = make_serve_steps(cfg, mesh)
    if mesh is None:
        _, step_fn, opt = make_train_step(cfg, peak_lr=TRAIN_LR)
    else:
        _, step_fn, opt = make_train_step(
            cfg, peak_lr=TRAIN_LR,
            grad_shardings=grad_shardings(cfg, mesh, params),
            batch_shardings=batch_shardings(cfg, mesh, batch, 1))

    def whole(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.float().cpu()
    out = {"logits": [], "tokens": [], "loss": [], "grad_norm": [],
           "ms": []}
    rk.rglru_scan.launches = rk.rglru_scan_bwd.launches = 0
    with ScanWidths() as widths:
        logits, state = prefill_fn(params, prompt, TP_PROMPT + TP_DECODE)
        for i in range(TP_DECODE + 1):
            out["logits"].append(whole(logits))
            tok = out["logits"][-1].argmax(-1).to(torch.int32)
            out["tokens"].append(tok.tolist())
            if i < TP_DECODE:
                logits, state = decode_fn(params, state, tok.to(device),
                                          TP_PROMPT + i)
        del state
        opt_state = opt.init(params)
        for _ in range(TP_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.monotonic()
            params, opt_state, m = step_fn(params, opt_state, batch)
            torch.cuda.synchronize(device)
            out["ms"].append((time.monotonic() - t0) * 1e3)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    out["launches"] = {"rglru_scan": rk.rglru_scan.launches,
                       "rglru_scan_bwd": rk.rglru_scan_bwd.launches}
    out["widths"] = {"rglru_scan": sorted(set(widths.fwd)),
                     "rglru_scan_bwd": sorted(set(widths.bwd))}
    return out, params


def tp_rank(rank, world, store, out_dir):
    """One rank of the tp phase: the seed-0 weights distributed under
    the reference's specs on a (1, world) ("data", "model") mesh of CUDA
    shards, the phase's work, and each parameter leaf after the steps
    against the one process's slice of it (``tp_one.pt``)."""
    import pickle
    from repro_torch.launch import dist as rdist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch import tp
    from repro_torch.launch.shardings import (distribute, param_shardings,
                                              spec_of)
    # the chip's machine has no network: gloo's pairs use the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rdist.init(f"file://{store}", rank=rank, world_size=world,
               timeout_s=300)
    try:
        dev = rdist.local_device()
        torch.cuda.set_device(dev)
        cfg = tp_config()
        mesh = make_host_mesh((1, world), ("data", "model"),
                              device_type="cuda")
        _, whole = init_model(cfg, dev)
        params = distribute(whole, param_shardings(cfg, mesh, whole), mesh)
        del whole
        torch.cuda.empty_cache()
        out, params = tp_run(cfg, params, mesh, dev)
        want = torch.load(Path(out_dir, "tp_one.pt"), mmap=True)
        worst = 0.0
        for p, w in zip(tree.leaves(params), want):
            local = p.to_local()
            w = tp.local_shard(w, spec_of(p), mesh)
            scale = max(w.float().abs().max().item(), 1e-30)
            worst = max(worst, (local.float().cpu() - w.float())
                        .abs().max().item() / scale)
        out["leaf_worst"] = worst
    finally:
        rdist.shutdown()
    Path(out_dir, f"tp{rank}.pkl").write_bytes(pickle.dumps(out))


def check_tp(smi):
    """Phase tp (see the module doc)."""
    import pickle
    import tempfile
    from repro_torch.launch import dist as rdist
    t_phase = time.monotonic()
    cfg = tp_config()
    with tempfile.TemporaryDirectory() as tmp:
        _, params = init_model(cfg)
        one, params = tp_run(cfg, params, None, DEVICE)
        torch.save([t.cpu() for t in tree.leaves(params)],
                   Path(tmp, "tp_one.pt"))
        del params
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        rdist.spawn(tp_rank, TP_WORLD, (TP_WORLD, str(Path(tmp, "store")),
                                        tmp), timeout_s=TP_BOX_S)
        spawn_s = time.monotonic() - t0
        ranks = [pickle.loads(Path(tmp, f"tp{r}.pkl").read_bytes())
                 for r in range(TP_WORLD)]
    # the kernels at the local shape (the card is free again), held
    # against their plain versions in float64 within their allowances
    local = cfg.lru_width // TP_WORLD
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    x, la, h, dh = rc.rglru_bwd_inputs(gen, 1, TP_PROMPT, local, "model")
    with torch.no_grad():
        fwd_err = rc.rglru_error(rk.rglru_scan(x, la), *rc.reference(x, la))
    bwd_err = rc.rglru_bwd_error(rk.rglru_scan_bwd(x, la, h, dh),
                                 *rc.bwd_reference(x, la, h, dh))
    with torch.no_grad():
        fwd_us = time_ms(lambda: rk.rglru_scan(x, la), 20) * 1e3
    bwd_us = time_ms(lambda: rk.rglru_scan_bwd(x, la, h, dh), 20) * 1e3
    r0 = ranks[0]
    logit_err = []
    for got, want in zip(r0["logits"], one["logits"]):
        scale = want.abs().max().item()
        logit_err.append((got - want).abs().max().item() / scale)
    tokens_equal = r0["tokens"] == one["tokens"]
    metrics_close = np.allclose(r0["loss"], one["loss"], rtol=1e-3) and \
        np.allclose(r0["grad_norm"], one["grad_norm"], rtol=1e-3)
    leaf_worst = max(r["leaf_worst"] for r in ranks)
    widths_ok = all(r["widths"] == {"rglru_scan": [local],
                                    "rglru_scan_bwd": [local]}
                    for r in ranks)
    launches_ok = all(r["launches"] == one["launches"] and
                      min(r["launches"].values()) > 0 for r in ranks)
    wall = time.monotonic() - t_phase
    emit({"phase": "tp", "arch": cfg.name, "layers": cfg.num_layers,
          "dtype": cfg.param_dtype, "world": TP_WORLD, "mesh": "(1, 2)",
          "prompt": TP_PROMPT, "decode_steps": TP_DECODE,
          "train_steps": TP_STEPS, "gpu": smi,
          "logits_err_over_max": logit_err, "decode_tol": DECODE_TOL,
          "tokens_equal": tokens_equal,
          "loss_one_process": one["loss"], "loss_ranks": r0["loss"],
          "grad_norm_one_process": one["grad_norm"],
          "grad_norm_ranks": r0["grad_norm"],
          "leaf_worst_over_max": leaf_worst, "leaf_tol": TP_LEAF_TOL,
          "launches_one_process": one["launches"],
          "launches_ranks": [r["launches"] for r in ranks],
          "widths_one_process": one["widths"],
          "widths_ranks": [r["widths"] for r in ranks]})
    emit({"phase": "tp_time", "gpu": smi,
          "step_ms_one_process": one["ms"],
          "step_ms_ranks": [r["ms"] for r in ranks],
          "local_shape": [1, TP_PROMPT, local],
          "rglru_scan_us": fwd_us, "rglru_scan_bwd_us": bwd_us,
          "rglru_scan_error_over_allowed": fwd_err,
          "rglru_scan_bwd_error_over_allowed": bwd_err,
          "spawn_and_run_s": spawn_s, "wall_s": wall, "box_s": TP_BOX_S})
    ok = max(logit_err) <= DECODE_TOL and tokens_equal and metrics_close \
        and leaf_worst <= TP_LEAF_TOL and widths_ok and launches_ok
    if not ok:
        raise SystemExit("tp: the tensor-parallel ranks differ from one "
                         "process, or a kernel did not launch at the "
                         "local width")
    if not (fwd_err <= 1.0 and bwd_err <= 1.0):
        raise SystemExit(f"tp: rglru_scan / rglru_scan_bwd at the local "
                         f"shape (1, {TP_PROMPT}, {local}) disagree with "
                         f"their plain versions: {fwd_err}, {bwd_err}")
    if wall > TP_BOX_S:
        raise SystemExit(f"tp: {wall:.1f} s, past its {TP_BOX_S} s box")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "nvidia-smi", "gpu": smi, "device_name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    fault_procs = start_fault_builds()
    logs = {}
    secs = _build.build(verbose=True, logs=logs)
    faults = finish_fault_builds(fault_procs)
    emit({"phase": "build", "seconds": secs,
          "flags": " ".join(_build.NVCC_FLAGS),
          "flash_attention_sm90_ptxas": ptxas_usage(
              logs.get("flash_attention_sm90", "")),
          "mlstm_chunk_sm90_ptxas": ptxas_usage(
              logs.get("mlstm_chunk_sm90", "")),
          "rglru_scan_ptxas": ptxas_usage(logs.get("rglru_scan", "")),
          "fused_downtime_ptxas": ptxas_usage(
              logs.get("fused_downtime", "")),
          "downtime_eval_ptxas": ptxas_usage(logs.get("downtime_eval", "")),
          "microsim_scan_ptxas": ptxas_usage(logs.get("microsim_scan", "")),
          "rglru_scan_bwd_ptxas": ptxas_usage(logs.get("rglru_scan_bwd",
                                                       "")),
          "mlstm_chunk_bwd_ptxas": ptxas_usage(logs.get("mlstm_chunk_bwd",
                                                        "")),
          "mlstm_chunk_bwd_sm90_ptxas": ptxas_usage(
              logs.get("mlstm_chunk_bwd_sm90", "")),
          "fault_copies": {k: sorted(v) for k, v in faults.items()}})

    bw = hbm_bw(name)
    rec = check_kernels(bw, faults["downtime_eval"], faults["fused_downtime"])
    rec.update(check_downtime_kernels(bw, faults["downtime_eval"],
                                      faults["fused_downtime"]))
    rec["latency_charge"] = check_latency_kernel(bw, faults["latency_charge"])
    # every Monte Carlo main-path run by (path, packed): the one-process
    # side of the sharded phase
    mc_runs = {}
    launches, runs = check_engine()
    mc_runs.update({("engine", k): v for k, v in runs.items()})
    check_bench_rows()
    got, runs = check_downtime_engine()
    launches.update(got)
    mc_runs.update({(f"downtime:{c}", k): v for (c, k), v in runs.items()})
    check_downtime_bench_rows()
    got, runs = check_latency_engine()
    launches["latency_charge"] = got["latency_charge"]
    mc_runs.update({("latency", k): v for k, v in runs.items()})
    # the roster eval without counts runs on the zoo's path (reconfig
    # without shared bandwidth); under bandwidth it is the counts mode
    got, runs = check_zoo_engine()
    launches["downtime_eval_roster"] = got["downtime_eval_roster"]
    mc_runs.update({("zoo", k): v for k, v in runs.items()})
    check_zoo_bench_rows()
    rec.update(check_mlstm_kernel(bw, faults))
    launches["mlstm_chunkwise_sm90"] = check_serve()
    launches["mlstm_chunkwise"] = check_serve_cpu()
    rec["rglru_scan"] = check_rglru_kernel(bw, faults["rglru_scan"])
    flash_rec, flash_launches = check_flash_kernel(bw, faults)
    rec.update(flash_rec)
    launches.update(flash_launches)
    launches["rglru_scan"] = check_serve_rg()
    check_serve_rg_cpu()
    rec["microsim_scan"], launches["microsim_scan"] = check_microsim(
        bw, faults["microsim_scan"])
    check_serve_dense()
    check_families()
    rec["rglru_scan_bwd"] = check_rglru_bwd_kernel(bw,
                                                   faults["rglru_scan_bwd"])
    rec.update(check_mlstm_bwd_kernel(
        bw, {src: faults[src] for src in mc.BWD_SOURCE_FAULTS}))
    with deterministic():
        launches["mlstm_chunkwise_bwd_sm90"] = check_train(
            "train", smi)["mlstm_chunkwise_bwd_sm90"]
        launches["rglru_scan_bwd"] = check_train(
            "train_rg", smi)["rglru_scan_bwd"]
        check_train("train_dense", smi)
        # the reduced float32 xlstm: the SIMT backward's main path
        launches["mlstm_chunkwise_bwd"] = check_train_cpu()[
            "mlstm_chunkwise_bwd"]
        check_elastic()
    check_sharded(mc_runs)
    check_train_dp(smi)
    check_tp(smi)

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        r = rec[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
    emit({"phase": "total", "wall_s": time.monotonic() - t_start,
          "device_count": torch.cuda.device_count()})
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run drives one card, whatever else the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
