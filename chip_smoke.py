#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without its final line:

  1. header   the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    the CUDA kernels from the repository's sources, one nvcc
              per kernel namespace, all started together, and an empty
              kernel (launch_floor) beside them (set-up); then
              cuobjdump --dump-sass on the flash-attention library: every
              bf16 instantiation must hold tensor-core instructions
              (HMMA), and ptxas must report no stack frame or spill in
              any of its 32 instantiations; and on the SSD chunk
              library: both instantiations (one and two warp groups)
              hold TF32 HMMA (its 3xTF32 products) and none has a stack
              frame or spills; the compress (3
              kernels) and robust_agg (the trimmed mean's six register
              networks and its shared-memory path) libraries, the
              telemetry library (the histogram's two one-warp
              instances and its grid kernel, the quantiles' three
              kernels) and the delta_sgd library (the norms' and the
              applies' instances): no stack frame and no spill in any
              function.
  3. kernels  each kernel at the main-path shape (C=10, N=71,808), at
              the fleet's cohort (C=50, N=71,808) and at a large shape
              (C=10, N=2**24), held against its plain
              PyTorch version on the card (norms: rtol 1e-5, two calls
              bitwise equal, a NaN and an inf each only in its own
              client's sums; apply: bitwise equal, masked lanes exactly
              bf16; with the SM count patched to 114 the norms keep
              their bits and the apply, on another grid, stays bitwise
              plain; norms, apply and masked apply one device op a call
              (the CUDA calls that enqueue work, as torch.profiler
              records them on the host); quantize/dequantize: bitwise equal,
              and a NaN chunk like the plain version; both also at
              ragged chunk counts (1, 7, 4k + 3 and 32k + 5 chunks, NaN
              and inf chunks; dequantize with NaN, ±inf and zero scales
              too), the same bits on two calls, one device op a call;
              quantize at 114 SMs (patched) with the same bits; top-k:
              exact, one device op a call; trimmed mean at t = 2 and the
              median at t = C/2 - 1, a row each: bitwise equal to the plain
              version, two calls bitwise equal, one device op a call, the
              median beside torch.quantile(midpoint), the same function
              at even C, within 1e-6 of the middle values),
              timed with CUDA events (median of 60 launches queued
              behind a device sleep, so the times are device times)
              beside the plain version, a library call where one exists,
              and the bound from the bytes moved and the card's peak
              rates. One JSON line per kernel and shape, after a
              "launch floor" line: an empty kernel from a library built
              as the port's are, and torch.cuda._sleep(0), in the same
              timing.
  4. paths    the paper's CNN federation through the training entry point
              (100 clients, alpha 0.1, participation 0.1, batch 64, 4
              rounds, 2 rounds per call) on cuda, three times: plain
              (slice 1), dirichlet_dropouts + trimmed mean + int8 + EF21,
              and bandwidth_tiered + median + EF21. Each path is driven
              with every launch count at 0 and read just after: 2*K*rounds
              Delta-SGD launches, the compression and robust-aggregation
              launches its round tail makes, all on CUDA, finite metrics.
              The host loop (--flat) on cuda is bitwise equal; the same
              run on the CPU agrees on round 0 within rtol 1e-4
              (cuDNN/cuBLAS and kernel sum order differ).
  5. lm kernels  flash attention at TinyLlama's prefill shape (1, 64,
              32, 4, 64), at S = 2048, at Zamba2's shared block (1, 64,
              32, 32, 112), with a window of 256 at S = 1024, in bf16
              at both prefill shapes and S = 2048, and at the hd-128
              prefill shapes of OLMoE (1, 64, 16, 16, 128), CodeQwen1.5
              (1, 64, 32, 32, 128), Qwen2.5 (1, 64, 40, 8, 128) and
              Granite (1, 64, 48, 1, 128: MQA) (f32 within 2e-5, bf16
              within atol 4e-3 + rtol 8e-3, about one bf16 ulp of the
              output; two calls bitwise equal); the SSD chunk kernel
              at (1, 64, 112, 64, 64), S = 2048, S = 96 (L = 48) and
              S = 67 (L = 1), rtol 1e-3 / atol 1e-4, two calls bitwise
              equal. Timed and bounded like phase 3; the SSD's bound is
              the lesser of its f32-FMA route's and its tensor-core
              route's (three TF32 products per f32 product at 494.7
              TFLOP/s), bound_route names it; SDPA (enable_gqa) is
              timed beside flash attention as a yardstick only, with the
              explicit mask and, without a window, with is_causal=True:
              the faster is library_ms, library_call names it. At the
              f32 prefill shapes each q-tile height (16, 32, 64 rows) is
              timed alone and must give the same bits; at each SSD shape
              blocks of one and of two warp groups, and at L = 1 each
              packing of chunks per block (1, 16, 32, 64), are timed
              alone, all with the same bits.
  6. serving  TinyLlama-1.1B whole (22 layers), Zamba2-7B at full
              width cut to 14 layers, OLMoE-1B-7B whole (16 layers),
              CodeQwen1.5-7B, Qwen2.5-14B and Granite-20B at full width
              cut to 2 layers, all f32, and DeepSeek-V3 at full width cut
              to one layer (with its MTP block) in bf16, random weights
              from seed 0, through DecodeEngine: 4 prompts of 64 tokens,
              32 new tokens, 4 slots, flush 8; then 6 prompts on 4 slots
              (continuous admission). Each run starts with every count at
              0 and must launch flash attention once per GQA attention
              site per request (22, 2, 16 and 2; none for DeepSeek-V3's
              MLA) and the SSD kernel once per Mamba2 layer per request
              (12), nothing else. Then, for the f32 paths: the decode
              logits of every generated position equal the
              teacher-forced full forward's within 2e-3 (MoE capacity
              factor 8.0 for this gate, 1.25 put back after); the card's
              prefill logits equal the CPU's within 2e-3 at full width
              and 2 layers (7 for Zamba2, so the shared block is there).
              For DeepSeek-V3: finite logits, the engine's tokens equal
              to a lockstep loop's (each prompt prefilled alone, the rows
              decoded together), and the f32 decode gate at its reduced
              config. Prefill and one decode block are timed and
              profiled (device busy, idle share); init time and peak
              allocation printed.
  3b. slice-4 kernels  lane_histogram exact at C = 1, 10, its
              crossover HIST_WARP_LANES (one warp up to it, a grid of
              blocks past it) and one either side, 16,384 and 100,000
              lanes, with B = 1, 16, 33 and 4,096 bins of ascending and of
              shuffled edges (a NaN edge, an empty bin), the same bits on
              two calls, one device op a call; then lane_histogram (B =
              16) and lane_quantiles (one block up to 2,048 lanes, two
              launches past it) at C = 10, 1000, 16,384, 16,385 and
              100,000 with NaN lanes of both signs, ±0, ±inf and ties
              (exact, quantiles bit for bit; torch.quantile(nearest) is
              checked equal on the NaN-free lanes and timed as the
              quantiles' yardstick), and the single-tensor norms (rtol
              1e-5 f32, 3e-3 bf16, two calls bitwise, the same bits at
              114 SMs (patched), one device op a call) and apply_update
              (bitwise, η a float and a 0-d device tensor; torch.add with
              alpha timed beside it) at (71,808) and 2**24 in f32 and
              bf16, apply_update also at 71,809 and on an unaligned view.
              Timed and bounded like phase 3.
  4b. telemetry  the plain CNN path with --telemetry, fused and host loop:
              params and every metric bitwise equal to telemetry off, 2
              telemetry launches per round and 2*K*rounds Delta-SGD
              launches, sum(eta_hist) = C with finite eta, non-decreasing
              loss deciles, the same host syncs in a fused block with
              telemetry on as off (torch.cuda.set_sync_debug_mode), the
              host-clock wall per local step on and off (blocks in turns),
              and the CLI's event log with --events --profile 1 (header,
              one round event per round, a static event with one
              lane_histogram launch per round, a spans event).
  4c. vmap    the vmap engine at the phase-4 configuration on cuda: the
              CLI with R = 1 and no --flat (Δ-SGD's plain per-leaf route,
              4 rounds: finite, no kernel launched, round 0 = the CPU's
              and phase 4's flat engine's within 1e-4); the kernel route
              (get_client_opt("delta_sgd", use_pallas=True), 2 rounds:
              exactly 2*K*rounds batched_norms and batched_apply launches,
              round 0 within 1e-5 of the plain route on the card); the
              baselines sgd, sgdm_decay, adam, adagrad and sps (--lr the
              paper grids' middle) and Δ-SGD under fedavgm, fedadam,
              fedyogi and FedProx, 2 rounds each (finite, η NaN for the
              baselines, round 0 loss = the CPU's within 1e-4); sgd with
              --telemetry (one lane_histogram and one lane_quantiles launch
              a round, an all-zero η histogram); the host syncs of one
              vmap round (torch.cuda.set_sync_debug_mode: none on the
              plain route, for Adam and Δ-SGD; the kernel route's and the
              flat engine's printed); and the wall per local step of the
              vmap engine's plain and kernel routes beside the flat
              engine's R = 1 host loop, a round each in turns, with the
              card's name and power limit.
  4d. async, fleet, resume  the async presets zipf_async and
              byzantine_async at phase 4's configuration, 4 rounds each,
              fused (2 a call) and --flat host loop: 2*K*rounds Delta-SGD
              launches, fused == host loop bitwise (params, server state,
              the FedBuff buffer, metrics), round 0 = the CPU within
              1e-4, the fraction of rounds flushed, the mean staleness and
              the wall per local step; fleet_zipf at its own scale
              (100,000 registered, participation 0.0005, C = 50), 8
              rounds, 4 a call, --eta-carry --telemetry: 2*K*rounds
              Delta-SGD launches and one histogram and one quantiles
              launch a round, 50 distinct ids a round, every arena row
              outside the drawn cohorts keeps its bits, rounds_seen sums
              to 50 x 8; the host ms of a block's cohort draws over
              100,000 candidates beside the wall per local step; the
              fleet with int8 + EF21 (4 rounds): the (100,000, 71,808) f32
              EF slab on the card (its bytes and the peak allocation
              printed), one quantize and one dequantize launch a round,
              the slab's untouched rows all zero; resume: 4 rounds with
              --ckpt-every 2 against 2 rounds then --resume for 2, fused,
              for the plain run, zipf_async's buffer and fleet_uniform's
              arena at 1,000 registered, bitwise; serving from a
              checkpoint: TinyLlama at full width cut to one layer, its
              random params saved and read back through restore_params,
              decodes the in-memory params' tokens (4 flash attention
              launches), and the serve CLI with --ckpt-dir of another
              seed's params than its own init decodes the saved params'
              tokens, not its run's without the checkpoint. Phases 3 and
              3b also hold batched_norms, batched_apply, quantize_int8,
              dequantize_int8, topk_mask and the trimmed mean at (50,
              71,808) (the fleet's cohort) and the telemetry kernels at
              C = 50.
  4e. LM training  the train CLI's LM path (``train.train_lm``, its
              model cut in depth through ``setup_lm(args, cfg)``), Δ-SGD
              + FedAvg, seed 0, random weights: TinyLlama-1.1B at full
              width cut to 2 layers (N = 219,283,456 packed), C = 4, K =
              2, b = 8, S = 256, 2 rounds: (a) the vmap engine (R = 1):
              finite, no kernel launched (training takes the models'
              plain route); (b) fused, 2 rounds a call: exactly K·rounds
              batched_norms and batched_apply launches at (4, N), the
              --flat host loop bitwise equal, round 0's loss within 1e-4
              of (a)'s; the wall of a staged one-round block (3 blocks),
              its device busy and idle share (profiler), training
              tokens/s (C·K·b·S over the round's wall); batched_norms
              and batched_apply on the run's own last-step slabs (norms
              rtol 1e-5, apply bitwise), timed beside the plain version,
              torch.addcmul and the bound; (c) --telemetry: one
              histogram and one quantiles launch a round; (d) 2 rounds
              then --resume for 2 == 4 rounds straight, bitwise.
              TinyLlama whole (22 layers, C = 2, b = 1: a (2,
              1,100,087,296) slab, past 2**31 elements), one fused round
              with --ckpt-dir: its launches, the last client row's two
              sums against f64 sums taken in slices (rtol 1e-5), the
              pair timed on its slabs as above, the peak allocation;
              (e) the serve CLI with --ckpt-dir on that checkpoint
              decodes the trained params' tokens (44 flash-attention
              launches for 2 requests), not those of its own init.
              Zamba2-7B at full width cut to 7 layers (6 Mamba2 and the
              shared block), C = 2, b = 2, one fused round: finite, its
              launches, the peak allocation. OLMoE-1B-7B at full width
              cut to 2 layers (a (2, 1.05e9) slab), C = 2, K = 2, b = 1,
              S = 256: the --flat host loop, then one fused round,
              bitwise equal, K launches of each Δ-SGD kernel each, the
              pair held and timed on the fused run's last slabs as
              above, the round's wall, busy and tokens/s as in (b), peak
              allocations. DeepSeek-V3 at its reduced config, one fused
              round (MTP and the MoE aux in its loss): finite, its
              launches; its trained params' loss on a batch carries both
              (aux with labels above aux without, above 0) and equals the
              CPU's within 1e-4.
  7. matrix   the port's kernel parity matrix (repro_torch.conformance,
              32 cells, every kernel namespace) on cuda through check_cell,
              every count at 0 before and read after: every cell passes
              and every cell's kernel launched on the card.
  8. the summary line {"kernels": [...]} (all twelve kernels, with their
              launches by path, the vmap runs of 4c, the runs of 4d and
              the LM runs of 4e among them; DeepSeek-V3's serve path
              launches none) and, last, the device line.

It imports nothing of ``jax`` or of the reference package ``repro``.
"""
from __future__ import annotations

import functools
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
_CSRC = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "batched_norms": (_CSRC.format("delta_sgd"),
                      "src/repro/kernels/delta_sgd/delta_sgd.py:111"),
    "batched_apply": (_CSRC.format("delta_sgd"),
                      "src/repro/kernels/delta_sgd/delta_sgd.py:137"),
    "norms": (_CSRC.format("delta_sgd"),
              "src/repro/kernels/delta_sgd/delta_sgd.py:217"),
    "apply_update": (_CSRC.format("delta_sgd"),
                     "src/repro/kernels/delta_sgd/delta_sgd.py:243"),
    "quantize_int8": (_CSRC.format("compress"),
                      "src/repro/kernels/compress/compress.py:94"),
    "dequantize_int8": (_CSRC.format("compress"),
                        "src/repro/kernels/compress/compress.py:117"),
    "topk_mask": (_CSRC.format("compress"),
                  "src/repro/kernels/compress/compress.py:136"),
    "batched_trimmed_mean": (_CSRC.format("robust_agg"),
                             "src/repro/kernels/robust_agg/robust_agg.py"
                             ":100"),
    "lane_histogram": (_CSRC.format("telemetry"),
                       "src/repro/kernels/telemetry/telemetry.py:75"),
    "lane_quantiles": (_CSRC.format("telemetry"),
                       "src/repro/kernels/telemetry/telemetry.py:103"),
    "flash_attention": (_CSRC.format("flash_attention"),
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:80"),
    "ssd_chunks": ("src/repro_torch/kernels/mamba2_scan/csrc/mamba2_scan.cu",
                   "src/repro/kernels/mamba2_scan/mamba2_scan.py:64"),
}
MAIN_SHAPE = (10, 71808)          # C = 10 clients, N of the paper's CNN
LARGE_SHAPE = (10, 2 ** 24)       # 671 MB per buffer, far past the L2
SAMPLES = 60
# clock cycles a second of torch.cuda._sleep: the H100's top SM clock
# (1.98 GHz), so a sleep lasts at least as long as asked
SLEEP_CYCLES_PER_S = 2e9

# (name fragment, HBM bytes/s, f32 non-tensor-core flop/s): NVIDIA data
# sheets, dense rates; the first fragment found in the card's name wins
CARDS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))

TRAIN_ARGS = ["--task", "image", "--model", "cnn", "--num-clients", "100",
              "--alpha", "0.1", "--participation", "0.1", "--batch", "64",
              "--rounds", "4", "--seed", "0"]
ROUNDS = 4
K = 500 // 64      # one local epoch: 500 examples per client
# path -> (extra flags, launches per round of each compress / robust_agg
# kernel)
SCENARIO_PATHS = {
    "dropouts_trimmed_int8_ef21": (
        ["--scenario", "dirichlet_dropouts", "--robust-agg", "trimmed",
         "--compression", "int8", "--error-feedback"],
        {"quantize_int8": 1, "dequantize_int8": 1,
         "batched_trimmed_mean": 1}),
    "bandwidth_median_ef21": (
        ["--scenario", "bandwidth_tiered", "--robust-agg", "median",
         "--error-feedback"],
        {"quantize_int8": 1, "dequantize_int8": 1, "topk_mask": 1,
         "batched_trimmed_mean": 1}),
}
# the trimmed-mean trim count on the dirichlet_dropouts path (C = 10,
# trim_frac 0.2); top-k slots per chunk at k_frac 0.25. The median of an
# even C trims C/2 - 1 a side (4 on the median path's C = 10)
TRIM_T, TOPK_K = 2, 32
# compare-exchanges of the trimmed mean's odd-even merge network on P2
# values (csrc/robust_agg.cu; tests/test_torch_select.py counts them)
MERGE_NETWORK_SIZE = {2: 1, 4: 5, 8: 19, 16: 63, 32: 191, 64: 543}

# flash attention cases (B, S, H, KV, hd, window, dtype name), the first
# two the prefill shapes of the two serve paths (f32, as they run), then
# the same shapes in bf16 (the reference's production dtype)
FA_CASES = ((1, 64, 32, 4, 64, None, "float32"),
            (1, 64, 32, 32, 112, None, "float32"),
            (1, 2048, 32, 4, 64, None, "float32"),
            (1, 1024, 32, 4, 64, 256, "float32"),
            (1, 64, 32, 4, 64, None, "bfloat16"),
            (1, 64, 32, 32, 112, None, "bfloat16"),
            (1, 2048, 32, 4, 64, None, "bfloat16"),
            # the hd-128 prefill shapes: OLMoE (16/16), CodeQwen1.5
            # (32/32), Qwen2.5 (40/8) and Granite (48/1, MQA)
            (1, 64, 16, 16, 128, None, "float32"),
            (1, 64, 32, 32, 128, None, "float32"),
            (1, 64, 40, 8, 128, None, "float32"),
            (1, 64, 48, 1, 128, None, "float32"))
# SSD chunk cases (B, S, H, P, G, N), the first the Zamba2 prefill shape
SSD_CASES = ((1, 64, 112, 64, 1, 64), (1, 2048, 112, 64, 1, 64),
             (1, 96, 112, 64, 1, 64), (1, 67, 112, 64, 1, 64))
# bf16 and TF32 dense tensor-core rates of the H100 SXM (the bound of
# bf16 inputs, and of the SSD kernel's 3xTF32 products)
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
# chunks-per-block packings timed at L = 1 (PACK_ROWS of the SSD wrapper)
SSD_PACKINGS = (1, 16, 32, 64)
# quantize_int8's ragged (clients, chunks a row): one chunk, a ragged
# warp (7), a ragged last warp after whole ones (4k + 3), a part-filled
# last block (32k + 5)
QUANT_RAGGED = ((1, 1), (1, 7), (1, 4 * 1000 + 3), (3, 7), (1, 32 * 41 + 5))
# telemetry lane counts (the CNN path's cohort, the fleet's, a larger
# cohort, the
# old one-block quantile limit and one past it, 10^5 lanes: the reference
# takes any C, though no path of either sends more than 2,048 a round);
# single-tensor sizes (the CNN's packed N, 2^24)
TELE_LANES = (10, 50, 1000, 16384, 16385, 100000)
# lane_histogram's exactness cases: bins from one to its most (the lanes
# follow its crossover, check_histogram_cases)
HIST_CHECK_BINS = (1, 16, 33, 4096)
SINGLE_SIZES = (71808, 2 ** 24)
# blocks timed per variant for the telemetry path's wall per local step
TELE_TIMED_BLOCKS = 6
# phase 4c, the vmap engine: rounds of its CLI run and of each other run;
# the baselines (flags, each over 2 rounds, --lr the middle of the paper
# grids of benchmarks/fl_common.py); rounds timed per engine
VMAP_ROUNDS = 2
VMAP_BASELINES = {
    "sgd": ["--client-opt", "sgd", "--lr", "0.05"],
    "sgdm_decay": ["--client-opt", "sgdm_decay", "--lr", "0.05"],
    "adam": ["--client-opt", "adam", "--lr", "0.01"],
    "adagrad": ["--client-opt", "adagrad", "--lr", "0.01"],
    "sps": ["--client-opt", "sps"],
    "delta_sgd_fedavgm": ["--server-opt", "fedavgm"],
    "delta_sgd_fedadam": ["--server-opt", "fedadam"],
    "delta_sgd_fedyogi": ["--server-opt", "fedyogi"],
    "delta_sgd_fedprox": ["--fedprox-mu", "0.01"],
}
VMAP_TIMED_ROUNDS = 12
# phase 4d: the async presets (phase 4's configuration); the fleet at the
# fleet presets' own scale (100,000 registered x 0.0005 = 50 a round:
# phase 4's flags without its --participation); rounds and rounds a call
# of each run; the fleet resume run's registered clients and cohort
ASYNC_PRESETS = ("zipf_async", "byzantine_async")
_PART = TRAIN_ARGS.index("--participation")
FLEET_ARGS = TRAIN_ARGS[:_PART] + TRAIN_ARGS[_PART + 2:]
FLEET_REGISTERED, FLEET_C = 100_000, 50
FLEET_ROUNDS, FLEET_R = 8, 4
FLEET_EF_ROUNDS = 4
RESUME_REGISTERED, RESUME_PARTICIPATION = 1000, "0.05"
ASYNC_TIMED_BLOCKS = 6
# the CNN's packed width (MAIN_SHAPE's N) at the fleet's cohort
FLEET_SHAPE = (FLEET_C, 71808)
# phase 4e, LM training (Δ-SGD + FedAvg, seed 0): TinyLlama at full
# width cut to 2 layers, C = 4 clients of K = 2 steps on b = 8 sequences
# of S = 256 tokens, 2 rounds a run; TinyLlama whole (22 layers, C·N past
# 2**31) and Zamba2-7B at full width cut to 7 layers (6 Mamba2 and the
# shared block), one fused round each; the rounds timed for 4e's wall
LM_ARCH = "tinyllama-1.1b"
LM_CUT = dict(layers=2, C=4, K=2, b=8, S=256)
LM_DEEP = dict(layers=22, C=2, K=2, b=1, S=256)
LM_ZAMBA = dict(layers=7, C=2, K=2, b=2, S=256)
# OLMoE at full width cut to 2 layers (N = 1,045,178,368: C·N just under
# 2**31 at C = 2, about 60 GB); DeepSeek-V3 at its reduced config (one
# layer at full width is 46 GB of f32 params before any client copy)
MOE_ARCH, MLA_ARCH = "olmoe-1b-7b", "deepseek-v3-671b"
LM_MOE = dict(layers=2, C=2, K=2, b=1, S=256)
LM_MLA = dict(layers=2, C=2, K=2, b=4, S=128)
LM_ROUNDS = 2
LM_TIMED_BLOCKS = 3
# the f64 check of the 22-layer run's sums reads the row in slices of
# LM_F64_SLICE elements; the run's slab must pass LM_PAST elements
LM_F64_SLICE = 2 ** 26
LM_PAST = 2 ** 31
# serve paths: arch -> (layers kept (None: all), dtype); the runs'
# request counts. DeepSeek-V3 serves in bf16: one layer and its MTP
# block at full width are 24.97e9 params, 99.9 GB in f32
SERVE_PATHS = {"tinyllama-1.1b": (None, "float32"),
               "zamba2-7b": (14, "float32"),
               "olmoe-1b-7b": (None, "float32"),
               "codeqwen1.5-7b": (2, "float32"),
               "qwen2.5-14b": (2, "float32"),
               "granite-20b": (2, "float32"),
               "deepseek-v3-671b": (1, "bfloat16")}
SERVE_PROMPT, SERVE_GEN, SERVE_SLOTS, SERVE_FLUSH = 64, 32, 4, 8
SERVE_RUNS = (4, 6)
# depth of the card-vs-CPU prefill check (Zamba2: with its shared block);
# DeepSeek-V3's bf16 path has none: its decode gate runs at its reduced
# config in f32
CPU_CHECK_LAYERS = {"tinyllama-1.1b": 2, "zamba2-7b": 7, "olmoe-1b-7b": 2,
                    "codeqwen1.5-7b": 2, "qwen2.5-14b": 2,
                    "granite-20b": 2}
# MoE capacity factor of the decode == full forward gates: prefill of
# B·S tokens and decode of B drop different choices at the served 1.25
# (the reference's tests patch the same 8.0)
GATE_CAPACITY_FACTOR = 8.0


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def peaks(name: str):
    for frag, bw, f32 in CARDS:
        if frag in name:
            return bw, f32
    raise RuntimeError(f"no peak rates known for {name!r}")


def device_ms(fn, torch):
    """Median device time of ``fn`` over SAMPLES launches. The launches
    are queued behind a device sleep that outlasts their enqueue (three
    times the warm-up calls' median host time each), so each start/end
    event pair brackets device work, not the host's enqueue: a call of
    many small kernels, such as SDPA's math path, enqueues slower than
    the card runs it."""
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(SAMPLES)]
    cover = 3 * SAMPLES * statistics.median(host) * SLEEP_CYCLES_PER_S
    torch.cuda._sleep(int(min(max(20e6, cover), 4e9)))
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


# an empty kernel behind a plain C entry point, built and loaded as the
# port's libraries are: the floor of any launch in device_ms's timing
FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def launch_floor(torch, build):
    """A call that launches FLOOR_SOURCE's empty kernel on the current
    stream (built at first use under build/probe)."""
    import ctypes
    src = build.BUILD_DIR.parent / "probe" / "launch_floor.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(FLOOR_SOURCE)
    lib = build.load_library("launch_floor", [src])
    lib.empty_launch.argtypes = [ctypes.c_void_p]

    def launch():
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel: CUDA error {err}")
    return launch


# CUDA runtime and driver calls that put work on the device
ENQUEUE_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                 "cudaMemcpy", "cuMemcpy")


def _one_device_op(torch, name, fn):
    """One call of ``fn`` puts one operation on the device: its kernel,
    and no fill, memset or copy beside it. Counted from the CUDA runtime
    and driver calls torch.profiler records on the host: on this card
    the profiler now and then drops the device record of a kernel
    launched from the port's libraries, never the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CPU
           and e.name.startswith(ENQUEUE_CALLS)]
    if len(ops) != 1:
        raise AssertionError(f"{name}: {len(ops)} device ops a call, not 1: "
                             f"{ops}")


def _other_sm_count(common):
    """The H100 PCIe's 114 SMs, or 132 on a card of 114."""
    return 132 if common.sm_count(0) == 114 else 114


def _at_other_sm_count(common, fn):
    """``fn()`` with ``_other_sm_count`` in place of the card's own."""
    own_sms = common.sm_count
    other = _other_sm_count(common)
    common.sm_count = lambda index: other
    try:
        return fn()
    finally:
        common.sm_count = own_sms


def check_sm_count(torch, tk, tref, g, gp, p, eta, mask, norms):
    """With the H100 PCIe's 114 SMs in place of the card's own count (132
    on a card of 114): the norms keep their bits ``norms`` (their grid is
    a function of (C, N), ``norms_grid``), and the apply, whose grid
    follows the SM count (it does at LARGE_SHAPE), stays bitwise plain."""
    C, N = g.shape
    other = _other_sm_count(tk.common)
    if (C, N) == LARGE_SHAPE and (tk.apply_grid(C, N, other)
                                  == tk.apply_grid(C, N,
                                                   tk.common.sm_count(0))):
        raise AssertionError("the SM count moves no batched_apply grid")
    again, applied = _at_other_sm_count(tk.common, lambda: (
        torch.stack(tk.batched_norms(g, gp)),
        [tk.batched_apply(p.clone(), g, eta, mask=m) for m in (None, mask)]))
    torch.cuda.synchronize()
    if not torch.equal(again, norms):
        raise AssertionError("batched_norms: the SM count moved bits")
    for m, got in zip((None, mask), applied):
        if not torch.equal(got, tref.batched_apply_ref(p, g, eta, m)):
            raise AssertionError(f"batched_apply at {other} SMs "
                                 f"(masked={m is not None}) is not bitwise "
                                 "equal to the plain version")


def check_kernels(torch, tk, tref, bw, f32):
    """Phase 3. Returns {(name, shape): row}."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for C, N in (MAIN_SHAPE, FLEET_SHAPE, LARGE_SHAPE):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        g, gp, p = rand(C, N), rand(C, N), rand(C, N)
        eta = torch.rand((C,), generator=gen, device="cuda") * 0.99 + 0.01
        mask = (torch.rand((N,), generator=gen, device="cuda") < 0.5).float()

        # batched_norms: rtol 1e-5 (sum order), bitwise across calls, and
        # a NaN or inf only in its own client's sums
        got = norms = torch.stack(tk.batched_norms(g, gp))
        again = torch.stack(tk.batched_norms(g, gp))
        want = torch.stack(tref.batched_norms_ref(g, gp))
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("batched_norms: two calls differ")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        bad = g.clone()
        bad[0, N // 2 + 1] = float("nan")
        bad[C - 1, 5] = float("inf")
        dirty = torch.stack(tk.batched_norms(bad, gp))
        torch.cuda.synchronize()
        if (torch.isfinite(dirty[:, [0, C - 1]]).any()
                or not torch.equal(dirty[:, 1:C - 1], got[:, 1:C - 1])):
            raise AssertionError("batched_norms: a NaN or inf left its "
                                 "client")
        del bad
        _one_device_op(torch, "batched_norms", lambda: tk.batched_norms(g, gp))
        row = dict(
            name="batched_norms", shape=[C, N],
            max_abs_err=float((got - want).abs().max()),
            ms=device_ms(lambda: tk.batched_norms(g, gp), torch),
            plain_ms=device_ms(lambda: tref.batched_norms_ref(g, gp), torch),
            library_ms=None,
            bound_ms=max((2 * C * N + 2 * C) * 4 / bw, 5 * C * N / f32) * 1e3,
            bound_by="bytes")
        rows[("batched_norms", (C, N))] = row

        # batched_apply, unmasked and masked: bitwise equal to the plain
        # version (no FMA contraction), masked lanes exactly bf16
        for masked in (False, True):
            m = mask if masked else None
            want = tref.batched_apply_ref(p, g, eta, m)
            got = tk.batched_apply(p.clone(), g, eta, mask=m)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"batched_apply(masked={masked}) is "
                                     "not bitwise equal to the plain "
                                     "version")
            if masked:
                sel = got[:, mask > 0]
                if not torch.equal(sel, sel.bfloat16().float()):
                    raise AssertionError("masked lanes are not bf16")
            work = p.clone()
            name = "batched_apply" + ("[masked]" if masked else "")
            _one_device_op(torch, name,
                           lambda: tk.batched_apply(work, g, eta, mask=m))
            moved = 3 * C * N * 4 + C * 4 + (N * 4 if masked else 0)
            row = dict(
                name=name, shape=[C, N],
                max_abs_err=float((got - want).abs().max()),
                ms=device_ms(lambda: tk.batched_apply(work, g, eta, mask=m),
                             torch),
                plain_ms=device_ms(
                    lambda: tref.batched_apply_ref(work, g, eta, m), torch),
                library_ms=(None if masked else device_ms(
                    lambda: torch.addcmul(work, eta[:, None], g, value=-1),
                    torch)),
                bound_ms=max(moved / bw, 2 * C * N / f32) * 1e3,
                bound_by="bytes")
            rows[(name, (C, N))] = row
        check_sm_count(torch, tk, tref, g, gp, p, eta, mask, norms)
        for key, row in rows.items():
            if key[1] == (C, N):
                row["gbps_achieved"] = (row["bound_ms"] / row["ms"]) * bw / 1e9
                print(json.dumps(row), flush=True)
    return rows


def _quant_bits_equal(torch, got, want):
    (q, s), (wq, ws) = got, want
    return torch.equal(q, wq) and torch.equal(
        s.nan_to_num(-1.0).view(torch.int32),
        ws.nan_to_num(-1.0).view(torch.int32))


def check_quantize_grids(torch, tcomp, tcref):
    """Phase 3: quantize_int8 bitwise plain at ragged chunk counts (one
    chunk, a ragged warp, a ragged last warp after whole ones, a
    part-filled last block), each with a NaN and an inf chunk where
    there are three chunks or more."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for C, M in QUANT_RAGGED:
        x = (torch.randn((C, M, 128), generator=gen, device="cuda")
             * torch.exp(3 * torch.randn((C, M, 1), generator=gen,
                                         device="cuda"))).view(C, M * 128)
        x[:, :128] = 0.0
        if M >= 3:
            x[0, 130] = float("nan")
            x[C - 1, 300] = float("inf")
        if not _quant_bits_equal(torch, tcomp.quantize_int8(x),
                                 tcref.quantize_int8_ref(x)):
            raise AssertionError(f"quantize_int8 at {(C, M)} chunks is not "
                                 "bitwise equal to the plain version")
    print("quantize_int8 ragged chunk counts bitwise plain:",
          json.dumps([[C, M, tcomp.quantize_grid(C * M)]
                      for C, M in QUANT_RAGGED]), flush=True)


def check_dequantize_grids(torch, tcomp, tcref):
    """Phase 3: dequantize_int8 bitwise plain at ragged chunk counts (one
    chunk, a ragged warp, a ragged last warp after whole ones, a
    part-filled last block), with NaN, ±inf and zero scales and zero
    codes beside them (0 · inf is NaN), the same bits on two calls, one
    device op a call."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0],
                           device="cuda")
    for C, M in QUANT_RAGGED:
        q = torch.randint(-127, 128, (C, M * 128), generator=gen,
                          device="cuda", dtype=torch.int8)
        s = torch.exp(3 * torch.randn((C, M), generator=gen, device="cuda"))
        q[:, :64] = 0
        s.view(-1)[:4] = special[:min(4, C * M)]
        got = tcomp.dequantize_int8(q, s)
        again = tcomp.dequantize_int8(q, s)
        want = tcref.dequantize_int8_ref(q, s)
        torch.cuda.synchronize()
        if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(again.view(torch.int32),
                                got.view(torch.int32))):
            raise AssertionError(f"dequantize_int8 at {(C, M)} chunks is "
                                 "not bitwise equal to the plain version "
                                 "on two calls")
        _one_device_op(torch, f"dequantize_int8 {(C, M)} chunks",
                       lambda: tcomp.dequantize_int8(q, s))
    print("dequantize_int8 ragged chunk counts and NaN/inf scales bitwise "
          "plain:", json.dumps([[C, M, tcomp.dequantize_grid(C * M)]
                                for C, M in QUANT_RAGGED]), flush=True)


def check_sm_count_moves_no_quantize_bit(torch, tcomp, x, q, s):
    """Phase 3: with 114 SMs in place of the card's own count (132 on a
    card of 114), quantize_int8 gives the same bits."""
    got = _at_other_sm_count(tcomp.common, lambda: tcomp.quantize_int8(x))
    torch.cuda.synchronize()
    if not _quant_bits_equal(torch, got, (q, s)):
        raise AssertionError(f"quantize_int8 at "
                             f"{_other_sm_count(tcomp.common)} SMs moved "
                             "bits")


def check_round_tail_kernels(torch, tcomp, tcref, tra, traref, bw, f32):
    """Phase 3, the compression and robust-aggregation kernels at the
    CNN path's shape, the fleet's cohort (whose int8 + EF21 run
    quantizes and dequantizes all 50 clients in one launch) and a large
    one. Returns {(name, shape): row}."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for C, N in (MAIN_SHAPE, FLEET_SHAPE, LARGE_SHAPE):
        M = N // 128
        # round-delta-like: a different scale per 128-chunk, a zero chunk
        scale = torch.exp(3 * torch.randn((C, M, 1), generator=gen,
                                          device="cuda"))
        x = (torch.randn((C, M, 128), generator=gen, device="cuda")
             * scale).view(C, N)
        x[:, :128] = 0.0
        q, s = tcomp.quantize_int8(x)
        want_q, want_s = tcref.quantize_int8_ref(x)
        out = tcomp.dequantize_int8(q, s)
        want_out = tcref.dequantize_int8_ref(q, s)
        top = tcomp.topk_mask(x, TOPK_K)
        want_top = tcref.topk_mask_ref(x, TOPK_K)
        torch.cuda.synchronize()
        for name, a, b in (("quantize_int8 q", q, want_q),
                           ("quantize_int8 scales", s, want_s),
                           ("dequantize_int8", out, want_out),
                           ("topk_mask", top, want_top)):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"{name} is not bitwise equal to the "
                                     "plain version")
        if (C, N) == MAIN_SHAPE:
            bad = x.clone()
            bad[0, 130] = float("nan")
            q_nan, s_nan = tcomp.quantize_int8(bad)
            wq, ws = tcref.quantize_int8_ref(bad)
            torch.cuda.synchronize()
            if not (torch.isnan(s_nan[0, 1]) and torch.equal(q_nan, wq)
                    and torch.equal(s_nan.nan_to_num(-1.0),
                                    ws.nan_to_num(-1.0))):
                raise AssertionError("quantize_int8 treats a NaN chunk "
                                     "unlike the plain version")
            check_quantize_grids(torch, tcomp, tcref)
            check_dequantize_grids(torch, tcomp, tcref)
        check_sm_count_moves_no_quantize_bit(torch, tcomp, x, q, s)
        q2, s2 = tcomp.quantize_int8(x)
        torch.cuda.synchronize()
        if not (torch.equal(q2, q) and torch.equal(bits(s2), bits(s))):
            raise AssertionError("quantize_int8: two calls differ")
        del q2, s2
        _one_device_op(torch, "quantize_int8",
                       lambda: tcomp.quantize_int8(x))
        again = tcomp.dequantize_int8(q, s)
        torch.cuda.synchronize()
        if not torch.equal(bits(again), bits(out)):
            raise AssertionError("dequantize_int8: two calls differ")
        del again
        _one_device_op(torch, "dequantize_int8",
                       lambda: tcomp.dequantize_int8(q, s))

        cn = C * N
        s_bytes = 4 * C * M
        rows[("quantize_int8", (C, N))] = dict(
            name="quantize_int8", shape=[C, N],
            max_abs_err=float((q.int() - want_q.int()).abs().max()),
            ms=device_ms(lambda: tcomp.quantize_int8(x), torch),
            plain_ms=device_ms(lambda: tcref.quantize_int8_ref(x), torch),
            library_ms=None,
            bound_ms=max((4 * cn + cn + s_bytes) / bw, 6 * cn / f32) * 1e3,
            bound_by="bytes")
        rows[("dequantize_int8", (C, N))] = dict(
            name="dequantize_int8", shape=[C, N],
            grid=tcomp.dequantize_grid(C * M),
            max_abs_err=float((out - want_out).abs().max()),
            ms=device_ms(lambda: tcomp.dequantize_int8(q, s), torch),
            plain_ms=device_ms(lambda: tcref.dequantize_int8_ref(q, s),
                               torch),
            library_ms=device_ms(
                lambda: torch.mul(q.view(C, M, 128), s[..., None]), torch),
            bound_ms=max((cn + s_bytes + 4 * cn) / bw, cn / f32) * 1e3,
            bound_by="bytes")
        _one_device_op(torch, "topk_mask", lambda: tcomp.topk_mask(x, TOPK_K))
        rows[("topk_mask", (C, N))] = dict(
            name="topk_mask", shape=[C, N],
            max_abs_err=float((top - want_top).abs().max()),
            ms=device_ms(lambda: tcomp.topk_mask(x, TOPK_K), torch),
            plain_ms=device_ms(lambda: tcref.topk_mask_ref(x, TOPK_K),
                               torch),
            library_ms=None,
            # the select's work depends on the data (its search stops
            # early): the bytes alone, each read and written once
            bound_ms=8 * cn / bw * 1e3, bound_by="bytes")

        # trimmed mean (t = 2, the dirichlet_dropouts path) and the
        # median (t = C/2 - 1): bitwise equal to the plain version, two
        # calls bitwise equal, one device op a call; one row each
        sort_ops = 2 * MERGE_NETWORK_SIZE[1 << (C - 1).bit_length()]
        median_t = C // 2 - 1
        for t, name in ((TRIM_T, "batched_trimmed_mean"),
                        (median_t, "batched_trimmed_mean[median]")):
            got = tra.batched_trimmed_mean(x, t)
            again = tra.batched_trimmed_mean(x, t)
            want = traref.batched_trimmed_mean_ref(x, t)
            torch.cuda.synchronize()
            if not torch.equal(bits(got), bits(again)):
                raise AssertionError(f"{name}: two calls differ")
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{name} is not bitwise equal to the "
                                     "plain version")
            _one_device_op(torch, name,
                           lambda t=t: tra.batched_trimmed_mean(x, t))
            row = dict(
                name=name, shape=[C, N], t=t,
                max_abs_err=float((got - want).abs().max()),
                ms=device_ms(lambda t=t: tra.batched_trimmed_mean(x, t),
                             torch),
                plain_ms=device_ms(
                    lambda t=t: traref.batched_trimmed_mean_ref(x, t),
                    torch),
                library_ms=None,
                bound_ms=max((4 * cn + 4 * N) / bw,
                             (sort_ops + C) * N / f32) * 1e3,
                bound_by="bytes")
            if t == median_t:
                # the median of an even cohort is torch.quantile's
                # midpoint: the same function, one library call
                try:
                    lib = torch.quantile(x, 0.5, dim=0,
                                         interpolation="midpoint")
                except RuntimeError as err:
                    row["library_refused"] = str(err).splitlines()[0]
                else:
                    # quantile's midpoint is a lerp, a + (b − a)/2, which
                    # rounds b − a: within 1e-6 of the larger middle value
                    mid = torch.sort(x, dim=0).values[C // 2 - 1:C // 2 + 1]
                    scale = mid.abs().amax(dim=0)
                    if not ((lib - got).abs() <= 1e-6 * scale).all():
                        raise AssertionError(
                            "torch.quantile(midpoint) differs from the "
                            "median by more than 1e-6 of the middle values")
                    row["library_max_rel_err_of_middle"] = float(
                        ((lib - got).abs() / scale.clamp(min=1e-30)).max())
                    del lib, mid, scale
                    row["library_ms"] = device_ms(
                        lambda: torch.quantile(x, 0.5, dim=0,
                                               interpolation="midpoint"),
                        torch)
                    row["library_call"] = "torch.quantile(midpoint)"
            rows[(name, (C, N))] = row
        for key, row in rows.items():
            if key[1] == (C, N):
                row["gbps_achieved"] = (row["bound_ms"] / row["ms"]) * bw / 1e9
                print(json.dumps(row), flush=True)
    return rows


def _tele_lanes(C, seed):
    """C lanes with NaN of both signs, ±0, ±inf and ties, the rest
    log-spread over nine decades, both signs."""
    import numpy as np
    r = np.random.default_rng(seed)
    x = (10.0 ** r.uniform(-6.0, 3.0, C)).astype(np.float32)
    x *= np.where(r.uniform(size=C) < 0.3, -1.0, 1.0).astype(np.float32)
    special = np.asarray([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0,
                          1.0, -0.0, 0.5, 0.5], np.float32)
    n = min(C, len(special))
    x[r.permutation(C)[:n]] = special[:n]
    return x


def _hist_edges(B, mixed):
    """B + 1 log-spaced edges from 0 (the telemetry spec's kind), or the
    same shuffled, with a NaN edge and an empty bin of equal edges."""
    import numpy as np
    e = np.concatenate([[0.0], np.logspace(-6, 3, B)]).astype(np.float32)
    if mixed:
        r = np.random.default_rng(B)
        e = r.permutation(e)
        e[r.integers(0, B + 1)] = np.nan
        e[min(B, 1)] = e[0]
    return e


def check_histogram_cases(torch, tt, ttref):
    """Phase 3b: lane_histogram exact at C = 1, 10, the crossover
    HIST_WARP_LANES (the one-warp path's last) and one either side,
    16,384 and 100,000 (the grid), at each B of HIST_CHECK_BINS, with
    ascending and non-ascending edges; two calls give the same bits; one
    device op a call on both paths."""
    X = tt.HIST_WARP_LANES
    lanes = (1, 10, X - 1, X, X + 1, 16384, 100000)
    n = 0
    for C in lanes:
        x = torch.from_numpy(_tele_lanes(C, C + 7)).cuda().abs()
        for B in HIST_CHECK_BINS:
            for mixed in (False, True):
                e = torch.from_numpy(_hist_edges(B, mixed)).cuda()
                got, again = tt.lane_histogram(x, e), tt.lane_histogram(x, e)
                want = ttref.lane_histogram_ref(x, e)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(got, again)):
                    raise AssertionError(
                        f"lane_histogram C={C} B={B} mixed={mixed}: "
                        f"{got[:8].tolist()} != plain {want[:8].tolist()} "
                        "or two calls differ")
                n += 1
        e = torch.from_numpy(_hist_edges(16, False)).cuda()
        _one_device_op(torch, f"lane_histogram C={C}",
                       lambda x=x, e=e: tt.lane_histogram(x, e))
    sms = tt.common.sm_count(0)
    print("lane_histogram exact, same bits twice, one device op a call:",
          json.dumps({"cases": n, "grids": {
              C: list(tt.hist_grid(C, 16, sms)) for C in lanes}}),
          flush=True)


def check_slice4_kernels(torch, tk, tref, tt, ttref, bw, f32):
    """Phase 3b. Returns {(name, case): row}."""
    import numpy as np
    from repro_torch.telemetry import TelemetrySpec
    rows = {}
    check_histogram_cases(torch, tt, ttref)
    edges = TelemetrySpec().edges_on("cuda")
    B = edges.numel() - 1
    Q = 11
    q = torch.linspace(0.0, 1.0, Q, device="cuda")
    for C in TELE_LANES:
        x = torch.from_numpy(_tele_lanes(C, C)).cuda()
        ax = x.abs()
        hist, want_hist = tt.lane_histogram(ax, edges), \
            ttref.lane_histogram_ref(ax, edges)
        quant, want_quant = tt.lane_quantiles(x, Q), \
            ttref.lane_quantiles_ref(x, Q)
        torch.cuda.synchronize()
        if not torch.equal(hist, want_hist):
            raise AssertionError(f"lane_histogram C={C}: {hist} != plain "
                                 f"{want_hist}")
        if not torch.equal(quant.view(torch.int32),
                           want_quant.view(torch.int32)):
            raise AssertionError(f"lane_quantiles C={C}: {quant} != plain "
                                 f"{want_quant}")
        if float(hist.sum()) != C - int((~torch.isfinite(ax)).sum()):
            raise AssertionError(f"lane_histogram C={C}: NaN or inf counted")
        # the library yardstick on the NaN-free lanes, where it is the
        # same function
        fin = torch.nan_to_num(x, nan=0.25)
        lib = torch.quantile(fin, q, interpolation="nearest")
        same = torch.equal(lib, tt.lane_quantiles(fin, Q))
        print(f"torch.quantile(nearest) at C={C} equals lane_quantiles on "
              f"NaN-free lanes: {same}", flush=True)
        p2 = 1 << max(1, (C - 1).bit_length())
        lg = p2.bit_length() - 1
        sort_ops = 2 * (p2 // 2) * lg * (lg + 1) // 2
        h_bytes, h_ops = 4 * C + 4 * (B + 1) + 4 * B, 2 * C * B
        q_bytes = 4 * C + 4 * Q
        rows[("lane_histogram", C)] = dict(
            name="lane_histogram", shape=[C], bins=B,
            max_abs_err=float((hist - want_hist).abs().max()),
            ms=device_ms(lambda: tt.lane_histogram(ax, edges), torch),
            plain_ms=device_ms(lambda: ttref.lane_histogram_ref(ax, edges),
                               torch),
            library_ms=None,
            bound_ms=max(h_bytes / bw, h_ops / f32) * 1e3,
            bound_by="bytes" if h_bytes / bw > h_ops / f32 else "operations")
        rows[("lane_quantiles", C)] = dict(
            name="lane_quantiles", shape=[C], quantiles=Q,
            max_abs_err=float(torch.nan_to_num(quant - want_quant).abs()
                              .max()),
            ms=device_ms(lambda: tt.lane_quantiles(x, Q), torch),
            plain_ms=device_ms(lambda: ttref.lane_quantiles_ref(x, Q),
                               torch),
            library_ms=(device_ms(lambda: torch.quantile(
                fin, q, interpolation="nearest"), torch) if same else None),
            bound_ms=max(q_bytes / bw, sort_ops / f32) * 1e3,
            bound_by="bytes" if q_bytes / bw > sort_ops / f32
            else "operations")
        for name in ("lane_histogram", "lane_quantiles"):
            print(json.dumps(rows[(name, C)]), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(4)
    eta = 0.37
    eta_t = torch.tensor(eta, device="cuda")
    for n in SINGLE_SIZES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            g, gp, p = (torch.randn((n,), generator=gen, device="cuda")
                        .to(dtype) for _ in range(3))
            got = torch.stack(tk.norms(g, gp))
            again = torch.stack(tk.norms(g, gp))
            want = torch.stack(tref.norms_ref(g, gp))
            torch.cuda.synchronize()
            other = torch.stack(_at_other_sm_count(
                tk.common, lambda: tk.norms(g, gp)))
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"norms {n} {dname}: two calls differ")
            if not torch.equal(got, other):
                raise AssertionError(f"norms {n} {dname}: the SM count "
                                     "moved bits")
            torch.testing.assert_close(
                got, want, rtol=1e-5 if dtype == torch.float32 else 3e-3,
                atol=0.0)
            _one_device_op(torch, f"norms {n} {dname}",
                           lambda: tk.norms(g, gp))
            # aligned, one element past (a ragged end), an unaligned view
            views = [(p, g), (torch.cat([p, p[:1]]), torch.cat([g, g[:1]])),
                     (p[1:], g[1:])]
            for pp, gg in views:
                for e in (eta, eta_t):
                    out = tk.apply_update(pp, gg, e)
                    if not torch.equal(out, tref.apply_ref(pp, gg, e)):
                        raise AssertionError(
                            f"apply_update {pp.numel()} {dname} (eta "
                            f"{type(e).__name__}, aligned "
                            f"{pp.data_ptr() % 16 == 0}) is not bitwise "
                            "equal to the plain version")
            item = g.element_size()
            case = (n, dname)
            rows[("norms", case)] = dict(
                name="norms", shape=[n], dtype=dname,
                grid=list(tk.single_norms_grid(n, dtype)),
                max_abs_err=float((got - want).abs().max()),
                ms=device_ms(lambda: tk.norms(g, gp), torch),
                plain_ms=device_ms(lambda: tref.norms_ref(g, gp), torch),
                library_ms=None,
                bound_ms=max((2 * n * item + 8) / bw, 5 * n / f32) * 1e3,
                bound_by="bytes")
            rows[("apply_update", case)] = dict(
                name="apply_update", shape=[n], dtype=dname,
                max_abs_err=0.0,
                ms=device_ms(lambda: tk.apply_update(p, g, eta), torch),
                plain_ms=device_ms(lambda: tref.apply_ref(p, g, eta), torch),
                library_ms=device_ms(lambda: torch.add(p, g, alpha=-eta),
                                     torch),
                bound_ms=max(3 * n * item / bw, 2 * n / f32) * 1e3,
                bound_by="bytes")
            for name in ("norms", "apply_update"):
                row = rows[(name, case)]
                row["gbps_achieved"] = (row["bound_ms"] / row["ms"]) * bw / 1e9
                print(json.dumps(row), flush=True)
            del g, gp, p
    return rows


def _counts(mods):
    """{(kernel, device): launches} over the kernel namespaces."""
    out = {}
    for mod in mods:
        out.update(mod.LAUNCHES)
    return out


def _reset(mods):
    for mod in mods:
        mod.reset_launch_count()


def _finite(row):
    import numpy as np
    return all(bool(np.isfinite(v).all()) for v in row.values())


def _fused_equals_host(torch, fused, host):
    for t, (a, b) in enumerate(zip(fused.history, host.history)):
        if a.keys() != b.keys():
            raise AssertionError(f"round {t}: metric keys differ")
        for k in a:
            if a[k].tobytes() != b[k].tobytes():
                raise AssertionError(f"round {t} {k}: fused {a[k]!r} != "
                                     f"host loop {b[k]!r}")
    for k, layer in fused.state.params.items():
        for leaf, v in layer.items():
            if not torch.equal(v, host.state.params[k][leaf]):
                raise AssertionError(f"param {k}.{leaf}: fused != host")


def run_scenario_path(torch, mods, train, name):
    """Phase 4, one scenario path. Returns its launch counts."""
    flags, per_round = SCENARIO_PATHS[name]
    args = TRAIN_ARGS + flags
    _reset(mods)
    fused = train.main(args + ["--rounds-per-call", "2", "--device",
                               "cuda"])
    torch.cuda.synchronize()
    launches = _counts(mods)
    want = {("batched_norms", "cuda"): K * ROUNDS,
            ("batched_apply", "cuda"): K * ROUNDS}
    want.update({(k, "cuda"): n * ROUNDS for k, n in per_round.items()})
    if launches != want:
        raise AssertionError(f"path {name} launched {launches}, expected "
                             f"{want}")
    for t, row in enumerate(fused.history):
        if not _finite(row):
            raise AssertionError(f"path {name} round {t}: non-finite "
                                 f"metrics {row}")
        print(f"path {name} round {t}", json.dumps(
            {k: float(row[k]) for k in ("loss", "eta_mean", "valid_count",
                                        "round_skipped", "wire_bytes",
                                        "comp_ratio")}), flush=True)

    host = train.main(args + ["--flat", "--device", "cuda"])
    _fused_equals_host(torch, fused, host)
    print(f"path {name}: fused == host loop, bitwise (params and metrics)")

    cpu = train.main(args + ["--rounds", "1", "--device", "cpu"])
    for k in ("loss", "eta_mean"):
        a, b = float(fused.history[0][k]), float(cpu.history[0][k])
        print(f"path {name} round 0 {k} cuda {a!r} cpu {b!r}")
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"path {name} round 0 {k}: cuda {a} vs "
                                 f"cpu {b}")
    print(f"path {name}: round 0 loss/eta_mean agree with the CPU within "
          "1e-4")
    return launches


def run_path(torch, mods, train):
    """Phase 4, the plain (slice-1) path. Returns its launch counts and
    the fused run's round-0 metrics."""
    _reset(mods)
    fused = train.main(TRAIN_ARGS + ["--rounds-per-call", "2",
                                     "--device", "cuda"])
    torch.cuda.synchronize()
    launches = _counts(mods)
    want = {("batched_norms", "cuda"): K * ROUNDS,
            ("batched_apply", "cuda"): K * ROUNDS}
    if launches != want:
        raise AssertionError(f"main path launched {launches}, expected "
                             f"{want}")
    for t, row in enumerate(fused.history):
        if not all(math.isfinite(float(v)) for v in row.values()):
            raise AssertionError(f"round {t}: non-finite metrics {row}")
        print("path round", t, json.dumps({k: float(v)
                                           for k, v in row.items()}))

    host = train.main(TRAIN_ARGS + ["--flat", "--device", "cuda"])
    _fused_equals_host(torch, fused, host)
    print("path: fused == host loop, bitwise (params and metrics)")

    cpu = train.main(TRAIN_ARGS + ["--rounds-per-call", "2",
                                   "--device", "cpu"])
    for t, (a, b) in enumerate(zip(fused.history, cpu.history)):
        print("path round", t, "cuda vs cpu", json.dumps(
            {k: [float(a[k]), float(b[k])] for k in ("loss", "eta_mean")}))
    for k in ("loss", "eta_mean"):
        a, b = float(fused.history[0][k]), float(cpu.history[0][k])
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"round 0 {k}: cuda {a} vs cpu {b}")
    print("path: round 0 loss/eta_mean agree with the CPU within 1e-4")

    return launches, fused.history[0]


def _fused_setup(train, torch, telemetry):
    """A plain CNN fused loop on the card (the phase 4 configuration),
    warmed by one block -> (run one block, state)."""
    from repro_torch.core import flatten_fl_state
    args = train.build_parser().parse_args(
        TRAIN_ARGS + ["--rounds-per-call", "2", "--device", "cuda"]
        + (["--telemetry"] if telemetry else []))
    pt = train.setup_paper_task(args)
    run = train.BlockRunner(pt, args)
    state = {"fs": flatten_fl_state(train.init_state(pt), run.layout)}

    def block():
        state["fs"], mets = run(state["fs"], run.stage(state["fs"].round, 2))
        return mets

    block()
    torch.cuda.synchronize()
    return block


def _block_syncs(torch, block):
    """Host syncs torch reports during one fused block -> (count, the
    first line of each distinct report)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            block()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    msgs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    return len(msgs), sorted({m.splitlines()[0][:160] for m in msgs})


def run_telemetry_path(torch, mods, train):
    """Phase 4b. Returns the launch counts of the telemetry-on fused run."""
    import tempfile
    import numpy as np
    from repro_torch.telemetry import load_events
    C = 10
    args = TRAIN_ARGS + ["--rounds-per-call", "2", "--device", "cuda"]
    off = train.main(args)
    _reset(mods)
    on = train.main(args + ["--telemetry"])
    torch.cuda.synchronize()
    launches = _counts(mods)
    want = {("batched_norms", "cuda"): K * ROUNDS,
            ("batched_apply", "cuda"): K * ROUNDS,
            ("lane_histogram", "cuda"): ROUNDS,
            ("lane_quantiles", "cuda"): ROUNDS}
    if launches != want:
        raise AssertionError(f"telemetry path launched {launches}, expected "
                             f"{want}")
    for t, (a, b) in enumerate(zip(off.history, on.history)):
        extra = set(b) - set(a)
        if extra != {"eta_hist", "loss_deciles", "eta_clip_count",
                     "nan_guard_count"}:
            raise AssertionError(f"round {t}: telemetry added {extra}")
        for k in a:
            if a[k].tobytes() != b[k].tobytes():
                raise AssertionError(f"round {t} {k}: telemetry on "
                                     f"{b[k]!r} != off {a[k]!r}")
        if not (math.isfinite(float(b["eta_min"]))
                and math.isfinite(float(b["eta_max"]))
                and float(np.sum(b["eta_hist"])) == C):
            raise AssertionError(f"round {t}: eta_hist {b['eta_hist']} does "
                                 f"not count the {C} finite eta lanes")
        if not bool(np.all(np.diff(b["loss_deciles"]) >= 0)):
            raise AssertionError(f"round {t}: loss deciles decrease: "
                                 f"{b['loss_deciles']}")
        print("telemetry round", t, json.dumps(
            {"eta_hist": b["eta_hist"].tolist(),
             "loss_deciles": b["loss_deciles"].tolist(),
             "eta_clip_count": float(b["eta_clip_count"]),
             "nan_guard_count": float(b["nan_guard_count"])}), flush=True)
    for k, layer in off.state.params.items():
        for leaf, v in layer.items():
            if not torch.equal(v, on.state.params[k][leaf]):
                raise AssertionError(f"param {k}.{leaf}: telemetry on != off")
    host = train.main(TRAIN_ARGS + ["--flat", "--device", "cuda",
                                    "--telemetry", "--log-every", "3"])
    _fused_equals_host(torch, on, host)
    print("telemetry path: on == off (params and metrics) and fused == host "
          "loop, bitwise", flush=True)

    # host syncs in one fused block, and the wall per local step, on and
    # off in turns (off, on, on, off, ...)
    blocks = {False: _fused_setup(train, torch, False),
              True: _fused_setup(train, torch, True)}
    # a first pass takes the reports torch makes once per process
    first = [_block_syncs(torch, blocks[tele]) for tele in (False, True)]
    syncs = {tele: _block_syncs(torch, blocks[tele])[0]
             for tele in (True, False)}
    print("telemetry path host syncs", json.dumps(
        {"first_pass_off_on": first, "off": syncs[False],
         "on": syncs[True]}), flush=True)
    if syncs[True] != syncs[False]:
        raise AssertionError(f"telemetry changed the host syncs of a fused "
                             f"block: {syncs}")
    walls = {False: [], True: []}
    for i in range(TELE_TIMED_BLOCKS):
        for tele in ((False, True) if i % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            blocks[tele]()
            torch.cuda.synchronize()
            walls[tele].append((time.perf_counter() - t0) / (2 * K) * 1e3)
    print("telemetry path time", json.dumps({
        "host_syncs_per_block": {"off": syncs[False], "on": syncs[True]},
        "wall_ms_per_step_off": walls[False],
        "wall_ms_per_step_on": walls[True],
        "median_off": statistics.median(walls[False]),
        "median_on": statistics.median(walls[True])}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        ev = Path(tmp) / "events.jsonl"
        train.main(args + ["--telemetry", "--events", str(ev), "--profile",
                           "1", "--profile-dir", str(Path(tmp) / "prof")])
        header, events = load_events(str(ev))
        kinds = [e["kind"] for e in events]
        static = [e for e in events if e["kind"] == "static"]
        if (header.get("device_name") != torch.cuda.get_device_name(0)
                or kinds.count("round") != ROUNDS or len(static) != 1
                or static[0]["kernel_launches_per_round"].get(
                    "telemetry/lane_histogram") != 1
                or kinds[-1] != "spans"
                or not (Path(tmp) / "prof" / "trace.json").exists()):
            raise AssertionError(f"event log {kinds}: {static}")
        print("telemetry CLI event log", json.dumps(
            {"kinds": kinds, "static": static[0], "spans": events[-1]}),
            flush=True)
    return launches


def _close_rel(a, b):
    """|a − b| / |b|, 0 where both are equal (NaN included)."""
    if a == b or (math.isnan(a) and math.isnan(b)):
        return 0.0
    return abs(a - b) / abs(b)


def _vmap_setup(torch, train, flags, client_opt=None):
    """The phase-4 configuration on cuda, and one round function of it
    -> (PaperTask, round_fn, batches of rounds 0..VMAP_TIMED_ROUNDS on
    the card). ``client_opt`` replaces the run's client optimizer."""
    from repro_torch.core import make_fl_round
    args = train.build_parser().parse_args(TRAIN_ARGS + ["--device", "cuda"])
    pt = train.setup_paper_task(args)
    rnd = make_fl_round(pt.loss_fn, client_opt or pt.client_opt,
                        pt.server_opt, num_rounds=ROUNDS, **flags)
    batches = []
    for t in range(VMAP_TIMED_ROUNDS + 1):
        b, _, _ = pt.fed.sample_round(pt.participation, pt.local_steps,
                                      args.batch, round_idx=t)
        batches.append({k: torch.from_numpy(v).to(pt.device)
                        for k, v in b.items()})
    return pt, rnd, batches


def run_vmap_path(torch, mods, train, flat_round0, smi):
    """Phase 4c, the vmap engine. Returns its launch counts by run."""
    from repro_torch.core import get_client_opt
    import numpy as np
    paths = {}

    # the CLI with R = 1 and no --flat: the vmap engine, plain Δ-SGD
    _reset(mods)
    vm = train.main(TRAIN_ARGS + ["--device", "cuda"])
    torch.cuda.synchronize()
    paths["vmap_cli"] = _counts(mods)
    if any(paths["vmap_cli"].values()):
        raise AssertionError(f"the vmap CLI run launched "
                             f"{paths['vmap_cli']}: its plain route "
                             "launches no kernel")
    for t, row in enumerate(vm.history):
        if not _finite(row) or "eta_clip_rate" in row:
            raise AssertionError(f"vmap round {t}: {row}")
        print("vmap round", t, json.dumps({k: float(v)
                                           for k, v in row.items()}))
    cpu = train.main(TRAIN_ARGS + ["--rounds", "1", "--device", "cpu"])
    for k in ("loss", "eta_mean"):
        a = float(vm.history[0][k])
        b, f = float(cpu.history[0][k]), float(flat_round0[k])
        print(f"vmap round 0 {k} cuda {a!r} cpu {b!r} flat engine {f!r}")
        if not (math.isclose(a, b, rel_tol=1e-4)
                and math.isclose(a, f, rel_tol=1e-4)):
            raise AssertionError(f"vmap round 0 {k}: cuda {a}, cpu {b}, "
                                 f"flat engine {f}")
    print("vmap: round 0 loss/eta_mean agree with the CPU and with the "
          "flat engine within 1e-4", flush=True)

    # the kernel route: fused_delta_sgd_update on the stacked cohort,
    # two launches a step, against the plain route on the card
    runs = {}
    for route, kw in (("plain", {}), ("kernel", dict(use_pallas=True))):
        pt, rnd, batches = _vmap_setup(
            torch, train, {}, get_client_opt("delta_sgd", **kw))
        state, rows = train.init_state(pt), []
        _reset(mods)
        for t in range(VMAP_ROUNDS):
            state, m, _ = rnd(state, batches[t])
            rows.append({k: float(v) for k, v in m.items()})
            if t == 0:
                p0 = {k: {n: v.clone() for n, v in layer.items()}
                      for k, layer in state.params.items()}
        torch.cuda.synchronize()
        runs[route] = (rows, p0, _counts(mods))
    paths["vmap_kernel_route"] = runs["kernel"][2]
    want = {("batched_norms", "cuda"): K * VMAP_ROUNDS,
            ("batched_apply", "cuda"): K * VMAP_ROUNDS}
    if runs["kernel"][2] != want or any(runs["plain"][2].values()):
        raise AssertionError(f"kernel route launched {runs['kernel'][2]}, "
                             f"plain {runs['plain'][2]}; expected {want} "
                             "and none")
    errs = {k: _close_rel(runs["kernel"][0][0][k], runs["plain"][0][0][k])
            for k in ("loss", "eta_mean", "eta_min", "eta_max")}
    perr = max(float((runs["kernel"][1][k][n] - v).abs().max()
                     / v.abs().max())
               for k, layer in runs["plain"][1].items()
               for n, v in layer.items())
    print("vmap kernel route", json.dumps({
        "launches": {f"{k}/{d}": n for (k, d), n in runs["kernel"][2].items()},
        "round0_rel_err": errs, "round0_param_err_rel_to_leaf_max": perr,
        "rounds": [{k: r[k] for k in ("loss", "eta_mean")}
                   for r in runs["kernel"][0]]}), flush=True)
    if max(errs.values()) > 1e-5 or perr > 1e-5:
        raise AssertionError(f"kernel route vs plain: {errs}, params {perr}")

    # the paper's baselines, Δ-SGD under the other server optimizers and
    # with FedProx: finite, round 0 = CPU's within 1e-4
    for name, flags in VMAP_BASELINES.items():
        args = TRAIN_ARGS + flags + ["--rounds", str(VMAP_ROUNDS)]
        _reset(mods)
        card = train.main(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        if any(_counts(mods).values()):
            raise AssertionError(f"baseline {name} launched {_counts(mods)}")
        delta = "--client-opt" not in flags
        for t, row in enumerate(card.history):
            finite = {k: v for k, v in row.items()
                      if delta or not k.startswith("eta_")}
            if not _finite(finite) or not (
                    delta or math.isnan(float(row["eta_mean"]))):
                raise AssertionError(f"baseline {name} round {t}: {row}")
        host = train.main(args + ["--rounds", "1", "--device", "cpu"])
        a, b = float(card.history[0]["loss"]), float(host.history[0]["loss"])
        print(f"vmap baseline {name}", json.dumps({
            "loss": [float(r["loss"]) for r in card.history],
            "eta_mean": [float(r["eta_mean"]) for r in card.history],
            "round0_loss_cpu": b}), flush=True)
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"baseline {name} round 0 loss: cuda {a} "
                                 f"vs cpu {b}")

    # telemetry on the vmap engine: one histogram and one quantiles
    # launch a round; no η lane to count for sgd
    _reset(mods)
    tele = train.main(TRAIN_ARGS + VMAP_BASELINES["sgd"]
                      + ["--rounds", str(VMAP_ROUNDS), "--telemetry",
                         "--device", "cuda"])
    torch.cuda.synchronize()
    paths["vmap_telemetry"] = _counts(mods)
    want = {("lane_histogram", "cuda"): VMAP_ROUNDS,
            ("lane_quantiles", "cuda"): VMAP_ROUNDS}
    if paths["vmap_telemetry"] != want:
        raise AssertionError(f"vmap telemetry launched "
                             f"{paths['vmap_telemetry']}, expected {want}")
    for t, row in enumerate(tele.history):
        if (float(np.sum(row["eta_hist"])) != 0.0
                or not np.isfinite(row["loss_deciles"]).all()):
            raise AssertionError(f"vmap telemetry round {t}: {row}")
    print("vmap telemetry", json.dumps(
        {"eta_hist": [r["eta_hist"].tolist() for r in tele.history],
         "loss_deciles_round0": tele.history[0]["loss_deciles"].tolist()}),
        flush=True)

    # host syncs in one vmap round: the plain route (Adam, Δ-SGD) makes
    # none; the kernel route's and the flat host loop's are printed
    engines = {"vmap": _vmap_setup(torch, train, dict(flat=False)),
               "vmap_kernel": _vmap_setup(
                   torch, train, dict(flat=False),
                   get_client_opt("delta_sgd", use_pallas=True)),
               "flat": _vmap_setup(torch, train, dict(flat=True))}
    adam = _vmap_setup(torch, train, dict(flat=False), get_client_opt(
        "adam", lr=float(VMAP_BASELINES["adam"][-1])))
    syncs = {}
    for e, (pt, rnd, batches) in (("adam", adam), *engines.items()):
        one_round = functools.partial(rnd, train.init_state(pt),
                                      batches[0])
        one_round()              # the reports torch makes once a process
        torch.cuda.synchronize()
        syncs[e] = _block_syncs(torch, one_round)
    print("vmap path host syncs per round", json.dumps(syncs), flush=True)
    if syncs["adam"][0] or syncs["vmap"][0]:
        raise AssertionError(f"the vmap engine's plain route synced the "
                             f"host: {syncs}")

    # wall per local step: the vmap engine's plain and kernel routes
    # beside the flat engine's R = 1 host loop, one round each in turns,
    # batches staged beforehand
    states = {e: train.init_state(engines[e][0]) for e in engines}
    walls = {e: [] for e in engines}
    order = list(engines)
    for t in range(VMAP_TIMED_ROUNDS + 1):
        for e in order[t % 3:] + order[:t % 3]:
            _, rnd, batches = engines[e]
            t0 = time.perf_counter()
            states[e], _, _ = rnd(states[e], batches[t])
            torch.cuda.synchronize()
            if t > 0:            # round 0 warms each engine up
                walls[e].append((time.perf_counter() - t0) / K * 1e3)
    print("vmap path time", json.dumps({
        "card": smi, "wall_ms_per_step_vmap": walls["vmap"],
        "wall_ms_per_step_vmap_kernel_route": walls["vmap_kernel"],
        "wall_ms_per_step_flat_host": walls["flat"],
        "median_vmap": statistics.median(walls["vmap"]),
        "median_vmap_kernel_route": statistics.median(walls["vmap_kernel"]),
        "median_flat_host": statistics.median(walls["flat"])}), flush=True)
    return paths


def _state_equal(torch, a, b, what):
    """Params, server state and, where there is one, the async buffer of
    two FLStates, bitwise."""
    from repro_torch.utils.tree import tree_leaves
    for tree in ("params", "server_state"):
        for x, y in zip(tree_leaves(getattr(a, tree)),
                        tree_leaves(getattr(b, tree))):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: {tree} differ")
    if (a.buffer is None) != (b.buffer is None):
        raise AssertionError(f"{what}: one state has no buffer")
    if a.buffer is not None:
        xs = tree_leaves(a.buffer.delta) + list(a.buffer[1:])
        ys = tree_leaves(b.buffer.delta) + list(b.buffer[1:])
        if not all(torch.equal(x, y) for x, y in zip(xs, ys)):
            raise AssertionError(f"{what}: async buffers differ")
    if a.round != b.round:
        raise AssertionError(f"{what}: round {a.round} != {b.round}")


def _arena_equal(torch, a, b, what):
    for name, x, y in zip(a._fields, a, b):
        if (x is None) != (y is None) or (x is not None
                                          and not torch.equal(x, y)):
            raise AssertionError(f"{what}: arena {name} differs")


def _block_runner(train, torch, flags, rounds):
    """The fused loop of a run with ``flags`` on the card -> (stage and
    run one block of ``rounds``, run one block already staged, the
    BlockRunner)."""
    from repro_torch.core import flatten_fl_state
    args = train.build_parser().parse_args(
        flags + ["--rounds-per-call", str(rounds), "--device", "cuda"])
    pt = train.setup_paper_task(args)
    run = train.BlockRunner(pt, args)
    state = {"fs": flatten_fl_state(train.init_state(pt), run.layout)}

    def staged_block():
        staged = run.stage(state["fs"].round, rounds)
        torch.cuda.synchronize()
        return lambda: run(state["fs"], staged)

    def block():
        state["fs"], mets = run(state["fs"], run.stage(state["fs"].round,
                                                       rounds))
        return mets
    return block, staged_block, run


def _wall_per_step(torch, block, rounds, n):
    """Host-clock wall per local step of ``n`` blocks after a warm-up
    block, each ended by a device synchronise."""
    block()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / (rounds * K) * 1e3)
    return walls


def run_async_path(torch, mods, train, name, smi):
    """Phase 4d, one async preset at phase 4's configuration. Returns
    its launch counts."""
    args = TRAIN_ARGS + ["--scenario", name]
    _reset(mods)
    fused = train.main(args + ["--rounds-per-call", "2", "--device",
                               "cuda"])
    torch.cuda.synchronize()
    launches = _counts(mods)
    want = {("batched_norms", "cuda"): K * ROUNDS,
            ("batched_apply", "cuda"): K * ROUNDS}
    if launches != want:
        raise AssertionError(f"async {name} launched {launches}, expected "
                             f"{want}")
    for t, row in enumerate(fused.history):
        if not _finite(row):
            raise AssertionError(f"async {name} round {t}: non-finite {row}")
        print(f"async {name} round {t}", json.dumps(
            {k: float(v) for k, v in row.items() if k != "cohort_ids"}),
            flush=True)
    host = train.main(args + ["--flat", "--device", "cuda"])
    _fused_equals_host(torch, fused, host)
    _state_equal(torch, fused.state, host.state, f"async {name} fused/host")
    cpu = train.main(args + ["--rounds", "1", "--device", "cpu"])
    for k in ("loss", "eta_mean"):
        a, b = float(fused.history[0][k]), float(cpu.history[0][k])
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"async {name} round 0 {k}: cuda {a} vs "
                                 f"cpu {b}")
    block, staged_block, _ = _block_runner(train, torch, args, 2)
    walls = _wall_per_step(torch, block, 2, ASYNC_TIMED_BLOCKS)
    # host syncs of one fused block's loop call, its draws staged before:
    # none in the plain async tail (zipf_async); byzantine_async's guarded
    # tail reads its quorum's survivor count once a round
    _block_syncs(torch, staged_block())   # reports made once a process
    syncs = _block_syncs(torch, staged_block())
    if name == "zipf_async" and syncs[0]:
        raise AssertionError(f"the plain async tail synced the host: "
                             f"{syncs}")
    print(f"async {name}", json.dumps({
        "card": smi, "rounds": ROUNDS,
        "flushed_fraction": statistics.mean(float(r["flushed"])
                                            for r in fused.history),
        "stale_mean": statistics.mean(float(r["stale_mean"])
                                      for r in fused.history),
        "buffer_fill": [float(r["buffer_fill"]) for r in fused.history],
        "host_syncs_per_block": syncs[0], "host_sync_reports": syncs[1],
        "wall_ms_per_step": walls,
        "median_wall_ms_per_step": statistics.median(walls)}), flush=True)
    print(f"async {name}: 2*K*rounds launches, fused == host loop bitwise "
          "(params, server state, buffer, metrics), round 0 = CPU within "
          "1e-4", flush=True)
    return launches


def _untouched_rows(torch, arena, ids, eta0):
    """Every row outside the drawn cohorts keeps arena_init's bits (the
    EF slab's rows all zero: a row-wise max and min, reductions that
    allocate no copy of the slab)."""
    import numpy as np
    seen = torch.zeros(arena.eta.shape[0], dtype=torch.bool, device="cuda")
    seen[torch.from_numpy(np.concatenate(ids).astype(np.int64)).cuda()] = True
    rest = ~seen
    ok = (bool((arena.eta[rest] == torch.tensor(eta0, device="cuda")).all())
          and bool((arena.rounds_seen[rest] == 0).all())
          and bool((arena.last_round[rest] == -1).all()))
    if arena.ef is not None:
        zero = (arena.ef.amax(dim=1) == 0) & (arena.ef.amin(dim=1) == 0)
        ok = ok and bool(zero[rest].all()) and not bool(zero[seen].any())
    if not ok:
        raise AssertionError("a row outside the drawn cohorts changed")
    return int(seen.sum())


def run_fleet_path(torch, mods, train, smi):
    """Phase 4d, the fleet at fleet_zipf's scale: 100,000 registered,
    C = 50, with the η carry and telemetry; then with int8 + EF21 and
    the (100,000, N) EF slab on the card. Returns launch counts by run."""
    paths = {}
    args = FLEET_ARGS + ["--scenario", "fleet_zipf", "--eta-carry"]
    flags = ["--rounds", str(FLEET_ROUNDS), "--rounds-per-call",
             str(FLEET_R), "--telemetry", "--device", "cuda"]
    _reset(mods)
    run = train.main(args + flags)
    torch.cuda.synchronize()
    paths["fleet_zipf"] = launches = _counts(mods)
    want = {("batched_norms", "cuda"): K * FLEET_ROUNDS,
            ("batched_apply", "cuda"): K * FLEET_ROUNDS,
            ("lane_histogram", "cuda"): FLEET_ROUNDS,
            ("lane_quantiles", "cuda"): FLEET_ROUNDS}
    if launches != want:
        raise AssertionError(f"fleet launched {launches}, expected {want}")
    ids = [r["cohort_ids"] for r in run.history]
    if any(i.shape != (FLEET_C,) or len(set(i.tolist())) != FLEET_C
           or i.max() >= FLEET_REGISTERED for i in ids):
        raise AssertionError("fleet cohorts are not 50 distinct ids")
    seen = _untouched_rows(torch, run.arena, ids, 0.2)
    total = int(run.arena.rounds_seen.sum())
    if total != FLEET_C * FLEET_ROUNDS or not all(
            _finite({k: v for k, v in r.items() if k != "cohort_ids"})
            for r in run.history):
        raise AssertionError(f"fleet rounds_seen sums to {total}, not "
                             f"{FLEET_C * FLEET_ROUNDS}, or a metric is "
                             "not finite")
    for t, r in enumerate(run.history):
        print(f"fleet round {t}", json.dumps({
            k: float(r[k]) for k in ("loss", "eta_mean", "revisit_frac",
                                     "realized_stale_mean",
                                     "eta_carry_mean")}
            | {"eta_hist_sum": float(r["eta_hist"].sum())}), flush=True)

    # host time of a block's cohort draw over 100,000 candidates (the
    # data pipeline's, the one draw the fleet loop trains on) and of its
    # whole staging (the draw, the example draws, the copies), beside
    # the wall per local step of a block
    block, staged_block, bl = _block_runner(
        train, torch, args + ["--telemetry"], FLEET_R)
    fed, scn = bl.pt.fed, bl.pt.scenario
    draw_ms, pipe_ms = [], []
    for r0 in range(0, 5 * FLEET_R, FLEET_R):
        t0 = time.perf_counter()
        for r in range(r0, r0 + FLEET_R):
            scn.draw_cohort(r, fed.registered_clients, FLEET_C,
                            sizes=fed.registered_sizes())
        draw_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        bl.stage(r0, FLEET_R)
        pipe_ms.append((time.perf_counter() - t0) * 1e3)
    walls = _wall_per_step(torch, block, FLEET_R, ASYNC_TIMED_BLOCKS)
    _block_syncs(torch, staged_block())   # reports made once a process
    syncs = _block_syncs(torch, staged_block())
    print("fleet time", json.dumps({
        "card": smi, "registered": FLEET_REGISTERED, "cohort": FLEET_C,
        "rounds_per_block": FLEET_R, "clients_seen": seen,
        "cohort_draw_host_ms_per_block": draw_ms,
        "median_cohort_draw_host_ms_per_block": statistics.median(draw_ms),
        "pipeline_stage_host_ms_per_block": pipe_ms,
        "median_pipeline_stage_host_ms_per_block": statistics.median(
            pipe_ms),
        "host_syncs_per_block": syncs[0], "host_sync_reports": syncs[1],
        "wall_ms_per_step": walls,
        "median_wall_ms_per_step": statistics.median(walls)}), flush=True)
    print("fleet: 2*K*rounds launches and one histogram and one quantiles "
          "launch a round, 50 distinct ids a round, rows outside the drawn "
          "cohorts keep their bits, rounds_seen sums to 50 x 8", flush=True)
    del run, block, staged_block, bl
    torch.cuda.empty_cache()

    # int8 + EF21: the (100,000, N) f32 EF slab lives in the arena
    torch.cuda.reset_peak_memory_stats()
    _reset(mods)
    ef = train.main(args + ["--compression", "int8", "--error-feedback",
                            "--rounds", str(FLEET_EF_ROUNDS),
                            "--rounds-per-call", str(FLEET_EF_ROUNDS),
                            "--device", "cuda"])
    torch.cuda.synchronize()
    paths["fleet_int8_ef21"] = launches = _counts(mods)
    want = {("batched_norms", "cuda"): K * FLEET_EF_ROUNDS,
            ("batched_apply", "cuda"): K * FLEET_EF_ROUNDS,
            ("quantize_int8", "cuda"): FLEET_EF_ROUNDS,
            ("dequantize_int8", "cuda"): FLEET_EF_ROUNDS}
    if launches != want:
        raise AssertionError(f"fleet int8 + EF21 launched {launches}, "
                             f"expected {want}")
    peak = torch.cuda.max_memory_allocated()
    slab = ef.arena.ef
    ef_bytes = slab.numel() * slab.element_size()
    if slab.shape != (FLEET_REGISTERED, MAIN_SHAPE[1]) or \
            slab.device.type != "cuda":
        raise AssertionError(f"EF slab {tuple(slab.shape)} on "
                             f"{slab.device}")
    _untouched_rows(torch, ef.arena, [r["cohort_ids"] for r in ef.history],
                    0.2)
    print("fleet int8 + EF21", json.dumps({
        "card": smi, "ef_slab_shape": list(slab.shape),
        "ef_slab_bytes": ef_bytes, "peak_allocated_bytes": peak,
        "loss": [float(r["loss"]) for r in ef.history],
        "wire_bytes": [float(r["wire_bytes"]) for r in ef.history],
        "launches": {f"{k}/{d}": n for (k, d), n in launches.items()}}),
        flush=True)
    if not all(math.isfinite(float(r["loss"])) for r in ef.history):
        raise AssertionError("fleet int8 + EF21: non-finite loss")
    del ef, slab
    torch.cuda.empty_cache()
    return paths


def run_resume_paths(torch, mods, train):
    """Phase 4d: 4 rounds straight with checkpoints every 2, against 2
    rounds then --resume for 2 more, fused, for the plain run, the
    zipf_async buffer and fleet_uniform's arena at 1,000 registered.
    Returns launch counts by run."""
    import tempfile
    paths = {}
    runs = {"plain": TRAIN_ARGS,
            "zipf_async": TRAIN_ARGS + ["--scenario", "zipf_async"],
            "fleet_uniform": FLEET_ARGS + [
                "--scenario", "fleet_uniform", "--num-registered",
                str(RESUME_REGISTERED), "--participation",
                RESUME_PARTICIPATION, "--eta-carry"]}
    for name, args in runs.items():
        total = paths[f"resume_{name}"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            def go(ckpt, rounds, *extra):
                _reset(mods)
                out = train.main(args + [
                    "--rounds", str(rounds), "--rounds-per-call", "2",
                    "--ckpt-dir", ckpt, "--ckpt-every", "2", "--device",
                    "cuda", *extra])
                torch.cuda.synchronize()
                got = _counts(mods)
                want = {("batched_norms", "cuda"): K * rounds,
                        ("batched_apply", "cuda"): K * rounds}
                if got != want:
                    raise AssertionError(f"resume {name}: launched {got}, "
                                         f"expected {want}")
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
                return out
            straight = go(f"{tmp}/straight", 4)
            go(f"{tmp}/cut", 2)
            resumed = go(f"{tmp}/cut", 2, "--resume")
            _state_equal(torch, straight.state, resumed.state,
                         f"resume {name}")
            if name == "fleet_uniform":
                _arena_equal(torch, straight.arena, resumed.arena,
                             "resume fleet_uniform")
            steps = sorted(p.name for p in Path(f"{tmp}/cut").iterdir())
            print(f"resume {name}", json.dumps({
                "rounds": straight.state.round, "checkpoints": steps,
                "final_loss": [float(straight.history[-1]["loss"]),
                               float(resumed.history[-1]["loss"])]}),
                flush=True)
    print("resume: 2 rounds + --resume 2 == 4 rounds straight, bitwise "
          "(params, server state, async buffer, fleet arena)", flush=True)
    return paths


def run_serve_checkpoint(torch, mods, smi):
    """Phase 4d: serving from a checkpoint. TinyLlama at full width cut
    to one layer: its random params saved and restored through
    restore_params decode the in-memory params' tokens; then the serve
    CLI with --ckpt-dir (reduced TinyLlama, a training-style checkpoint
    of another seed's params than the CLI's own init) decodes the saved
    params' tokens, not those of its run without the checkpoint.
    Returns launch counts."""
    import dataclasses
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import restore_params, save
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.serving import DecodeEngine
    from repro_torch.utils.tree import tree_leaves
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=1)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_SLOTS, SERVE_PROMPT))

    def decode(p):
        engine = DecodeEngine(model, p, slots=SERVE_SLOTS,
                              cache_len=SERVE_PROMPT + SERVE_GEN,
                              flush_tokens=SERVE_FLUSH)
        rids = [engine.submit(q, SERVE_GEN) for q in prompts]
        done = {c.request_id: c.tokens for c in engine.run_until_idle()}
        return np.stack([done[r] for r in rids])
    with tempfile.TemporaryDirectory() as tmp:
        save(tmp, {"params": params, "round": 7}, step=7)
        like = model.init(torch.Generator(device="cuda").manual_seed(1))
        loaded, step = restore_params(tmp, like)
        if step != 7 or not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(params), tree_leaves(loaded))):
            raise AssertionError("restore_params did not give the saved "
                                 "params back")
        _reset(mods)
        got = decode(loaded)
        torch.cuda.synchronize()
        launches = _counts(mods)
        want = decode(params)
        if not np.array_equal(got, want):
            raise AssertionError("the checkpoint's params decode other "
                                 "tokens than the in-memory params")
        if launches != {("flash_attention", "cuda"): SERVE_SLOTS}:
            raise AssertionError(f"serve from checkpoint launched "
                                 f"{launches}")

        # the CLI's own init is seed 0's: the checkpoint holds seed 1's
        flags = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
                 "--prompt-len", "16", "--gen", "8", "--device", "cuda"]
        cli = serve.build_parser().parse_args(flags)
        small = build_model(get_config("tinyllama-1.1b").reduced())
        p1 = small.init(torch.Generator(device="cuda").manual_seed(1))
        save(f"{tmp}/cli", {"params": p1, "round": 3}, step=3)
        mem = serve.run(cli)
        _reset(mods)
        ck = serve.run(serve.build_parser().parse_args(
            flags + ["--ckpt-dir", f"{tmp}/cli"]))
        torch.cuda.synchronize()
        for k, v in _counts(mods).items():
            launches[k] = launches.get(k, 0) + v
        saved_tokens, _, _ = serve.decode(small, p1, cli)
        if (ck["ckpt_step"] != 3
                or not np.array_equal(ck["tokens"], saved_tokens)
                or np.array_equal(ck["tokens"], mem["tokens"])):
            raise AssertionError("serve --ckpt-dir does not decode the "
                                 "saved params' tokens, or decodes the "
                                 "CLI's own init's")
    print("serve from checkpoint", json.dumps({
        "card": smi, "arch": f"tinyllama-1.1b[{cfg.num_layers}L]",
        "requests": SERVE_SLOTS, "tokens_equal": True,
        "cli_tokens_equal_the_saved_params": True,
        "cli_tokens_differ_from_its_own_init": True,
        "launches": {f"{k}/{d}": n for (k, d), n in launches.items()}}),
        flush=True)
    del model, params, loaded, like
    torch.cuda.empty_cache()
    return launches


def _lm_args(train, shape, rounds, *extra, arch=LM_ARCH):
    """The train CLI's parsed flags of an LM run of ``shape`` on cuda."""
    return train.build_parser().parse_args([
        "--arch", arch, "--clients-per-round", str(shape["C"]),
        "--local-steps", str(shape["K"]), "--batch", str(shape["b"]),
        "--seq", str(shape["S"]), "--rounds", str(rounds), "--seed", "0",
        "--device", "cuda", *extra])


def _lm_cfg(arch, layers):
    """``arch``'s full-width config with ``layers`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers)


def _lm_train(torch, mods, train, cfg, args):
    """train_lm on ``cfg`` (the CLI's body, its model cut in depth) with
    every count at 0 before -> (TrainResult, launches, peak GB)."""
    _reset(mods)
    torch.cuda.reset_peak_memory_stats()
    out = train.train_lm(args, train.setup_lm(args, cfg))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for t, row in enumerate(out.history):
        if not _finite(row):
            raise AssertionError(f"LM round {t}: non-finite metrics {row}")
    return out, _counts(mods), peak


class _LastCall:
    """Stands in for a kernel wrapper of ``mod`` and keeps the arguments
    and result of its last call (the slabs of the main path's last local
    step, for the checks and timings that follow the run)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.fn = mod, name, getattr(mod, name)
        self.args = self.out = None

    def __enter__(self):
        def call(*args, **kw):
            self.args, self.out = (args, kw), self.fn(*args, **kw)
            return self.out
        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def _lm_kernel_rows(torch, tk, tref, bw, f32, g, gp, p, eta, smi, what):
    """batched_norms and batched_apply on the LM run's own (C, N) slabs:
    held against their plain versions (norms rtol 1e-5, apply bitwise),
    timed beside the plain version, torch.addcmul (the apply) and the
    bound of the bytes they move. -> {(name, (C, N)): row}."""
    C, N = g.shape
    rows = {}
    got = torch.stack(tk.batched_norms(g, gp))
    want = torch.stack(tref.batched_norms_ref(g, gp))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
    rows[("batched_norms", (C, N))] = dict(
        name="batched_norms", shape=[C, N], path=what, card=smi,
        max_abs_err=float((got - want).abs().max()),
        ms=device_ms(lambda: tk.batched_norms(g, gp), torch),
        plain_ms=device_ms(lambda: tref.batched_norms_ref(g, gp), torch),
        library_ms=None, bytes=(2 * C * N + 2 * C) * 4,
        bound_ms=max((2 * C * N + 2 * C) * 4 / bw, 5 * C * N / f32) * 1e3,
        bound_by="bytes")
    del want
    work = p.clone()
    got = tk.batched_apply(work, g, eta)
    want = tref.batched_apply_ref(p, g, eta, None)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: batched_apply is not bitwise equal "
                             "to the plain version")
    err = float((got - want).abs().max())
    del want
    moved = 3 * C * N * 4 + C * 4
    rows[("batched_apply", (C, N))] = dict(
        name="batched_apply", shape=[C, N], path=what, card=smi,
        max_abs_err=err,
        ms=device_ms(lambda: tk.batched_apply(work, g, eta), torch),
        plain_ms=device_ms(lambda: tref.batched_apply_ref(work, g, eta,
                                                          None), torch),
        library_ms=device_ms(
            lambda: torch.addcmul(work, eta[:, None], g, value=-1), torch),
        bytes=moved, bound_ms=max(moved / bw, 2 * C * N / f32) * 1e3,
        bound_by="bytes")
    del work
    for row in rows.values():
        row["gbps_achieved"] = (row["bound_ms"] / row["ms"]) * bw / 1e9
        print(json.dumps(row), flush=True)
    return rows


def _lm_round_time(torch, train, cfg, sh, smi, label, arch=LM_ARCH):
    """The wall of a staged one-round fused block of ``cfg`` at ``sh``
    (LM_TIMED_BLOCKS blocks after a warm one), its device busy and idle
    share (profiler), ms per local step and training tokens/s (C·K·b·S
    over the round's wall), printed as ``{label} time`` and ``{label}
    profile``."""
    from repro_torch.core import flatten_fl_state
    args = _lm_args(train, sh, 2, "--rounds-per-call", "2", arch=arch)
    lt = train.setup_lm(args, cfg)
    run = train.LMBlockRunner(lt, args)
    box = {"fs": flatten_fl_state(train.init_lm_state(lt), run.layout)}
    del lt
    staged = run.stage(0, 1)

    def block():
        box["fs"], _ = run(box["fs"], staged)
    block()
    torch.cuda.synchronize()
    walls = [_host_ms(torch, block, 1) for _ in range(LM_TIMED_BLOCKS)]
    wall, busy, split = _profile_ms(torch, block)
    tokens = sh["C"] * sh["K"] * sh["b"] * sh["S"]
    print(f"{label} time", json.dumps({
        "card": smi, "round_ms": walls,
        "ms_per_local_step": statistics.median(walls) / sh["K"],
        "tokens_per_round": tokens,
        "train_tokens_per_s": tokens / (statistics.median(walls) / 1e3),
        "profiled_round_ms": wall, "device_busy_ms": busy,
        "idle_share": 1 - busy / wall}), flush=True)
    print(f"{label} profile", json.dumps(split), flush=True)
    del run, box, staged
    torch.cuda.empty_cache()


def run_lm_train_path(torch, mods, train, tk, tref, bw, f32, smi):
    """Phase 4e, LM training. Returns (launch counts by run, kernel rows
    at the LM shapes)."""
    import tempfile
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    paths, rows = {}, {}
    sh, R = LM_CUT, LM_ROUNDS
    cfg = _lm_cfg(LM_ARCH, sh["layers"])
    dsgd = lambda n: {("batched_norms", "cuda"): n,      # noqa: E731
                      ("batched_apply", "cuda"): n}

    # (a) the vmap engine, R = 1: the plain route, no kernel at all
    vm, launches, peak = _lm_train(torch, mods, train, cfg,
                                   _lm_args(train, sh, R))
    if launches:
        raise AssertionError(f"LM vmap engine launched {launches}")
    paths["lm_train_vmap"] = launches

    # (b) the fused flat engine, R = 2, against the --flat host loop
    with _LastCall(tk, "batched_norms") as nrm, \
            _LastCall(tk, "batched_apply") as app:
        fused, launches, fpeak = _lm_train(
            torch, mods, train, cfg,
            _lm_args(train, sh, R, "--rounds-per-call", "2"))
    if launches != dsgd(sh["K"] * R):
        raise AssertionError(f"LM fused launched {launches}")
    paths["lm_train_fused"] = launches
    g, gp = nrm.args[0]
    p, gapp, eta = app.args[0][0], app.args[0][1], app.args[0][2]
    C, N = g.shape
    if C != sh["C"]:
        raise AssertionError(f"LM slab {tuple(g.shape)}")
    host, _, _ = _lm_train(torch, mods, train, cfg,
                           _lm_args(train, sh, R, "--flat"))
    _state_equal(torch, fused.state, host.state, "LM fused vs host loop")
    for t, (a, b) in enumerate(zip(fused.history, host.history)):
        for k in a:
            if a[k].tobytes() != b[k].tobytes():
                raise AssertionError(f"LM round {t} {k}: fused != host")
    l0v, l0f = float(vm.history[0]["loss"]), float(fused.history[0]["loss"])
    if not math.isclose(l0v, l0f, rel_tol=1e-4):
        raise AssertionError(f"LM round 0 loss: vmap {l0v} fused {l0f}")
    print("lm train", json.dumps({
        "card": smi, "arch": f"{LM_ARCH}[{sh['layers']}L]", "N": N,
        "clients": C, "local_steps": sh["K"], "batch": sh["b"],
        "seq": sh["S"], "rounds": R,
        "loss_vmap": [float(r["loss"]) for r in vm.history],
        "loss_fused": [float(r["loss"]) for r in fused.history],
        "eta_fused": [float(r["eta_mean"]) for r in fused.history],
        "fused_equals_host_bitwise": True,
        "peak_gb_vmap": peak, "peak_gb_fused": fpeak}), flush=True)
    del vm, host

    # where the time goes at (4, N): blocks of one round, staged first
    _lm_round_time(torch, train, cfg, sh, smi, "lm train")
    rows.update(_lm_kernel_rows(torch, tk, tref, bw, f32, g, gp, p, eta,
                                smi, "lm_train_fused"))
    del g, gp, p, gapp, eta, nrm, app

    # (c) telemetry: one histogram and one quantiles launch a round
    _, launches, _ = _lm_train(
        torch, mods, train, cfg,
        _lm_args(train, sh, R, "--rounds-per-call", "2", "--telemetry"))
    want = dsgd(sh["K"] * R)
    want.update({("lane_histogram", "cuda"): R,
                 ("lane_quantiles", "cuda"): R})
    if launches != want:
        raise AssertionError(f"LM telemetry launched {launches}")
    paths["lm_train_telemetry"] = launches

    # (d) resume: 2 rounds then --resume for 2 == 4 rounds straight
    total = paths["lm_train_resume"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        def go(ckpt, rounds, *extra):
            out, got, _ = _lm_train(torch, mods, train, cfg, _lm_args(
                train, sh, rounds, "--rounds-per-call", "2", "--ckpt-dir",
                ckpt, "--ckpt-every", "2", *extra))
            if got != dsgd(sh["K"] * rounds):
                raise AssertionError(f"LM resume launched {got}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            return out
        straight = go(f"{tmp}/straight", 2 * R)
        go(f"{tmp}/cut", R)
        resumed = go(f"{tmp}/cut", R, "--resume")
        _state_equal(torch, straight.state, resumed.state, "LM resume")
    print("lm train resume: 2 rounds + --resume 2 == 4 rounds straight, "
          "bitwise", flush=True)
    del straight, resumed
    torch.cuda.empty_cache()

    # 2. TinyLlama whole: one fused round, C·N past 2**31; the last row's
    # sums against f64; then (e) its checkpoint served by the serve CLI
    sh = LM_DEEP
    cfg = _lm_cfg(LM_ARCH, sh["layers"])
    with tempfile.TemporaryDirectory() as tmp:
        with _LastCall(tk, "batched_norms") as nrm, \
                _LastCall(tk, "batched_apply") as app:
            deep, launches, peak = _lm_train(torch, mods, train, cfg, _lm_args(
                train, sh, 1, "--rounds-per-call", "2", "--ckpt-dir", tmp))
        if launches != dsgd(sh["K"]):
            raise AssertionError(f"LM 22 layers launched {launches}")
        paths["lm_train_22L"] = launches
        g, gp = nrm.args[0]
        C, N = g.shape
        if C * N <= LM_PAST:
            raise AssertionError(f"22-layer slab {C} x {N} is not past "
                                 f"{LM_PAST} elements")
        dg, gg = (float(v[C - 1]) for v in nrm.out)
        want_dg = want_gg = 0.0
        for off in range(0, N, LM_F64_SLICE):
            a = g[C - 1, off:off + LM_F64_SLICE].double()
            b = gp[C - 1, off:off + LM_F64_SLICE].double()
            want_dg += float(((a - b) ** 2).sum())
            want_gg += float((a * a).sum())
            del a, b
        for got_v, want_v, what in ((dg, want_dg, "dg"), (gg, want_gg, "gg")):
            if not math.isclose(got_v, want_v, rel_tol=1e-5):
                raise AssertionError(f"22-layer last row {what}: kernel "
                                     f"{got_v} vs f64 {want_v}")
        print("lm train 22 layers", json.dumps({
            "card": smi, "arch": LM_ARCH, "N": N, "clients": C,
            "elements": C * N, "past_2_31": True,
            "last_row_dg": [dg, want_dg], "last_row_gg": [gg, want_gg],
            "loss": float(deep.history[0]["loss"]),
            "eta_mean": float(deep.history[0]["eta_mean"]),
            "peak_gb": peak}), flush=True)
        trained = deep.state.params
        del deep
        torch.cuda.empty_cache()
        p, eta = app.args[0][0], app.args[0][2]
        rows.update(_lm_kernel_rows(torch, tk, tref, bw, f32, g, gp, p, eta,
                                    smi, "lm_train_22L"))
        del g, gp, p, eta, nrm, app
        torch.cuda.empty_cache()

        # (e) the serve CLI with --ckpt-dir on the trained checkpoint; its
        # own init is seed 1's
        flags = ["--arch", LM_ARCH, "--batch", "2", "--prompt-len", "16",
                 "--gen", "8", "--device", "cuda", "--seed", "1"]
        _reset(mods)
        ck = serve.main(flags + ["--ckpt-dir", tmp])
        torch.cuda.synchronize()
        launches = _counts(mods)
        if launches != {("flash_attention", "cuda"): 2 * sh["layers"]}:
            raise AssertionError(f"serve of the trained LM launched "
                                 f"{launches}")
        paths["lm_train_serve"] = launches
        own = serve.main(flags)
        want, _, _ = serve.decode(build_model(cfg), trained,
                                  serve.build_parser().parse_args(flags))
        if (ck["ckpt_step"] != 1 or not np.array_equal(ck["tokens"], want)
                or np.array_equal(ck["tokens"], own["tokens"])):
            raise AssertionError("the serve CLI does not decode the trained "
                                 "checkpoint's tokens")
        del trained
    print("lm train serve: the serve CLI decodes the trained 22-layer "
          "checkpoint's tokens", flush=True)
    torch.cuda.empty_cache()

    # 3. Zamba2-7B at full width, 7 layers: one fused round
    sh = LM_ZAMBA
    args = _lm_args(train, sh, 1, "--rounds-per-call", "2")
    args.arch = "zamba2-7b"
    zb, launches, peak = _lm_train(torch, mods, train,
                                   _lm_cfg("zamba2-7b", sh["layers"]), args)
    if launches != dsgd(sh["K"]):
        raise AssertionError(f"LM Zamba2 launched {launches}")
    paths["lm_train_zamba2"] = launches
    print("lm train zamba2", json.dumps({
        "card": smi, "arch": f"zamba2-7b[{sh['layers']}L]",
        "loss": float(zb.history[0]["loss"]),
        "eta_mean": float(zb.history[0]["eta_mean"]), "peak_gb": peak}),
        flush=True)
    del zb
    torch.cuda.empty_cache()

    # 4. OLMoE at full width, 2 layers: one fused round == its --flat host
    # loop bitwise; the Δ-SGD pair on its slabs; the round's wall
    paths.update(_lm_moe_path(torch, mods, train, tk, tref, bw, f32, smi,
                              rows))
    # 5. DeepSeek-V3 reduced: a round with the MoE aux and the MTP loss
    paths["lm_train_deepseek"] = _lm_mla_path(torch, mods, train, smi)
    return paths, rows


def _lm_moe_path(torch, mods, train, tk, tref, bw, f32, smi, rows):
    """Phase 4e, OLMoE at full width cut to LM_MOE's layers: the host
    loop first (its result is 4 GB), then the fused round with the
    kernels' last slabs kept for the kernel rows. Returns the launch
    counts by run; adds the kernel rows to ``rows``."""
    sh, paths = LM_MOE, {}
    cfg = _lm_cfg(MOE_ARCH, sh["layers"])
    dsgd = {("batched_norms", "cuda"): sh["K"],
            ("batched_apply", "cuda"): sh["K"]}
    host, launches, hpeak = _lm_train(torch, mods, train, cfg, _lm_args(
        train, sh, 1, "--flat", arch=MOE_ARCH))
    if launches != dsgd:
        raise AssertionError(f"OLMoE host loop launched {launches}")
    paths["lm_train_olmoe_host"] = launches
    with _LastCall(tk, "batched_norms") as nrm, \
            _LastCall(tk, "batched_apply") as app:
        fused, launches, fpeak = _lm_train(torch, mods, train, cfg, _lm_args(
            train, sh, 1, "--rounds-per-call", "2", arch=MOE_ARCH))
    if launches != dsgd:
        raise AssertionError(f"OLMoE fused launched {launches}")
    paths["lm_train_olmoe_fused"] = launches
    _state_equal(torch, fused.state, host.state, "OLMoE fused vs host loop")
    for k in fused.history[0]:
        if fused.history[0][k].tobytes() != host.history[0][k].tobytes():
            raise AssertionError(f"OLMoE round 0 {k}: fused != host")
    g, gp = nrm.args[0]
    C, N = g.shape
    print("lm train olmoe", json.dumps({
        "card": smi, "arch": f"{MOE_ARCH}[{sh['layers']}L]", "N": N,
        "clients": C, "local_steps": sh["K"], "batch": sh["b"],
        "seq": sh["S"], "loss": float(fused.history[0]["loss"]),
        "eta_mean": float(fused.history[0]["eta_mean"]),
        "fused_equals_host_bitwise": True, "peak_gb_host": hpeak,
        "peak_gb_fused": fpeak}), flush=True)
    del fused, host
    torch.cuda.empty_cache()
    p, eta = app.args[0][0], app.args[0][2]
    rows.update(_lm_kernel_rows(torch, tk, tref, bw, f32, g, gp, p, eta,
                                smi, "lm_train_olmoe"))
    del g, gp, p, eta, nrm, app
    torch.cuda.empty_cache()
    _lm_round_time(torch, train, cfg, sh, smi, "lm train olmoe",
                   arch=MOE_ARCH)
    return paths


def _lm_mla_path(torch, mods, train, smi):
    """Phase 4e, DeepSeek-V3 at its reduced config: one fused round
    (finite, K Δ-SGD launches of each kind); its trained params' loss on
    a batch carries the MoE aux and the MTP loss (aux with labels above
    aux without, both above 0) and equals the CPU's within 1e-4.
    Returns the round's launch counts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_map
    sh = LM_MLA
    cfg = get_config(MLA_ARCH).reduced()
    out, launches, peak = _lm_train(torch, mods, train, cfg, _lm_args(
        train, sh, 1, "--rounds-per-call", "2", arch=MLA_ARCH))
    if launches != {("batched_norms", "cuda"): sh["K"],
                    ("batched_apply", "cuda"): sh["K"]}:
        raise AssertionError(f"DeepSeek-V3 reduced launched {launches}")
    model = build_model(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, sh["S"] + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
             "labels": torch.from_numpy(toks[:, 1:]).cuda()}
    params = out.state.params
    with torch.no_grad():
        loss, m = model.loss(params, batch, use_pallas=False)
        _, aux_stack = model.apply(params, {"tokens": batch["tokens"]},
                                   use_pallas=False)
        cpu_loss, cpu_m = model.loss(tree_map(lambda a: a.cpu(), params),
                                     tree_map(lambda a: a.cpu(), batch),
                                     use_pallas=False)
    if not 0 < float(aux_stack) < float(m["aux"]):
        raise AssertionError(f"DeepSeek-V3 aux {float(aux_stack)} without "
                             f"labels, {float(m['aux'])} with")
    for a, b in ((loss, cpu_loss), (m["aux"], cpu_m["aux"])):
        if not math.isclose(float(a), float(b), rel_tol=1e-4):
            raise AssertionError(f"DeepSeek-V3 loss on the card {float(a)} "
                                 f"vs the CPU {float(b)}")
    print("lm train deepseek", json.dumps({
        "card": smi, "arch": f"{MLA_ARCH}[reduced]",
        "round_loss": float(out.history[0]["loss"]),
        "eta_mean": float(out.history[0]["eta_mean"]),
        "loss": float(loss), "ce": float(m["ce"]),
        "aux_with_mtp": float(m["aux"]), "aux_stack": float(aux_stack),
        "cpu_loss": float(cpu_loss), "peak_gb": peak}), flush=True)
    del out, params
    torch.cuda.empty_cache()
    return launches


def run_matrix(torch, mods):
    """Phase 7. Returns the launch counts of the 32 cells on cuda."""
    from collections import Counter
    from repro_torch.conformance import KERNEL_MATRIX, check_cell
    _reset(mods)
    bad, passed = [], Counter()
    for cell in KERNEL_MATRIX:
        v = check_cell(cell, 0, "cuda")
        bad += v
        passed[cell.ns] += not v
    torch.cuda.synchronize()
    launches = _counts(mods)
    print("matrix cells passed per namespace", json.dumps(dict(passed)),
          flush=True)
    if bad:
        raise AssertionError(f"kernel matrix violations: {bad}")
    if any(dev != "cuda" for _, dev in launches):
        raise AssertionError(f"a matrix cell ran a plain version through "
                             f"its wrapper: {launches}")
    print("matrix launches", json.dumps(
        {k: v for (k, _), v in launches.items()}), flush=True)
    return launches


def check_lm_kernels(torch, fa, faref, m2, m2ref, bw, f32):
    """Phase 5. Returns {(name, case): row}."""
    import numpy as np
    from repro_torch.kernels.mamba2_scan.ops import chunk_len
    F = torch.nn.functional
    rows = {}
    r = np.random.default_rng(2)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(dtype)

    for case in FA_CASES:
        B, S, H, KV, hd, window, dname = case
        dtype = getattr(torch, dname)
        q = t(r.normal(size=(B, S, H, hd)), dtype)
        k = t(r.normal(size=(B, S, KV, hd)), dtype)
        v = t(r.normal(size=(B, S, KV, hd)), dtype)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        again = fa.flash_attention(q, k, v, causal=True, window=window)
        want = faref.attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention {case}: two calls "
                                 "differ")
        # f32 within 2e-5; bf16 within about one bf16 ulp of the output
        rtol, atol = ((2e-5, 2e-5) if dtype == torch.float32
                      else (8e-3, 4e-3))
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        rows_i = torch.arange(S, device="cuda")
        mask = rows_i[None, :] <= rows_i[:, None]
        if window is not None:
            mask &= (rows_i[:, None] - rows_i[None, :]) < window
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pairs = int(mask.sum())              # visible (query, key) pairs
        item = q.element_size()
        moved = (2 * B * S * H * hd + 2 * B * S * KV * hd) * item
        ops = 4 * hd * pairs * B * H         # q·k and p·v multiply-adds
        peak = f32 if dtype == torch.float32 else BF16_FLOPS
        # SDPA with the explicit mask and, without a window, is_causal
        sdpa = {"sdpa(attn_mask)": device_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), torch)}
        if window is None:
            sdpa["sdpa(is_causal)"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), torch)
        lib_call = min(sdpa, key=sdpa.get)
        rows[("flash_attention", case)] = dict(
            name="flash_attention", shape=list(case),
            q_tile_rows=fa.q_tile_rows(B, S, H, fa.sm_count(q.device.index),
                                       dtype),
            max_abs_err=float((got.float() - want.float()).abs().max()),
            ms=device_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                    window=window), torch),
            plain_ms=device_ms(lambda: faref.attention_ref(
                q, k, v, causal=True, window=window), torch),
            library_ms=sdpa[lib_call], library_call=lib_call,
            sdpa_ms=sdpa,
            bound_ms=max(moved / bw, ops / peak) * 1e3,
            bound_by="bytes" if moved / bw > ops / peak else "operations")
        print(json.dumps(rows[("flash_attention", case)]), flush=True)

    # the f32 q-tile rule at the serve prefill shapes: each tile height,
    # picked through the SM count the rule reads, timed alone; the output
    # the same bits at every height
    sm_count = fa.sm_count
    for B, S, H, KV, hd, _, dname in FA_CASES:
        if S != SERVE_PROMPT or dname != "float32":
            continue
        q = t(r.normal(size=(B, S, H, hd)))
        k = t(r.normal(size=(B, S, KV, hd)))
        v = t(r.normal(size=(B, S, KV, hd)))
        chosen = fa.q_tile_rows(B, S, H, sm_count(q.device.index), q.dtype)
        outs, us_by_rows = [], {}
        try:
            for tile in fa.Q_TILE_ROWS:
                sms = -(-S // tile) * H * B  # the grid at ``tile`` fills it
                if fa.q_tile_rows(B, S, H, sms, q.dtype) != tile:
                    raise AssertionError(f"{sms} SMs do not pick {tile} rows")
                fa.sm_count = lambda index, sms=sms: sms
                outs.append(fa.flash_attention(q, k, v, causal=True))
                us_by_rows[tile] = device_ms(lambda: fa.flash_attention(
                    q, k, v, causal=True), torch) * 1e3
        finally:
            fa.sm_count = sm_count
        torch.cuda.synchronize()
        if any(not torch.equal(o, outs[0]) for o in outs[1:]):
            raise AssertionError(f"flash_attention {(B, S, H, KV, hd)} "
                                 f"{dname}: q tiles give different bits")
        print("flash_attention q tiles", json.dumps({
            "shape": [B, S, H, KV, hd], "dtype": dname, "chosen": chosen,
            "us_by_rows": us_by_rows}), flush=True)

    for B, S, H, P, G, N in SSD_CASES:
        x = t(r.normal(size=(B, S, H, P)))
        dt = t(r.uniform(0.001, 0.1, (B, S, H)))
        A_log = t(np.log(r.uniform(1, 16, (H,))))
        Bm, Cm = t(r.normal(size=(B, S, G, N))), t(r.normal(size=(B, S, G, N)))
        dA = (dt * -torch.exp(A_log)).contiguous()
        L = chunk_len(S)
        got = m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=L)
        again = m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=L)
        want = m2ref.ssd_chunks_ref(x, dt, dA, Bm, Cm, L)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssd_chunks {(B, S, H, P, G, N)}: two "
                                 "calls differ")
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
        nc = S // L
        moved = 4 * (2 * B * S * H * P + 3 * B * S * H + 2 * B * S * G * N
                     + B * nc * H * P * N + B * nc * H)
        tri = L * (L + 1) // 2
        ops = 2 * B * nc * H * (tri * (N + P) + L * P * N)
        case = (B, S, H, P, G, N)
        fma_ms = max(moved / bw, ops / f32) * 1e3
        tf32_ms = max(moved / bw, 3 * ops / TF32_FLOPS) * 1e3
        # the kernel's own route (3xTF32) unless f32 FMA bounds it lower
        route = "3xTF32" if tf32_ms <= fma_ms else "f32 FMA"
        rows[("ssd_chunks", case)] = dict(
            name="ssd_chunks", shape=list(case), chunk=L,
            grid=m2.ssd_grid(B, S, H, P, L, m2.sm_count(x.device.index)),
            max_abs_err=max(float((a - b).abs().max())
                            for a, b in zip(got, want)),
            ms=device_ms(lambda: m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=L),
                         torch),
            plain_ms=device_ms(lambda: m2ref.ssd_chunks_ref(
                x, dt, dA, Bm, Cm, L), torch),
            library_ms=None,
            bound_ms=min(fma_ms, tf32_ms), bound_route=route,
            bound_by=("bytes" if moved / bw * 1e3 >= min(fma_ms, tf32_ms)
                      else "operations"),
            bound_fma_ms=fma_ms, bound_tf32_ms=tf32_ms)
        print(json.dumps(rows[("ssd_chunks", case)]), flush=True)
        check_ssd_variants(torch, m2, "groups", (x, dt, dA, Bm, Cm), L)
        if L == 1:
            check_ssd_variants(torch, m2, "packing", (x, dt, dA, Bm, Cm), L)
    return rows


def check_ssd_variants(torch, m2, kind, args, L):
    """Phase 5: each kind of block ("groups": one or two warp groups,
    chosen through the SM count ``ssd_grid`` reads) or each packing of
    chunks per block ("packing", through PACK_ROWS) timed alone; every
    variant must give the same bits."""
    x = args[0]
    B, S, H, P = x.shape
    sm_count, pack_rows = m2.sm_count, m2.PACK_ROWS
    variants = ({"one": 0, "two": 2 ** 30} if kind == "groups"
                else {str(v): v for v in SSD_PACKINGS})
    outs, us = [], {}
    try:
        for name, v in variants.items():
            if kind == "groups":
                m2.sm_count = lambda index, sms=v: sms
            else:
                m2.PACK_ROWS = v * L
            outs.append(m2.ssd_chunks(*args, chunk=L))
            us[name] = device_ms(lambda: m2.ssd_chunks(*args, chunk=L),
                                 torch) * 1e3
    finally:
        m2.sm_count, m2.PACK_ROWS = sm_count, pack_rows
    torch.cuda.synchronize()
    for o in outs[1:]:
        if not all(torch.equal(a, b) for a, b in zip(o, outs[0])):
            raise AssertionError(f"ssd_chunks {tuple(x.shape)}: {kind} "
                                 "give different bits")
    print(f"ssd_chunks {kind}", json.dumps({
        "shape": [B, S, H, P], "chunk": L,
        "chosen": m2.ssd_grid(B, S, H, P, L, sm_count(x.device.index)),
        "us_by_variant": us}), flush=True)


def check_no_spill(build, mod, namespace, kernels):
    """Phase 2: the -Xptxas -v log of a kernel library lists ``kernels``
    functions, none with a stack frame or a spill (a register array
    indexed at run time lands in local memory). Returns {function:
    registers}."""
    import re
    log = build.library_path(namespace, mod.SOURCES).with_suffix(
        ".log").read_text()
    props = re.findall(r"Function properties for (\S+)\n\s+(\d+) bytes stack "
                       r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                       r"loads\n.*?Used (\d+) registers", log)
    bad = {n: (int(f), int(st), int(ld)) for n, f, st, ld, _ in props
           if int(f) or int(st) or int(ld)}
    regs = {n: int(r) for n, *_, r in props}
    print(f"{namespace} ptxas", json.dumps({
        "functions": len(props), "registers": sorted(regs.values()),
        "stack_or_spill": bad}), flush=True)
    if len(props) != kernels or bad:
        raise AssertionError(f"{namespace} build: {len(props)} kernels in "
                             f"the ptxas log (want {kernels}), stack "
                             f"frames or spills {bad}")
    return regs


def check_tensor_core_sass(build, fa):
    """Phase 2: every bf16 flash-attention instantiation in the built
    library holds HMMA (tensor-core) instructions, and no instantiation of
    either dtype has a stack frame or spills (check_no_spill). Returns
    the HMMA counts."""
    import shutil
    # hd = 16..128 in steps of 16: f32 with q tiles of 16, 32 and 64
    # rows, bf16 with 64-row tiles
    want_f32, want_bf16 = 8 * len(fa.Q_TILE_ROWS), 8
    check_no_spill(build, fa, "flash_attention", want_f32 + want_bf16)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = build.library_path("flash_attention", fa.SOURCES)
    sass = subprocess.run([tool, "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hmma = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        if "fa_bf16_kernel" in name or "fa_f32_kernel" in name:
            hmma[name] = fn.count("HMMA")
    bf16 = [n for name, n in hmma.items() if "fa_bf16_kernel" in name]
    f32 = [n for name, n in hmma.items() if "fa_f32_kernel" in name]
    print("flash_attention SASS", json.dumps({
        "bf16_instantiations": len(bf16), "f32_instantiations": len(f32),
        "hmma_per_bf16_instantiation": sorted(bf16),
        "f32_instantiations_with_hmma": sum(n > 0 for n in f32)}),
        flush=True)
    if len(bf16) != want_bf16 or len(f32) != want_f32 or min(bf16) == 0:
        raise AssertionError(f"flash_attention SASS: {len(bf16)} bf16 and "
                             f"{len(f32)} f32 instantiations (want "
                             f"{want_bf16} and {want_f32}), HMMA counts "
                             f"{sorted(bf16)}")
    return hmma


def check_ssd_sass(build, m2):
    """Phase 2: the built SSD chunk library holds its two instantiations
    (one and two warp groups), each with TF32 tensor-core instructions
    (HMMA ... TF32) and no stack frame or spill (check_no_spill).
    Returns the HMMA counts."""
    import shutil
    lib = build.library_path("mamba2_scan", m2.SOURCES)
    check_no_spill(build, m2, "mamba2_scan", 2)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    hmma = {}
    for fn in sass.split("Function : ")[1:]:
        lines = fn.splitlines()
        hmma[lines[0].strip()] = sum("HMMA" in ln and "TF32" in ln
                                     for ln in lines)
    print("mamba2_scan SASS", json.dumps({
        "instantiations": len(hmma),
        "tf32_hmma_per_instantiation": sorted(hmma.values())}), flush=True)
    if len(hmma) != 2 or min(hmma.values(), default=0) == 0:
        raise AssertionError(f"mamba2_scan SASS: {len(hmma)} functions "
                             f"for 2 in the ptxas log, TF32 HMMA counts "
                             f"{sorted(hmma.values())}")
    return hmma


def _profile_ms(torch, fn, top=5):
    """(wall ms, device busy ms, {top kernels and host ops by time}) of
    one synchronised call of ``fn`` under torch.profiler."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile import busy_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device activity")
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    split = {"device_ops": len(events),
             "top_kernels_ms": dict(sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:top]),
             "top_host_ops_self_ms": {a.key[:60]: a.self_cpu_time_total / 1e3
                                      for a in host[:top]}}
    return (wall * 1e3,
            busy_us([(e.time_range.start, e.time_range.end)
                      for e in events]) / 1e3, split)


def _host_ms(torch, fn, n):
    """Median host-clock ms of ``n`` synchronised calls of ``fn``."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _decode_matches_full(torch, model, params, seq, prompt, name):
    """Every generated position's decode logits (a lockstep prefill of
    ``prompt`` tokens, then decode_step) against the teacher-forced full
    forward of ``seq``, within 2e-3, with the MoE capacity factor at
    GATE_CAPACITY_FACTOR and put back after."""
    from repro_torch.models import moe
    V = model.cfg.vocab_size
    gen = seq.shape[1] - prompt
    factor = moe.CAPACITY_FACTOR
    moe.CAPACITY_FACTOR = GATE_CAPACITY_FACTOR
    try:
        full, _ = model.apply(params, {"tokens": seq[:, :-1]})
        logits, cache = model.prefill(params, {"tokens": seq[:, :prompt]},
                                      cache_len=seq.shape[1])
        dec = [logits[:, 0]]
        for j in range(gen - 1):
            lg, cache = model.decode_step(
                params, cache, seq[:, prompt + j:prompt + j + 1])
            dec.append(lg[:, 0])
    finally:
        moe.CAPACITY_FACTOR = factor
    dec = torch.stack(dec, 1)[..., :V]
    ref_ = full[:, prompt - 1:, :V]
    err = float((dec - ref_).abs().max())
    torch.testing.assert_close(dec, ref_, rtol=2e-3, atol=2e-3)
    moe_note = (f", MoE capacity factor {GATE_CAPACITY_FACTOR}"
                if model.cfg.num_experts else "")
    print(f"serve {name}: decode logits == full forward at all {gen} "
          f"generated positions, max abs diff {err:.3g} (tolerance "
          f"2e-3{moe_note})", flush=True)


def _engine_matches_lockstep(torch, model, params, prompts, gen, name):
    """Each prompt prefilled alone (B = 1, as the engine admits), the
    rows decoded together in lockstep: -> (B, gen) greedy tokens; every
    logit finite."""
    import numpy as np
    from repro_torch.utils.tree import tree_map
    cache_len = prompts.shape[1] + gen
    caches, first = [], []
    for p in prompts:
        lg, c = model.prefill(params, {"tokens": torch.from_numpy(
            p[None]).cuda()}, cache_len=cache_len)
        caches.append(c)
        first.append(lg)
    cache = {"runs": tree_map(lambda *xs: torch.cat(xs, 1),
                              *[c["runs"] for c in caches]),
             "t": caches[0]["t"], "positions": caches[0]["positions"]}
    logits = torch.cat(first)
    toks, finite = [], []
    for j in range(gen):
        if j:
            logits, cache = model.decode_step(params, cache, toks[-1])
        finite.append(torch.isfinite(logits[..., :model.cfg.vocab_size]
                                     ).all())
        toks.append(torch.argmax(logits, dim=-1))
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"serve {name}: non-finite logits")
    print(f"serve {name}: engine tokens == lockstep prefill + decode_step "
          f"loop for all {len(prompts)} requests, logits finite",
          flush=True)
    return np.asarray(torch.cat(toks, 1).cpu())


def run_serve_path(torch, mods, arch, layers, dtype_name, smi):
    """Phase 6, one serve path. Returns its launch counts over its runs."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build_model
    from repro_torch.serving import DecodeEngine
    from repro_torch.serving.engine import _decode_block
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    dtype = getattr(torch, dtype_name)
    name = f"{arch}[{cfg.num_layers}L]"
    # MLA runs no flash attention: its qk head dim passes the kernel's
    attn_sites = 0 if cfg.use_mla else sum(t in tfm.ATTN_TYPES
                                           for t in cfg.layer_types)
    ssd_sites = sum(t == "mamba2" for t in cfg.layer_types)
    model = build_model(cfg, dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(a.numel() for a in tree_leaves(params))
    rng = np.random.default_rng(0)
    cache_len = SERVE_PROMPT + SERVE_GEN
    total = {}
    for n_req in SERVE_RUNS:
        prompts = rng.integers(0, cfg.vocab_size, (n_req, SERVE_PROMPT))
        engine = DecodeEngine(model, params, slots=SERVE_SLOTS,
                              cache_len=cache_len, flush_tokens=SERVE_FLUSH)
        _reset(mods)
        t0 = time.perf_counter()
        rids = [engine.submit(p, SERVE_GEN) for p in prompts]
        done = {c.request_id: c.tokens for c in engine.run_until_idle()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(mods)
        want = {}
        if attn_sites:
            want[("flash_attention", "cuda")] = n_req * attn_sites
        if ssd_sites:
            want[("ssd_chunks", "cuda")] = n_req * ssd_sites
        if launches != want:
            raise AssertionError(f"serve {name} ({n_req} requests) launched "
                                 f"{launches}, expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        gen = np.stack([done[r] for r in rids])
        if gen.shape != (n_req, SERVE_GEN) or gen.min() < 0 or \
                gen.max() >= cfg.vocab_size:
            raise AssertionError(f"serve {name}: bad tokens {gen.shape}")
        print(f"serve {name}", json.dumps({
            "card": smi, "dtype": dtype_name, "params": n_params,
            "init_s": init_s, "init_peak_gb": init_peak,
            "requests": n_req, "slots": SERVE_SLOTS,
            "flush_tokens": SERVE_FLUSH, "flushes": engine.stats["flushes"],
            "wall_s": wall, "tok_per_s": n_req * SERVE_GEN / wall,
            "occupancy_mean": engine.metrics()["serve_occupancy_mean"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {f"{k}/{d}": v for (k, d), v in launches.items()}}),
            flush=True)
        if n_req == SERVE_RUNS[0]:
            first = (prompts, gen, engine)

    prompts, gen, engine = first
    seq = torch.from_numpy(np.concatenate([prompts, gen], 1)).cuda()
    if dtype == torch.float32:
        # prefill and decode agree: every generated position's decode
        # logits against the teacher-forced full forward
        _decode_matches_full(torch, model, params, seq, SERVE_PROMPT, name)
    else:
        # bf16: the engine's tokens are a lockstep loop's, bit for bit
        lock = _engine_matches_lockstep(torch, model, params, prompts,
                                        SERVE_GEN, name)
        if not np.array_equal(lock, gen):
            raise AssertionError(f"serve {name}: engine tokens differ from "
                                 "the lockstep loop's")

    # where the time goes: one prefill (B = 1) and one decode block of
    # SERVE_FLUSH steps over the full pool
    one = {"tokens": seq[:1, :SERVE_PROMPT]}
    act = torch.ones((SERVE_SLOTS,), dtype=torch.bool, device="cuda")

    def prefill():
        model.prefill(params, one, cache_len=cache_len)

    def block():
        _decode_block(model, params, engine.pool, engine._tok, act,
                      SERVE_FLUSH, None)

    prefill(), block()
    torch.cuda.synchronize()
    pre_ms, blk_ms = _host_ms(torch, prefill, 5), _host_ms(torch, block, 3)
    pre_wall, pre_busy, pre_split = _profile_ms(torch, prefill)
    blk_wall, blk_busy, blk_split = _profile_ms(torch, block)
    print(f"serve {name} time", json.dumps({
        "card": smi, "prefill_ms": pre_ms, "prefill_tokens": SERVE_PROMPT,
        "prefill_device_busy_ms": pre_busy,
        "prefill_idle_share": 1 - pre_busy / pre_wall,
        "decode_block_ms": blk_ms, "decode_ms_per_step": blk_ms / SERVE_FLUSH,
        "decode_rows": SERVE_SLOTS,
        "decode_device_busy_ms_per_step": blk_busy / SERVE_FLUSH,
        "decode_idle_share": 1 - blk_busy / blk_wall}), flush=True)
    print(f"serve {name} prefill profile", json.dumps(pre_split))
    print(f"serve {name} decode block profile", json.dumps(blk_split),
          flush=True)
    del params, engine, first
    torch.cuda.empty_cache()

    if arch not in CPU_CHECK_LAYERS:
        # DeepSeek-V3: the f32 decode gate at its reduced config
        small = get_config(arch).reduced()
        model = build_model(small)
        params = model.init(torch.Generator(device="cuda").manual_seed(1))
        seq = torch.from_numpy(rng.integers(
            0, small.vocab_size, (SERVE_SLOTS, SERVE_PROMPT + SERVE_GEN))
        ).cuda()
        _decode_matches_full(torch, model, params, seq, SERVE_PROMPT,
                             f"{arch}[reduced]")
        del params
        return total

    # the card agrees with the CPU: prefill at full width, fewer layers
    V = cfg.vocab_size
    small = dataclasses.replace(cfg, num_layers=CPU_CHECK_LAYERS[arch])
    model = build_model(small)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": seq[:2, :SERVE_PROMPT]}
    card, _ = model.prefill(params, batch)
    card_full, _ = model.apply(params, batch)
    params = tree_map(lambda a: a.cpu(), params)
    batch = {"tokens": batch["tokens"].cpu()}
    host, _ = model.prefill(params, batch)
    host_full, _ = model.apply(params, batch)
    for a, b in ((card, host), (card_full, host_full)):
        torch.testing.assert_close(a.cpu()[..., :V], b[..., :V], rtol=2e-3,
                                   atol=2e-3)
    print(f"serve {name}: prefill logits on the card == CPU at "
          f"{small.num_layers} layers, full width, max abs diff "
          f"{float((card_full.cpu() - host_full)[..., :V].abs().max()):.3g}"
          " (tolerance 2e-3)", flush=True)
    del params
    torch.cuda.empty_cache()
    return total


def main() -> int:
    if not (SRC / "repro_torch" / "kernels").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout "
                    "of the repository")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run "
                    "needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.compress import compress as tcomp
    from repro_torch.kernels.compress import ref as tcref
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.delta_sgd import ref as tref
    from repro_torch.kernels.robust_agg import ref as traref
    from repro_torch.kernels.robust_agg import robust_agg as tra
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.kernels.mamba2_scan import ref as m2ref
    from repro_torch.kernels.telemetry import ref as ttref
    from repro_torch.kernels.telemetry import telemetry as tt
    from repro_torch.launch import train
    mods = (tk, tcomp, tra, fa, m2, tt)
    namespaces = ("delta_sgd", "compress", "robust_agg", "flash_attention",
                  "mamba2_scan", "telemetry")

    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name}", flush=True)
    resolve_device("cuda")
    bw, f32 = peaks(name)

    # 2. build: one nvcc per namespace, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods) + 1) as pool:
        floor = pool.submit(launch_floor, torch, build)
        list(pool.map(lambda m: m.library(), mods))
        floor = floor.result()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(mods) + 1} "
          "libraries in parallel (set-up)")
    for mod, ns in zip(mods, namespaces):
        log = build.library_path(ns, mod.SOURCES).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
    check_tensor_core_sass(build, fa)
    check_ssd_sass(build, m2)
    # top-k and the three other compress kernels; the trimmed mean's six
    # register networks and its shared-memory path
    check_no_spill(build, tcomp, "compress", 3)
    check_no_spill(build, tra, "robust_agg", 7)
    # the histogram's two one-warp instances and its grid kernel, the
    # quantiles' three kernels
    check_no_spill(build, tt, "telemetry", 6)
    # the norms' instances (f32 and bf16, each load count, 16-byte and
    # one-element paths; batched_norms' is f32's at 8 loads),
    # batched_apply's two and apply_update's eight
    check_no_spill(build, tk, "delta_sgd", 2 * 2 * len(tk.NORMS_VECS) + 2 + 8)

    # 3. kernels, beside the floor of any launch in this timing
    print(json.dumps({
        "name": "launch floor", "ms": device_ms(floor, torch),
        "torch_sleep0_ms": device_ms(lambda: torch.cuda._sleep(0), torch),
        "what": "an empty kernel from a library built as the port's are; "
                "torch.cuda._sleep(0) beside it"}), flush=True)
    rows = check_kernels(torch, tk, tref, bw, f32)
    rows.update(check_round_tail_kernels(torch, tcomp, tcref, tra, traref,
                                         bw, f32))
    rows.update(check_slice4_kernels(torch, tk, tref, tt, ttref, bw, f32))

    # 4. paths
    paths = {}
    paths["plain"], flat_round0 = run_path(torch, mods, train)
    for pname in SCENARIO_PATHS:
        paths[pname] = run_scenario_path(torch, mods, train, pname)
    paths["telemetry"] = run_telemetry_path(torch, mods, train)
    # 4c. the vmap engine
    paths.update(run_vmap_path(torch, mods, train, flat_round0, smi))
    # 4d. async, fleet, resume, serving from a checkpoint
    for pname in ASYNC_PRESETS:
        paths[pname] = run_async_path(torch, mods, train, pname, smi)
    paths.update(run_fleet_path(torch, mods, train, smi))
    paths.update(run_resume_paths(torch, mods, train))
    paths["serve_checkpoint"] = run_serve_checkpoint(torch, mods, smi)
    # 4e. LM training
    torch.cuda.empty_cache()
    lm_paths, lm_rows = run_lm_train_path(torch, mods, train, tk, tref, bw,
                                          f32, smi)
    paths.update(lm_paths)
    rows.update(lm_rows)

    # 5. lm kernels
    rows.update(check_lm_kernels(torch, fa, faref, m2, m2ref, bw, f32))

    # 6. serving
    for arch, (layers, dtype_name) in SERVE_PATHS.items():
        paths[arch] = run_serve_path(torch, mods, arch, layers, dtype_name,
                                     smi)

    # 7. the kernel parity matrix
    paths["matrix"] = run_matrix(torch, mods)

    # 8. summary: each kernel at its main-path shape
    main_case = {"flash_attention": FA_CASES[0], "ssd_chunks": SSD_CASES[0],
                 "norms": (SINGLE_SIZES[0], "float32"),
                 "apply_update": (SINGLE_SIZES[0], "float32"),
                 "lane_histogram": TELE_LANES[0],
                 "lane_quantiles": TELE_LANES[0]}
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        row = rows[(kname, main_case.get(kname, MAIN_SHAPE))]
        by_path = {p: c.get((kname, "cuda"), 0) for p, c in paths.items()}
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library_call=row.get("library_call"),
            bound_route=row.get("bound_route")))
        if kernels[-1]["launches"] == 0:
            raise AssertionError(f"{kname} was not launched on any path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
