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
              Granite (1, 64, 48, 1, 128: MQA), Whisper-tiny's decoder
              (1, 64, 6, 6, 64), InternVL2-1B over its image and text
              positions (1, 320, 14, 2, 64), and the heads one rank of
              phase 6c holds: TinyLlama (2, 64, 16, 2, 64), Qwen2.5 (2,
              64, 20, 4, 128), Granite (2, 64, 24, 1, 128), OLMoE (2,
              64, 8, 8, 128), Zamba2's shared block (2, 64, 16, 16,
              112), InternVL2 (2, 320, 7, 1, 64), Whisper's decoder (2,
              64, 3, 3, 64), and TinyLlama's one row at a rank of (data
              1, model 4) (1, 64, 8, 1, 64) (f32 within
              2e-5, bf16 within atol 4e-3 + rtol 8e-3, about one bf16
              ulp of the output; two calls bitwise equal); the SSD chunk
              kernel at (1, 64, 112, 64, 64), S = 2048, S = 96 (L = 48),
              S = 67 (L = 1) and at the 56 heads a rank of phase 6c
              holds (2, 64, 56, 64, 64), rtol 1e-3 / atol 1e-4, two calls
              bitwise equal. Timed and bounded like phase 3; the SSD's bound is
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
              width cut to 14 layers, OLMoE-1B-7B, CodeQwen1.5-7B,
              Qwen2.5-14B and Granite-20B at full width cut to 2 layers,
              xLSTM-1.3B at full width cut to 4 layers, Whisper-tiny
              whole (4 + 4 layers, 1,500 stub frames a request) and
              InternVL2-1B whole (24 layers, 256 stub image embeddings a
              request, counted in the cache), all f32, and DeepSeek-V3 at
              full width cut to one layer (with its MTP block) in bf16,
              random weights from seed 0, through DecodeEngine: 4 prompts
              of 64 tokens, 32 new tokens, 4 slots, flush 8; then 6
              prompts on 4 slots (continuous admission). Each run starts
              with every count at 0 and must launch flash attention once
              per causal GQA attention site per request (22, 2, 2, 2, 4
              and 24; none for DeepSeek-V3's MLA and xLSTM; Whisper's
              encoder and cross-attention run plain) and the SSD kernel
              once per Mamba2 layer per request (12), nothing else. Then,
              for the f32 paths: the decode logits of every generated
              position equal the teacher-forced full forward's within
              2e-3 (MoE capacity factor 8.0 for this gate, 1.25 put back
              after; for xLSTM, Whisper and InternVL2 at the depth of the
              CPU check, with the requests' extras); the card's prefill
              logits equal the CPU's within 2e-3 at full width and 2
              layers (7 for Zamba2, so the shared block is there; 4 for
              xLSTM, so its sLSTM is; Whisper whole). For DeepSeek-V3,
              xLSTM, Whisper and InternVL2: finite logits and the
              engine's tokens equal to a lockstep loop's bit for bit
              (each prompt prefilled alone with its extras, the rows
              decoded together); for DeepSeek-V3 the f32 decode gate at
              its reduced config. Prefill and one decode block are timed
              and profiled (device busy, idle share); init time and peak
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
  4f. sharded  multi-device Δ-SGD (repro_torch.sharding, the flat
              round on a mesh): 4 ranks over a (data 2, model 2) mesh,
              spawned by sharding.dist.spawn (gloo with every rank on
              cuda:0 when the card count is below 4, NCCL otherwise; the
              choice, each rank's device and the card are printed). On
              each rank: flat_delta_sgd_step_sharded against the card's
              unsharded step, 3 steps at (10, 71,936) (the CNN's N padded
              for 2 shards), f32 and masked slabs (f32 elements within
              1e-5·max|p|, a bf16 element at most one bf16 ulp a step
              apart, η rtol 1e-5; 2 launches and one (2, 5) all_reduce
              over model a step; peak allocation below the 3 global
              slabs and within 5 local slabs: P, G, the previous
              gradients and the step's sanitised G, plus one of slack);
              the cross_device and cross_silo rounds at phase 4's
              configuration, 2 rounds, against the unsharded round on the
              card (loss rel 1e-4, params within 1e-5·max|p|; 2·K
              launches a round; the recorder's count from
              core.sharded.round_collectives exactly; no (C, N) payload
              and no (C_loc, N_loc) payload across the client axes); the
              block path (clients over data, N whole) twice, bitwise
              equal to itself, 2 collectives and 2·K launches a round;
              int8 + EF21, top-k, trimmed (dirichlet_dropouts) and clip
              (byzantine 0.3) rounds, held against a second spawn of 4
              gloo CPU ranks on the same inputs (loss and eta_mean rel
              1e-5, counts exact, the round-end params within
              1e-5·max|p| and the EF21 slab within 1e-5·max|p|);
              the flat round on the ranks' tensor-parallel blocks
              (core.sharded: each rank's TP slab, one flat_reshard
              all-to-all a round): TinyLlama at full width cut to 2
              layers, K = 2, 4 rows of 128 tokens a client, under
              cross_device (C = 4, dirichlet_dropouts + trimmed +
              int8/EF21) and cross_silo (one client, N over data ×
              model), each against the unsharded flat round on the card
              (loss and η rel 1e-5; each leaf within 1e-5·max|p| but
              int8 code flips, each within one code step of each
              client's chunk over the clients the mean keeps, on at
              most 0.1 % of the model); the collectives by role are
              flat_train_collectives', no local-step op holds a
              client's whole N and a rank's peak is within the slabs
              its round holds (assert_peak_within_local: 6 local slabs,
              6 whole-N vectors, 2 of slack); printed: each rank's
              round seconds, the
              collectives by role with their bytes, the reshard's
              seconds, each rank's peak beside the unsharded round's
              (the sharded lm lines).
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
              CPU's within 1e-4. xLSTM-1.3B at full width cut to 4 layers
              (one [m, m, m, s] period), C = 2, b = 1; Whisper-tiny whole,
              C = 4, b = 8 with (C, K, b, 1500, 384) frames; InternVL2-1B
              whole, C = 2, b = 1, 256 image tokens before the S = 256
              text tokens; K = 2 each: the --flat host loop and one fused
              round, bitwise equal, K launches of each Δ-SGD kernel each,
              the round's wall, busy, tokens/s and peak allocations as
              for OLMoE; the pair held and timed on InternVL2's slabs.
  4g. tensor-parallel training  launch.steps.make_train_step's vmap
              round (Δ-SGD + FedAvg, K = 2, f32 random weights from seed
              0) on 4 ranks over (data 2, model 2), gloo with every rank
              on the card (dist.spawn), under the training rules
              (launch.steps.train_rules, place_train_for_rank). Before
              the run, each run's collectives a round on a rank
              (launch.steps.train_collectives) are printed. Unsharded
              rounds on the card first, each finished and its memory
              freed before the spawn, their round-end params kept on
              the host's disk for the ranks: TinyLlama-1.1B at full
              width cut to 11 of its 22 layers (cross_device, one client
              a data rank: C = 2, b = 2, S = 256, remat on), Qwen2.5-14B
              and Granite-20B at full width
              and 1 layer (cross_silo: one client, FSDP over data, b =
              4 split over data; remat off, which spares a second gather
              of each layer's fsdp dims), TinyLlama at 2 layers (remat
              off). The ranks run TinyLlama at 11 layers on the plain
              route and
              at 2 layers on the Δ-SGD kernel route (2·K launches a
              rank), Qwen2.5 and Granite, and TinyLlama at 2 layers with
              remat off and on, on allocators that grow their segments
              in place (expandable_segments), the parent holding under
              1 GiB of the card. Gates: loss and η within 1e-4 relative of the
              unsharded round; each rank's round-end blocks within
              1e-5·max|p| of each leaf's unsharded block; every leaf
              replicated over model bitwise equal on the model ranks;
              the collectives by role exactly the derived ones;
              assert_no_param_gather(train=True) on TinyLlama; remat on
              within 1e-6·max|p| of remat off (bitwise or not printed,
              both peaks); each rank's peak below the unsharded run's.
              batched_norms and batched_apply are held against their
              plain versions at a rank's local slab shapes and timed
              (rank 0, after the runs). The dry run of TinyLlama's
              train_4k on the (32, 8) H100 mesh runs meanwhile in a CPU
              process of its own; its analytic memory and counts are
              printed beside the measured peaks. The MoE and MLA
              decoders under the same gates: OLMoE-1B-7B at full width
              and 2 layers (cross_device, C = 2, b = 2) on the plain
              and the kernel route (the pair held and timed at a rank's
              OLMoE slab), DeepSeek-V3 at its reduced config with MTP
              (cross_silo, one client's 4 rows over data, so the MoE
              counts and aux sums cross data; wq_a, wkv_a, q_norm,
              kv_norm and the router among the replicas compared).
              Zamba2-7B at full width and 7 layers (6 Mamba2 layers and
              the shared block; b = 1), Whisper-tiny whole and
              InternVL2-1B at full width and 2 layers (b = 2;
              cross_device, C = 2), with
              their frames and image embeddings beside the tokens, under
              the same gates (the Mamba2 layers' ssm_zx, ssm_conv and
              ssm_norm among the collectives). xLSTM-1.3B at full width
              and 4 layers (3 mLSTM, 1 sLSTM; cross_device, C = 2, b =
              1), held at XLSTM_RTOL (η within 1e-4 relative, params
              within 1e-3·max|p|: its local steps are ill-conditioned in
              f32), replicas bitwise. The dry runs of OLMoE's and
              DeepSeek-V3's train_4k and decode_32k, of Zamba2's and
              xLSTM's prefill_32k, decode_32k and train_4k (xLSTM's
              sLSTM loop counted at two and three cells and
              extrapolated), and the one-row long_500k of the 8 archs
              whose heads split over 8 ranks start before phase 4, in a
              CPU process a group; all are printed after 6c
              (Zamba2's with every Mamba2 role among their collectives,
              xLSTM's with its mixer's, long_500k's with the time-block
              decode's seq_max and seq_sum, xLSTM's with xlstm_state).
  6b. serving plane  TinyLlama-1.1B whole (22 layers, f32, random
              weights from seed 0), every count at 0 before each part
              and read after. (1) Hot swap: seed 0's params saved as
              step 1 in a temporary dir, an engine with a ModelRegistry
              on it (version 1 after its start-up poll), 2 requests of
              64 + 17 tokens on 4 slots, flush 8, one step(), seed 1's
              params saved as step 2, run until idle: one swap,
              kv_reuse_swaps 1, history versions [1, 2, ...], each
              completion's versions (1, 2), the staged params on the card
              equal to the saved ones, tokens equal to a replay at the
              pool's width (each prompt prefilled alone, the first flush
              under step 1, the rest under step 2 on the same cache), 22
              flash launches a request; the swap stall printed. (2)
              Personalized decode: a store with client 7's delta (a
              card normal draw at scale 5e-2, set_delta) and 3 requests
              of one prompt (client 7, global, unknown client 9): two
              groups in each flush's history, one device-to-host copy a
              flush and no other host read, client 7's tokens equal a
              pool-width decode under unpack(pack(params) + scale ·
              delta) and differ from the global ones, client 9's equal
              the global ones, 22 flash launches a request; the peak
              allocation printed. (3) The serve CLI with the watched
              --ckpt-dir of (1) (it serves step 2), --batch 4
              --prompt-len 64 --gen 32 --loadgen 8 --events F, closed,
              then Poisson at 2 requests/s: 8
              requests, p99 >= p50 > 0, occupancy in (0, 1], one
              serve_flush row a flush and one serve_load row, 22 flash
              launches for each of the 12 requests; tok/s, p50 and p99
              printed. (4) The int8 KV cache: 4 prompts of 64 tokens fed
              through decode_step from init_cache(4, 96, quant_kv=True),
              then 32 greedy steps, and the same from the f32 cache:
              finite logits, int8 and f16 leaves, the logits within
              QUANT_KV_TOL of the largest f32 logit over the steps whose
              inputs agree, no kernel launched; at 2 layers the card's
              int8 decode within the same of the CPU's; both caches'
              bytes and decode ms a step printed. The phase's seconds and
              the script's total are printed.
  6c. tensor-parallel serving  4 ranks over (data 2, model 2), gloo
              with every rank on the card (dist.spawn). Before the run,
              each path's collectives a step on a rank, derived from the
              placement (launch.steps.serve_collectives), are printed.
              An unsharded run on the card first (prefill of 4 prompts
              of 64 tokens, then greedy decode; random f32 weights from
              seed 0): TinyLlama-1.1B at full width and 2 layers
              (cross_device, KV heads split over model; its whole depth
              is the one-row run's), 32 new tokens; Qwen2.5-14B and Granite-20B at
              full width and 2 layers (cross_silo: params FSDP over
              data; Granite's MQA head on every rank), 4 new tokens;
              Zamba2-7B at full width and 14 layers (12 Mamba2 layers,
              the shared block at two sites), InternVL2-1B whole (256
              image rows before the prompt) and Whisper-tiny whole (its
              1500 frames), cross_device, 8 new tokens, their frames and
              image embeddings standard normals from seed 1 placed with
              the rows; xLSTM-1.3B at full width and 4 layers (3 mLSTM,
              1 sLSTM), cross_device, 8 new tokens; for these four the
              unsharded run also takes the teacher-forced full forward. Each rank builds the same
              weights, keeps its block (launch.steps.place_for_rank),
              holds flash at its local heads (and, Zamba2, the SSD chunk
              kernel at its 56 heads) against the plain version, then
              prefills through
              make_prefill_step(rules=) and decodes the unsharded run's
              tokens (TinyLlama also greedy through make_serve_step):
              prefill's and every step's logits within 1e-4·max|logits|
              of the unsharded (the worst printed), tokens equal where
              the top-two margin passes that tolerance, each step's
              collectives by role exactly the derived ones,
              assert_no_param_gather on the cross_device paths, flash
              launched once an attention layer a prefill at the rank's
              head shape (the encoder's non-causal attention takes the
              plain route) and the SSD chunk kernel once a Mamba2 layer
              at the rank's heads, each rank's prefill and decode logits
              within 2e-3 of the full forward (Zamba2, InternVL2,
              Whisper, xLSTM), each rank's peak below the unsharded
              model's. In the same spawn, the one-row run on (data 1,
              model 4): TinyLlama-1.1B whole, the first prompt alone,
              prefill into a cache of 1,024 slots which the placement
              cuts over model along its time dim (place_prefill_cache:
              256 a rank), then the unsharded run's 8 greedy tokens fed
              back: flash once a layer at (1, 64, 8, 1, 64), logits
              within 1e-4·max|logits| of the unsharded and within 2e-3
              of the full forward, each step's collectives exactly
              serve_collectives' with the cut cache (seq_q, seq_max,
              seq_sum in every layer), assert_no_param_gather; then an
              int8 cache made empty under the rules (cut the same way)
              fed the prompt's first 8 tokens, its logits within
              QUANT_KV_TOL·max of the full forward. Then the dry run of
              TinyLlama's prefill_32k and decode_32k on the (32, 8) H100
              mesh, its analytic memory beside the measured peaks.
              Then the MoE and MLA decoders (TPM_RUNS; experts and heads
              over model, the capacity counts gathered over data): an
              unsharded run on the card first (prefill of the 4 prompts
              of 64 at the served capacity 1.25, greedy decode; for the
              gate runs also the full forward and the prefill at
              GATE_CAPACITY_FACTOR), then the ranks: OLMoE-1B-7B at 2
              layers (cross_device, 32 new tokens; cross_silo, 4: each
              layer's experts gathered over data through the host) and
              DeepSeek-V3 reduced in f32 (cross_silo, 8; its router
              leaning on one expert so that 1.25 drops choices, which
              the unsharded prefill at 8.0 shows) in the dense part's
              spawn, each rank drawing the weights; OLMoE at 4 layers
              (cross_silo, a decode step) and DeepSeek-V3 at one layer
              with its MTP block at full width in bf16 on (data 1,
              model 4), a spawn each, the ranks reading the parent's
              params through CUDA IPC. Gates: prefill's and every
              step's logits within 1e-4·max|logits| of the unsharded;
              bf16: the router's input at every row and step within
              TPM_BF16_REL·max of the unsharded run's, at least half
              the rows and steps routed to the unsharded run's experts
              and their logits within TPM_BF16_REL·max (the others
              printed with the unsharded router's near-tie); tokens
              equal where the margin passes (and, bf16, the routing
              agrees), finite logits and tokens in the vocab, each
              step's collectives by role exactly serve_collectives',
              assert_no_param_gather on OLMoE 2 L cross_device, flash
              once a layer a prefill at the rank's heads (none for
              MLA), decode == full forward at GATE_CAPACITY_FACTOR
              within 2e-3 on the three gate runs (OLMoE 2 L on both
              federations, DeepSeek-V3 reduced), the MLA latent cache
              bitwise equal on the model ranks of a data coordinate
              (DeepSeek-V3 at one layer on (data 1, model 4) decodes on
              its latent cut over its time dim, each rank its block of
              the 72 slots, the blocks in model order within the run's
              tolerance of the unsharded latent), a rank's peak below
              the unsharded run's where the ranks drew their own
              weights. Then the dry runs' lines, and launch/perf.py's
              (PERF_RUNS, started beside phase 4 on the host: the
              sharded flat round's variants on TinyLlama and on
              Qwen2.5-14B at full width, each holding
              assert_flat_buffer_sharded, the compressed ones their
              wire record; OLMoE's capacity1 and expert_2d; the decode
              cache's quant_kv+cache_seq_shard; softmax_bf16), each
              counted at two depths and extrapolated: one line a
              variant, then launch/report.py's dry-run, roofline and
              perf tables over what they wrote.
  7. matrix   the port's kernel parity matrix (repro_torch.conformance,
              32 cells, every kernel namespace) on cuda through check_cell,
              every count at 0 before and read after: every cell passes
              and every cell's kernel launched on the card.
  8. summary  each phase's seconds and the script's total, then the
              line {"kernels": [...]} (all twelve kernels, with their
              launches by path, the vmap runs of 4c, the runs of 4d, the
              LM runs of 4e, the ranks' of 4f and 4g, the serving
              plane's of 6b and the ranks' of 6c among them;
              DeepSeek-V3's serve path and the int8 cache's launch none)
              and, last, the device line.

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
            (1, 64, 48, 1, 128, None, "float32"),
            # Whisper-tiny's decoder (6/6) and InternVL2-1B over its 256
            # image and 64 text positions (14/2)
            (1, 64, 6, 6, 64, None, "float32"),
            (1, 320, 14, 2, 64, None, "float32"),
            # a rank's heads at phase 6c's (data 2, model 2): 2 prompts
            # of 4 a data rank; TinyLlama 16/2 (KV sharded), Qwen2.5
            # 20/4, Granite 24/1 (the MQA head on every rank)
            (2, 64, 16, 2, 64, None, "float32"),
            (2, 64, 20, 4, 128, None, "float32"),
            (2, 64, 24, 1, 128, None, "float32"),
            # OLMoE's 8 heads and 8 KV heads at a rank of (data 2,
            # model 2)
            (2, 64, 8, 8, 128, None, "float32"),
            # Zamba2's shared block (16/16 of 32/32), InternVL2 over its
            # 320 positions (7/1 of 14/2) and Whisper's decoder (3/3 of
            # 6/6) at a rank of (data 2, model 2)
            (2, 64, 16, 16, 112, None, "float32"),
            (2, 320, 7, 1, 64, None, "float32"),
            (2, 64, 3, 3, 64, None, "float32"),
            # TinyLlama's one prompt at a rank of (data 1, model 4): 8 of
            # its 32 heads, 1 of its 4 KV heads
            (1, 64, 8, 1, 64, None, "float32"))
# SSD chunk cases (B, S, H, P, G, N), the first the Zamba2 prefill shape,
# the last its 56 of 112 heads at a rank of (data 2, model 2)
SSD_CASES = ((1, 64, 112, 64, 1, 64), (1, 2048, 112, 64, 1, 64),
             (1, 96, 112, 64, 1, 64), (1, 67, 112, 64, 1, 64),
             (2, 64, 56, 64, 1, 64))
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
# phase 4f: world-4 ranks over (data 2, model 2), rounds a case, and the
# LM slab of phase 4e (TinyLlama at 2 layers: C = 4, N packed at shards=1)
SHARD_WORLD = 4
SHARD_MESH = ((2, 2), ("data", "model"))
SHARD_ROUNDS = 2
# phase 4f's LM rounds: the flat round on the ranks' tensor-parallel
# blocks (core.sharded), LM_ARCH at full width cut to SHARD_LM_LAYERS
# layers, f32, random weights from TPT_SEED, TPT_K local steps on
# SHARD_LM_B rows of SHARD_LM_SEQ tokens a client: (federation, C, the
# guarded tail: dirichlet_dropouts + trimmed + int8/EF21). cross_silo
# puts N over data × model with one client (the slab's 0.88 GB through
# gloo). Each is held to the unsharded flat round on the card: loss and
# η within SHARD_LM_REL relative, each leaf within SHARD_LM_REL·max|p|
# but, under int8, the elements whose code fell the other way: each
# within SHARD_LM_REL·max|p| plus its flip bound (one code step of each
# client's chunk, over the clients the mean keeps), on at most
# SHARD_LM_FLIP_SHARE of the model's elements (on an H100 80GB HBM3 at
# 700 W: 51,343 of 219.3e6, 2.3e-4)
SHARD_LM = (("cross_device", 4, True), ("cross_silo", 1, False))
SHARD_LM_LAYERS, SHARD_LM_B, SHARD_LM_SEQ = 2, 4, 128
SHARD_LM_REL = 1e-5
SHARD_LM_FLIP_SHARE = 1e-3
# a rank's peak bytes of the same cross_device round on the gather
# route it replaced (each chunk of clients' params gathered to full N):
# scripts/flat_tp_probe.py --src on the parent commit's tree, H100 80GB
# HBM3 at 700 W
SHARD_LM_GATHER_PEAK = {"cross_device": 9_292_225_024}
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
# the LM zoo's last three archs, each a --flat host loop and a fused
# round: xLSTM-1.3B at full width cut to one [m, m, m, s] period (about
# 0.41e9 params), Whisper-tiny whole with its (C, K, b, 1500, 384)
# frames, InternVL2-1B whole (256 image tokens before the S text tokens;
# the Δ-SGD pair held and timed on its (2, ~6.3e8) slabs)
LM_NEW = {"xlstm-1.3b": dict(layers=4, C=2, K=2, b=1, S=256),
          "whisper-tiny": dict(layers=4, C=4, K=2, b=8, S=256),
          "internvl2-1b": dict(layers=24, C=2, K=2, b=1, S=256)}
LM_ROUNDS = 2
LM_TIMED_BLOCKS = 3
# profiled calls of one block before its busy time counts as not measured
PROFILE_TRIES = 3
# the f64 check of the 22-layer run's sums reads the row in slices of
# LM_F64_SLICE elements; the run's slab must pass LM_PAST elements
LM_F64_SLICE = 2 ** 26
LM_PAST = 2 ** 31
# serve paths: arch -> (layers kept (None: all), dtype); the runs'
# request counts. DeepSeek-V3 serves in bf16: one layer and its MTP
# block at full width are 24.97e9 params, 99.9 GB in f32. OLMoE and
# xLSTM at the depth of their CPU checks: 6c serves OLMoE at full width
# on the ranks at 2 and 4 layers, and xLSTM at full width on the ranks,
# 4g trains it there
SERVE_PATHS = {"tinyllama-1.1b": (None, "float32"),
               "zamba2-7b": (14, "float32"),
               "olmoe-1b-7b": (2, "float32"),
               "codeqwen1.5-7b": (2, "float32"),
               "qwen2.5-14b": (2, "float32"),
               "granite-20b": (2, "float32"),
               "deepseek-v3-671b": (1, "bfloat16"),
               "xlstm-1.3b": (4, "float32"),
               "whisper-tiny": (None, "float32"),
               "internvl2-1b": (None, "float32")}
SERVE_PROMPT, SERVE_GEN, SERVE_SLOTS, SERVE_FLUSH = 64, 32, 4, 8
SERVE_RUNS = (4, 6)
# depth of the card-vs-CPU prefill check (Zamba2: with its shared block);
# DeepSeek-V3's bf16 path has none: its decode gate runs at its reduced
# config in f32
CPU_CHECK_LAYERS = {"tinyllama-1.1b": 2, "zamba2-7b": 7, "olmoe-1b-7b": 2,
                    "codeqwen1.5-7b": 2, "qwen2.5-14b": 2,
                    "granite-20b": 2, "xlstm-1.3b": 4, "whisper-tiny": 4,
                    "internvl2-1b": 2}
# serve paths whose decode == full forward gate runs at the
# CPU_CHECK_LAYERS depth (xLSTM's four reach its sLSTM), and whose engine
# tokens are also held bitwise against a lockstep decode of each request
CHECK_DEPTH_GATES = ("xlstm-1.3b", "whisper-tiny", "internvl2-1b")
# phase 6b, the serving plane: TinyLlama whole; requests of 64 + 17
# tokens on 4 slots, flush 8 (so a request spans the swap of part 1);
# the personalized overlay's scale; the CLI's load run (8 requests, the
# Poisson rate in requests/s, under the 4 slots' throughput); the int8
# cache's run (4 prompts of 64 teacher-forced steps, 32 greedy ones)
PLANE_ARCH = "tinyllama-1.1b"
PLANE_PROMPT, PLANE_GEN = 64, 17
PLANE_SCALE = 5e-2
PLANE_LOADGEN, PLANE_RATE = 8, 2.0
PLANE_BATCH = 4
PLANE_CLI = ["--arch", PLANE_ARCH, "--batch", str(PLANE_BATCH),
             "--prompt-len", "64", "--gen", "32", "--device", "cuda"]
QUANT_ROWS, QUANT_PROMPT, QUANT_GEN = 4, 64, 32
# the int8 cache's decode logits against the f32 cache's (and the card's
# against the CPU's), as a share of the largest f32 logit: the bound
# tests/test_torch_serving_plane.py fixes (QUANT_KV_TOL there)
QUANT_KV_TOL = 0.05
# phase 6c, tensor-parallel serving on 4 ranks over (data 2, model 2)
# (SHARD_MESH): arch -> (layers kept (None: all), federation, new
# tokens); TP_ROWS prompts of TP_PROMPT tokens (with Whisper's frames or
# InternVL2's image embeddings, standard normals from TP_SEED, placed
# with the rows), f32, random weights from TP_SEED; logits held to the
# unsharded port's within TP_REL·max|logits|. Zamba2 at full width cut
# to 14 layers: 12 Mamba2 layers and the shared block at two sites;
# TinyLlama at 2 (the one-row run serves it whole), xLSTM at 4 (3 mLSTM,
# 1 sLSTM: at 8 its f32 logits lie 7.3e-5·max from f64, 1.5e-5 at 4,
# scripts/xlstm_conditioning.py --serve, and two f32 sum orders reached
# TP_REL on the H100)
TP_PATHS = {"tinyllama-1.1b": (2, "cross_device", 32),
            "qwen2.5-14b": (2, "cross_silo", 4),
            "granite-20b": (2, "cross_silo", 4),
            "zamba2-7b": (14, "cross_device", 8),
            "internvl2-1b": (None, "cross_device", 8),
            "whisper-tiny": (None, "cross_device", 8),
            "xlstm-1.3b": (4, "cross_device", 8)}
TP_ROWS, TP_PROMPT, TP_SEED = 4, 64, 0
TP_REL = 1e-4
# the paths whose ranks' decode logits are also held against the
# unsharded teacher-forced full forward (decode == full forward, within
# the 2e-3 of _decode_matches_full)
TP_GATE_PATHS = ("zamba2-7b", "internvl2-1b", "whisper-tiny", "xlstm-1.3b")
# phase 6c's one-row run on (data 1, model 4) in the same spawn: LM_ARCH
# whole, the first of the TP_ROWS prompts, a cache of ONE_ROW_CACHE slots
# whose time dim cache_shardings cuts over model (256 a rank: the ranks'
# blocks of the decode's attention are combined over model), the
# unsharded run's ONE_ROW_GEN greedy tokens fed back; and the int8 cache,
# empty under the rules, fed the prompt's first ONE_ROW_INT8 tokens; both
# held to the unsharded full forward (the int8 one within QUANT_KV_TOL)
ONE_ROW_MESH = ((1, 4), ("data", "model"))
ONE_ROW_CACHE, ONE_ROW_GEN, ONE_ROW_INT8 = 1024, 8, 8
# phase 4g, tensor-parallel training on 4 ranks over (data 2, model 2)
# (SHARD_MESH): (run, arch, layers kept (None: all), federation, C, b,
# remat, the Δ-SGD kernel route); TPT_K local steps of TPT_SEQ tokens,
# f32, random weights from TPT_SEED; loss and η held to the unsharded
# round's within TPT_REL relative, params within TPT_PARAM_REL·max|p|,
# remat on to remat off within TPT_REMAT_REL·max|p|
TPT_RUNS = (
    ("tinyllama_l11", "tinyllama-1.1b", 11, "cross_device", 2, 2, True,
     False),
    ("tinyllama_kernel", "tinyllama-1.1b", 2, "cross_device", 2, 2,
     False, True),
    ("qwen2.5-14b", "qwen2.5-14b", 1, "cross_silo", 1, 4, False, False),
    ("granite-20b", "granite-20b", 1, "cross_silo", 1, 4, False, False),
    ("tinyllama_l2_remat_off", "tinyllama-1.1b", 2, "cross_device", 2, 2,
     False, False),
    ("tinyllama_l2_remat_on", "tinyllama-1.1b", 2, "cross_device", 2, 2,
     True, False),
    # the MoE and MLA decoders: OLMoE at full width, 2 layers, one
    # client a data rank, on both routes; DeepSeek-V3 at its reduced
    # config (MLA, the shared expert, MTP) with one client's 4 rows
    # over data, so the capacity counts and the aux loss cross data
    ("olmoe_l2", "olmoe-1b-7b", 2, "cross_device", 2, 2, False, False),
    ("olmoe_l2_kernel", "olmoe-1b-7b", 2, "cross_device", 2, 2, False,
     True),
    ("deepseek_reduced_silo", "deepseek-v3-671b", "reduced", "cross_silo",
     1, 4, False, False),
    # Zamba2 at full width cut to 7 layers (6 Mamba2 and the shared
    # block), Whisper whole and InternVL2 at full width cut to 2 layers,
    # with their frames and image embeddings (standard normals from
    # TPT_SEED) beside the tokens
    ("zamba2_l7", "zamba2-7b", 7, "cross_device", 2, 1, False, False),
    ("whisper", "whisper-tiny", None, "cross_device", 2, 2, False, False),
    ("internvl2_l2", "internvl2-1b", 2, "cross_device", 2, 2, False,
     False),
    # xLSTM at full width cut to 4 layers (3 mLSTM, 1 sLSTM), one row a
    # client
    ("xlstm_l4", "xlstm-1.3b", 4, "cross_device", 2, 1, False, False),
)
TPT_K, TPT_SEQ, TPT_SEED = 2, 256, 0
TPT_REL, TPT_PARAM_REL, TPT_REMAT_REL = 1e-4, 1e-5, 1e-6
# xLSTM's local steps are ill-conditioned in f32: its rounds are held at
# tests/test_torch_lm_rounds.py's XLSTM_RTOL (η relative; params as a
# share of a leaf's max|p|), from η₀ = 0.005, where its full-width 4-layer
# round in f32 lies within 2e-5 of its f64 evaluation in every η metric;
# at the default 0.2 it lies 8 % away, at 0.02 4e-4
# (scripts/xlstm_conditioning.py on the H100)
XLSTM_RTOL = {"eta": 1e-4, "params": 1e-3}
TPT_ETA0 = {"xlstm-1.3b": 0.005}
# phase 6c, the MoE and MLA decoders under tensor-parallel serving on 4
# ranks: (run, arch, layers (None: all; "reduced": its reduced config),
# dtype, federation, mesh (data, model), new tokens, whether the ranks
# read the parent's unsharded params through CUDA IPC). OLMoE under
# cross_silo gathers each layer's fsdp dims at use, through the host
# under gloo (about 0.8 GB a layer a rank, 1.2 s): at 4 layers (whole,
# 16, until the smoke's time ran out: 46-48 s of ranks) it decodes one
# step; its multi-step decode gate runs at 2 layers; DeepSeek-V3 at one
# layer and its MTP block at full width is 49.9 GB in bf16: on one card
# only (data 1, model 4) fits, and only with the ranks reading the
# parent's tensors
TPM_RUNS = (
    ("olmoe_l2", "olmoe-1b-7b", 2, "float32", "cross_device", (2, 2), 32,
     False),
    ("olmoe_l2_silo", "olmoe-1b-7b", 2, "float32", "cross_silo", (2, 2), 4,
     False),
    ("deepseek_reduced", "deepseek-v3-671b", "reduced", "float32",
     "cross_silo", (2, 2), 8, False),
    ("olmoe_l4_ipc", "olmoe-1b-7b", 4, "float32", "cross_silo", (2, 2), 1,
     True),
    ("deepseek_l1", "deepseek-v3-671b", 1, "bfloat16", "cross_silo", (1, 4),
     8, True),
)
# the runs with the decode == full forward gate at GATE_CAPACITY_FACTOR
TPM_GATE_RUNS = ("olmoe_l2", "olmoe_l2_silo", "deepseek_reduced")
# a bf16 run against the unsharded bf16 run, as a share of the largest
# value (PERF.md gives the ground): the router's input at each row's
# last position, every step; the logits of each row and step whose
# routing (the K experts of that position) is the unsharded run's. A
# row and step routed otherwise is printed with its near-tie (the
# unsharded router's K-th and (K+1)-th probabilities)
TPM_BF16_REL = 2.0 ** -5
# DeepSeek-V3 reduced: an embedding table shifted by TPM_SHIFT and every
# MoE router's expert-0 column raised by TPM_LEAN, so that the served
# capacity 1.25 drops choices
TPM_SHIFT, TPM_LEAN = 0.02, 0.1
# MoE capacity factor of the decode == full forward gates: prefill of
# B·S tokens and decode of B drop different choices at the served 1.25
# (the reference's tests patch the same 8.0)
GATE_CAPACITY_FACTOR = 8.0


def took(label, t0):
    """Prints the seconds since ``t0`` under ``label``: where the
    script's time goes, a run at a time."""
    print(f"took {label}: {time.perf_counter() - t0:.1f} s", flush=True)


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
    busy, idle = _idle_share(busy, wall)
    tokens = sh["C"] * sh["K"] * sh["b"] * sh["S"]
    print(f"{label} time", json.dumps({
        "card": smi, "round_ms": walls,
        "ms_per_local_step": statistics.median(walls) / sh["K"],
        "tokens_per_round": tokens,
        "image_tokens_per_round": tokens // sh["S"] * cfg.num_image_tokens,
        "train_tokens_per_s": tokens / (statistics.median(walls) / 1e3),
        "profiled_round_ms": wall, "device_busy_ms": busy,
        "idle_share": idle}), flush=True)
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

    t0 = time.perf_counter()
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
    took(f"4e {LM_ARCH}[{LM_CUT['layers']}L]", t0)

    # 2. TinyLlama whole: one fused round, C·N past 2**31; the last row's
    # sums against f64; then (e) its checkpoint served by the serve CLI
    t0 = time.perf_counter()
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
        took(f"4e {LM_ARCH} whole", t0)
        t0 = time.perf_counter()

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
    took("4e the serve CLI on the trained checkpoint", t0)
    t0 = time.perf_counter()

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
    took("4e zamba2-7b", t0)

    # 4. OLMoE at full width, 2 layers: one fused round == its --flat host
    # loop bitwise; the Δ-SGD pair on its slabs; the round's wall
    t0 = time.perf_counter()
    paths.update(_lm_host_fused_path(
        torch, mods, train, tk, tref, bw, f32, smi, rows, MOE_ARCH, LM_MOE,
        "lm_train_olmoe", "lm train olmoe", kernel_rows=True))
    took(f"4e {MOE_ARCH}", t0)
    # 5. DeepSeek-V3 reduced: a round with the MoE aux and the MTP loss
    t0 = time.perf_counter()
    paths["lm_train_deepseek"] = _lm_mla_path(torch, mods, train, smi)
    took(f"4e {MLA_ARCH}", t0)
    # 6. xLSTM (one period), Whisper-tiny and InternVL2-1B (whole): each
    # fused round == its --flat host loop bitwise; InternVL2's slabs give
    # the Δ-SGD pair's rows
    for arch, sh in LM_NEW.items():
        t0 = time.perf_counter()
        short = arch.split("-")[0]
        paths.update(_lm_host_fused_path(
            torch, mods, train, tk, tref, bw, f32, smi, rows, arch, sh,
            f"lm_train_{short}", f"lm train {short}",
            kernel_rows=arch == "internvl2-1b"))
        took(f"4e {arch}", t0)
    return paths, rows


def _lm_host_fused_path(torch, mods, train, tk, tref, bw, f32, smi, rows,
                        arch, sh, key, label, kernel_rows):
    """Phase 4e, ``arch`` at full width cut to ``sh``'s layers: the
    --flat host loop first, then one fused round, bitwise equal, K
    launches of each Δ-SGD kernel each; with ``kernel_rows`` the pair
    held and timed on the fused run's last slabs (added to ``rows``);
    the round's wall, busy and tokens/s. Returns the launch counts by
    run, keyed ``{key}_host`` and ``{key}_fused``."""
    paths = {}
    cfg = _lm_cfg(arch, sh["layers"])
    dsgd = {("batched_norms", "cuda"): sh["K"],
            ("batched_apply", "cuda"): sh["K"]}
    host, launches, hpeak = _lm_train(torch, mods, train, cfg, _lm_args(
        train, sh, 1, "--flat", arch=arch))
    if launches != dsgd:
        raise AssertionError(f"{arch} host loop launched {launches}")
    paths[f"{key}_host"] = launches
    with _LastCall(tk, "batched_norms") as nrm, \
            _LastCall(tk, "batched_apply") as app:
        fused, launches, fpeak = _lm_train(torch, mods, train, cfg, _lm_args(
            train, sh, 1, "--rounds-per-call", "2", arch=arch))
    if launches != dsgd:
        raise AssertionError(f"{arch} fused launched {launches}")
    paths[f"{key}_fused"] = launches
    _state_equal(torch, fused.state, host.state, f"{arch} fused vs host loop")
    for k in fused.history[0]:
        if fused.history[0][k].tobytes() != host.history[0][k].tobytes():
            raise AssertionError(f"{arch} round 0 {k}: fused != host")
    g, gp = nrm.args[0]
    C, N = g.shape
    print(label, json.dumps({
        "card": smi, "arch": f"{arch}[{sh['layers']}L]", "N": N,
        "clients": C, "local_steps": sh["K"], "batch": sh["b"],
        "seq": sh["S"], "image_tokens": cfg.num_image_tokens,
        "encoder_frames": cfg.encoder_seq if cfg.encoder_layers else 0,
        "loss": float(fused.history[0]["loss"]),
        "eta_mean": float(fused.history[0]["eta_mean"]),
        "fused_equals_host_bitwise": True, "peak_gb_host": hpeak,
        "peak_gb_fused": fpeak}), flush=True)
    del fused, host
    torch.cuda.empty_cache()
    if kernel_rows:
        p, eta = app.args[0][0], app.args[0][2]
        rows.update(_lm_kernel_rows(torch, tk, tref, bw, f32, g, gp, p, eta,
                                    smi, f"{key}_fused"))
        del p, eta
    del g, gp, nrm, app
    torch.cuda.empty_cache()
    _lm_round_time(torch, train, cfg, sh, smi, label, arch=arch)
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


def check_lm_kernels(torch, fa, faref, m2, m2ref, bw, f32,
                     fa_cases=FA_CASES, ssd_cases=SSD_CASES):
    """Phase 5 at ``fa_cases`` and ``ssd_cases``. Returns {(name, case):
    row}."""
    import numpy as np
    from repro_torch.kernels.mamba2_scan.ops import chunk_len
    F = torch.nn.functional
    rows = {}
    r = np.random.default_rng(2)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(dtype)

    for case in fa_cases:
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
    for B, S, H, KV, hd, _, dname in fa_cases:
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

    for B, S, H, P, G, N in ssd_cases:
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


def _self_us(events):
    """{name: self µs} of the profiler's raw host events: each event's
    duration less that of the events nested directly in it on its
    thread (the self time ``key_averages`` gives)."""
    from collections import defaultdict
    out = defaultdict(float)
    by_thread = defaultdict(list)
    for e in events:
        by_thread[e.start_thread_id()].append(
            (e.start_ns(), -e.duration_ns(), e.name()))
    for evs in by_thread.values():
        evs.sort()
        stack = []                       # [end, name, self ns]
        for start, neg, name in evs:
            while stack and stack[-1][0] <= start:
                _, n, own = stack.pop()
                out[n] += own / 1e3
            if stack:
                stack[-1][2] += neg      # a child's time is not its parent's
            stack.append([start - neg, name, -neg])
        for _, n, own in stack:
            out[n] += own / 1e3
    return out


def _profile_ms(torch, fn, top=5, tries=PROFILE_TRIES):
    """(wall ms, device busy ms, {top kernels and host ops by time}) of
    one synchronised call of ``fn`` under torch.profiler. It reads the
    profiler's raw events: building its event tree (``prof.events()``)
    takes about 90 µs an event, 15 s for one round of xLSTM. Now and
    then the profiler on this card records no device activity for a
    whole call: ``fn`` is then profiled again, up to ``tries`` calls,
    and after that the wall comes from the host clock and the device
    span from CUDA events, and busy is None (not measured)."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile import busy_us
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        raw = prof.profiler.kineto_results.events()
        events = [e for e in raw if e.device_type() == DeviceType.CUDA]
        if events:
            break
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"profiler: no device activity in {tries} profiled calls; "
              "busy not measured, times from CUDA events", flush=True)
        return wall * 1e3, None, {"device_ops": None,
                                  "device_span_ms": start.elapsed_time(end)}
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name()[:60]] += e.duration_ns() / 1e6
    host = _self_us([e for e in raw if e.device_type() == DeviceType.CPU
                     and not e.is_async()])
    split = {"device_ops": len(events),
             "top_kernels_ms": dict(sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:top]),
             "top_host_ops_self_ms": {
                 k[:60]: v / 1e3 for k, v in sorted(
                     host.items(), key=lambda kv: -kv[1])[:top]}}
    return (wall * 1e3,
            busy_us([(e.start_ns() / 1e3,
                      (e.start_ns() + e.duration_ns()) / 1e3)
                     for e in events]) / 1e3, split)


def _idle_share(busy, wall, per=1):
    """(busy / per, 1 - busy / wall), or (None, None) where the profiler
    measured no busy time (``_profile_ms``)."""
    return (None, None) if busy is None else (busy / per, 1 - busy / wall)


def _host_ms(torch, fn, n):
    """Median host-clock ms of ``n`` synchronised calls of ``fn``."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _extras_batch(torch, extras, rows):
    """The requests' extras (a list of {name: array} or None) of ``rows``
    stacked into batch tensors on the card; {} without extras."""
    import numpy as np
    if not extras or extras[0] is None:
        return {}
    return {k: torch.from_numpy(np.stack([extras[i][k] for i in rows])
                                ).cuda() for k in extras[0]}


def _decode_matches_full(torch, model, params, seq, prompt, name,
                         extras=None):
    """Every generated position's decode logits (a lockstep prefill of
    ``prompt`` tokens, with the rows' extras, then decode_step) against
    the teacher-forced full forward of ``seq``, within 2e-3, with the
    MoE capacity factor at GATE_CAPACITY_FACTOR and put back after."""
    from repro_torch.models import moe
    V = model.cfg.vocab_size
    gen = seq.shape[1] - prompt
    ex = extras or {}
    factor = moe.CAPACITY_FACTOR
    moe.CAPACITY_FACTOR = GATE_CAPACITY_FACTOR
    try:
        full, _ = model.apply(params, {"tokens": seq[:, :-1], **ex})
        logits, cache = model.prefill(
            params, {"tokens": seq[:, :prompt], **ex},
            cache_len=seq.shape[1] + model.cfg.num_image_tokens)
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


def _engine_matches_lockstep(torch, model, params, prompts, gen, name,
                             extras=None):
    """Each prompt prefilled alone (B = 1, as the engine admits, with
    its extras), the rows decoded together in lockstep: -> (B, gen)
    greedy tokens; every logit finite."""
    import numpy as np
    from repro_torch.utils.tree import tree_map
    cache_len = prompts.shape[1] + gen + model.cfg.num_image_tokens
    caches, first = [], []
    for i, p in enumerate(prompts):
        lg, c = model.prefill(params, {
            "tokens": torch.from_numpy(p[None]).cuda(),
            **_extras_batch(torch, extras, [i])}, cache_len=cache_len)
        caches.append(c)
        first.append(lg)
    cache = {"runs": tree_map(lambda *xs: torch.cat(xs, 1),
                              *[c["runs"] for c in caches]),
             "t": caches[0]["t"], "positions": caches[0]["positions"]}
    if "enc_kv" in caches[0]:
        cache["enc_kv"] = tree_map(lambda *xs: torch.cat(xs, 1),
                                   *[c["enc_kv"] for c in caches])
    del caches
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
    from repro_torch.launch.serve import _row_extras
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
    # MLA runs no flash attention: its qk head dim passes the kernel's;
    # the Whisper encoder's attention is non-causal and runs plain
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
    cache_len = cfg.num_image_tokens + SERVE_PROMPT + SERVE_GEN
    total = {}
    for n_req in SERVE_RUNS:
        prompts = rng.integers(0, cfg.vocab_size, (n_req, SERVE_PROMPT))
        # each request's frames or image embeddings, after the prompts
        extras = [_row_extras(cfg, rng) for _ in prompts]
        engine = DecodeEngine(model, params, slots=SERVE_SLOTS,
                              cache_len=cache_len, flush_tokens=SERVE_FLUSH)
        _reset(mods)
        t0 = time.perf_counter()
        rids = [engine.submit(p, SERVE_GEN, extras=ex)
                for p, ex in zip(prompts, extras)]
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
            "image_tokens": cfg.num_image_tokens,
            "encoder_frames": cfg.encoder_seq if cfg.encoder_layers else 0,
            "flush_tokens": SERVE_FLUSH, "flushes": engine.stats["flushes"],
            "wall_s": wall, "tok_per_s": n_req * SERVE_GEN / wall,
            "occupancy_mean": engine.metrics()["serve_occupancy_mean"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {f"{k}/{d}": v for (k, d), v in launches.items()}}),
            flush=True)
        if n_req == SERVE_RUNS[0]:
            first = (prompts, gen, engine, extras)

    prompts, gen, engine, extras = first
    seq = torch.from_numpy(np.concatenate([prompts, gen], 1)).cuda()
    ex_all = _extras_batch(torch, extras, range(len(prompts)))
    if dtype != torch.float32 or arch in CHECK_DEPTH_GATES:
        # the engine's tokens are a lockstep loop's, bit for bit
        lock = _engine_matches_lockstep(torch, model, params, prompts,
                                        SERVE_GEN, name, extras)
        if not np.array_equal(lock, gen):
            raise AssertionError(f"serve {name}: engine tokens differ from "
                                 "the lockstep loop's")
    if dtype == torch.float32 and arch not in CHECK_DEPTH_GATES:
        # prefill and decode agree: every generated position's decode
        # logits against the teacher-forced full forward
        _decode_matches_full(torch, model, params, seq, SERVE_PROMPT, name)

    # where the time goes: one prefill (B = 1) and one decode block of
    # SERVE_FLUSH steps over the full pool
    one = {"tokens": seq[:1, :SERVE_PROMPT], **_extras_batch(torch, extras,
                                                              [0])}
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
    pre_busy, pre_idle = _idle_share(pre_busy, pre_wall)
    blk_busy, blk_idle = _idle_share(blk_busy, blk_wall, SERVE_FLUSH)
    print(f"serve {name} time", json.dumps({
        "card": smi, "prefill_ms": pre_ms, "prefill_tokens": SERVE_PROMPT,
        "prefill_positions": SERVE_PROMPT + cfg.num_image_tokens,
        "prefill_device_busy_ms": pre_busy,
        "prefill_idle_share": pre_idle,
        "decode_block_ms": blk_ms, "decode_ms_per_step": blk_ms / SERVE_FLUSH,
        "decode_rows": SERVE_SLOTS,
        "decode_device_busy_ms_per_step": blk_busy,
        "decode_idle_share": blk_idle}), flush=True)
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
    if arch in CHECK_DEPTH_GATES:
        _decode_matches_full(torch, model, params, seq, SERVE_PROMPT,
                             f"{arch}[{small.num_layers}L]", ex_all)
    batch = {"tokens": seq[:2, :SERVE_PROMPT],
             **{k: v[:2] for k, v in ex_all.items()}}
    card, _ = model.prefill(params, batch)
    card_full, _ = model.apply(params, batch)
    params = tree_map(lambda a: a.cpu(), params)
    batch = {k: v.cpu() for k, v in batch.items()}
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


def _pool_replay(torch, model, params_at, prompts, gen, cache_len):
    """Each prompt prefilled alone (B = 1, as the engine admits) into its
    row of a SERVE_SLOTS-row pool, then every row decoded together with
    token j's step under ``params_at(j)`` (j = 0: the prefill): -> the
    prompts' (n, gen) greedy tokens. The pool's other rows decode beside
    them, as the engine's masked rows do: at the pool's width, the bits
    of a row depend on no other row."""
    import numpy as np
    from repro_torch.utils.tree import tree_map
    S = SERVE_SLOTS
    cache = model.init_cache(S, cache_len, device="cuda")
    cache["t"] = torch.zeros((S,), dtype=torch.int32, device="cuda")
    cache["positions"] = torch.full((S, cache_len), -1, dtype=torch.int32,
                                    device="cuda")
    tok = torch.zeros((S, 1), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts):
        lg, c1 = model.prefill(params_at(0), {
            "tokens": torch.from_numpy(np.asarray(p)[None]).cuda()},
            cache_len=cache_len)
        tree_map(lambda pl, cl: pl[:, i].copy_(cl[:, 0]), cache["runs"],
                 c1["runs"])
        cache["t"][i] = c1["t"]
        cache["positions"][i] = c1["positions"]
        tok[i] = torch.argmax(lg[:, -1:], dim=-1)[0]
    out = [tok]
    for j in range(1, gen):
        lg, cache = model.decode_step(params_at(j), cache, tok)
        tok = torch.argmax(lg, dim=-1)
        out.append(tok)
    return torch.cat(out, 1)[:len(prompts)].cpu().numpy()


class _OneCopyPerFlush:
    """Counts ``Tensor.cpu`` calls and refuses any other host read of a
    tensor while active (the engine's one device-to-host copy a flush)."""
    REFUSED = ("item", "tolist", "__int__", "__float__", "__bool__",
               "__index__")

    def __init__(self, torch):
        self.torch, self.copies = torch, 0

    def __enter__(self):
        T = self.torch.Tensor
        self.saved = {n: getattr(T, n) for n in ("cpu",) + self.REFUSED}
        cpu = self.saved["cpu"]

        def count(t, *a, **k):
            self.copies += 1
            return cpu(t, *a, **k)

        def refuse(t, *a, **k):
            raise AssertionError("the engine read a tensor on the host")
        T.cpu = count
        for n in self.REFUSED:
            setattr(T, n, refuse)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.torch.Tensor, n, f)


def _plane_swap(torch, mods, smi, model, params, p2, tmp):
    """6b part 1: the hot swap through a ModelRegistry on ``tmp``."""
    import numpy as np
    from repro_torch.checkpoint import save
    from repro_torch.serving import DecodeEngine, ModelRegistry
    from repro_torch.utils.tree import tree_leaves
    cache_len = PLANE_PROMPT + PLANE_GEN
    t0 = time.perf_counter()
    save(tmp, {"params": params, "round": 1}, step=1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = DecodeEngine(model, params, slots=SERVE_SLOTS,
                          cache_len=cache_len, flush_tokens=SERVE_FLUSH,
                          registry=ModelRegistry(tmp, params))
    start_s = time.perf_counter() - t0
    if engine.version != 1:
        raise AssertionError(f"serving plane: version {engine.version} "
                             "after the start-up poll, not 1")
    prompts = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, PLANE_PROMPT))
    _reset(mods)
    rids = [engine.submit(p, PLANE_GEN) for p in prompts]
    engine.step()
    save(tmp, {"params": p2, "round": 2}, step=2)
    done = {c.request_id: c for c in engine.run_until_idle()}
    torch.cuda.synchronize()
    launches = _counts(mods)
    m = engine.metrics()
    versions = [h["version"] for h in engine.history]
    if (m["serve_swaps_total"] != 1 or m["kv_reuse_swaps"] != 1
            or versions[:2] != [1, 2] or set(versions[1:]) != {2}
            or any(done[r].versions != (1, 2) for r in rids)):
        raise AssertionError(f"serving plane swap: metrics {m}, versions "
                             f"{versions}, completions "
                             f"{[done[r].versions for r in rids]}")
    if not all(t.is_cuda and torch.equal(t, w) for t, w in zip(
            tree_leaves(engine._params), tree_leaves(p2))):
        raise AssertionError("serving plane swap: the staged step 2 is "
                             "not the saved params on the card")
    want = {("flash_attention", "cuda"): len(rids) * model.cfg.num_layers}
    if launches != want:
        raise AssertionError(f"serving plane swap launched {launches}, "
                             f"expected {want}")
    # token j >= 1 comes from flush (j - 1) // SERVE_FLUSH: the first
    # flush under step 1, the rest under step 2, on the same cache
    replay = _pool_replay(
        torch, model, lambda j: params if j <= SERVE_FLUSH else p2,
        prompts, PLANE_GEN, cache_len)
    if not np.array_equal(replay, np.stack([done[r].tokens for r in rids])):
        raise AssertionError("serving plane swap: the engine's tokens "
                             "differ from the pool-width replay's")
    print("serving plane swap", json.dumps({
        "card": smi, "arch": f"{PLANE_ARCH}[{model.cfg.num_layers}L]",
        "requests": len(rids), "flushes": engine.stats["flushes"],
        "versions": versions, "swap_stall_s": m["serve_swap_stall_max"],
        "stall_holds": "restore_params of the step to the card and the "
                       "wait to the flush boundary",
        "checkpoint_gb": sum(t.numel() * t.element_size()
                             for t in tree_leaves(params)) / 1e9,
        "checkpoint_save_s": save_s, "start_with_restore_s": start_s,
        "kv_reuse_swaps": m["kv_reuse_swaps"],
        "tokens_equal_replay": True,
        "launches": {f"{k}/{d}": n for (k, d), n in launches.items()}}),
        flush=True)
    return launches


def _plane_personalized(torch, mods, smi, model, params):
    """6b part 2: one client's overlay beside the global params."""
    import numpy as np
    from repro_torch.core.flat import pack, unpack
    from repro_torch.serving import DecodeEngine, PersonalizationStore
    cache_len = PLANE_PROMPT + PLANE_GEN
    torch.cuda.reset_peak_memory_stats()
    store = PersonalizationStore(params, scale=PLANE_SCALE)
    N = store.layout.padded_size
    delta = torch.randn((N,), generator=torch.Generator(
        device="cuda").manual_seed(7), device="cuda")
    store.set_delta(7, delta)
    engine = DecodeEngine(model, params, slots=SERVE_SLOTS,
                          cache_len=cache_len, flush_tokens=SERVE_FLUSH,
                          personalization=store)
    prompt = np.random.default_rng(2).integers(0, model.cfg.vocab_size,
                                               PLANE_PROMPT)
    rids = [engine.submit(prompt, PLANE_GEN, client_id=c)
            for c in (7, None, 9)]
    _reset(mods)
    copies = []
    t0 = time.perf_counter()
    with _OneCopyPerFlush(torch) as one:
        while engine.has_work():
            before = one.copies
            engine.step()
            copies.append(one.copies - before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(mods)
    peak = torch.cuda.max_memory_allocated() / 1e9
    done = {c.request_id: c.tokens for c in engine.completed}
    groups = [h["groups"] for h in engine.history]
    if any(g != {7: [0], None: [1, 2]} for g in groups) or \
            set(copies) != {1}:
        raise AssertionError(f"serving plane personalized: groups {groups}"
                             f", copies a flush {copies}")
    want = {("flash_attention", "cuda"): len(rids) * model.cfg.num_layers}
    if launches != want:
        raise AssertionError(f"serving plane personalized launched "
                             f"{launches}, expected {want}")
    over = unpack(pack(params, store.layout) + PLANE_SCALE * delta,
                  store.layout)
    mine = _pool_replay(torch, model, lambda j: over, [prompt],
                        PLANE_GEN, cache_len)[0]
    glob = _pool_replay(torch, model, lambda j: params, [prompt],
                        PLANE_GEN, cache_len)[0]
    t7, tg, t9 = (done[r] for r in rids)
    if not (np.array_equal(t7, mine) and np.array_equal(tg, glob)
            and np.array_equal(t9, glob) and not np.array_equal(t7, tg)):
        raise AssertionError("serving plane personalized: the tokens are "
                             "not the overlay's and the global params' "
                             "pool-width replays, or they do not differ")
    print("serving plane personalized", json.dumps({
        "card": smi, "arch": f"{PLANE_ARCH}[{model.cfg.num_layers}L]",
        "padded_size": N, "scale": PLANE_SCALE,
        "flushes": engine.stats["flushes"], "groups_per_flush": 2,
        "copies_per_flush": 1, "wall_s": wall, "peak_gb": peak,
        "tokens_equal_replays": True, "personalized_differs": True,
        "launches": {f"{k}/{d}": n for (k, d), n in launches.items()}}),
        flush=True)
    del store, delta, over, engine
    return launches


def _plane_cli(torch, mods, smi, tmp, arrival):
    """6b part 3: the serve CLI with a watched --ckpt-dir, the load
    generator and --events."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.telemetry import load_events
    events = f"{tmp}/events_{arrival}.jsonl"
    flags = PLANE_CLI + ["--ckpt-dir", tmp, "--loadgen", str(PLANE_LOADGEN),
                         "--arrival", arrival, "--events", events]
    # no --personalize: the CLI draws a client's delta on the host (1.1e9
    # normals, about 30 s a run on the H100's host); part 2 holds the
    # personalized overlay on the card
    if arrival == "poisson":
        flags += ["--rate", str(PLANE_RATE)]
    _reset(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.run(serve.build_parser().parse_args(flags))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(mods)
    rep = out["report"]
    _, rows = load_events(events)
    kinds = [r["kind"] for r in rows]
    flushes = len(out["history"])
    if (rep["requests"] != PLANE_LOADGEN
            or not rep["p99_s"] >= rep["p50_s"] > 0
            or not 0 < rep["occupancy"] <= 1
            or kinds.count("serve_flush") != flushes
            or kinds.count("serve_load") != 1 or out["ckpt_step"] != 2):
        raise AssertionError(f"serving plane CLI ({arrival}): report {rep}, "
                             f"{kinds.count('serve_flush')} flush rows for "
                             f"{flushes} flushes, "
                             f"{kinds.count('serve_load')} load rows")
    want = {("flash_attention", "cuda"): (PLANE_LOADGEN + PLANE_BATCH)
            * get_config(PLANE_ARCH).num_layers}
    if launches != want:
        raise AssertionError(f"serving plane CLI ({arrival}) launched "
                             f"{launches}, expected {want}")
    print(f"serving plane CLI {arrival}", json.dumps({
        "card": smi, "flags": " ".join("F" if f == events else f
                                       for f in flags),
        "requests": rep["requests"], "tok_per_s": rep["tok_per_s"],
        "p50_s": rep["p50_s"], "p99_s": rep["p99_s"],
        "occupancy": rep["occupancy"], "load_wall_s": rep["wall_s"],
        "demo_tok_per_s": out["tok_per_s"], "flushes": flushes,
        "cli_wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated()
        / 1e9, "launches": {f"{k}/{d}": n for (k, d), n in
                            launches.items()}}), flush=True)
    return launches


def _quant_decode(torch, model, params, prompts, quant, device):
    """QUANT_PROMPT teacher-forced decode steps of ``prompts`` from an
    empty cache, then QUANT_GEN greedy ones -> (logits (steps, B, V),
    greedy tokens (B, QUANT_GEN), the cache)."""
    V = model.cfg.vocab_size
    cache = model.init_cache(QUANT_ROWS, QUANT_PROMPT + QUANT_GEN,
                             device=device, quant_kv=quant)
    toks = torch.from_numpy(prompts).to(device)
    logits, gen = [], []
    for j in range(QUANT_PROMPT + QUANT_GEN):
        tok = toks[:, j:j + 1] if j < QUANT_PROMPT else gen[-1]
        lg, cache = model.decode_step(params, cache, tok)
        logits.append(lg[:, 0, :V])
        if j >= QUANT_PROMPT - 1 and len(gen) < QUANT_GEN:
            gen.append(torch.argmax(lg[:, :, :V], dim=-1))
    return torch.stack(logits), torch.cat(gen, 1), cache


def _plane_int8(torch, mods, smi, model, params):
    """6b part 4: the int8 KV cache against the f32 one, and the card's
    int8 decode against the CPU's at 2 layers."""
    import dataclasses
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, model.cfg.vocab_size,
                           (QUANT_ROWS, QUANT_PROMPT))
    _reset(mods)
    lq, gq, cq = _quant_decode(torch, model, params, prompts, True, "cuda")
    lf, gf, cf = _quant_decode(torch, model, params, prompts, False, "cuda")
    torch.cuda.synchronize()
    launches = _counts(mods)
    if launches:
        raise AssertionError(f"the int8 decode launched {launches}")
    leaves = cq["runs"]["run0"]
    if (leaves["k"].dtype != torch.int8 or leaves["v"].dtype != torch.int8
            or leaves["k_scale"].dtype != torch.float16
            or leaves["v_scale"].dtype != torch.float16):
        raise AssertionError("the int8 cache's leaves are "
                             f"{ {k: v.dtype for k, v in leaves.items()} }")
    if not (bool(torch.isfinite(lq).all()) and bool(torch.isfinite(lf).all())):
        raise AssertionError("the int8 or f32 decode logits are not finite")
    # the inputs agree through the prompt and while both greedy runs do
    same = int((gq == gf).all(0).int().cumprod(0).sum())
    n = QUANT_PROMPT + same
    gap = float((lq[:n] - lf[:n]).abs().max())
    top = float(lf[:n].abs().max())
    if not 0 < gap <= QUANT_KV_TOL * top:
        raise AssertionError(f"int8 vs f32 decode logits: gap {gap}, "
                             f"largest f32 logit {top}")

    def nbytes(c):
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(c["runs"]))
    tok = gf[:, -1:]
    q_ms = _host_ms(torch, lambda: model.decode_step(params, cq, tok), 10)
    f_ms = _host_ms(torch, lambda: model.decode_step(params, cf, tok), 10)
    q_bytes, f_bytes = nbytes(cq), nbytes(cf)
    del lq, lf, cq, cf

    # the card's int8 decode is the CPU's at 2 layers, full width
    small = dataclasses.replace(model.cfg, num_layers=2)
    m2_ = build_model(small)
    p_card = m2_.init(torch.Generator(device="cuda").manual_seed(1))
    p_cpu = tree_map(lambda a: a.cpu(), p_card)
    card, g_card, _ = _quant_decode(torch, m2_, p_card, prompts, True,
                                    "cuda")
    host, g_host, _ = _quant_decode(torch, m2_, p_cpu, prompts, True, "cpu")
    same2 = int((g_card.cpu() == g_host).all(0).int().cumprod(0).sum())
    n2 = QUANT_PROMPT + same2
    gap2 = float((card.cpu()[:n2] - host[:n2]).abs().max())
    top2 = float(host[:n2].abs().max())
    if not gap2 <= QUANT_KV_TOL * top2:
        raise AssertionError(f"int8 decode card vs CPU at 2 layers: gap "
                             f"{gap2}, largest CPU logit {top2}")
    print("serving plane int8 kv", json.dumps({
        "card": smi, "arch": f"{PLANE_ARCH}[{model.cfg.num_layers}L]",
        "rows": QUANT_ROWS, "cache_len": QUANT_PROMPT + QUANT_GEN,
        "int8_cache_bytes": q_bytes, "f32_cache_bytes": f_bytes,
        "int8_decode_ms_per_step": q_ms, "f32_decode_ms_per_step": f_ms,
        "steps_compared": n, "greedy_steps_agreeing": same,
        "max_abs_gap_int8_vs_f32": gap, "largest_f32_logit": top,
        "tolerance": f"{QUANT_KV_TOL} x largest f32 logit",
        "card_vs_cpu_2L_gap": gap2, "card_vs_cpu_2L_largest": top2,
        "card_vs_cpu_2L_steps_compared": n2}), flush=True)
    return launches


def run_serving_plane(torch, mods, smi):
    """Phase 6b. Returns {path: launch counts}."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    model = build_model(get_config(PLANE_ARCH))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    p2 = model.init(torch.Generator(device="cuda").manual_seed(1))
    paths = {}
    took("6b init", t0)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        paths["serve_plane_swap"] = _plane_swap(torch, mods, smi, model,
                                                params, p2, tmp)
        del p2
        torch.cuda.empty_cache()
        took("6b swap", t1)
        t1 = time.perf_counter()
        paths["serve_plane_personalized"] = _plane_personalized(
            torch, mods, smi, model, params)
        torch.cuda.empty_cache()
        took("6b personalized", t1)
        for arrival in ("closed", "poisson"):
            t1 = time.perf_counter()
            paths[f"serve_plane_cli_{arrival}"] = _plane_cli(
                torch, mods, smi, tmp, arrival)
            torch.cuda.empty_cache()
            took(f"6b CLI {arrival}", t1)
    t1 = time.perf_counter()
    paths["serve_plane_int8"] = _plane_int8(torch, mods, smi, model, params)
    took("6b int8", t1)
    del params
    torch.cuda.empty_cache()
    print(f"serving plane: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 4f, multi-device Δ-SGD: world-4 ranks over (data 2, model 2)
# ---------------------------------------------------------------------------

def _shard_task(train, device):
    """Phase 4's CNN federation on ``device`` and its pipeline's first
    SHARD_ROUNDS rounds: (task, [(batches (C, K, b, ...) numpy, weights)])."""
    args = train.build_parser().parse_args(TRAIN_ARGS + ["--device", device])
    pt = train.setup_paper_task(args)
    data = [pt.fed.sample_round(pt.participation, pt.local_steps, args.batch,
                                round_idx=t)[:2]
            for t in range(SHARD_ROUNDS)]
    return pt, data


def _to_dev(torch, tree, device):
    return {k: torch.from_numpy(v).to(device) for k, v in tree.items()}


def _shard_round_case(torch, pt, data, mesh, fed, device, scenario=None,
                      compression=None, sharded=True):
    """SHARD_ROUNDS rounds of the flat engine from pt.params; sharded on
    the rank's block, else whole -> (state, metric rows, per-round
    (launches on the card, collectives), the EF21 slab after each round
    (numpy; none without EF21))."""
    from repro_torch.core import init_fl_state, make_fl_round
    from repro_torch.core.flat import local_clients
    from repro_torch.sharding import hlo
    kw = dict(mesh=mesh, federation=fed) if sharded else {}
    rnd = make_fl_round(pt.loss_fn, pt.client_opt, pt.server_opt,
                        num_rounds=ROUNDS, flat=True, scenario=scenario,
                        compression=compression, **kw)
    C = data[0][0]["y"].shape[0]
    state = init_fl_state(pt.params, pt.server_opt, scenario,
                          compression=compression, cohort=C, **kw)
    rows, counts, efs = [], [], []
    for batches, _ in data:
        b = _to_dev(torch, batches, device)
        if sharded:
            b = {k: local_clients(v, mesh, fed) for k, v in b.items()}
        _reset(_shard_mods())
        hlo.reset()
        state, m, _ = rnd(state, b)
        rows.append({k: v.detach().cpu().numpy() for k, v in m.items()})
        launches = _counts(_shard_mods())
        counts.append((launches.get(("batched_norms", "cuda"), 0)
                       + launches.get(("batched_apply", "cuda"), 0),
                       hlo.snapshot(), launches))
        if state.ef is not None:
            efs.append(state.ef.detach().cpu().numpy())
    return state, rows, counts, efs


def _shard_mods():
    """The kernel namespaces a sharded round reaches."""
    from repro_torch.kernels.compress import compress as tcomp
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.robust_agg import robust_agg as tra
    return (tk, tcomp, tra)


def _add_counts(total, launches):
    for key, n in launches.items():
        if key[1] == "cuda" and n:
            total[key] = total.get(key, 0) + n
    return total


def _shard_flat_max(torch, a, b):
    """max |a - b| and max |b| over two param trees."""
    d = max(float((a[k][j].float() - b[k][j].float()).abs().max())
            for k in a for j in a[k])
    m = max(float(b[k][j].float().abs().max()) for k in b for j in b[k])
    return d, m


def _shard_step_gate(torch, mesh, fed, dev, masked, lines, total):
    """The sharded step against the card's unsharded step, 3 steps at
    (10, N) with N the CNN's packed size at shards=2."""
    import numpy as np
    from repro_torch.core import flat as flatlib
    from repro_torch.core.delta_sgd import (flat_delta_sgd_init,
                                            flat_delta_sgd_step,
                                            flat_delta_sgd_step_sharded)
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.sharding import hlo
    C = MAIN_SHAPE[0]
    N = flatlib._padded(MAIN_SHAPE[1], fed.flat_shards(mesh))
    rng = np.random.default_rng(7)
    P0 = torch.from_numpy(rng.normal(size=(C, N)).astype(np.float32))
    Gs = [torch.from_numpy(rng.normal(size=(C, N)).astype(np.float32))
          for _ in range(3)]
    mask = None
    if masked:
        mask = torch.zeros(N)
        mask[:N // 3] = 1.0
    layout = flatlib.FlatLayout(None, (), N, N, fed.flat_shards(mesh))
    kw = dict(gamma=2.0, delta=0.1, eta0=0.2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    P = flatlib.local_slab(P0, mesh, fed).to(dev)
    mloc = None if mask is None else flatlib.local_slab(mask, mesh,
                                                        fed).to(dev)
    S = flat_delta_sgd_init(C, layout, eta0=0.2, theta0=1.0, device=dev,
                            mesh=mesh, federation=fed)
    tk.reset_launch_count()
    hlo.reset()
    for G in Gs:
        P, S = flat_delta_sgd_step_sharded(
            P, flatlib.local_slab(G, mesh, fed).to(dev), S, mesh=mesh,
            pspec=fed.flat_spec(mesh), mask=mloc, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(tk.LAUNCHES)
    ops = hlo.snapshot()
    Pu, Su = P0.to(dev), flat_delta_sgd_init(
        C, flatlib.FlatLayout(None, (), N, N, 1), eta0=0.2, theta0=1.0,
        device=dev)
    for G in Gs:
        Pu, Su = flat_delta_sgd_step(Pu, G.to(dev), Su, mask=None if mask
                                     is None else mask.to(dev), **kw)
    want = flatlib.local_slab(Pu, mesh, fed)
    gap = (P - want).abs()
    scale = float(want.abs().max())
    bf16_flips = 0
    if mloc is not None:
        # a bf16-rounded element may round to the next bf16 value (one
        # ulp, <= 2^-7 of the larger) a step when η differs in its last
        # f32 bit (the sums' order differs)
        on = mloc.bool()[None].expand_as(gap)
        bf16_flips = int((gap[on] > 0).sum())
        top = torch.maximum(want.abs(), P.abs())[on]
        if bool((gap[on] > len(Gs) * 2.0 ** -7 * top).any()):
            raise AssertionError("sharded step (masked): a bf16 element "
                                 "moved more than one bf16 ulp a step")
        gap = gap.masked_fill(on, 0.0)
    err = float(gap.max())
    eta_want = flatlib.local_clients(Su.eta, mesh, fed)
    eta_err = float(((S.eta - eta_want).abs() / eta_want.abs()).max())
    what = "masked" if masked else "f32"
    if err > 1e-5 * scale or eta_err > 1e-5:
        raise AssertionError(f"sharded step ({what}): params err {err} "
                             f"(max |p| {scale}), eta rel err {eta_err}")
    if launches != {("batched_norms", "cuda"): 3,
                    ("batched_apply", "cuda"): 3}:
        raise AssertionError(f"sharded step ({what}) launched {launches}")
    C_loc = P.shape[0]
    if [(o.kind, o.shape, o.axes) for o in ops] != [
            ("all-reduce", (2, C_loc), ("model",))] * 3:
        raise AssertionError(f"sharded step ({what}) collectives {ops}")
    from repro_torch.sharding.hlo import (assert_peak_below_global,
                                          assert_peak_within_local)
    mem = assert_peak_below_global(peak, C, N)
    loc = assert_peak_within_local(peak, *P.shape, slabs=5)
    lines.append(json.dumps({
        "sharded step": what, "local_slab": list(P.shape), "N": N,
        "max_abs_err_f32_elements": err, "max_abs_p": scale,
        "bf16_elements_one_ulp_apart": bf16_flips, "eta_max_rel_err": eta_err,
        "launches": 6, "collectives": len(ops), "peak_bytes": peak,
        "peak_local_slabs": loc["local_slabs"],
        "global_slab_bytes": mem["global_bytes"]}))
    _add_counts(total, launches)


def _shard_case_specs():
    from repro_torch.federation import get_scenario
    return {"int8_ef21": (None, dict(kind="int8", error_feedback=True)),
            "topk": (None, dict(kind="topk")),
            "trimmed": (get_scenario("dirichlet_dropouts",
                                     robust_agg="trimmed"), None),
            "clip": (get_scenario("sync_iid", byzantine_rate=0.3,
                                  robust_agg="clip"), None)}


def _check_round_counts(rows, counts, C_loc, shards, fed, mesh, C, N,
                        robust, what):
    from repro_torch.core.sharded import round_collectives
    from repro_torch.sharding import hlo
    ca, _ = fed.flat_axes(mesh)
    for t, (launches, ops, _) in enumerate(counts):
        if launches != 2 * K:
            raise AssertionError(f"{what} round {t}: {launches} Δ-SGD "
                                 f"launches on the card, expected {2 * K}")
        skipped = bool(rows[t].get("round_skipped", 0.0))
        want = round_collectives(C_loc, K, shards, client_axes=bool(ca),
                                 robust=robust, skipped=skipped)
        if len(ops) != want:
            raise AssertionError(f"{what} round {t}: {len(ops)} "
                                 f"collectives, expected {want}: {ops}")
        hlo.assert_flat_buffer_sharded(ops, C, N)
        if ca and C_loc >= 2:
            hlo.assert_no_fullprec_delta_collective(ops, C, N, mesh=mesh,
                                                    federation=fed)
    total = {}
    for c in counts:
        _add_counts(total, c[2])
    return total


def _shard_cases(torch, train, mesh, device):
    """The compressed and robust rounds (cross_device) -> ({case: metric
    rows}, {"<case>.P": the round-end packed params, "<case>.ef<t>": the
    rank's EF21 slab after round t} numpy, {(kernel, "cuda"):
    launches})."""
    from repro_torch.compression import CompressionSpec
    from repro_torch.core import flat as flatlib
    from repro_torch.sharding.spec import get_federation_spec
    pt, data = _shard_task(train, device)
    fed = get_federation_spec("cross_device", mesh)
    shards = fed.flat_shards(mesh)
    C = data[0][0]["y"].shape[0]
    N = flatlib.layout_of(pt.params, shards=shards).padded_size
    C_loc = C // fed.clients_on(mesh)
    out, states, n = {}, {}, {}
    for name, (scn, comp) in _shard_case_specs().items():
        comp = CompressionSpec(**comp) if comp else None
        st, rows, counts, efs = _shard_round_case(torch, pt, data, mesh,
                                                  fed, device, scn, comp)
        robust = None
        if scn is not None and (scn.faulty or scn.robust or scn.quorum > 0):
            robust = scn.robust_model.kind
        if device == "cuda":
            _add_counts(n, _check_round_counts(rows, counts, C_loc, shards,
                                               fed, mesh, C, N, robust,
                                               name))
        out[name] = rows
        states[f"{name}.P"] = flatlib.pack(st.params, flatlib.layout_of(
            st.params, shards=shards)).detach().cpu().numpy()
        states.update({f"{name}.ef{t}": ef for t, ef in enumerate(efs)})
    return out, states, n


def _shard_lm_parts(kind, guarded):
    """(model, FLConfig, scenario, compression) of a 4f LM round."""
    from repro_torch.compression import CompressionSpec
    from repro_torch.configs import FLConfig
    from repro_torch.federation import get_scenario
    from repro_torch.models.model import build_model
    model = build_model(_lm_cfg(LM_ARCH, SHARD_LM_LAYERS))
    fl = FLConfig(local_steps=TPT_K, flat_engine=True)
    if not guarded:
        return model, fl, None, None
    return (model, fl, get_scenario("dirichlet_dropouts",
                                    robust_agg="trimmed"),
            CompressionSpec(kind="int8", error_feedback=True))


def _shard_lm_batch(torch, C, vocab, device):
    """A round's (C, K, b, S) tokens and labels, from TPT_SEED."""
    import numpy as np
    toks = np.random.default_rng(TPT_SEED).integers(
        0, vocab, (C, TPT_K, SHARD_LM_B, SHARD_LM_SEQ + 1))
    t = torch.from_numpy(toks).to(device)
    return {"tokens": t[..., :-1], "labels": t[..., 1:]}


def _shard_lm_run(torch, mesh, dev, kind, C, guarded):
    """One rank's LM round of 4f through the entry points a caller
    uses: the flat round on the mesh under the training rules ->
    (model, spec, rules, layout, state, metrics, seconds, peak bytes,
    the recorder's ops)."""
    from repro_torch.core import flat as flatlib
    from repro_torch.core import init_fl_state
    from repro_torch.launch.steps import (make_train_step,
                                          place_train_for_rank, train_rules)
    from repro_torch.models.common import logical_rules
    from repro_torch.sharding import dist, hlo
    from repro_torch.sharding.spec import get_federation_spec
    model, fl, scn, comp = _shard_lm_parts(kind, guarded)
    spec = get_federation_spec(kind, mesh)
    params = model.init(torch.Generator(device=dev).manual_seed(TPT_SEED))
    rules = train_rules(model, mesh, params, spec=spec)
    step, sopt, scn, comp = make_train_step(
        model, fl, flat=True, mesh=mesh, federation=spec, scenario=scn,
        compression=comp)
    state = init_fl_state(params, sopt, scn, comp, cohort=C, mesh=mesh,
                          federation=spec)
    batch = place_train_for_rank(rules, batch=_shard_lm_batch(
        torch, C, model.cfg.vocab_size, dev))["batch"]
    layout = flatlib.layout_of(params, shards=spec.flat_shards(mesh))
    del params
    dist.all_reduce(torch.zeros(1, device=dev), mesh, ("data", "model"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hlo.reset()
    t0 = time.perf_counter()
    with logical_rules(rules):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del batch
    return (model, spec, rules, scn, layout, state, m, secs, peak,
            hlo.snapshot())


def _shard_lm_rank(torch, mesh, dev, kind, C, guarded, out_dir, rank):
    """One rank's LM round of 4f (``_shard_lm_run``) on the rank's TP
    slab -> its record (metrics, seconds, peak, collectives by role and
    bytes, the reshard's seconds); rank 0 saves the round-end params
    (whole on every rank) and, under int8, each element's flip bound to
    ``out_dir``. The recorded roles must be
    ``launch.steps.flat_train_collectives``'."""
    from repro_torch.core import flat as flatlib
    from repro_torch.core.sharded import tp_slab
    from repro_torch.launch.steps import flat_train_collectives
    from repro_torch.sharding import dist, hlo
    from repro_torch.utils.tree import tree_flatten
    (model, spec, rules, scn, layout, state, m, secs, peak,
     ops) = _shard_lm_run(torch, mesh, dev, kind, C, guarded)
    roles = {}
    for o in ops:
        n, b = roles.get(o.role, (0, 0))
        roles[o.role] = (n + 1, b + o.bytes)
    rec = {"metrics": {k: float(m[k]) for k in (
               "loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")},
           "round_s": secs, "peak_bytes": peak,
           "collectives": {r: list(v) for r, v in roles.items()},
           "staged": sum(o.staged for o in ops),
           "skipped": float(m.get("round_skipped", 0.0))}
    slab = tp_slab(layout, mesh, spec, rules)
    want = flat_train_collectives(
        model, rules, slab, local_steps=TPT_K, clients=C,
        robust="trimmed" if guarded else None,
        skipped=bool(rec["skipped"]))
    got = {r: v[0] for r, v in roles.items()}
    if got != want:
        raise AssertionError(f"sharded lm {kind}: collectives {got}, "
                             f"flat_train_collectives {want}")
    hlo.assert_flat_buffer_sharded(ops, C, layout.padded_size,
                                   client_n=layout.size)
    C_loc = C // spec.clients_on(mesh) if spec.client_axes else C
    # the slabs the round holds live, in (C_loc, N/S) f32 slabs: the
    # TP slab's P, G and previous G and the reshard's send, receive
    # and column buffers (6); the tail's whole-N vectors, S/C_loc
    # slabs each: the caller's params, their packing, the
    # aggregate's gather (its staged copy and its ordered blocks),
    # the server's new params and their packing (6); two of slack
    S = spec.flat_shards(mesh)
    rec["peak_local_slabs"] = hlo.assert_peak_within_local(
        peak, C_loc, layout.padded_size // S,
        slabs=6 + 6 * S // C_loc + 2)["local_slabs"]
    P = torch.randn((C_loc, slab.width), device=dev)
    slab.to_columns(P)            # its maps, made once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slab.to_columns(P)
    torch.cuda.synchronize()
    rec.update(reshard_s=time.perf_counter() - t0,
               tp_slab=[C_loc, slab.width], tp_valid=slab.valid,
               gathered=slab.gathered, chunk=slab.chunk(C_loc),
               N=layout.padded_size)
    del P
    bound = None
    if guarded:
        # each element's flip bound: one code step of each client's
        # chunk, max|ef chunk| / 127 (the round starts from ef = 0),
        # summed over the clients, over the fewest the mean keeps
        ca, na = spec.flat_axes(mesh)
        step = state.ef.abs().reshape(C_loc, -1, 128).amax(-1).sum(0) / 127.0
        step = dist.all_gather(dist.all_reduce(step, mesh, ca), mesh, na,
                               dim=0)
        kept = float(m["valid_count"]) - 2 * scn.robust_model.trim_count(C)
        bound = flatlib.unpack(step.repeat_interleave(128) / max(kept, 1.0),
                               layout, cast=False)
    if rank == 0:
        for what, tree in (("params", state.params), ("bound", bound)):
            if tree is None:
                continue
            leaves, treedef = tree_flatten(tree)
            torch.save({"/".join(p): x.cpu()
                        for p, x in zip(treedef, leaves)},
                       Path(out_dir) / f"lm_{kind}_{what}.pt")
    del state
    torch.cuda.empty_cache()
    return rec


def _shard_lm_unsharded(torch, kind, C, guarded):
    """The unsharded flat round of a 4f LM run on the card: (metrics,
    params on the host, seconds, peak)."""
    from repro_torch.core import init_fl_state
    from repro_torch.launch.steps import make_train_step
    from repro_torch.utils.tree import tree_flatten
    model, fl, scn, comp = _shard_lm_parts(kind, guarded)
    params = model.init(torch.Generator(device="cuda").manual_seed(TPT_SEED))
    step, sopt, scn, comp = make_train_step(model, fl, flat=True,
                                            scenario=scn, compression=comp)
    state = init_fl_state(params, sopt, scn, comp, cohort=C)
    batch = _shard_lm_batch(torch, C, model.cfg.vocab_size, "cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    leaves, treedef = tree_flatten(state.params)
    out = ({k: float(m[k]) for k in ("loss", "loss_last_step", "eta_mean",
                                     "eta_min", "eta_max")},
           {"/".join(p): x.cpu() for p, x in zip(treedef, leaves)}, secs,
           peak)
    del state, batch, leaves, m
    torch.cuda.empty_cache()
    return out


def _shard_lm_gate(torch, kind, recs, want, got_params, bound=None):
    """A 4f LM run's ranks against the unsharded round -> the worst
    errors. ``bound``: each element's int8 flip bound (SHARD_LM)."""
    metrics, params = want
    for rec in recs:
        for k, w in metrics.items():
            g = rec["metrics"][k]
            if abs(g - w) > SHARD_LM_REL * abs(w):
                raise AssertionError(f"sharded lm {kind}: {k} {g} vs the "
                                     f"unsharded {w}")
    worst, flips, total, over = 0.0, 0, 0, 0.0
    for path, w in params.items():
        g = got_params[path]
        scale = float(w.abs().max())
        err = (g - w).abs()
        off = int((err > SHARD_LM_REL * scale).sum())
        worst = max(worst, float(err.max()) / scale)
        flips, total = flips + off, total + err.numel()
        if bound is None:
            if off:
                raise AssertionError(f"sharded lm {kind}: {path} differs "
                                     f"by {float(err.max())} (max |p| "
                                     f"{scale})")
            continue
        excess = err - SHARD_LM_REL * scale - bound[path].view_as(err)
        over = max(over, float(excess.max()))
        if over > 0.0:
            raise AssertionError(f"sharded lm {kind}: {path}: "
                                 f"{over} beyond its flip bound")
    if flips > SHARD_LM_FLIP_SHARE * total:
        raise AssertionError(f"sharded lm {kind}: {flips} of {total} "
                             "elements off")
    return {"max_err_over_max_p": worst, "int8_flipped_elements": flips,
            "flipped_share": flips / total}


def _sharded_rank(rank, world, out_dir, device):
    """One rank of phase 4f (see run_sharded_path). Writes its lines,
    counts and results to ``out_dir/rank<rank>.json``."""
    import torch
    from repro_torch.core import flat as flatlib
    from repro_torch.core import make_fl_loop
    from repro_torch.core.fed_loop import FlatFLState
    from repro_torch.core.flat import local_clients
    from repro_torch.launch import train
    from repro_torch.sharding import dist, hlo
    from repro_torch.sharding.spec import (FederationSpec,
                                           get_federation_spec)
    mesh = dist.make_mesh(*SHARD_MESH)
    dev = dist.runtime().device
    lines, res = [], {"device": str(dev)}
    cases, states, launches = _shard_cases(torch, train, mesh, device)
    res["cases"] = {k: [{m: v.tolist() for m, v in r.items()} for r in rows]
                    for k, rows in cases.items()}
    import numpy as np
    np.savez(Path(out_dir) / f"rank{rank}.npz", **states)
    if device == "cuda":
        cd = get_federation_spec("cross_device", mesh)
        for masked in (False, True):
            _shard_step_gate(torch, mesh, cd, dev, masked, lines, launches)
        pt, data = _shard_task(train, device)
        C = data[0][0]["y"].shape[0]
        for kind in ("cross_device", "cross_silo"):
            fed = get_federation_spec(kind, mesh)
            shards = fed.flat_shards(mesh)
            st, rows, counts, _ = _shard_round_case(torch, pt, data, mesh,
                                                    fed, device)
            ust, urows, _, _ = _shard_round_case(torch, pt, data, mesh, fed,
                                                 device, sharded=False)
            N = flatlib.layout_of(pt.params, shards=shards).padded_size
            C_loc = C // fed.clients_on(mesh)
            _add_counts(launches, _check_round_counts(
                rows, counts, C_loc, shards, fed, mesh, C, N, None, kind))
            d, m = _shard_flat_max(torch, st.params, ust.params)
            for t, (a, b) in enumerate(zip(rows, urows)):
                if not math.isclose(float(a["loss"]), float(b["loss"]),
                                    rel_tol=1e-4):
                    raise AssertionError(f"{kind} round {t} loss {a['loss']}"
                                         f" vs unsharded {b['loss']}")
            if d > 1e-5 * m:
                raise AssertionError(f"{kind}: params differ by {d} "
                                     f"(max |p| {m})")
            lines.append(json.dumps({
                "sharded round": kind, "C_loc": C_loc, "shards": shards,
                "loss": [float(r["loss"]) for r in rows],
                "unsharded_loss": [float(r["loss"]) for r in urows],
                "params_max_abs_err": d, "max_abs_p": m,
                "collectives_per_round": [len(c[1]) for c in counts],
                "staged_per_round": [sum(o.staged for o in c[1])
                                     for c in counts],
                "launches_per_round": [c[0] for c in counts]}))
        # the block path, twice
        fed = FederationSpec(client_axes=("data",), fsdp_axes=(),
                             tp_axes=())
        loop = make_fl_loop(pt.loss_fn, pt.client_opt, pt.server_opt,
                            params_like=pt.params, num_rounds=ROUNDS,
                            rounds_per_call=SHARD_ROUNDS, flat=True,
                            mesh=mesh, federation=fed, block_sharded=True)
        block = {k: torch.stack([local_clients(
            torch.from_numpy(b[k]).to(dev), mesh, fed) for b, _ in data])
            for k in data[0][0]}
        f0 = FlatFLState(flatlib.pack(pt.params, loop.layout),
                         pt.server_opt.init(pt.params), 0)
        outs = []
        for _ in range(2):
            _reset(_shard_mods())
            hlo.reset()
            f, mets = loop(f0, block)
            outs.append((f, mets, _counts(_shard_mods()), hlo.snapshot()))
        _add_counts(launches, outs[0][2])
        for f, mets, n, ops in outs:
            if not torch.equal(f.P, outs[0][0].P):
                raise AssertionError("block path: two runs differ")
            for k, v in mets.items():
                if not torch.equal(v, outs[0][1][k]):
                    raise AssertionError(f"block path: two runs differ "
                                         f"in {k}")
            if n != {("batched_norms", "cuda"): K * SHARD_ROUNDS,
                     ("batched_apply", "cuda"): K * SHARD_ROUNDS}:
                raise AssertionError(f"block path: {n} launches")
            Nb = loop.layout.padded_size
            if [(o.kind, o.shape, o.op) for o in ops] != [
                    ("all-reduce", (Nb + 5,), "sum"),
                    ("all-reduce", (2,), "min")] * SHARD_ROUNDS:
                raise AssertionError(f"block path collectives {ops}")
        lines.append(json.dumps({
            "block path": "repeats its bits",
            "rounds": SHARD_ROUNDS, "collectives_per_round": 2,
            "launches_per_round": 2 * K}))
        res["lm"] = {}
        for kind, C, guarded in SHARD_LM:
            t0 = time.perf_counter()
            _reset(_shard_mods())
            res["lm"][kind] = _shard_lm_rank(torch, mesh, dev, kind, C,
                                             guarded, out_dir, rank)
            n = _counts(_shard_mods())
            if (n.get(("batched_norms", "cuda")), n.get(
                    ("batched_apply", "cuda"))) != (TPT_K, TPT_K):
                raise AssertionError(f"sharded lm {kind}: {n} launches, "
                                     f"expected {TPT_K} of the pair's each")
            _add_counts(launches, n)
            if rank == 0:
                took(f"4f rank 0 lm {kind}", t0)
    res["lines"] = lines
    res["launches"] = [[k[0], n] for k, n in launches.items()]
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def _read_ranks(tmp, world):
    import numpy as np
    out = []
    for r in range(world):
        with open(Path(tmp) / f"rank{r}.json") as f:
            out.append(json.load(f))
        with np.load(Path(tmp) / f"rank{r}.npz") as z:
            out[-1]["states"] = {k: z[k] for k in z.files}
    return out


def _compare_states(gpu, cpu):
    """The compressed and robust rounds' round-end params and EF21 slabs,
    card against CPU ranks -> {array: [max |diff| / max|p|, elements
    beyond 1e-5·max|p|]} over the ranks.

    Every element is within 1e-5·max|p|, the round-end params' scale,
    except where an int8 code flipped: η differs in its last bit between
    the card's and the CPU's norms (their sums' order), and a delta
    element then sitting at a rounding boundary takes the next code. A
    flipped EF21 element moves by one code step of its chunk, max|chunk
    of what round t quantized| / 127, which is max|chunk of ef_t −
    ef_{t−1}| / 127 (the chunk's largest element dequantizes to itself);
    EF21 absorbs a round-1 flip in round 2, and the params move by the
    flips of the C clients' last two rounds over C, at most 2 steps / C.
    Flips stay on at most 0.1 % of an array's elements: a wrong lane,
    column or aggregate moves most of them."""
    import numpy as np
    worst = {}
    C = MAIN_SHAPE[0]
    for name in {k.split(".")[0] for k in cpu[0]["states"]}:
        scale = float(np.abs(cpu[0]["states"][f"{name}.P"]).max())
        keys = sorted(k for k in cpu[0]["states"] if k.startswith(name))
        steps = {}        # key -> its per-element code step (EF21 slabs)
        top = 0.0
        for key in keys:
            if ".ef" not in key:
                continue
            prev = f"{name}.ef{int(key.rsplit('.ef', 1)[1]) - 1}"
            for r, c in enumerate(cpu):
                sent = c["states"][key] - c["states"].get(prev, 0.0)
                rows, cols = sent.shape
                step = np.abs(sent).reshape(rows, cols // 128, 128).max(
                    axis=-1) / 127.0
                steps[(r, key)] = np.repeat(step, 128, axis=1)
                top = max(top, float(step.max()))
        for key in keys:
            for r, (g, c) in enumerate(zip(gpu, cpu)):
                a, b = g["states"][key], c["states"][key]
                d = np.abs(a - b)
                flip = (2.0 * top / C if key.endswith(".P") and steps
                        else steps.get((r, key), 0.0))
                beyond = int((d > 1e-5 * scale).sum())
                w = worst.setdefault(key, [0.0, 0])
                w[0] = max(w[0], float(d.max()) / scale)
                w[1] = max(w[1], beyond)
                if (d > 1e-5 * scale + flip).any() or beyond > 1e-3 * d.size:
                    raise AssertionError(
                        f"sharded rank {r} {key}: cuda vs cpu max |diff| "
                        f"{float(d.max())} (1e-5·max|p| {1e-5 * scale}), "
                        f"{beyond} of {d.size} elements beyond it")
    return worst


def run_sharded_path(torch, tk, tref, bw, f32, smi):
    """Phase 4f. Returns its launch counts (the ranks' launches on the
    card, summed)."""
    import tempfile
    from repro_torch.sharding import dist
    t0 = time.perf_counter()
    backend, _, why = dist.choose_backend(SHARD_WORLD, "cuda")
    print(f"sharded: world {SHARD_WORLD}, mesh {SHARD_MESH}, backend "
          f"{backend} ({why}); card {smi}", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as gpu_dir, \
            tempfile.TemporaryDirectory() as cpu_dir:
        dist.spawn(_sharded_rank, SHARD_WORLD, (gpu_dir, "cuda"),
                   device="cuda")
        gpu = _read_ranks(gpu_dir, SHARD_WORLD)
        lm_params = {kind: torch.load(Path(gpu_dir) / f"lm_{kind}_params.pt")
                     for kind, _, _ in SHARD_LM}
        lm_bounds = {kind: torch.load(Path(gpu_dir) / f"lm_{kind}_bound.pt")
                     for kind, _, guarded in SHARD_LM if guarded}
        t_gpu = time.perf_counter() - t0
        dist.spawn(_sharded_rank, SHARD_WORLD, (cpu_dir, "cpu"),
                   device="cpu", threads=2)
        cpu = _read_ranks(cpu_dir, SHARD_WORLD)
    for r, res in enumerate(gpu):
        print(f"sharded rank {r}: device {res['device']}", flush=True)
        for line in res["lines"]:
            print(f"sharded rank {r}", line, flush=True)
    # the compressed and robust rounds: card == the CPU gloo run
    for r, (g, c) in enumerate(zip(gpu, cpu)):
        for name, rows in g["cases"].items():
            for t, (a, b) in enumerate(zip(rows, c["cases"][name])):
                for k in ("valid_count", "round_skipped", "wire_bytes",
                          "comp_ratio", "nan_guard_rate"):
                    if k in a and a[k] != b[k]:
                        raise AssertionError(f"sharded {name} round {t} {k}:"
                                             f" cuda {a[k]} cpu {b[k]}")
                for k in ("loss", "eta_mean"):
                    if not math.isclose(a[k], b[k], rel_tol=1e-5):
                        raise AssertionError(f"sharded {name} round {t} {k}:"
                                             f" cuda {a[k]} cpu {b[k]}")
            if r == 0:
                print("sharded", name, "cuda vs cpu gloo", json.dumps(
                    {k: [[row[k] for row in rows],
                         [row[k] for row in c["cases"][name]]]
                     for k in ("loss", "eta_mean")}), flush=True)
    worst = _compare_states(gpu, cpu)
    print("sharded: int8 + EF21, top-k, trimmed and clip rounds, card == "
          "CPU gloo run (loss, eta_mean within 1e-5; counts exact; params "
          "and EF21 slabs within 1e-5·max|p| but for int8 code flips, one "
          "code step each, on at most 0.1 % of elements):", json.dumps(worst),
          flush=True)
    # the LM rounds on the ranks' TP blocks, against the unsharded round
    lm_slab = None
    for kind, C, guarded in SHARD_LM:
        t1 = time.perf_counter()
        want = _shard_lm_unsharded(torch, kind, C, guarded)
        took(f"4f unsharded lm {kind}", t1)
        recs = [res["lm"][kind] for res in gpu]
        errs = _shard_lm_gate(torch, kind, recs, want[:2], lm_params[kind],
                              lm_bounds.get(kind))
        lm_slab = lm_slab or recs[0]["tp_slab"]
        print("sharded lm", json.dumps({
            "card": smi, "backend": backend, "federation": kind,
            "arch": LM_ARCH, "layers": SHARD_LM_LAYERS, "C": C,
            "rows": SHARD_LM_B, "seq": SHARD_LM_SEQ, "K": TPT_K,
            "guarded_tail": "dirichlet_dropouts + trimmed + int8/EF21"
                            if guarded else None,
            "N": recs[0]["N"], "tp_slab": recs[0]["tp_slab"],
            "tp_valid_by_rank": [r["tp_valid"] for r in recs],
            "gathered_at_use": recs[0]["gathered"],
            "chunk": recs[0]["chunk"],
            "metrics": recs[0]["metrics"], "unsharded": want[0],
            **errs,
            "round_s_by_rank": [r["round_s"] for r in recs],
            "unsharded_round_s": want[2],
            "reshard_s_by_rank": [r["reshard_s"] for r in recs],
            "collectives_by_role_count_bytes": recs[0]["collectives"],
            "staged": recs[0]["staged"],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in recs],
            "peak_local_slabs": recs[0]["peak_local_slabs"],
            "gather_route_peak_bytes": SHARD_LM_GATHER_PEAK.get(kind),
            "unsharded_peak_bytes": want[3],
            "note": "all ranks on one card at once; gloo stages through "
                    "the host"}), flush=True)
    # the kernel pair alone at the ranks' local-slab shapes: the CNN's
    # contiguous block and the LM's TP slab
    from repro_torch.core.flat import _padded
    shapes = ((MAIN_SHAPE[0] // 2, _padded(MAIN_SHAPE[1], 2) // 2),
              tuple(lm_slab))
    for C_loc, N_loc in shapes:
        gen = torch.Generator(device="cuda").manual_seed(5)
        g, gp, p = (torch.randn((C_loc, N_loc), generator=gen,
                                device="cuda") for _ in range(3))
        eta = torch.rand(C_loc, generator=gen, device="cuda")
        _lm_kernel_rows(torch, tk, tref, bw, f32, g, gp, p, eta, smi,
                        "sharded local slab (data 2, model 2)")
        del g, gp, p
        torch.cuda.empty_cache()
    launches = {}
    for res in gpu:
        for kname, n in res["launches"]:
            launches[(kname, "cuda")] = launches.get((kname, "cuda"), 0) + n
    print("sharded launches on the card, all ranks", json.dumps(
        {k[0]: n for k, n in launches.items()}))
    print(f"sharded: {time.perf_counter() - t0:.1f} s (card ranks "
          f"{t_gpu:.1f} s)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 4g, tensor-parallel training: world-4 ranks over (data 2, model 2)
# ---------------------------------------------------------------------------

def _tpt_key(run):
    """The unsharded round a run is held against: (arch, layers,
    federation, C, b)."""
    return run[1:6]


def _tpt_name(key):
    arch, layers, fed, C, b = key
    return f"{arch}_L{layers or 'all'}_{fed}_C{C}_b{b}"


def _cut_cfg(arch, layers):
    """``arch``'s config: whole (None), its reduced config ("reduced")
    or at full width cut to ``layers``."""
    from repro_torch.configs import get_config
    if layers == "reduced":
        return get_config(arch).reduced()
    return _lm_cfg(arch, layers) if layers else get_config(arch)


def _tpt_model(key):
    from repro_torch.models.model import build_model
    return build_model(_cut_cfg(*key[:2]))


def _extras_np(cfg, lead, seed):
    """The stub frontends' inputs of ``lead`` rows (Whisper's frames,
    InternVL2's image embeddings): f32 standard normals from ``seed``."""
    import numpy as np
    from repro_torch.models.model import batch_extras
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + shape, dtype=np.float32)
            for k, shape in batch_extras(cfg).items()}


def _tpt_batch(torch, key, device):
    """A round's (C, K, b, S) tokens and labels, from TPT_SEED, and the
    config's frontend extras."""
    import numpy as np
    model = _tpt_model(key)
    C, b = key[3], key[4]
    toks = np.random.default_rng(TPT_SEED).integers(
        0, model.cfg.vocab_size, (C, TPT_K, b, TPT_SEQ + 1))
    t = torch.from_numpy(toks).to(device)
    batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
    batch.update({k: torch.from_numpy(v).to(device) for k, v in _extras_np(
        model.cfg, (C, TPT_K, b), TPT_SEED + 1).items()})
    return batch


def _tpt_fl(arch):
    """Phase 4g's FLConfig of ``arch``: TPT_K local steps, η₀ from
    TPT_ETA0 where it names the arch."""
    from repro_torch.configs import FLConfig
    kw = {"eta0": TPT_ETA0[arch]} if arch in TPT_ETA0 else {}
    return FLConfig(local_steps=TPT_K, **kw)


def _tpt_metrics(m):
    return {k: float(m[k]) for k in ("loss", "loss_last_step", "eta_mean",
                                     "eta_min", "eta_max")}


def _tpt_unsharded(torch, key, out_dir):
    """The unsharded round of ``key`` on the card (remat as the first
    run held against it): its metrics, each leaf's max|p|, ms and peak;
    its round-end params saved to ``out_dir/<name>.pt`` on the host.
    The card is emptied after."""
    from repro_torch.core import init_fl_state
    from repro_torch.launch.steps import make_train_step
    from repro_torch.utils.tree import tree_flatten
    model = _tpt_model(key)
    params = model.init(torch.Generator(device="cuda").manual_seed(TPT_SEED))
    remat = next(r[6] for r in TPT_RUNS if _tpt_key(r) == key)
    step, sopt, _, _ = make_train_step(model, _tpt_fl(key[0]), remat=remat)
    state = init_fl_state(params, sopt)
    batch = _tpt_batch(torch, key, "cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del state
    leaves, treedef = tree_flatten(new.params)
    maxp = {"/".join(p): float(x.abs().max()) for p, x in zip(treedef,
                                                                leaves)}
    torch.save({"/".join(p): x.cpu() for p, x in zip(treedef, leaves)},
               Path(out_dir) / f"{_tpt_name(key)}.pt")
    out = {"metrics": _tpt_metrics(m), "maxp": maxp, "round_ms": ms,
           "peak_bytes": peak, "params": sum(x.numel() for x in leaves)}
    del new, leaves, m, batch
    torch.cuda.empty_cache()
    return out


class _Shapes:
    """Records the shapes a kernel wrapper of ``mod`` is called at, and
    no tensor."""

    def __init__(self, mod, name):
        self.mod, self.name, self.fn = mod, name, getattr(mod, name)
        self.shapes = []

    def __enter__(self):
        def call(*args, **kw):
            self.shapes.append(tuple(args[0].shape))
            return self.fn(*args, **kw)
        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def _tpt_run(torch, run, mesh, dev, out_dir):
    """One run of phase 4g on this rank -> (its record, its blocks of
    the leaves replicated over model, its round-end params on the host
    where the remat comparison needs them)."""
    import gc

    import numpy as np
    from repro_torch.core import fed_round, init_fl_state
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.launch.steps import (make_train_step,
                                          place_train_for_rank,
                                          train_collectives, train_rules)
    from repro_torch.models.common import logical_rules
    from repro_torch.sharding import hlo
    from repro_torch.sharding.spec import entry_axes, get_federation_spec
    from repro_torch.sharding.spec import local_block
    from repro_torch.utils.tree import tree_flatten
    name, _, _, fed, _, _, remat, kernel = run
    key = _tpt_key(run)
    model = _tpt_model(key)
    spec = get_federation_spec(fed, mesh)
    whole = model.init(torch.Generator(device=dev).manual_seed(TPT_SEED))
    rules = train_rules(model, mesh, whole, spec=spec)
    placed = place_train_for_rank(rules, params=whole,
                                  batch=_tpt_batch(torch, key, dev),
                                  device=dev)
    del whole
    torch.cuda.empty_cache()
    step, sopt, _, _ = make_train_step(model, _tpt_fl(run[1]), remat=remat,
                                       use_pallas=kernel)
    state = init_fl_state(placed["params"], sopt)
    batch = placed["batch"]
    del placed
    fedavg_s = []
    real_sum = fed_round._sum_over_clients

    def timed_sum(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_sum(*a, **kw)
        torch.cuda.synchronize()
        fedavg_s.append(time.perf_counter() - t)
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_count()
    hlo.reset()
    fed_round._sum_over_clients = timed_sum
    try:
        with _Shapes(tk, "batched_norms") as nsh, \
                _Shapes(tk, "batched_apply") as ash:
            t0 = time.perf_counter()
            with logical_rules(rules):
                new, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        fed_round._sum_over_clients = real_sum
    peak = torch.cuda.max_memory_allocated()
    ops = hlo.snapshot()
    launches = {k: n for k, n in tk.LAUNCHES.items() if k[1] == "cuda"}
    want = train_collectives(model, rules, local_steps=TPT_K, remat=remat)
    got = _tp_roles(ops)
    if got != want:
        raise AssertionError(f"tp train {name}: collectives {got}, derived "
                             f"{want}")
    if fed == "cross_device":
        hlo.assert_no_param_gather(ops, spec, train=True)
    if kernel:
        if launches != {("batched_norms", "cuda"): TPT_K,
                        ("batched_apply", "cuda"): TPT_K}:
            raise AssertionError(f"tp train {name}: launches {launches}, "
                                 f"expected {TPT_K} of each")
    elif launches:
        raise AssertionError(f"tp train {name}: the plain route launched "
                             f"{launches}")
    # each block against the unsharded round's, read from the host
    ref = torch.load(Path(out_dir) / f"{_tpt_name(key)}.pt", mmap=True)
    leaves, treedef = tree_flatten(new.params)
    axes = tree_flatten(rules.param_axes)[0]
    errs, replicated, host = {}, {}, {}
    coord = rules.coords
    for path, leaf, ax in zip(treedef, leaves, axes):
        p = "/".join(path)
        want_blk = local_block(ref[p], ax, mesh, coord).to(dev)
        errs[p] = float((leaf - want_blk).abs().max())
        if not any(rules.tp in entry_axes(e) for e in ax):
            replicated[f"{name}.{p}"] = leaf.cpu().numpy()
        if name.startswith("tinyllama_l2"):
            host[p] = leaf.cpu()
    del ref
    reserved = torch.cuda.max_memory_reserved()
    rec = {"metrics": _tpt_metrics(m), "errs": errs, "wall_s": wall,
           "fedavg_s": sum(fedavg_s),
           "step_ms": (wall - sum(fedavg_s)) * 1e3 / TPT_K,
           "peak_bytes": peak, "peak_reserved_bytes": reserved,
           "collectives": got,
           "collective_bytes": sum(o.bytes for o in ops),
           "staged": sum(o.staged for o in ops),
           "backward_ops": sum(o.backward for o in ops),
           "launches": {f"{k[0]}": n for k, n in launches.items()},
           "norms_shapes": sorted(set(nsh.shapes)),
           "apply_shapes": sorted(set(ash.shapes)),
           "local_params": sum(x.numel() for x in leaves)}
    del new, state, batch, leaves, m
    gc.collect()
    torch.cuda.empty_cache()
    return rec, replicated, host


def _tpt_kernel_rows(torch, norms_shape, apply_shape, smi, bw, f32):
    """batched_norms and batched_apply at a rank's local slab shapes of
    the kernel route, on normal draws: held against their plain versions
    and timed (``_lm_kernel_rows``' rows) -> {(name, shape): row}."""
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.delta_sgd import ref as tref
    gen = torch.Generator(device="cuda").manual_seed(TPT_SEED)
    out = {}
    for name, shape in (("batched_norms", norms_shape),
                        ("batched_apply", apply_shape)):
        g, gp, p = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(3))
        eta = torch.rand((shape[0],), generator=gen, device="cuda") * 0.2
        rows = _lm_kernel_rows(torch, tk, tref, bw, f32, g, gp, p, eta, smi,
                               "4g tensor-parallel training, a rank's "
                               "local slab")
        out[(name, tuple(shape))] = rows[(name, tuple(shape))]
        del g, gp, p, eta
        torch.cuda.empty_cache()
    return out


def _tpt_rank(rank, world, out_dir, runs, smi, bw, f32):
    """One rank of phase 4g (see run_tp_train_path): each of ``runs``
    (TPT_RUNS' rows). Writes its records to ``out_dir/rank<rank>.json``
    and its replicated leaves to ``out_dir/rank<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.sharding import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = dist.make_mesh(*SHARD_MESH)
    dev = dist.runtime().device
    res = {"device": str(dev), "coord": dist.coords(mesh), "runs": {}}
    arrays, remat = {}, {}
    for run in runs:
        t0 = time.perf_counter()
        rec, rep, host = _tpt_run(torch, run, mesh, dev, out_dir)
        if rank == 0:
            took(f"4g rank 0 {run[0]}", t0)
        res["runs"][run[0]] = rec
        arrays.update(rep)
        if host:
            remat[run[0]] = host
    if len(remat) == 2:      # both of the remat pair ran
        off = remat["tinyllama_l2_remat_off"]
        on = remat["tinyllama_l2_remat_on"]
        res["remat"] = {"bitwise": all(torch.equal(off[p], on[p])
                                       for p in off),
                        "rel": max(float((off[p] - on[p]).abs().max())
                                   / max(float(off[p].abs().max()), 1e-30)
                                   for p in off)}
    tdist.barrier()
    if rank == 0:
        res["kernel_rows"] = []
        for run in runs:
            if not run[7]:
                continue
            kr = res["runs"][run[0]]
            rows = _tpt_kernel_rows(torch, kr["norms_shapes"][0],
                                    kr["apply_shapes"][0], smi, bw, f32)
            res["kernel_rows"] += [dict(r, key=[k[0], list(k[1])], run=run[0])
                                   for k, r in rows.items()]
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def run_tp_train_path(torch, smi, bw, f32, runs=TPT_RUNS):
    """Phase 4g over ``runs`` (TPT_RUNS' rows, every one of them: the
    remat gate reads its pair). Returns (its launch counts (the ranks'
    Δ-SGD launches on the card, summed), the Δ-SGD rows at a rank's
    local slab)."""
    import gc
    import os
    import tempfile
    import numpy as np
    from repro_torch.launch.specs import params_struct
    from repro_torch.launch.steps import train_collectives, train_rules
    from repro_torch.sharding import dist
    from repro_torch.sharding.spec import get_federation_spec
    t0 = time.perf_counter()
    backend, _, why = dist.choose_backend(SHARD_WORLD, "cuda")
    mesh = dist.AbstractMesh(dict(zip(SHARD_MESH[1], SHARD_MESH[0])))
    for run in runs:
        model = _tpt_model(_tpt_key(run))
        rules = train_rules(model, mesh, params_struct(model),
                            spec=get_federation_spec(run[3], mesh))
        print(f"tp train {run[0]}: expected collectives a round on each "
              "rank", json.dumps(train_collectives(
                  model, rules, local_steps=TPT_K, remat=run[6])),
              flush=True)
    print(f"tp train: world {SHARD_WORLD}, mesh {SHARD_MESH}, backend "
          f"{backend} ({why}); card {smi}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        # the dry run of the H100 mesh, on fake tensors in a CPU process
        # of its own while the card works
        env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
        dry = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             LM_ARCH, "--shape", "train_4k", "--mesh", "single", "--out",
             tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            torch.cuda.empty_cache()
            keys = sorted({_tpt_key(r) for r in runs}, key=str)
            ref = {}
            for k in keys:
                t1 = time.perf_counter()
                ref[k] = _tpt_unsharded(torch, k, tmp)
                took(f"4g unsharded {_tpt_name(k)}", t1)
            t_ref = time.perf_counter() - t0
            # the card is the ranks': this process keeps nothing on it,
            # and each rank's allocator grows its segments in place (its
            # runs' shapes differ, and 4 ranks' fragments add up)
            gc.collect()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            print(f"tp train: the parent holds {held} B on the card "
                  f"({torch.cuda.memory_reserved()} B reserved) before "
                  "the spawn", flush=True)
            if held > 2 ** 30:
                raise AssertionError(f"tp train: {held} B still allocated "
                                     "before the ranks start")
            alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = \
                "expandable_segments:True"
            try:
                dist.spawn(_tpt_rank, SHARD_WORLD,
                           (tmp, runs, smi, bw, f32), device="cuda")
            finally:
                if alloc_conf is None:
                    del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
                else:
                    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
            t_ranks = time.perf_counter() - t0 - t_ref
            ranks = []
            for r in range(SHARD_WORLD):
                with open(Path(tmp) / f"rank{r}.json") as f:
                    ranks.append(json.load(f))
                with np.load(Path(tmp) / f"rank{r}.npz") as z:
                    ranks[-1]["arrays"] = {k: z[k] for k in z.files}
            dry_out, _ = dry.communicate(timeout=600)
            if dry.returncode:
                raise AssertionError(f"tp train dry run failed:\n{dry_out}")
            with open(Path(tmp) / f"{LM_ARCH}_train_4k_single.json") as f:
                dry_res = json.load(f)
        finally:
            if dry.poll() is None:
                dry.kill()
                dry.wait()
    for run in runs:
        name, key = run[0], _tpt_key(run)
        want = ref[key]
        recs = [res["runs"][name] for res in ranks]
        xl = run[1] == "xlstm-1.3b"
        for rec in recs:
            for k, w in want["metrics"].items():
                g = rec["metrics"][k]
                rel = XLSTM_RTOL["eta"] if xl and k.startswith("eta") \
                    else TPT_REL
                if abs(g - w) > rel * abs(w):
                    raise AssertionError(f"tp train {name}: {k} {g} vs the "
                                         f"unsharded {w}")
        worst = {}
        prel = XLSTM_RTOL["params"] if xl else TPT_PARAM_REL
        for p, mp in want["maxp"].items():
            e = max(rec["errs"][p] for rec in recs)
            worst[p] = e / mp
            if e > prel * mp:
                raise AssertionError(f"tp train {name}: {p} differs by {e} "
                                     f"(tolerance {prel * mp})")
        # the model replicas of every replicated leaf: the same bits
        nrep = 0
        for a in ranks:
            for b in ranks:
                if a["coord"]["data"] != b["coord"]["data"] or a is b:
                    continue
                for k, v in a["arrays"].items():
                    if k.startswith(name + "."):
                        nrep += 1
                        if not np.array_equal(v, b["arrays"][k]):
                            raise AssertionError(
                                f"tp train {name}: replicated leaf {k} "
                                f"differs between ranks {a['coord']} and "
                                f"{b['coord']}")
        peaks_ = [rec["peak_bytes"] for rec in recs]
        if max(peaks_) >= want["peak_bytes"]:
            raise AssertionError(f"tp train {name}: a rank's peak "
                                 f"{max(peaks_)} B is not below the "
                                 f"unsharded round's {want['peak_bytes']} B")
        print(f"tp train {name}", json.dumps({
            "card": smi, "arch": run[1], "layers": _tpt_model(
                key).cfg.num_layers, "federation": run[3], "C": run[4],
            "b": run[5], "K": TPT_K, "S": TPT_SEQ, "remat": run[6],
            "eta0": _tpt_fl(run[1]).eta0,
            "route": "kernel" if run[7] else "plain",
            "metrics_by_rank": [rec["metrics"] for rec in recs],
            "unsharded_metrics": want["metrics"],
            "worst_param_err_over_maxp": max(worst.values()),
            "param_tolerance_over_maxp": prel,
            "replicated_leaf_pairs_bitwise": nrep,
            "collectives": recs[0]["collectives"],
            "backward_ops": recs[0]["backward_ops"],
            "collective_bytes": recs[0]["collective_bytes"],
            "staged": recs[0]["staged"],
            "launches_by_rank": [rec["launches"] for rec in recs],
            "round_s_by_rank": [rec["wall_s"] for rec in recs],
            "step_ms_by_rank": [rec["step_ms"] for rec in recs],
            "fedavg_s_by_rank": [rec["fedavg_s"] for rec in recs],
            "peak_bytes_by_rank": peaks_,
            "peak_reserved_bytes_by_rank": [rec["peak_reserved_bytes"]
                                            for rec in recs],
            "local_params_by_rank": [rec["local_params"] for rec in recs],
            "unsharded": {k: want[k] for k in ("round_ms", "peak_bytes",
                                               "params")},
            "note": "all ranks on one card at once over gloo: a collective "
                    "is a host round trip, so the times say nothing of "
                    "NCCL"}), flush=True)
    rm = [res["remat"] for res in ranks if "remat" in res]
    if len(rm) != len(ranks) and len(runs) == len(TPT_RUNS):
        raise AssertionError("tp train: the remat pair did not run")
    if rm and max(r["rel"] for r in rm) > TPT_REMAT_REL:
        raise AssertionError(f"tp train: remat on vs off {rm}")
    print("tp train remat", rm and json.dumps({
        "bitwise_by_rank": [r["bitwise"] for r in rm],
        "max_err_over_maxp": max(r["rel"] for r in rm),
        "peak_bytes_off_by_rank": [res["runs"]["tinyllama_l2_remat_off"][
            "peak_bytes"] for res in ranks],
        "peak_bytes_on_by_rank": [res["runs"]["tinyllama_l2_remat_on"][
            "peak_bytes"] for res in ranks]}), flush=True)
    rows = {}
    for row in ranks[0]["kernel_rows"]:
        k = row.pop("key")
        row.pop("run")
        rows[(k[0], tuple(k[1]))] = row
    print(f"tp train dry run {LM_ARCH} train_4k 32x8", json.dumps({
        "analytic_memory": dry_res["analytic_memory"],
        "memory": dry_res["memory"], "collectives": dry_res["collectives"],
        "roofline": dry_res["roofline"], "lower_s": dry_res["lower_s"],
        "model_flops": dry_res["model_flops"],
        "hlo_flops_total": dry_res["hlo_flops_total"],
        "measured_peak_bytes_by_rank_tinyllama_4_ranks": [
            r["runs"]["tinyllama_l11"]["peak_bytes"] for r in ranks
            if "tinyllama_l11" in r["runs"]],
        "note": "other shapes (C = 2, b = 2, S = 256 on 2 x 2 here): no "
                "gate"}), flush=True)
    launches = {}
    for res in ranks:
        for run in runs:
            if not run[7]:
                continue
            for k, n in res["runs"][run[0]]["launches"].items():
                launches[(k, "cuda")] = launches.get((k, "cuda"), 0) + n
    print(f"tp train: {time.perf_counter() - t0:.1f} s (unsharded runs "
          f"{t_ref:.1f} s, ranks {t_ranks:.1f} s)", flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# phase 6c, tensor-parallel serving: world-4 ranks over (data 2, model 2)
# ---------------------------------------------------------------------------

def _tp_cfg(arch):
    from repro_torch.configs import get_config
    layers = TP_PATHS[arch][0]
    return _lm_cfg(arch, layers) if layers else get_config(arch)


def _tp_prompts(cfg):
    import numpy as np
    return np.random.default_rng(TP_SEED).integers(
        0, cfg.vocab_size, (TP_ROWS, TP_PROMPT))


def _tp_extras(torch, cfg, device):
    """Phase 6c's frontend extras of the TP_ROWS prompts on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in _extras_np(
        cfg, (TP_ROWS,), TP_SEED + 1).items()}


def _tp_unsharded(torch, arch, out_dir):
    """Phase 6c's unsharded run of ``arch`` on the card: prefill and
    greedy decode; its logits (prefill's last position, then each step)
    and tokens go to ``out_dir/<arch>.npz``, and for TP_GATE_PATHS the
    teacher-forced full forward's logits at the same positions
    (``full``). Returns its numbers."""
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_leaves
    cfg = _tp_cfg(arch)
    gen = TP_PATHS[arch][2]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(TP_SEED))
    prompts = torch.from_numpy(_tp_prompts(cfg)).cuda()
    extras = _tp_extras(torch, cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(
        params, {"tokens": prompts, **extras},
        cache_len=TP_PROMPT + cfg.num_image_tokens + gen)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    steps, toks = [logits[:, 0]], []
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    for _ in range(gen):
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
        steps.append(logits[:, 0])
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / gen
    peak = torch.cuda.max_memory_allocated()
    arrays = {"logits": torch.stack(steps).cpu().numpy(),
              "tokens": torch.cat(toks, 1).cpu().numpy()}
    del cache
    if arch in TP_GATE_PATHS:
        seq = torch.cat([prompts] + toks, 1)
        with torch.no_grad():
            full, _ = model.apply(params, {"tokens": seq[:, :-1], **extras})
        arrays["full"] = full[:, TP_PROMPT - 1:].cpu().numpy()
        del full
    np.savez(Path(out_dir) / f"{arch}.npz", **arrays)
    n = sum(a.numel() for a in tree_leaves(params))
    del params, logits
    torch.cuda.empty_cache()
    return {"params": n, "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
            "peak_bytes": peak}


def _tp_roles(ops):
    out = {}
    for o in ops:
        out[o.role] = out.get(o.role, 0) + 1
    return out


def _tp_rank(rank, world, out_dir, archs, one_row_run=True, moe_runs=()):
    """One rank of phase 6c (see run_tp_serve_path): each of ``archs``
    (TP_PATHS' keys), then with ``one_row_run`` the one-row run on
    (data 1, model 4) (``_tp_one_row``), then ``moe_runs`` (TPM_RUNS'
    rows on SHARD_MESH whose ranks draw their own weights, through
    ``_tpm_rank_run``: one spawn for both parts). Writes its logits and
    tokens to ``out_dir/rank<rank>.npz``, its numbers to
    ``out_dir/rank<rank>.json`` and the MoE runs' records to
    ``out_dir/tpm.rank<rank>.json``."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.kernels.mamba2_scan import ops as m2ops
    from repro_torch.kernels.mamba2_scan import ref as m2ref
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          place_for_rank, serve_collectives,
                                          serve_rules)
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.models.common import logical_rules
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import ATTN_TYPES
    from repro_torch.sharding import dist, hlo
    from repro_torch.sharding.spec import get_federation_spec, local_block
    from repro_torch.utils.tree import tree_leaves
    mesh = dist.make_mesh(*SHARD_MESH)
    one_row = dist.make_mesh(*ONE_ROW_MESH) if one_row_run else None
    dev = dist.runtime().device
    coord = dist.coords(mesh)
    res, arrays = {"device": str(dev), "coord": coord, "cases": {}}, {}
    rows = (("data",), None)
    for arch in archs:
        t0 = time.perf_counter()
        _, fed, gen = TP_PATHS[arch]
        cfg = _tp_cfg(arch)
        model = build_model(cfg)
        whole = model.init(torch.Generator(device=dev).manual_seed(TP_SEED))
        rules = serve_rules(model, mesh, whole,
                            spec=get_federation_spec(fed, mesh))
        prompts = torch.from_numpy(_tp_prompts(cfg)).to(dev)
        placed = place_for_rank(
            rules, params=whole,
            batch={"tokens": prompts, **_tp_extras(torch, cfg, dev)},
            device=dev)
        del whole
        params, batch = placed["params"], placed["batch"]
        with np.load(Path(out_dir) / f"{arch}.npz") as z:
            forced = local_block(torch.from_numpy(z["tokens"]), rows, mesh,
                                 coord).to(dev)
        Bl = batch["tokens"].shape[0]
        want = [serve_collectives(model, rules, Bl, TP_PROMPT)] + \
            [serve_collectives(model, rules, Bl, 1)] * gen
        # the kernels at the rank's local-head shapes against their
        # plain versions (outside the counted run): flash at the first
        # attention block's heads over the prompt (and the image rows),
        # the SSD chunks at the Mamba2 heads; xLSTM has neither
        stack = params["stack"]
        ap = (stack["shared_attn"] if "shared_attn" in stack else
              next((stack[k] for k in stack if "attn" in stack[k]),
                   None))
        mx = next((stack[k]["mixer"] for k in stack
                   if "mixer" in stack[k] and "A_log" in stack[k]["mixer"]),
                  None)
        with logical_rules(rules):
            mix = ssm.mixer_of(mx, cfg) if mx is not None else None
            hd = attn.heads_of(ap["attn"], cfg) if ap is not None else None
        # no reference to the params outlives them (the spawn's later
        # runs count their peaks)
        del stack, ap, mx
        S_att = TP_PROMPT + cfg.num_image_tokens
        gen_ = torch.Generator(device=dev).manual_seed(rank)
        shape, fa_err = None, None
        if hd is not None:
            shape = (Bl, S_att, hd.h, hd.a, cfg.head_dim)
            fa_err = _flash_vs_plain(torch, fa, faref, shape, gen_, dev,
                                     f"tp {arch}")
        ssd_shape, ssd_err = None, None
        if mix is not None:
            P, N = cfg.ssm_head_dim, cfg.ssm_state
            ssd_shape = (Bl, TP_PROMPT, mix.h, P, mix.g, N)
            x = torch.randn(ssd_shape[:4], generator=gen_, device=dev)
            dt = torch.rand(ssd_shape[:3], generator=gen_, device=dev) * 0.1
            dA = (dt * -torch.rand((mix.h,), generator=gen_,
                                   device=dev) * 16).contiguous()
            Bm, Cm = (torch.randn((Bl, TP_PROMPT, mix.g, N), generator=gen_,
                                  device=dev) for _ in range(2))
            got = m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=64)
            ref_ = m2ref.ssd_chunks_ref(x, dt, dA, Bm, Cm, 64)
            ssd_err = max(float((a - b).abs().max()) for a, b in
                          zip(got, ref_))
            for a, b in zip(got, ref_):
                torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
            del x, dt, dA, Bm, Cm, got, ref_
        torch.cuda.empty_cache()
        # the counted run: prefill, then the unsharded run's tokens fed
        # back (every step's logits comparable)
        seen, seen_ssd = [], []
        real_fa, real_ssd = attn.flash_attention, m2ops.ssd_chunks

        def recording(q, k, v, **kw):
            seen.append((tuple(q.shape), tuple(k.shape)))
            return real_fa(q, k, v, **kw)

        def recording_ssd(x, *a, **kw):
            seen_ssd.append(tuple(x.shape) + tuple(a[2].shape[2:]))
            return real_ssd(x, *a, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        m2.reset_launch_count()
        hlo.reset()
        attn.flash_attention, m2ops.ssd_chunks = recording, recording_ssd
        try:
            t0 = time.perf_counter()
            logits, cache = make_prefill_step(
                model, cache_len=S_att + gen, rules=rules)(params, batch)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
        finally:
            attn.flash_attention, m2ops.ssd_chunks = real_fa, real_ssd
        launches = dict(fa.LAUNCHES)
        launches.update(m2.LAUNCHES)
        ops = [hlo.snapshot()]
        steps, c = [logits[:, 0]], cache
        t0 = time.perf_counter()
        for t in range(gen):
            hlo.reset()
            with logical_rules(rules):
                logits, c = model.decode_step(params, c, forced[:, t:t + 1])
            ops.append(hlo.snapshot())
            steps.append(logits[:, 0])
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / gen
        peak = torch.cuda.max_memory_allocated()
        greedy = []
        if arch == LM_ARCH:
            # greedy decode through the serve step from the prefill
            step = make_serve_step(model, rules=rules)
            tok, c = torch.argmax(steps[0], -1)[:, None], cache
            for _ in range(gen):
                greedy.append(tok)
                tok, c = step(params, c, tok)
            arrays[f"{arch}.greedy"] = torch.cat(greedy, 1).cpu().numpy()
        for i, (o, w) in enumerate(zip(ops, want)):
            got = _tp_roles(o)
            if got != {r: n for r, n in w.items() if n}:
                raise AssertionError(f"tp {arch} step {i}: collectives {got}"
                                     f", derived {w}")
        if fed == "cross_device":
            for o in ops:
                hlo.assert_no_param_gather(o, rules.spec)
        # flash in every attention block of the decoder (the encoder's
        # attention is non-causal: the plain route), the SSD chunks in
        # every Mamba2 layer
        n_layers = sum(t in ATTN_TYPES for t in cfg.layer_types)
        n_mamba = cfg.layer_types.count("mamba2")
        want_l = {("flash_attention", dev.type): n_layers}
        if n_mamba:
            want_l[("ssd_chunks", dev.type)] = n_mamba
        if not n_layers:
            del want_l[("flash_attention", dev.type)]
        if {k: n for k, n in launches.items() if n} != want_l or \
                any(sq != shape[:3] + (cfg.head_dim,) or
                    sk != (shape[0], shape[1], shape[3], shape[4])
                    for sq, sk in seen) or \
                any(s != ssd_shape for s in seen_ssd):
            raise AssertionError(f"tp {arch}: prefill launched {launches} "
                                 f"at {seen[:2]}, {seen_ssd[:2]}, expected "
                                 f"{want_l} at {shape}, {ssd_shape}")
        arrays[f"{arch}.logits"] = torch.stack(steps).cpu().numpy()
        res["cases"][arch] = {
            "collectives_prefill": {r: n for r, n in want[0].items() if n},
            "collectives_decode_step": {r: n for r, n in want[-1].items()
                                        if n},
            "collective_bytes_per_step": [sum(x.bytes for x in o)
                                          for o in ops[:2]],
            "staged_per_step": [sum(x.staged for x in o) for o in ops[:2]],
            "flash_launches_prefill": n_layers,
            "flash_shape": list(shape) if shape else None,
            "flash_max_abs_err_vs_plain": fa_err,
            "ssd_launches_prefill": n_mamba,
            "ssd_shape": list(ssd_shape) if ssd_shape else None,
            "ssd_max_abs_err_vs_plain": ssd_err,
            "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
            "peak_bytes": peak,
            "local_params": sum(a.numel() for a in tree_leaves(params))}
        del params, cache, c, logits, steps, placed, batch
        torch.cuda.empty_cache()
        if rank == 0:
            took(f"6c rank 0 {arch}", t0)
    if one_row is not None:
        t0 = time.perf_counter()
        res["one_row"] = _tp_one_row(torch, one_row, dev, out_dir, arrays)
        if rank == 0:
            took("6c rank 0 one row", t0)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    if moe_runs:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        tpm = {"device": str(dev), "coord": coord, "runs": {}}
        for run in moe_runs:
            if tuple(run[5]) != SHARD_MESH[0]:
                raise AssertionError(f"tp moe {run[0]}: mesh {run[5]} is "
                                     f"not 6c's {SHARD_MESH[0]}")
            t0 = time.perf_counter()
            tpm["runs"][run[0]] = _tpm_rank_run(torch, run, mesh, dev,
                                                out_dir, None)
            if rank == 0:
                took(f"6c rank 0 {run[0]}", t0)
        with open(Path(out_dir) / f"tpm.rank{rank}.json", "w") as f:
            json.dump(tpm, f)


def _flash_vs_plain(torch, fa, faref, shape, gen, dev, what):
    """Flash attention at ``shape`` (B, S, H, KV, hd) on normal draws
    against its plain version, failing beyond 2e-5·max|v|: the error."""
    B, S, H, KV, hd = shape
    q = torch.randn((B, S, H, hd), generator=gen, device=dev)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=dev)
            for _ in range(2))
    err = float((fa.flash_attention(q, k, v, causal=True)
                 - faref.attention_ref(q, k, v, causal=True)).abs().max())
    if err > 2e-5 * max(1.0, float(v.abs().max())):
        raise AssertionError(f"{what}: flash at {shape} differs from its "
                             f"plain version by {err}")
    return err


def _tp_one_row_unsharded(torch, out_dir):
    """The one-row run's unsharded side on the card: LM_ARCH whole,
    prefill of the first prompt into ONE_ROW_CACHE slots, ONE_ROW_GEN
    greedy tokens, and the full forward over the prompt and them;
    arrays to ``out_dir/one_row.npz``. Returns its numbers."""
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.configs import get_config
    model = build_model(get_config(LM_ARCH))
    params = model.init(torch.Generator(device="cuda").manual_seed(TP_SEED))
    prompt = torch.from_numpy(_tp_prompts(model.cfg)[:1]).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      cache_len=ONE_ROW_CACHE)
        steps, toks = [logits[:, 0]], []
        tok = torch.argmax(logits, -1)
        for _ in range(ONE_ROW_GEN):
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok)
            steps.append(logits[:, 0])
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        # every fed token's position: the prompt and the 8 generated
        full, _ = model.apply(params, {"tokens": torch.cat([prompt] + toks,
                                                           1)})
    np.savez(Path(out_dir) / "one_row.npz",
             logits=torch.stack(steps).cpu().numpy(),
             tokens=torch.cat(toks, 1).cpu().numpy(),
             full=full.cpu().numpy())
    del params, cache, logits, full
    torch.cuda.empty_cache()
    return {"prefill_and_decode_ms": ms, "peak_bytes": peak}


def _tp_one_row(torch, mesh, dev, out_dir, arrays):
    """The one-row run on this rank of (data 1, model 4): its blocks of
    LM_ARCH whole, flash at its heads against the plain version, the
    counted prefill (flash in every layer at the rank's heads), the
    cache narrowed to the rank's time block (``place_prefill_cache``),
    the unsharded run's tokens fed back, each step's collectives against
    ``serve_collectives`` with that cache; then the int8 cache made
    empty under the rules and fed the prompt's first ONE_ROW_INT8
    tokens. Logits into ``arrays``; returns its record."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.launch.steps import (make_prefill_step,
                                          place_for_rank,
                                          place_prefill_cache,
                                          serve_collectives, serve_rules)
    from repro_torch.models.common import logical_rules
    from repro_torch.models.model import build_model
    from repro_torch.sharding import dist, hlo
    from repro_torch.sharding.spec import get_federation_spec
    from repro_torch.utils.tree import tree_flatten
    model = build_model(get_config(LM_ARCH))
    cfg = model.cfg
    whole = model.init(torch.Generator(device=dev).manual_seed(TP_SEED))
    rules = serve_rules(model, mesh, whole, batch_size=1,
                        spec=get_federation_spec("cross_device", mesh))
    prompt = torch.from_numpy(_tp_prompts(cfg)[:1]).to(dev)
    placed = place_for_rank(rules, params=whole, batch={"tokens": prompt},
                            device=dev)
    del whole
    torch.cuda.empty_cache()
    params, batch = placed["params"], placed["batch"]
    with np.load(Path(out_dir) / "one_row.npz") as z:
        forced = torch.from_numpy(z["tokens"]).to(dev)
    h, kv = cfg.num_heads // 4, max(1, cfg.num_kv_heads // 4)
    shape = (1, TP_PROMPT, h, kv, cfg.head_dim)
    fa_err = _flash_vs_plain(torch, fa, faref, shape,
                             torch.Generator(device=dev).manual_seed(
                                 dist.runtime().rank), dev, "tp one row")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    hlo.reset()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(model, cache_len=ONE_ROW_CACHE,
                                          rules=rules)(params, batch)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: n for k, n in fa.LAUNCHES.items() if n}
        pre_ops = hlo.snapshot()
        c = place_prefill_cache(rules, cache, 1)
        del cache
        leaves, paths = tree_flatten(c["runs"])
        slots = {"/".join(p): list(x.shape) for p, x in zip(paths, leaves)}
        steps, ops = [logits[:, 0]], []
        t0 = time.perf_counter()
        for t in range(ONE_ROW_GEN):
            hlo.reset()
            with logical_rules(rules):
                logits, c = model.decode_step(params, c, forced[:, t:t + 1])
            ops.append(hlo.snapshot())
            steps.append(logits[:, 0])
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / ONE_ROW_GEN
        peak = torch.cuda.max_memory_allocated()
        want = serve_collectives(model, rules, 1, 1, cache=c)
        want_pre = serve_collectives(model, rules, 1, TP_PROMPT)
        del c
        with logical_rules(rules):
            q8 = model.init_cache(1, ONE_ROW_CACHE, device=dev,
                                  quant_kv=True)
            int8 = []
            for t in range(ONE_ROW_INT8):
                lg, q8 = model.decode_step(params, q8, prompt[:, t:t + 1])
                int8.append(lg[:, 0])
        int8_slots = list(q8["runs"]["run0"]["k"].shape)
        want_int8 = serve_collectives(model, rules, 1, 1, cache=q8)
        del q8
    for i, o in enumerate([pre_ops] + ops):
        got = _tp_roles(o)
        w = want_pre if i == 0 else want
        if got != {r: n for r, n in w.items() if n}:
            raise AssertionError(f"tp one row step {i}: collectives {got}, "
                                 f"derived {w}")
        hlo.assert_no_param_gather(o, rules.spec)
    if launches != {("flash_attention", dev.type): cfg.num_layers}:
        raise AssertionError(f"tp one row: prefill launched {launches}")
    arrays["one_row.logits"] = torch.stack(steps).cpu().numpy()
    arrays["one_row.int8"] = torch.stack(int8).cpu().numpy()
    rec = {"collectives_prefill": {r: n for r, n in want_pre.items() if n},
           "collectives_decode_step": {r: n for r, n in want.items() if n},
           "collectives_decode_step_int8": {r: n for r, n in
                                            want_int8.items() if n},
           "collective_bytes_per_step": sum(x.bytes for x in ops[0]),
           "cache_shapes": {k: v for k, v in slots.items()
                            if k.endswith("/k")},
           "int8_cache_k_shape": int8_slots,
           "flash_launches_prefill": cfg.num_layers,
           "flash_shape": list(shape), "flash_max_abs_err_vs_plain": fa_err,
           "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
           "peak_bytes": peak}
    del params, placed, batch, logits, steps
    torch.cuda.empty_cache()
    return rec


def _tp_one_row_check(ranks, want, ref, smi):
    """The one-row run's gates, then its line: every rank's prefill and
    decode logits (its time block of the cache, combined over model)
    against the unsharded run's within TP_REL·max|logits| and against
    the full forward (``_tpm_close``'s 2e-3); the int8 cache's logits
    against the full forward within QUANT_KV_TOL·max|logits|."""
    import numpy as np
    V = _tp_cfg(LM_ARCH).vocab_size
    logits, full = want["logits"][:, 0, :V], want["full"][0, :, :V]
    tol = TP_REL * float(np.abs(logits).max())
    err = gate = int8_err = 0.0
    fwd = full[TP_PROMPT - 1:TP_PROMPT + ONE_ROW_GEN]
    for res in ranks:
        got = res["arrays"]["one_row.logits"][:, 0, :V]
        err = max(err, float(np.abs(got - logits).max()))
        if err > tol:
            raise AssertionError(f"tp one row {res['coord']}: logits differ "
                                 f"by {err} (tolerance {tol})")
        gate = max(gate, float(np.abs(got - fwd).max()))
        if _tpm_close(got, fwd) > 0:
            raise AssertionError(f"tp one row {res['coord']}: decode differs "
                                 f"from the full forward by {gate}")
        q = res["arrays"]["one_row.int8"][:, 0, :V]
        int8_err = max(int8_err, float(np.abs(
            q - full[:ONE_ROW_INT8]).max()))
    int8_tol = QUANT_KV_TOL * float(np.abs(full[:ONE_ROW_INT8]).max())
    if int8_err > int8_tol:
        raise AssertionError(f"tp one row: the int8 cache's logits differ "
                             f"from the full forward by {int8_err} "
                             f"(tolerance {int8_tol})")
    rec = ranks[0]["one_row"]
    print(f"tp one_row {LM_ARCH}", json.dumps({
        "card": smi, "mesh": dict(zip(*reversed(ONE_ROW_MESH))),
        "rows": 1, "prompt": TP_PROMPT, "cache_slots": ONE_ROW_CACHE,
        "new_tokens": ONE_ROW_GEN, "logits_max_abs_err": err,
        "tolerance": tol, "decode_vs_full_forward_max_abs_err": gate,
        "int8_steps": ONE_ROW_INT8, "int8_vs_full_forward_max_abs_err":
            int8_err, "int8_tolerance": int8_tol,
        **{k: rec[k] for k in ("collectives_prefill",
                               "collectives_decode_step",
                               "collectives_decode_step_int8",
                               "collective_bytes_per_step", "cache_shapes",
                               "int8_cache_k_shape", "flash_shape",
                               "flash_launches_prefill")},
        "flash_max_abs_err_vs_plain": max(
            r["one_row"]["flash_max_abs_err_vs_plain"] for r in ranks),
        "prefill_ms_by_rank": [r["one_row"]["prefill_ms"] for r in ranks],
        "decode_ms_per_step_by_rank": [r["one_row"]["decode_ms_per_step"]
                                       for r in ranks],
        "peak_bytes_by_rank": [r["one_row"]["peak_bytes"] for r in ranks],
        "unsharded": ref,
        "note": "all ranks on one card at once over gloo: a collective is "
                "a host round trip"}), flush=True)


def _tp_margin_sure(logits, tol):
    """Rows whose top-two margin exceeds ``tol``."""
    import numpy as np
    srt = np.sort(logits, -1)
    return (srt[:, -1] - srt[:, -2]) > tol


def run_tp_serve_path(torch, smi, archs=tuple(TP_PATHS), one_row=True,
                      moe_runs=()):
    """Phase 6c's dense part over ``archs`` (TP_PATHS' keys), and with
    ``one_row`` the one-row run on (data 1, model 4), and ``moe_runs``
    (the MoE and MLA runs on SHARD_MESH whose ranks draw their own
    weights, gated by ``_tpm_check``) in the same spawn. Returns its
    launch counts (the ranks' flash and SSD launches on the card,
    summed)."""
    import tempfile
    import numpy as np
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import params_struct
    from repro_torch.launch.steps import serve_collectives, serve_rules
    from repro_torch.models.model import build_model
    from repro_torch.sharding import dist
    from repro_torch.sharding.spec import get_federation_spec
    t0 = time.perf_counter()
    backend, _, why = dist.choose_backend(SHARD_WORLD, "cuda")
    mesh = dist.AbstractMesh(dict(zip(SHARD_MESH[1], SHARD_MESH[0])))
    # the collectives a step of each path makes on a rank, derived from
    # the placement before the run
    rows = TP_ROWS // mesh.shape["data"]
    paths = {a: TP_PATHS[a] for a in archs}
    for arch, (_, fed, gen) in paths.items():
        model = build_model(_tp_cfg(arch))
        rules = serve_rules(model, mesh, params_struct(model),
                            spec=get_federation_spec(fed, mesh))
        print(f"tp {arch}: expected collectives on each rank", json.dumps({
            what: {k: n for k, n in serve_collectives(
                model, rules, rows, seq).items() if n}
            for what, seq in (("prefill", TP_PROMPT), ("decode step", 1))}),
            flush=True)
    _tpm_expected(moe_runs)
    print(f"tp: world {SHARD_WORLD}, mesh {SHARD_MESH}, backend {backend} "
          f"({why}); card {smi}", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref = {arch: _tp_unsharded(torch, arch, tmp) for arch in paths}
        if one_row:
            ref_one = _tp_one_row_unsharded(torch, tmp)
            with np.load(Path(tmp) / "one_row.npz") as z:
                one_want = {k: z[k] for k in z.files}
        moe_refs = {run[0]: _tpm_unsharded(torch, run, tmp)[0]
                    for run in moe_runs}
        t_ref = time.perf_counter() - t0
        dist.spawn(_tp_rank, SHARD_WORLD,
                   (tmp, tuple(paths), one_row, tuple(moe_runs)),
                   device="cuda")
        moe_flash = 0
        if moe_runs:
            tpm = []
            for r in range(SHARD_WORLD):
                with open(Path(tmp) / f"tpm.rank{r}.json") as f:
                    tpm.append(json.load(f))
            for run in moe_runs:
                moe_flash += _tpm_check(run, moe_refs[run[0]], tpm, tmp, smi)
        ranks = []
        for r in range(SHARD_WORLD):
            with open(Path(tmp) / f"rank{r}.json") as f:
                ranks.append(json.load(f))
            with np.load(Path(tmp) / f"rank{r}.npz") as z:
                ranks[-1]["arrays"] = {k: z[k] for k in z.files}
        want, full = {}, {}
        for arch in paths:
            with np.load(Path(tmp) / f"{arch}.npz") as z:
                want[arch] = (z["logits"], z["tokens"])
                if "full" in z.files:
                    full[arch] = z["full"]
    t_ranks = time.perf_counter() - t0 - t_ref
    for arch, (_, fed, gen) in paths.items():
        logits, tokens = want[arch]
        V = _tp_cfg(arch).vocab_size
        tol = TP_REL * float(np.abs(logits[..., :V]).max())
        worst, sure_steps, greedy_equal, gate_err = 0.0, 0, 0, None
        for res in ranks:
            d = res["coord"]["data"]
            sl = slice(d * TP_ROWS // 2, (d + 1) * TP_ROWS // 2)
            got = res["arrays"][f"{arch}.logits"]
            err = float(np.abs(got[..., :V] - logits[:, sl, :V]).max())
            worst = max(worst, err)
            if err > tol:
                raise AssertionError(f"tp {arch} rank {res['coord']}: logits "
                                     f"differ by {err} (tolerance {tol})")
            if arch in TP_GATE_PATHS:
                # the rank's prefill and decode logits, fed the unsharded
                # run's tokens, against the teacher-forced full forward
                mine = got[:gen, :, :V].transpose(1, 0, 2)
                ref_ = full[arch][sl, :, :V]
                gate_err = max(gate_err or 0.0,
                               float(np.abs(mine - ref_).max()))
                if _tpm_close(mine, ref_) > 0:
                    raise AssertionError(f"tp {arch} rank {res['coord']}: "
                                         "decode differs from the full "
                                         f"forward by {gate_err}")
            # the sharded argmax after each fed token against the
            # unsharded greedy token, where the margin is clear
            for t in range(1, gen):
                sure = _tp_margin_sure(logits[t, sl, :V], tol)
                mine = np.argmax(got[t, :, :V], -1)
                if not np.array_equal(mine[sure], tokens[sl, t][sure]):
                    raise AssertionError(f"tp {arch} step {t}: tokens "
                                         f"{mine} vs {tokens[sl, t]}")
                sure_steps += int(sure.sum())
            if arch == LM_ARCH:
                # the serve step's greedy tokens, up to the first step
                # whose margin is within the tolerance on some row
                g = res["arrays"][f"{arch}.greedy"]
                for t in range(gen):
                    if not _tp_margin_sure(logits[t, sl, :V], tol).all():
                        break
                    if not np.array_equal(g[:, t], tokens[sl, t]):
                        raise AssertionError(f"tp {arch} greedy step {t}: "
                                             f"{g[:, t]} vs {tokens[sl, t]}")
                    greedy_equal = t + 1
        peaks_ = [res["cases"][arch]["peak_bytes"] for res in ranks]
        if max(peaks_) >= ref[arch]["peak_bytes"]:
            raise AssertionError(f"tp {arch}: a rank's peak {max(peaks_)} B "
                                 "is not below the unsharded model's "
                                 f"{ref[arch]['peak_bytes']} B")
        cs = [res["cases"][arch] for res in ranks]
        print(f"tp {arch}", json.dumps({
            "card": smi, "federation": fed, "layers": _tp_cfg(arch).num_layers,
            "rows": TP_ROWS, "prompt": TP_PROMPT, "new_tokens": gen,
            "logits_max_abs_err": worst, "tolerance": tol,
            "tokens_checked": sure_steps,
            "greedy_steps_equal": greedy_equal,
            "decode_vs_full_forward_max_abs_err": gate_err,
            "collectives_prefill": cs[0]["collectives_prefill"],
            "collectives_decode_step": cs[0]["collectives_decode_step"],
            "collective_bytes_per_step": cs[0]["collective_bytes_per_step"],
            "staged_per_step": cs[0]["staged_per_step"],
            "flash_launches_prefill_each_rank":
                cs[0]["flash_launches_prefill"],
            "flash_shape": cs[0]["flash_shape"],
            "flash_max_abs_err_vs_plain": max(
                (c["flash_max_abs_err_vs_plain"] or 0.0) for c in cs),
            "ssd_launches_prefill_each_rank": cs[0]["ssd_launches_prefill"],
            "ssd_shape": cs[0]["ssd_shape"],
            "ssd_max_abs_err_vs_plain": max(
                (c["ssd_max_abs_err_vs_plain"] or 0.0) for c in cs),
            "prefill_ms_by_rank": [c["prefill_ms"] for c in cs],
            "decode_ms_per_step_by_rank": [c["decode_ms_per_step"]
                                           for c in cs],
            "peak_bytes_by_rank": peaks_,
            "local_params_by_rank": [c["local_params"] for c in cs],
            "unsharded": ref[arch],
            "note": "all ranks on one card at once over gloo: a collective "
                    "is a host round trip, so the step times say nothing "
                    "of NCCL"}), flush=True)
    # the dry run of the production mesh beside the measured peaks
    for shape in ("prefill_32k", "decode_32k") if LM_ARCH in paths else ():
        res = dryrun.lower_one(LM_ARCH, shape, False, verbose=False)
        print(f"tp dry run {LM_ARCH} {shape} 32x8", json.dumps({
            "analytic_memory": res["analytic_memory"],
            "memory": res["memory"], "collectives": res["collectives"],
            "roofline": res["roofline"], "lower_s": res["lower_s"],
            "measured_peak_bytes_by_rank_4_ranks": [
                r["cases"][LM_ARCH]["peak_bytes"] for r in ranks],
            "note": "other shapes (4 x 64 tokens on 2 x 2 here): no gate"}),
            flush=True)
    if one_row:
        _tp_one_row_check(ranks, one_want, ref_one, smi)
    launches = {(k, "cuda"): sum(r["cases"][a][f"{n}_launches_prefill"]
                                 for r in ranks for a in r["cases"])
                for k, n in (("flash_attention", "flash"),
                             ("ssd_chunks", "ssd"))}
    if one_row:
        launches[("flash_attention", "cuda")] += sum(
            r["one_row"]["flash_launches_prefill"] for r in ranks)
    launches[("flash_attention", "cuda")] += moe_flash
    print(f"tp: {time.perf_counter() - t0:.1f} s (unsharded runs "
          f"{t_ref:.1f} s, ranks {t_ranks:.1f} s)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6c, the MoE and MLA decoders: world-4 ranks, tensor-parallel serving
# ---------------------------------------------------------------------------

def _tpm_model(run):
    import torch
    from repro_torch.models.model import build_model
    return build_model(_cut_cfg(run[1], run[2]), getattr(torch, run[3]))


class _RouteTap:
    """While on, every ``moe.apply_moe`` call also keeps, at each row's
    last position (the one whose logits the step returns), the router's
    input and its probabilities, computed as ``apply_moe`` computes them
    (the same product on the same tensors). Kept on the card until
    ``arrays``; a bf16 run's routing gate reads them."""

    def __init__(self, moe, on):
        self.moe, self.on, self.taps = moe, on, []

    def __enter__(self):
        import torch
        inner = self.inner = self.moe.apply_moe

        def tapped(params, x, cfg):
            xt = x.reshape(-1, x.shape[-1])
            probs = torch.softmax((xt @ params["router"]).float(), dim=-1)
            last = torch.arange(x.shape[0], device=x.device) * x.shape[1] \
                + x.shape[1] - 1
            self.taps.append((x[:, -1].float(), probs[last]))
            return inner(params, x, cfg)

        if self.on:
            self.moe.apply_moe = tapped
        return self

    def __exit__(self, *exc):
        self.moe.apply_moe = self.inner

    def arrays(self):
        """{"route_x": (calls, B, D), "route_probs": (calls, B, E)}."""
        import torch
        if not self.taps:
            return {}
        return {"route_x": torch.stack([x for x, _ in self.taps]
                                       ).cpu().numpy(),
                "route_probs": torch.stack([p for _, p in self.taps]
                                           ).cpu().numpy()}


def _tpm_params(torch, run, dev):
    """The run's weights from TP_SEED on ``dev``; DeepSeek-V3 reduced's
    router leans on expert 0 over a shifted embedding table, so the
    served capacity drops choices."""
    model = _tpm_model(run)
    params = model.init(torch.Generator(device=dev).manual_seed(TP_SEED))
    if run[0] == "deepseek_reduced":
        params["embed"].add_(TPM_SHIFT)
        params["stack"]["run0"]["moe"]["router"][..., 0].add_(TPM_LEAN)
    return params


def _tpm_unsharded(torch, run, out_dir):
    """The run's unsharded prefill and greedy decode on the card at the
    served capacity; for the gate runs also the full forward of the
    prompts and generated tokens, and the prefill, at
    GATE_CAPACITY_FACTOR. Arrays to ``out_dir/<run>.npz``. Returns (its
    numbers, its params where the ranks read them, else None)."""
    import numpy as np
    from repro_torch.models import moe
    from repro_torch.utils.tree import tree_leaves
    name, gen = run[0], run[6]
    model = _tpm_model(run)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = _tpm_params(torch, run, "cuda")
    init_peak = torch.cuda.max_memory_allocated()
    prompts = torch.from_numpy(_tp_prompts(model.cfg)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tap = _RouteTap(moe, run[3] == "bfloat16")
    with torch.no_grad():
        t0 = time.perf_counter()
        with tap:
            logits, cache = model.prefill(params, {"tokens": prompts},
                                          cache_len=TP_PROMPT + gen)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        steps, toks = [logits[:, 0]], []
        tok = torch.argmax(logits, -1)
        t0 = time.perf_counter()
        for _ in range(gen):
            toks.append(tok)
            with tap:
                logits, cache = model.decode_step(params, cache, tok)
            steps.append(logits[:, 0])
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / gen
        peak = torch.cuda.max_memory_allocated()
        arrays = tap.arrays()
        arrays["logits"] = torch.stack(steps).float().cpu().numpy()
        arrays["tokens"] = torch.cat(toks, 1).cpu().numpy()
        if model.cfg.use_mla:
            for key in ("c_kv", "k_rope"):
                arrays[key] = cache["runs"]["run0"][key].float().cpu().numpy()
        del cache, logits, steps
        if name in TPM_GATE_RUNS:
            seq = torch.cat([prompts] + toks, 1)
            factor = moe.CAPACITY_FACTOR
            moe.CAPACITY_FACTOR = GATE_CAPACITY_FACTOR
            try:
                full, _ = model.apply(params, {"tokens": seq[:, :-1]})
                pre8, _ = model.prefill(params, {"tokens": prompts},
                                        cache_len=TP_PROMPT + gen)
            finally:
                moe.CAPACITY_FACTOR = factor
            arrays["full"] = full[:, TP_PROMPT - 1:].float().cpu().numpy()
            arrays["prefill_gate"] = pre8[:, 0].float().cpu().numpy()
            del full, pre8
    np.savez(Path(out_dir) / f"{name}.npz", **arrays)
    n = sum(a.numel() for a in tree_leaves(params))
    nbytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    out = {"params": n, "param_bytes": nbytes, "init_peak_bytes": init_peak,
           "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
           "peak_bytes": peak}
    if not run[7]:
        del params
        params = None
    torch.cuda.empty_cache()
    return out, params


def _tpm_rank_run(torch, run, mesh, dev, out_dir, shared):
    """One run of the MoE/MLA part of phase 6c on this rank: its blocks
    (of ``shared``, the parent's params read through CUDA IPC, or of
    its own draw), flash at its heads against the plain version (GQA),
    then the counted prefill and the unsharded tokens fed back, and for
    the gate runs the same at GATE_CAPACITY_FACTOR. Writes its arrays to
    ``out_dir/<run>.rank<r>.npz``; returns its record."""
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.launch.steps import (make_prefill_step, place_for_rank,
                                          place_prefill_cache,
                                          serve_collectives, serve_rules)
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.common import logical_rules
    from repro_torch.sharding import dist, hlo
    from repro_torch.sharding.spec import get_federation_spec, local_block
    from repro_torch.utils.tree import tree_leaves
    name, _, _, _, fed, mshape, gen, _ = run
    coord = dist.coords(mesh)
    model = _tpm_model(run)
    cfg = model.cfg
    whole = shared if shared is not None else _tpm_params(torch, run, dev)
    rules = serve_rules(model, mesh, whole,
                        spec=get_federation_spec(fed, mesh),
                        batch_size=TP_ROWS)
    prompts = torch.from_numpy(_tp_prompts(cfg)).to(dev)
    placed = place_for_rank(rules, params=whole, batch={"tokens": prompts},
                            device=dev)
    del whole
    torch.cuda.empty_cache()
    params, batch = placed["params"], placed["batch"]
    with np.load(Path(out_dir) / f"{name}.npz") as z:
        forced = local_block(torch.from_numpy(z["tokens"]),
                             (("data",), None), mesh, coord).to(dev)
    Bl = batch["tokens"].shape[0]
    want = [serve_collectives(model, rules, Bl, TP_PROMPT)] + \
        [serve_collectives(model, rules, Bl, 1)] * gen
    fa_err, shape = None, None
    if not cfg.use_mla:
        with logical_rules(rules):
            hd = attn.heads_of(params["stack"]["run0"]["attn"], cfg)
        shape = (Bl, TP_PROMPT, hd.h, hd.a, cfg.head_dim)
        g = torch.Generator(device=dev).manual_seed(dist.runtime().rank)
        q = torch.randn(shape[:3] + shape[4:], generator=g, device=dev)
        k, v = (torch.randn((Bl, TP_PROMPT, hd.a, cfg.head_dim),
                            generator=g, device=dev) for _ in range(2))
        fa_err = float((fa.flash_attention(q, k, v, causal=True)
                        - faref.attention_ref(q, k, v, causal=True)
                        ).abs().max())
        if fa_err > 2e-5 * max(1.0, float(v.abs().max())):
            raise AssertionError(f"tp moe {name}: flash at {shape} differs "
                                 f"from its plain version by {fa_err}")
        del q, k, v
    prefill = make_prefill_step(model, cache_len=TP_PROMPT + gen,
                                rules=rules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    hlo.reset()
    tap = _RouteTap(moe, run[3] == "bfloat16")
    with torch.no_grad():
        t0 = time.perf_counter()
        with tap:
            logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: n for k, n in fa.LAUNCHES.items() if n}
        ops = [hlo.snapshot()]
        # at one data rank the placement cuts the latent's time dim over
        # model: the rank keeps its block of the prefill's cache
        c = place_prefill_cache(rules, cache, TP_ROWS) if mshape[0] == 1 \
            else cache
        want[1:] = [serve_collectives(model, rules, Bl, 1, cache=c)] * gen
        steps = [logits[:, 0]]
        t0 = time.perf_counter()
        for t in range(gen):
            hlo.reset()
            with logical_rules(rules), tap:
                logits, c = model.decode_step(params, c, forced[:, t:t + 1])
            ops.append(hlo.snapshot())
            steps.append(logits[:, 0])
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / gen
    peak = torch.cuda.max_memory_allocated()
    arrays = tap.arrays()
    arrays["logits"] = torch.stack(steps).float().cpu().numpy()
    if cfg.use_mla:
        for key in ("c_kv", "k_rope"):
            arrays[key] = c["runs"]["run0"][key].float().cpu().numpy()
    del cache, c, logits, steps
    for i, (o, w) in enumerate(zip(ops, want)):
        got = _tp_roles(o)
        if got != {r: n for r, n in w.items() if n}:
            raise AssertionError(f"tp moe {name} step {i}: collectives "
                                 f"{got}, derived {w}")
    if fed == "cross_device":
        for o in ops:
            hlo.assert_no_param_gather(o, rules.spec)
    n_flash = 0 if cfg.use_mla else cfg.num_layers
    if launches != ({("flash_attention", dev.type): n_flash} if n_flash
                    else {}):
        raise AssertionError(f"tp moe {name}: prefill launched {launches}, "
                             f"expected {n_flash} flash launches")
    if name in TPM_GATE_RUNS:
        factor = moe.CAPACITY_FACTOR
        moe.CAPACITY_FACTOR = GATE_CAPACITY_FACTOR
        try:
            with torch.no_grad():
                lg, c8 = prefill(params, batch)
                g8 = [lg[:, 0]]
                for t in range(gen - 1):
                    with logical_rules(rules):
                        lg, c8 = model.decode_step(params, c8,
                                                   forced[:, t:t + 1])
                    g8.append(lg[:, 0])
        finally:
            moe.CAPACITY_FACTOR = factor
        arrays["gate"] = torch.stack(g8, 1).float().cpu().numpy()
        del lg, c8, g8
    np.savez(Path(out_dir) / f"{name}.rank{dist.runtime().rank}.npz",
             **arrays)
    rec = {"collectives_prefill": {r: n for r, n in want[0].items() if n},
           "collectives_decode_step": {r: n for r, n in want[-1].items()
                                       if n},
           "collective_bytes_per_step": [sum(x.bytes for x in o)
                                         for o in ops[:2]],
           "staged_per_step": [sum(x.staged for x in o) for o in ops[:2]],
           "flash_launches_prefill": n_flash,
           "flash_shape": list(shape) if shape else None,
           "flash_max_abs_err_vs_plain": fa_err,
           "prefill_ms": pre_ms, "decode_ms_per_step": dec_ms,
           "peak_bytes": peak,
           "local_params": sum(a.numel() for a in tree_leaves(params)),
           "local_param_bytes": sum(a.numel() * a.element_size()
                                    for a in tree_leaves(params))}
    del params, placed, batch
    torch.cuda.empty_cache()
    return rec


def _tpm_rank(rank, world, out_dir, runs, box):
    """One rank of the MoE/MLA part of phase 6c: ``runs`` (one mesh),
    each through ``_tpm_rank_run``; its records to
    ``out_dir/tpm.rank<rank>.json``. ``box`` holds the parent's params
    (CUDA IPC) or nothing: they are taken out of it and dropped before
    the rank ends, so that the parent gets their memory back (a
    process started by multiprocessing ends without finalizing what its
    arguments still hold)."""
    import gc
    import torch
    from repro_torch.sharding import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shared = box.pop() if box else None
    mesh = dist.make_mesh(runs[0][5], ("data", "model"))
    dev = dist.runtime().device
    res = {"device": str(dev), "coord": dist.coords(mesh), "runs": {}}
    for run in runs:
        res["runs"][run[0]] = _tpm_rank_run(torch, run, mesh, dev, out_dir,
                                            shared)
    del shared
    gc.collect()
    torch.cuda.synchronize()
    with open(Path(out_dir) / f"tpm.rank{rank}.json", "w") as f:
        json.dump(res, f)


def _tpm_close(got, want):
    """The largest |got − want| beyond torch.testing's rtol = atol =
    2e-3 (the decode == full forward gate's), 0 when within."""
    import numpy as np
    excess = np.abs(got - want) - (2e-3 + 2e-3 * np.abs(want))
    return float(max(excess.max(), 0.0))


def _tpm_routing(name, cfg, z, a, sl, row_err):
    """A bf16 run's routing against the unsharded run's, from the
    ``_RouteTap`` arrays: raises unless the router's input at every row
    and step is within TPM_BF16_REL·max of the unsharded one and at
    least half the rows and steps pick the unsharded run's K experts in
    every MoE layer. Returns (alike (steps, rows), the input's error and
    tolerance, the rows and steps routed otherwise with the unsharded
    router's K-th and (K+1)-th probabilities and their logits' error)."""
    import numpy as np
    K, steps, rows = cfg.num_experts_per_tok, row_err.shape[0], \
        row_err.shape[1]
    xu, pu = z["route_x"][:, sl], z["route_probs"][:, sl]
    xr, pr = a["route_x"], a["route_probs"]
    x_err = float(np.abs(xr - xu).max())
    x_tol = TPM_BF16_REL * float(np.abs(xu).max())
    if x_err > x_tol:
        raise AssertionError(f"tp moe {name}: the router's input differs "
                             f"by {x_err} (tolerance {x_tol})")

    def chosen(p):
        return np.sort(np.argsort(-p, -1, kind="stable")[..., :K], -1)

    # (steps, MoE layers, rows): every step runs each MoE layer once
    alike = (chosen(pr) == chosen(pu)).all(-1).reshape(steps, -1, rows)
    alike = alike.all(1)
    if 2 * alike.sum() < alike.size:
        raise AssertionError(f"tp moe {name}: only {alike.sum()} of "
                             f"{alike.size} rows and steps routed alike")
    ps = -np.sort(-pu, -1).reshape(steps, -1, rows, pu.shape[-1])
    other = [{"step": int(t), "row": int(b),
              "logits_err": float(row_err[t, b]),
              "unsharded_kth_k1th_prob": [
                  [float(ps[t, layer, b, K - 1]), float(ps[t, layer, b, K])]
                  for layer in range(ps.shape[1])]}
             for t, b in zip(*np.nonzero(~alike))]
    return alike, x_err, x_tol, other


def _tpm_check(run, ref, ranks, out_dir, smi):
    """The gates of one MoE/MLA run, then its line."""
    import numpy as np
    name, arch, _, dname, fed, mshape, gen, shared = run
    cfg = _cut_cfg(arch, run[2])
    V = cfg.vocab_size
    z = dict(np.load(Path(out_dir) / f"{name}.npz"))
    want, tokens = z["logits"], z["tokens"]
    f32 = dname == "float32"
    tol = (TP_REL if f32 else TPM_BF16_REL) * float(
        np.abs(want[..., :V]).max())
    nd = mshape[0]
    worst, worst_decode, sure_steps, gate_err = 0.0, 0.0, 0, None
    routing = None
    recs = [r["runs"][name] for r in ranks]
    arrs = [dict(np.load(Path(out_dir) / f"{name}.rank{i}.npz"))
            for i in range(len(ranks))]
    for res, a in zip(ranks, arrs):
        d = res["coord"]["data"]
        sl = slice(d * TP_ROWS // nd, (d + 1) * TP_ROWS // nd)
        got = a["logits"]
        if not np.isfinite(got[..., :V]).all():
            raise AssertionError(f"tp moe {name}: non-finite logits")
        row_err = np.abs(got[..., :V] - want[:, sl, :V]).max(-1)
        alike = np.ones(row_err.shape, bool)
        if not f32:
            alike, x_err, x_tol, other = _tpm_routing(name, cfg, z, a, sl,
                                                      row_err)
            routing = {"router_input_max_abs_err": x_err,
                       "router_input_tolerance": x_tol,
                       "rows_steps_routed_alike": int(alike.sum()),
                       "rows_steps": int(alike.size),
                       "routed_otherwise": other}
        worst = max(worst, float(row_err[0][alike[0]].max(initial=0.0)))
        worst_decode = max(worst_decode,
                           float(row_err[1:][alike[1:]].max(initial=0.0)))
        if worst > tol or worst_decode > tol:
            raise AssertionError(f"tp moe {name} rank {res['coord']}: logits "
                                 f"differ by {worst} / {worst_decode} "
                                 f"(tolerance {tol})")
        for t in range(gen + 1):
            mine = np.argmax(got[t, :, :V], -1)
            if not (mine < V).all():
                raise AssertionError(f"tp moe {name}: a token past the vocab")
            if t == gen:
                break
            sure = _tp_margin_sure(want[t, sl, :V], tol) & alike[t]
            if not np.array_equal(mine[sure], tokens[sl, t][sure]):
                raise AssertionError(f"tp moe {name} step {t}: tokens "
                                     f"{mine} vs {tokens[sl, t]}")
            sure_steps += int(sure.sum())
        if "gate" in a:
            e = _tpm_close(a["gate"][..., :V], z["full"][sl, :, :V])
            gate_err = max(gate_err or 0.0, float(np.abs(
                a["gate"][..., :V] - z["full"][sl, :, :V]).max()))
            if e > 0:
                raise AssertionError(f"tp moe {name}: decode at capacity "
                                     f"{GATE_CAPACITY_FACTOR} differs from "
                                     f"the full forward by {gate_err}")
    # the MLA latent cache: the same bits on every model rank of a data
    # coordinate; at one data rank each rank's block of its time dim, the
    # blocks in model order the unsharded run's latent (fed the same
    # tokens) within the run's tolerance
    latent_pairs, latent_err = 0, None
    if nd == 1 and cfg.use_mla:
        order = sorted(range(len(ranks)),
                       key=lambda i: ranks[i]["coord"]["model"])
        latent_err = 0.0
        for key in ("c_kv", "k_rope"):
            blocks = [arrs[i][key] for i in order]
            if len({b.shape[2] for b in blocks}) != 1 or \
                    blocks[0].shape[2] * len(blocks) != z[key].shape[2]:
                raise AssertionError(f"tp moe {name}: {key} blocks "
                                     f"{[b.shape for b in blocks]}")
            got = np.concatenate(blocks, axis=2)
            e = float(np.abs(got - z[key]).max())
            latent_err = max(latent_err, e)
            if e > (TP_REL if f32 else TPM_BF16_REL) * float(
                    np.abs(z[key]).max()):
                raise AssertionError(f"tp moe {name}: the ranks' {key} "
                                     f"blocks differ from the unsharded "
                                     f"latent by {e}")
            latent_pairs += len(blocks)
    for i, a in enumerate(ranks):
        for j, b in enumerate(ranks):
            if nd == 1 or j <= i or a["coord"]["data"] != b["coord"]["data"]:
                continue
            for key in ("c_kv", "k_rope"):
                if key in arrs[i]:
                    latent_pairs += 1
                    if not np.array_equal(arrs[i][key], arrs[j][key]):
                        raise AssertionError(f"tp moe {name}: {key} differs "
                                             f"between {a['coord']} and "
                                             f"{b['coord']}")
    if cfg.use_mla and not latent_pairs:
        raise AssertionError(f"tp moe {name}: no latent cache compared")
    drops = None
    if "prefill_gate" in z:
        # the served capacity drops choices: its prefill is not the
        # prefill at GATE_CAPACITY_FACTOR
        drops = float(np.abs(z["prefill_gate"][:, :V] - want[0, :, :V]).max())
        if name == "deepseek_reduced" and drops <= tol:
            raise AssertionError(f"tp moe {name}: no choice dropped at the "
                                 f"served capacity ({drops} <= {tol})")
    peaks_ = [r["peak_bytes"] for r in recs]
    if not shared and max(peaks_) >= ref["peak_bytes"]:
        raise AssertionError(f"tp moe {name}: a rank's peak {max(peaks_)} B "
                             "is not below the unsharded run's "
                             f"{ref['peak_bytes']} B")
    print(f"tp moe {name}", json.dumps({
        "card": smi, "arch": arch, "layers": cfg.num_layers,
        "dtype": dname, "federation": fed,
        "mesh": dict(zip(("data", "model"), mshape)), "rows": TP_ROWS,
        "prompt": TP_PROMPT, "new_tokens": gen,
        "capacity_factor": 1.25,
        "prefill_logits_max_abs_err": worst,
        "decode_logits_max_abs_err": worst_decode, "tolerance": tol,
        "routing_vs_unsharded": routing,
        "tokens_checked": sure_steps,
        "decode_eq_full_forward_max_abs_err": gate_err,
        "served_vs_gate_capacity_prefill_diff": drops,
        "latent_cache_pairs_bitwise": latent_pairs if nd > 1 else None,
        "latent_time_blocks": latent_pairs if nd == 1 else None,
        "latent_blocks_vs_unsharded_max_abs_err": latent_err,
        "collectives_prefill": recs[0]["collectives_prefill"],
        "collectives_decode_step": recs[0]["collectives_decode_step"],
        "collective_bytes_per_step": recs[0]["collective_bytes_per_step"],
        "staged_per_step": recs[0]["staged_per_step"],
        "flash_launches_prefill_each_rank": recs[0]["flash_launches_prefill"],
        "flash_shape": recs[0]["flash_shape"],
        "flash_max_abs_err_vs_plain": max(
            (r["flash_max_abs_err_vs_plain"] or 0.0) for r in recs),
        "prefill_ms_by_rank": [r["prefill_ms"] for r in recs],
        "decode_ms_per_step_by_rank": [r["decode_ms_per_step"]
                                       for r in recs],
        "peak_bytes_by_rank": peaks_,
        "local_param_bytes_by_rank": [r["local_param_bytes"] for r in recs],
        "params_from_the_parent_by_cuda_ipc": shared,
        "unsharded": ref,
        "note": "all ranks on one card at once over gloo: a collective is a "
                "host round trip, so the step times say nothing of NCCL"
                + ("; the ranks' blocks are views of the parent's params "
                   "(CUDA IPC), which their peaks do not count" if shared
                   else "")}), flush=True)
    return sum(r["flash_launches_prefill"] for r in recs)


# the archs whose heads split over the production mesh's 8 model ranks
# (or that have none to split): their one-row long_500k lowers
LONG_ARCHS = ("tinyllama-1.1b", "codeqwen1.5-7b", "qwen2.5-14b",
              "granite-20b", "olmoe-1b-7b", "deepseek-v3-671b", "zamba2-7b",
              "xlstm-1.3b")
# the dry runs, started before phase 4 and read after 6c, one CPU
# process each: (archs, shapes). train_4k at one local step (the
# analytic memory does not depend on K); xLSTM's prefill and round count
# the sLSTM loop at two and three cells (launch.dryrun._lower_scaled:
# 6 and 48 s on one thread of a CPU, where counting every cell at 512
# and 768 tokens took 155 and 503 s); long_500k on a cache cut over
# model, for every arch whose heads split 8 ways
TP_DRY_RUNS = ((("xlstm-1.3b",), ("prefill_32k", "decode_32k", "train_4k")),
               (LONG_ARCHS, ("long_500k",)),
               ((MOE_ARCH, MLA_ARCH), ("decode_32k", "train_4k")),
               (("zamba2-7b",), ("prefill_32k", "decode_32k", "train_4k")))


# launch/perf.py's variants, one pair a family, each pair a CPU process
# beside phase 4 (as the dry runs): the sharded flat round's, on
# TinyLlama and on Qwen2.5-14B at full width (cross_silo: one client
# whose N is cut 256 ways), the MoE switches, the decode cache's and the
# bf16 softmax
PERF_RUNS = (("tinyllama-1.1b/train_4k",
              "flat_fed_sharded,flat_fed_compressed,flat_fed_rounds_fused"),
             ("qwen2.5-14b/train_4k", "flat_fed_faults"),
             ("olmoe-1b-7b/train_4k", "capacity1,expert_2d"),
             ("tinyllama-1.1b/decode_32k", "quant_kv+cache_seq_shard"),
             ("tinyllama-1.1b/prefill_32k", "softmax_bf16"))


def _cpu_env():
    import os
    return dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
                OMP_NUM_THREADS="1")


def start_perf_runs(tmp):
    """``PERF_RUNS`` on the (32, 8) H100 mesh's dry run, each pair in a
    CPU process of its own (one thread, the lowest priority), writing
    into ``tmp``; read by ``report_perf_runs``."""
    import atexit
    import os
    procs = []
    for pair, variants in PERF_RUNS:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.perf", "--pair", pair,
             "--variants", variants, "--out", tmp], env=_cpu_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(19)))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def report_perf_runs(procs, tmp, dry_tmp):
    """Each perf pair's output and variants (a refusal fails: every
    variant asked for lowers), then ``launch/report.py``'s tables over
    the dry runs' and perf's artifacts."""
    for (pair, variants), proc in zip(PERF_RUNS, procs):
        try:
            out, _ = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode:
            raise AssertionError(f"perf {pair} failed:\n{out}")
        print(f"perf {pair}:\n{out.strip()}", flush=True)
        with open(Path(tmp) / (pair.replace("/", "_") + ".json")) as f:
            res = json.load(f)
        for v in variants.split(","):
            if "refused" in res[v]:
                raise AssertionError(f"perf {pair} {v}: {res[v]}")
            print(f"perf {pair} {v} 32x8", json.dumps(res[v]), flush=True)
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--dir",
         dry_tmp, "--perf", tmp], env=_cpu_env(), capture_output=True,
        text=True, timeout=300)
    if rep.returncode:
        raise AssertionError(f"report failed:\n{rep.stdout}{rep.stderr}")
    print(rep.stdout, flush=True)


def start_tp_dry_runs(tmp, groups=TP_DRY_RUNS):
    """The dry runs of ``groups`` (TP_DRY_RUNS' rows) on the (32, 8)
    H100 mesh, on fake tensors, each group in a CPU process of its own
    (one thread, at the lowest scheduling priority, so the host-bound
    phases they run beside keep their cores); read by
    ``report_tp_dry_runs``."""
    import atexit
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = []
    for archs, shapes in groups:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ",".join(archs), "--shape", ",".join(shapes), "--mesh",
             "single", "--local-steps", "1", "--out", tmp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(19)))
    # stopped with the script, whichever phase fails
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def report_tp_dry_runs(procs, tmp, groups=TP_DRY_RUNS):
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode:
            raise AssertionError(f"tp dry runs failed:\n{out}")
    for archs, shapes in groups:
        for arch in archs:
            for shape in shapes:
                with open(Path(tmp) / f"{arch}_{shape}_single.json") as f:
                    r = json.load(f)
                roles = {"zamba2-7b": ("ssm_zx", "ssm_conv", "ssm_norm",
                                       "tp_reduce"),
                         "xlstm-1.3b": ("xlstm_up", "xlstm_qkv",
                                        "tp_reduce")}.get(arch, ())
                if shape == "long_500k":
                    roles += ("xlstm_state",) if arch == "xlstm-1.3b" \
                        else ("seq_max", "seq_sum")
                if not all(r["collectives"].get(k) for k in roles):
                    raise AssertionError(f"tp dry run {arch} {shape}: "
                                         f"collectives {r['collectives']}")
                print(f"tp dry run {arch} {shape} 32x8", json.dumps({
                    k: r[k] for k in ("federation", "analytic_memory",
                                      "memory", "collectives", "roofline",
                                      "lower_s", "model_flops",
                                      "hlo_flops_total")}), flush=True)



def _tpm_expected(runs):
    """Print each MoE/MLA run's collectives a step on a rank, derived
    from the placement before the run (a decode step on the prefill's
    cache, whole over its time dim)."""
    from repro_torch.launch.specs import params_struct
    from repro_torch.launch.steps import serve_collectives, serve_rules
    from repro_torch.sharding import dist
    from repro_torch.sharding.spec import get_federation_spec
    for run in runs:
        mesh = dist.AbstractMesh(dict(zip(("data", "model"), run[5])))
        model = _tpm_model(run)
        rules = serve_rules(model, mesh, params_struct(model),
                            spec=get_federation_spec(run[4], mesh),
                            batch_size=TP_ROWS)
        rows = TP_ROWS // run[5][0]
        print(f"tp moe {run[0]}: expected collectives on each rank",
              json.dumps({what: {k: n for k, n in serve_collectives(
                  model, rules, rows, seq).items() if n}
                  for what, seq in (("prefill", TP_PROMPT),
                                    ("decode step", 1))}), flush=True)


def run_tp_moe_serve_path(torch, smi, runs=TPM_RUNS):
    """Phase 6c's MoE and MLA runs (``runs``: TPM_RUNS' rows, each
    gated on its own). Returns its launch counts (the ranks' flash
    launches on the card, summed)."""
    import tempfile
    from repro_torch.sharding import dist
    t0 = time.perf_counter()
    _tpm_expected(runs)
    flash = 0
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the runs whose ranks draw their own weights, in one spawn; then
        # each run whose ranks read the parent's, a spawn each
        own = [r for r in runs if not r[7]]
        groups = [(own, None)] * bool(own) + [([r], True) for r in runs
                                              if r[7]]
        for group, shared in groups:
            t1 = time.perf_counter()
            refs, params = {}, None
            for run in group:
                refs[run[0]], params = _tpm_unsharded(torch, run, tmp)
            t_ref = time.perf_counter() - t1
            dist.spawn(_tpm_rank, SHARD_WORLD,
                       (tmp, group, [] if params is None else [params]),
                       device="cuda")
            del params
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
            left = torch.cuda.memory_allocated()
            if left > 2 ** 30:
                raise AssertionError(f"tp moe: {left} B still allocated "
                                     "after the ranks ended")
            ranks = []
            for r in range(SHARD_WORLD):
                with open(Path(tmp) / f"tpm.rank{r}.json") as f:
                    ranks.append(json.load(f))
            for run in group:
                flash += _tpm_check(run, refs[run[0]], ranks, tmp, smi)
            times["+".join(r[0] for r in group)] = {
                "unsharded_s": t_ref,
                "ranks_s": time.perf_counter() - t1 - t_ref,
                "parent_allocated_after_bytes": left}
    print(f"tp moe: {time.perf_counter() - t0:.1f} s", json.dumps(times),
          flush=True)
    return {("flash_attention", "cuda"): flash}


def main() -> int:
    t_start = time.perf_counter()
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
    # each phase's seconds, printed before the script's total
    marks = [("start", time.perf_counter())]

    def mark(phase):
        marks.append((phase, time.perf_counter()))

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
    mark("1-3 build and kernels")
    # the dry runs start now, beside phase 4
    import tempfile
    dry_dir = tempfile.TemporaryDirectory()
    dry = start_tp_dry_runs(dry_dir.name)
    perf_dir = tempfile.TemporaryDirectory()
    perf = start_perf_runs(perf_dir.name)

    # 4. paths
    paths = {}
    t0 = time.perf_counter()
    paths["plain"], flat_round0 = run_path(torch, mods, train)
    took("4a plain", t0)
    for pname in SCENARIO_PATHS:
        t0 = time.perf_counter()
        paths[pname] = run_scenario_path(torch, mods, train, pname)
        took(f"4a {pname}", t0)
    t0 = time.perf_counter()
    paths["telemetry"] = run_telemetry_path(torch, mods, train)
    took("4b telemetry", t0)
    # 4c. the vmap engine
    t0 = time.perf_counter()
    paths.update(run_vmap_path(torch, mods, train, flat_round0, smi))
    took("4c vmap", t0)
    # 4d. async, fleet, resume, serving from a checkpoint
    for pname in ASYNC_PRESETS:
        t0 = time.perf_counter()
        paths[pname] = run_async_path(torch, mods, train, pname, smi)
        took(f"4d {pname}", t0)
    t0 = time.perf_counter()
    paths.update(run_fleet_path(torch, mods, train, smi))
    took("4d fleet", t0)
    t0 = time.perf_counter()
    paths.update(run_resume_paths(torch, mods, train))
    took("4d resume", t0)
    t0 = time.perf_counter()
    paths["serve_checkpoint"] = run_serve_checkpoint(torch, mods, smi)
    took("4d serve from a checkpoint", t0)
    mark("4a-4d")
    # 4e. LM training
    torch.cuda.empty_cache()
    lm_paths, lm_rows = run_lm_train_path(torch, mods, train, tk, tref, bw,
                                          f32, smi)
    paths.update(lm_paths)
    rows.update(lm_rows)
    mark("4e")
    # 4f. multi-device Δ-SGD
    torch.cuda.empty_cache()
    paths["sharded"] = run_sharded_path(torch, tk, tref, bw, f32, smi)
    mark("4f")
    # 4g. tensor-parallel training
    torch.cuda.empty_cache()
    paths["tp_train"], tpt_rows = run_tp_train_path(torch, smi, bw, f32)
    rows.update(tpt_rows)
    mark("4g")

    # 5. lm kernels
    rows.update(check_lm_kernels(torch, fa, faref, m2, m2ref, bw, f32))
    mark("5")

    # 6. serving
    for arch, (layers, dtype_name) in SERVE_PATHS.items():
        t0 = time.perf_counter()
        paths[arch] = run_serve_path(torch, mods, arch, layers, dtype_name,
                                     smi)
        took(f"6 {arch}", t0)
    mark("6")

    # 6b. the serving plane
    paths.update(run_serving_plane(torch, mods, smi))
    mark("6b")

    # 6c. tensor-parallel serving: the dense decoders, then the MoE and
    # MLA ones, the latter's dry runs read last
    torch.cuda.empty_cache()
    paths["tp_serve"] = run_tp_serve_path(
        torch, smi, moe_runs=[r for r in TPM_RUNS if not r[7]])
    mark("6c dense, one row and MoE")
    torch.cuda.empty_cache()
    paths["tp_moe_serve"] = run_tp_moe_serve_path(
        torch, smi, runs=[r for r in TPM_RUNS if r[7]])
    mark("6c through CUDA IPC")
    report_tp_dry_runs(dry, dry_dir.name)
    report_perf_runs(perf, perf_dir.name, dry_dir.name)
    dry_dir.cleanup()
    perf_dir.cleanup()
    mark("waiting for the dry runs and perf")

    # 7. the kernel parity matrix
    paths["matrix"] = run_matrix(torch, mods)
    mark("7")

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
    print("phase seconds", json.dumps({
        b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}))
    print(f"script total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
