#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no result line):

1.  card     -- the card's name and power limit, torch and CUDA versions;
2.  build    -- compile the four CUDA kernels from the checkout's sources
               (one ``nvcc`` each, ``sm_90a``, started together), print
               each build time and every kernel's ``-Xptxas -v`` lines
               (registers, shared memory, spills); the support-core kernel
               and the tensor-core flash kernel must not spill;
3.  kernels  -- each kernel against its plain PyTorch version on the card:
               the support-core burst bit for bit (directed cases, the
               sweep shapes, a large shape, a 50-burst trace, and the
               decode, release and all-NOP bursts of card-sized gemma3-1b
               pools of 35840 and 65536 pages, gated and ungated, each
               with its path and cluster size); paged decode
               attention and flash prefill attention over the JAX sweeps in
               f32 and bf16, the serving shapes of both configurations, the
               NO_BLOCK slot, shared vs private tables (bit-identical), the
               self mode on a pool layer with inactive lanes and a page
               boundary, and a ragged Tq; bf16 flash edge cases (T, window,
               hd and G swept, queries scaled by 8 so scores reach +-30);
               paged lanes spanning no, one and every split of the context,
               against both plain versions; two identical launches of each
               kernel bit-identical (the support core on its block and
               cluster paths); then times per launch at the serving
               shapes beside the plain version, the bound and, for flash,
               ``scaled_dot_product_attention`` (causal, or with a boolean
               band mask for the window; timed here only); the
               support-core burst also at the large shape, the pool's
               three bursts and one burst on the global path (a pool of
               131072 pages), beside the launch floor (a one-element fill);
               the multi-engine bursts (a merged window burst over four
               classes, a FREE_ALL over aliased pages, the in-step R = 1
               emergency burst) bit for bit; zamba2-1.2b's bursts at its
               serving pool bit for bit, three tenants (KV pages, state
               slots, scratch) on one engine (C = 3: admission, gated
               decode, release) and on two shards (C = 6: admissions and a
               merged release), nothing in use after a release, the C = 3
               admission and the C = 6 release timed; the paged and flash
               kernels also at zamba2-1.2b's shared-block shapes (hd 64,
               H = KV = 32) and at the dense backbones' (phi3-medium's
               40 heads on 10 KV heads x 128, qwen2's 64 on 8 x 128,
               phi-3-vision's 32 on 32 x 96; flash at 576 + 524 rows and
               a bf16 edge sweep at hd 96), timed there too; mixtral-8x7b's
               bursts at its serving pool (N = 1536) bit for bit: a gated
               decode burst carrying mallocs, refills and the overflow
               single frees of recycled pages, and a burst in which a
               single free and a FREE_ALL name one refcount-1 page (it must
               return once), both timed; paged decode at mixtral's shape
               (32 on 8 KV heads x 128, 4 lanes of 4111-4250 tokens, window
               4096, the slots behind the window NO_BLOCK) and flash at 4 x
               4090 and 1 x 4100 rows (window 4096), in f32 and bf16, each
               timed, with faults planted in their plain versions (the
               window ignored, the last page or key tile lost) that the
               row check must reject; every attention case holds each
               output row to ROW_TOL of its own max besides TOL; flash
               prefill over a cached
               prefix (query offsets 8-1200) in f32 and bf16, offset 0
               bit-identical to the call without one, and one offset
               shape per architecture timed; the bitmap and buddy policies
               (plain PyTorch on the card) against the same bursts on the
               CPU, bit for bit: directed ``OP_MALLOC_RUN`` cases (an
               aligned run, the fallback to singles, split and merge
               counts), a 50-burst random trace, the gated all-NOP burst
               and the card-sized pool's decode burst; no burst of any
               policy and no staged commit synchronises with the host
               (``torch.cuda.set_sync_debug_mode``); each timed at the
               serve's shape and the pool's, beside the free-list kernel
               on the same burst;
4.  serve    -- deepseek-7b at its published widths (bf16, random weights
               from a seeded generator) serves 8 synthetic requests through
               the port's scheduler and engine: every support-core burst,
               decode attention and prefill attention of that run must be
               a kernel launch, and the allocator invariants must hold with
               no live page at the end; prints the median wall time of a
               prefill pass (ending in ``torch.cuda.synchronize()``);
4b. serve    -- gemma3-1b at its published widths (26 layers, windows of
               512 on five layers in six, GQA 4:1) the same way, with
               prompts of 600-1500 tokens so the window binds;
4g. phi3     -- phi3-medium-14b at its published widths (40 layers,
               d_model 5120, 40 heads on 10 KV heads x 128: G = 4; 29.3 GB
               of bf16 weights) the same way as 4b, with 4b's traffic
               (8 prompts of 600-1500 tokens, 16-token pages, 32 new
               tokens); prints the weights', the KV pool's and a token's
               K/V bytes;
4h. qwen2    -- qwen2-72b at its published widths with a depth cut (8 of
               80 layers, printed as ``reduced``; d_model 8192, 64 heads
               on 8 KV heads x 128: G = 8, random nonzero QKV biases, RoPE
               theta 1e6), 4b's traffic;
4i. vlm      -- phi-3-vision-4.2b at its published widths (32 layers, head
               dim 96): 8 requests of 576 patch rows (``randn``, f32 cast
               to bf16) and prompts of 32-512 tokens, 16-token pages,
               seq_len 1152; every admitted lane must hold its patch rows
               and its prompt; then in f32 with TF32 off, 576 patch rows
               and a 124-token prompt, 8 decode steps fed given tokens
               against ``forward(prefix_embeds=...)`` (max |decode -
               forward| / max |logit| <= 2e-4);
               4g-4i check launches as phase 4 does and that nothing is
               in use at the end;
4l. mixtral  -- mixtral-8x7b at its published widths with a depth cut (16
               of 32 layers, printed as ``reduced``; 8 experts of d_ff
               14336, top-2, 32 heads on 8 KV heads x 128, sliding window
               4096; 46.96 GB of bf16 weights): 8 prompts of 4000-4090
               tokens, 16-token pages, seq_len 4352, 160 new tokens, so
               every lane passes position 4111, where its first page slides
               out of the window; launches as phase 4 checks them; after
               every step no lane's table holds more than ceil(4096 / 16) +
               1 = 257 pages and every lane recycled pages (each step's
               tables kept and counted after the timed serve); prints recycles, stash pushes and flushes; then a
               profile of 8 decode steps with the MoE layers' and their
               routing's shares;
4l'. mixtral -- decode against the forward in f32 with TF32 off at full
               width, 2 of 32 layers, capacity factor 4 (no token can
               drop): one 4100-token prompt, 40 steps fed given tokens, so
               pages are recycled at positions 4111 and 4127 (max |decode
               - forward| / max |logit| <= 2e-4);
4m. phi3.5   -- phi3.5-moe-42b-a6.6b at its published widths, 16 of 32
               layers (16 experts of d_ff 6400, top-2, full attention;
               42.1 GB), 4b's traffic, the same checks;
4f. hybrid   -- zamba2-1.2b at its published widths (38 Mamba2 layers,
               d_model 2048, one shared attention block every 6 layers:
               6 KV layers of 32 heads x 64) the same way, bf16, 4 lanes,
               8 prompts of 600-1500 tokens, 32 new tokens: support-core
               launches == commits, paged == engine-steps x 6, flash ==
               prefill passes x 6, every tenant (``kv_pages``,
               ``state_slots``, ``scratch``) empty at the end; prints
               tokens/s, the median step and prefill pass, peak and
               per-part memory beside the card; profiles 8 decode steps
               of its first batch (launches, device time, idle share) and
               the shares of the Mamba2 blocks and of their SSD
               recurrence (plain PyTorch) in them; then in f32 with TF32
               off, 8 decode steps fed given tokens after a 700-token
               prompt against the full forward (max |decode - forward| /
               max |logit| <= 2e-4);
4c. multi    -- deepseek-7b at full width (phase 4's weights) as two engine
               shards of four lanes on one support core, burst windows of
               4 steps, preemption on, per-shard prefix caches in alias
               mode: 16 requests on two shared 64-token prefixes, each
               routed to the shard that caches its prefix; every shard
               must hit, save prefill tokens and alias pages, I1–I6 must
               hold after every window, every burst, decode attention and
               prefill attention must be a kernel launch, and each shard's
               last occupancy must be its cache's residue; prints the
               window commits, the cross-engine burst occupancy, decode
               tokens/s, the median prefill pass with and without a hit,
               and how many tokens differ from the cache-off run (printed,
               not gated: bf16 products of other shapes round otherwise);
4d. open     -- phase 4c's deployment under the buddy policy, driven open
               loop: 24 requests from ``build_workload`` (Poisson, 0.5 per
               decode step, seed 0; prompts bounded-Pareto alpha 2 in 8-48
               tokens, outputs alpha 1.5 in 2-24, half on one 16-token
               shared prefix, a quarter at priority 1), every shard
               compacted after every second window, the allocator-op trace
               recorded; fails on a stranded request, on I1-I6 after any
               window (copied on the card, checked after the run), unless
               every decode and prefill attention is a kernel launch and
               the support core none, unless each shard's mean run length
               exceeds 1 and its last occupancy is its cache's residue;
               prints TTFT and TPOT percentiles, requests/s, queue depth,
               the compaction moves and a pass's fragmentation report;
4e. replay   -- 4d's tracefile replayed with no model on the card and on
               the CPU: as recorded (buddy), the live run's counters;
               without its block-naming ops (``drop_block_ids``), under
               each of the three policies; every final state card == CPU
               bit for bit, every free-list burst a kernel launch, and a
               what-if of the whole trace refused; prints each replay's
               wall time and bursts/s;
5.  device   -- the same requests at the reduced configs in f32 (TF32 off)
               through the port on ``cuda`` and on ``cpu``, for every
               architecture (zamba2-1.2b at 4 layers, the shared block
               twice; phi3-medium with 8 heads on 2 KV heads, qwen2 with
               8 on 1 and its QKV bias, phi-3-vision at hd 96 with 4 patch
               rows a request): allocator state and served tokens must be
               identical; then, for deepseek-7b, gemma3-1b and qwen2-72b,
               two shards with the cache on (alias mode for deepseek-7b
               and qwen2-72b, copy for gemma3-1b) on both devices:
               identical tokens and shared allocator state, and tokens
               equal to the cache-off run's; then the same two shards under
               the bitmap and under the buddy policy, stepped window by
               window on both devices with one compaction pass after the
               second window: the shared allocator state identical after
               every window, and tokens equal to the free-list run's;
               zamba2-1.2b, which no prefix cache serves, instead runs its
               two shards without one under the free list and under buddy
               (a compaction pass after the second window), window by
               window on both devices, to the same checks; mixtral-8x7b
               (window 64, prompts of 65-128 tokens) and phi3.5-moe at
               smoke widths (4 experts) the same way on one engine; mixtral
               again with the stash off (every recycle a single free on the
               decode burst; recycles and flushes equal on both devices),
               then as two shards with the stash off and the cache on (copy
               mode), window by window, its recycled pages flushed on the
               window commits;
6a. train    -- for the ten architectures at phase 5's reduced configs
               (gemma3-1b with one local and one global layer and 128-token
               rows, past its window of 64), f32 with TF32 off, the same
               weights and ``TokenSource`` batch on the card and on the
               CPU: two ``make_train_step`` steps, the second with
               ``grad_accum=2`` and compression; loss, gradient norm,
               first moments and every parameter card against CPU within
               the tolerances of ``train_device_vs_cpu``; no flash launch
               in a train step; the flash op raises on an input that
               requires a gradient;
6b. train    -- gemma3-1b at its published widths (about 1.0 B parameters)
               in bf16 with remat, one ``DataPipeline`` batch of 8 x 1024
               tokens trained 8 times: every loss finite, the last below
               the first; prints the losses, gradient norms, step times
               (each ending when the loss is read back), tokens/s, peak
               memory and the card's line; then the step's parts: forward
               + backward, the AdamW update, the cross entropy and
               ``mea_attention`` alone (forward + backward) beside
               ``F.cross_entropy`` and SDPA (timed here only) and their
               bounds;
6c. trainer  -- the port's ``Trainer`` on the card in bf16 at gemma3-1b's
               widths with 2 layers and a 16384-word vocabulary (a 0.73 GB
               checkpoint): preempted at step 6, it restarts once from the
               checkpoint of step 4 and ends within 1e-2 of an
               uninterrupted run's loss; the last checkpoint, restored onto
               the card and saved again, gives the same files, its bf16
               leaves bit for bit; phase 6 prints one JSON line of its
               numbers;
7.  sim      -- the allocator simulator (``repro_torch.sim``): the
               ``sim_trace`` kernel against its plain loop, all nine
               counts bit for bit, for every policy of ``ALL_POLICIES``
               on every paper workload at its own thread count and at 16
               (324 traces of 4096 events), on the empty trace and at
               4096 threads (the state in device memory); 2**24 + 8
               mallocs on the kernel alone must read 16777216.0 (float32
               saturation); ``calibration_table(16)`` and phase 4d's
               tracefile through ``replay_sim_policies`` for all nine
               policies, card equal to cpu, each trace of that main path
               one kernel launch; prints the kernel's time per trace
               beside the launch floor and the plain loop's host time,
               both ``calibration_table`` wall times and the card's line;
8a. mesh     -- phase 4's deepseek-7b serve (full width, the same
               requests) on a one-rank NCCL mesh (an in-process
               ``HashStore``): parameters placed by ``distribute_params``,
               the engine's decode step and prefill built with
               ``ShardingHints(mesh)``, its state placed by
               ``distribute_state`` each step; tokens equal to phase 4's,
               support-core launches == commits, paged == steps x 30,
               flash == passes x 30, I1-I6 after the serve;
8b. dry run  -- the same configuration and decode shapes dry-run on a fake
               one-rank mesh (``meta`` tensors): its argument bytes equal
               8a's parameters and state on the card to the byte; prints
               its temp peak and FLOPs beside the card's peak above the
               arguments and ``model_flops``;
8c. meshes   -- ``repro_torch.launch.dryrun`` on the production meshes,
               one process per cell (one CPU thread each), all started
               together after phase 2, while the card runs phases 3-8b,
               and collected here: qwen2-72b
               train_4k (FSDP + TP, backward) and mixtral-8x7b prefill_32k
               (TP-MoE, 16 dispatch groups) on 16x16, phi3.5-moe decode_32k
               (EP) on 2x16x16, deepseek-7b decode_32k on 16x16; each
               ``ok`` with no parameter shard above 1 GiB; prints each
               cell's roofline row (dry-run counts over datasheet peaks,
               not times) beside the card's line;
9.  examples -- the four examples a user runs first, each through its
               ``main`` in-process on the card: ``torch_quickstart.py``
               (all six parts with their asserts; its support-core
               launches equal its free-list services' and engines'
               commits and the replayed bursts, paged launches its
               engine-steps x KV layers, flash launches its prefill passes
               x KV layers, sim-trace launches its two sim replays; part
               1's grants equal a CPU run's), ``torch_serve_paged.py``
               (every request served), ``torch_train_lm.py`` (lm-100m, 60
               steps of 8 x 256 tokens with a checkpoint at 50 and 60 in a
               temporary directory: losses finite, their mean over the
               second half below the initial weights' loss; median step
               ms, tokens/s and peak memory recorded) and
               ``torch_allocator_sim.py`` (one sim-trace launch a trace;
               its printed table equal, character for character, to the
               same script on the CPU); fails past 60 s;
10. result   -- the card's line again, one JSON line describing the
               kernels (each kernel's launches also counted over the
               training runs of 6b and 6c: none; over 8a's serve; over
               phase 9's examples; the sim kernel's over phase 7's main
               path and phase 9), then the last line
               ``{"ok": true, "device": {...}}``.

Each phase's header line ends with the seconds since the run began.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM non-tensor f32 rate, per data sheet
TENSOR_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
FULL = 1 << 30                 # "no window"
SERVE_LANES = 4
# prefill over a cached prefix at the serving shapes, 4 lanes:
# (Tq, q_offset, H, KV, hd, window)
OFFSET_SHAPES = {
    "deepseek-7b offset 64": (64, 64, 32, 32, 128, FULL),
    "gemma3-1b local offset 1024": (512, 1024, 4, 1, 256, 512)}
# per architecture: pool shape, prompt mix and generation length
WORKLOADS = {
    "deepseek-7b": dict(seq=256, page=8, max_prompt=128, requests=8,
                        new_tokens=16, prompt_lens=None),
    "gemma3-1b": dict(seq=2048, page=16, max_prompt=1536, requests=8,
                      new_tokens=32, prompt_lens=(600, 1500)),
    "zamba2-1.2b": dict(seq=2048, page=16, max_prompt=1536, requests=8,
                        new_tokens=32, prompt_lens=(600, 1500)),
    "phi3-medium-14b": dict(seq=2048, page=16, max_prompt=1536, requests=8,
                            new_tokens=32, prompt_lens=(600, 1500)),
    "qwen2-72b": dict(seq=2048, page=16, max_prompt=1536, requests=8,
                      new_tokens=32, prompt_lens=(600, 1500)),
    # 576 patch rows ahead of prompts of 32-512 tokens: 576 + 512 + 32 new
    # tokens fit 73 pages of 16 (seq_len 1152)
    "phi-3-vision-4.2b": dict(seq=1152, page=16, max_prompt=512, requests=8,
                              new_tokens=32, prompt_lens=(32, 512),
                              patches=576),
    "rwkv6-7b": dict(seq=2048, page=16, max_prompt=1536, requests=8,
                     new_tokens=32, prompt_lens=(600, 1500)),
    # 1500 frame rows a request; prompts of 4-224 tokens, half of the
    # decoder's 448-token context (the part a previous-text prompt fills)
    "whisper-medium": dict(seq=448, page=16, max_prompt=224, requests=8,
                           new_tokens=32, prompt_lens=(4, 224),
                           frames=1500),
    # prompts just under the window of 4096, 160 new tokens: every lane
    # passes position 4111, where its first page slides out of the window
    "mixtral-8x7b": dict(seq=4352, page=16, max_prompt=4096, requests=8,
                         new_tokens=160, prompt_lens=(4000, 4090)),
    "phi3.5-moe-42b-a6.6b": dict(seq=2048, page=16, max_prompt=1536,
                                 requests=8, new_tokens=32,
                                 prompt_lens=(600, 1500)),
    # prompts past its window of 1024 plus two pages: the window tenant
    # maps only the window's pages at admission and recycles from there
    "mellum2-12b-a2.5b": dict(seq=2304, page=16, max_prompt=2048,
                              requests=8, new_tokens=64,
                              prompt_lens=(1100, 2048)),
}
# full width with a depth cut where all layers would not fit one card:
# qwen2-72b's 80 layers are 145 GB of bf16 weights; 8 layers are 19 GB;
# mixtral-8x7b's 32 layers ~93 GB, 16 ~47 GB; phi3.5-moe's 32 ~84 GB, 16
# ~42 GB
DEPTH_CUT = {"qwen2-72b": 8, "mixtral-8x7b": 16, "phi3.5-moe-42b-a6.6b": 16}
# the dense backbones' serving shapes at 4 lanes: paged decode (B, KV, G,
# hd, ps, P, L, seq_lens) and flash prefill (B, T, H, KV, hd): phi3-medium
# (G = 4, 10 KV heads), qwen2 (G = 8, the paged kernel's MAXG path),
# phi-3-vision (hd 96; T = 576 patch rows + a 512-token bucket)
DENSE_PAGED = {
    "phi3-medium-14b": (4, 10, 4, 128, 16, 129, 40, [1500, 1200, 900, 611]),
    "qwen2-72b": (4, 8, 8, 128, 16, 129, 8, [1500, 1200, 900, 611]),
    "phi-3-vision-4.2b": (4, 32, 1, 96, 16, 73, 32, [1120, 1000, 850, 700])}
DENSE_FLASH = {"phi3-medium-14b": (4, 1536, 40, 10, 128),
               "qwen2-72b": (4, 1536, 64, 8, 128),
               "phi-3-vision-4.2b": (4, 1088, 32, 32, 96)}
# zamba2-1.2b's serving shapes: the shared block's paged decode (hd 64,
# H = KV = 32, 16-token pages, 129-page tables, 6 KV layers) and flash
# prefill (hd 64, G = 1); the teacher-forced check's prompt and steps
ZAMBA_PAGED = (4, 32, 1, 64, 16, 129, 6, [1500, 1200, 900, 611])
ZAMBA_FLASH = (4, 1200, 32, 32, 64)
# whisper-medium's attention at 4 lanes, 16 heads on 16 x 64: flash with
# causal off over the encoder (1500 frames) and the cross-attention at
# prefill (the largest prompt bucket, 224, and 512) and at decode (one
# query) over the 1500 encoder rows, (B, Tq, Tk); the decoder's paged
# self-attention (16-token pages, 29-page tables, 24 KV layers)
WHISPER_FLASH = {"whisper-medium encoder": (4, 1500, 1500),
                 "whisper-medium cross prefill": (4, 224, 1500),
                 "whisper-medium cross prefill 512": (4, 512, 1500),
                 "whisper-medium cross decode": (4, 1, 1500)}
WHISPER_PAGED = (4, 16, 1, 64, 16, 29, 24, [440, 300, 211, 37])
# mixtral-8x7b's serving shapes at 4 lanes: paged decode (KV, G, hd, ps,
# P, L, seq_lens, window) over 273-slot tables whose slots behind the
# window are NO_BLOCK, and flash prefill (B, T): exact-length buckets pad
# each 4000-4090-token prompt's pass to 4 rows; 4100 tokens, where the
# window binds
MIXTRAL_PAGED = (8, 4, 128, 16, 273, 16, [4200, 4150, 4111, 4250], 4096)
MIXTRAL_FLASH = ((4, 4090), (1, 4100))
TEACHER = dict(prompt=700, steps=8, tol=2e-4)
# mixtral-8x7b's teacher-forced check: 2 of its 32 layers (f32 weights of
# all 32 would not fit the card), one 4100-token prompt (the window binds
# in the forward) and 40 steps, which recycle pages at positions 4111 and
# 4127; a capacity factor of num_experts / experts_per_token = 4 on both
# sides, so that no token can drop (the forward routes 4140 tokens, the
# decode one)
MOE_TEACHER = dict(prompt=4100, steps=40, tol=2e-4, layers=2,
                   capacity_factor=4.0, seq=4352)
# whisper-medium's teacher-forced check: 1500 frame rows, a 124-token prompt
AUDIO_TEACHER = dict(frames=1500, prompt=124, steps=8, tol=2e-4)
# phi-3-vision's teacher-forced check: 576 patch rows, a 124-token prompt
VLM_TEACHER = dict(patches=576, prompt=124, steps=8, tol=2e-4)
# phase 4c and the multi-engine runs of phase 5: two shards, shared-prefix
# traffic (two 64-token prefixes, tails of 8-40 tokens)
MULTI = dict(engines=2, quantum=4, seq=256, page=8, max_prompt=128,
             prefix=64, requests=16, small_requests=12, new_tokens=16)
# the reduced configs of phase 5 (gemma3: one local and one global layer;
# zamba2: 4 layers, the shared block after layers 1 and 3)
SMALL = dict(seq=256, page=8, max_prompt=128, requests=8, new_tokens=16)
SMALL_PROMPTS = {"deepseek-7b": None, "gemma3-1b": (65, 128),
                 "zamba2-1.2b": None, "phi3-medium-14b": None,
                 "qwen2-72b": None, "phi-3-vision-4.2b": None,
                 "rwkv6-7b": None, "whisper-medium": None,
                 "mixtral-8x7b": (65, 128), "phi3.5-moe-42b-a6.6b": None,
                 "mellum2-12b-a2.5b": (65, 128)}
# each reduced config keeps what smoke_config would hide: phi3-medium's
# G = 4, qwen2's G = 8 (with its QKV bias), phi-3-vision's hd 96,
# rwkv6's wkv heads of 64 and whisper's hd 64 over 150 frames (not a
# multiple of the flash kernel's tile)
SMALL_DEPTH = {"zamba2-1.2b": dict(num_layers=4, attn_every=2),
               "phi3-medium-14b": dict(num_heads=8, num_kv_heads=2),
               "qwen2-72b": dict(num_heads=8, num_kv_heads=1),
               "phi-3-vision-4.2b": dict(head_dim=96),
               "rwkv6-7b": dict(head_dim=64),
               "whisper-medium": dict(head_dim=64, encoder_seq_len=150),
               # one period (three windowed layers of 64, one global), 8
               # experts top-2: a split cache, grouped expert products
               "mellum2-12b-a2.5b": dict(num_layers=4, num_experts=8)}
# the archs whose phase 5 adds two shards with prefix caches and the
# bitmap and buddy policies
MULTI_ARCHS = ("deepseek-7b", "gemma3-1b", "qwen2-72b")
# a card-sized page pool: make_paged_config(gemma3-1b, seq_len=2048,
# lanes=256, page_size=16) gives 35840 pages (14.2 GiB of bf16 KV) and 256
# scratch slots; warm bursts put POOL_WARM pages in use across its lanes
POOL_LANES = 256
POOL_WARM = 26000
# the JAX kernel tests' sweeps (tests/test_kernels.py)
PAGED_SWEEP = [(3, 2, 4, 32, 8, 5), (2, 1, 8, 64, 16, 4), (2, 4, 1, 128, 8, 6),
               (1, 2, 2, 16, 4, 3)]
FLASH_SWEEP = [(32, 32, 4, 2, 32, True, FULL), (64, 64, 4, 1, 64, True, 24),
               (32, 32, 2, 2, 32, False, FULL), (64, 64, 8, 2, 128, True, FULL)]
TOL = {"paged": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "flash": {torch.float32: 2e-5, torch.bfloat16: 3e-2}}
# each output row (one query head's hd values) against its own scale:
# max |kernel - plain| over the row <= ROW_TOL x max |plain| over it.
# Attention over ~4096 random keys averages to rows of max ~0.07, below
# TOL; two bf16 ulps at the top of a row's binade are 2^-6 of it
ROW_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -6}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# --------------------------------------------------------------------------
# phase 3, support core: kernel vs plain version
# --------------------------------------------------------------------------

def random_queue(rng, Q, C, N, R, dev, ops=None, lanes=8):
    """A random burst: ``lanes`` is a lane count, or the lane ids to draw
    from."""
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                                          make_queue)
    ops = ops if ops is not None else rng.choice(
        [OP_MALLOC, OP_REFILL, OP_MALLOC_RUN, OP_FREE, OP_FREE, OP_NOP], Q)
    args = np.where(ops == OP_FREE,
                    np.where(rng.rand(Q) < 0.5, FREE_ALL,
                             rng.randint(0, N + 2, Q)),
                    rng.randint(0, R + 2, Q))          # incl. 0 and overwide
    ids = np.arange(lanes) if np.isscalar(lanes) else np.asarray(lanes)
    return make_queue(ops, ids[rng.randint(0, len(ids), Q)],
                      rng.randint(-1, C + 1, Q), args, device=dev)


class Parity:
    """Runs the kernel and the plain version on the same scheduled bursts
    and requires every output to be identical."""

    def __init__(self):
        self.bursts = 0
        self.max_abs_err = 0

    def step(self, state, queue, R, gated=False):
        from repro_torch.core.hmq import schedule
        return self.step_scheduled(state, schedule(queue)[0], R, gated)

    def step_scheduled(self, state, sched, R, gated=False):
        from repro_torch.core.support_core import _step_scheduled_torch
        from repro_torch.kernels.support_core.ops import support_core_burst
        want = _step_scheduled_torch(state, sched, R, gated=gated)
        got = support_core_burst(state, sched, R, gated=gated)
        pairs = list(zip(want[0], got[0])) + [(want[1], got[1]),
                                              (want[2], got[2])]
        names = list(state._fields) + ["blocks", "ok"]
        for name, (a, b) in zip(names, pairs):
            err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            self.max_abs_err = max(self.max_abs_err, err)
            if not torch.equal(a, b):
                fail(f"kernel != plain on {name} (burst {self.bursts}, "
                     f"Q={sched.capacity} C={state.num_classes} "
                     f"N={state.max_capacity} R={R} gated={gated})")
        self.bursts += 1
        return got[0]


def card_pool(dev, pages: int, warm: int = POOL_WARM, seed: int = 11):
    """A pool of classes ``[pages, POOL_LANES]`` with about ``warm`` pages in
    use across lanes 0-255, from seeded warm bursts of up to 512 mallocs of
    1-8 pages (R = 8), as an admitted batch of ~1000-token prompts leaves
    it.  The plain version runs them, so the state does not depend on the
    kernel under test."""
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.core.packets import OP_MALLOC, make_queue
    from repro_torch.core.support_core import _step_scheduled_torch
    rng = np.random.RandomState(seed)
    wants = rng.randint(1, 9, 2 * warm // 4)
    wants = wants[:int(np.searchsorted(np.cumsum(wants), warm)) + 1]
    state = init_freelist([pages, POOL_LANES], device=dev)
    for lo in range(0, len(wants), 512):
        w = wants[lo:lo + 512]
        q = make_queue(np.full(len(w), OP_MALLOC),
                       (np.arange(len(w)) + lo) % POOL_LANES,
                       np.zeros(len(w), int), w, capacity=512, device=dev)
        state = _step_scheduled_torch(state, schedule(q)[0], 8)[0]
    return state


def pool_bursts(dev, state, seed: int = 12) -> dict:
    """The pool's three bursts, scheduled, as ``(sched, R)``: the live
    decode burst (each lane's MALLOC(1) slot live for ~1/16 of the lanes,
    its REFILL(8) slot for ~1/8, the rest NOP: Q = 512), the release burst
    (32 FREE_ALLs of distinct lanes and 32 single frees of owned pages: Q =
    64) and the all-NOP decode burst.  The live and release mixes are
    synthetic: their rates are set here, not taken from a serve (with
    16-token pages and a stash refill of 8, a lane's REFILL is due about
    once in 128 steps, so a 256-lane step would carry ~2, not ~32)."""
    from repro_torch.core.hmq import schedule
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_NOP, OP_REFILL, make_queue)
    rng = np.random.RandomState(seed)
    lanes = np.repeat(np.arange(POOL_LANES), 2)
    slot = np.tile([OP_MALLOC, OP_REFILL], POOL_LANES)
    live = rng.rand(2 * POOL_LANES) < np.tile([1 / 16, 1 / 8], POOL_LANES)
    ops = np.where(live, slot, OP_NOP)
    zeros = np.zeros(2 * POOL_LANES, int)
    decode = make_queue(ops, lanes, zeros, np.where(slot == OP_MALLOC, 1, 8),
                        device=dev)
    nop = make_queue(zeros, lanes, zeros, zeros, device=dev)
    owner = state.owner[0].cpu().numpy()
    pages = rng.choice(np.flatnonzero(owner >= 0), 32, replace=False)
    fa_lanes = rng.choice(POOL_LANES, 32, replace=False)
    release = make_queue(np.full(64, OP_FREE),
                         np.concatenate([fa_lanes, owner[pages]]),
                         np.zeros(64, int),
                         np.concatenate([np.full(32, FREE_ALL), pages]),
                         device=dev)
    return {name: (schedule(q)[0], 8) for name, q in
            (("decode", decode), ("release", release), ("all_nop", nop))}


def plan_of(Q: int, C: int, N: int) -> str:
    from repro_torch.kernels.support_core.ops import card_plan
    plan = card_plan(Q, C, N)
    return f"{plan.path} path, cluster {plan.cluster} x {plan.slice} ids"


def kernel_parity(dev) -> Parity:
    from repro_torch.core.freelist import init_freelist, validate_freelist
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                                          make_queue)
    par = Parity()

    def trace(caps, steps, R):
        state = init_freelist(caps, device=dev)
        for reqs in steps:
            q = make_queue(*zip(*reqs), device=dev)
            state = par.step(state, q, R)
            validate_freelist(state)

    # directed corners (the JAX package's directed suites)
    trace([3, 2], [
        [(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 4), (OP_MALLOC, 2, 0, 2),
         (OP_FREE, 0, 0, FREE_ALL)],
        [(OP_FREE, 0, 0, 2), (OP_FREE, 0, 0, 2), (OP_FREE, 3, 0, 1),
         (OP_FREE, 4, 1, FREE_ALL)],
        [(OP_MALLOC, 2, 1, 2), (OP_FREE, 2, 0, FREE_ALL),
         (OP_FREE, 2, 1, FREE_ALL)],
        [(OP_REFILL, 1, 0, 3), (OP_MALLOC, 0, 0, 1),
         (OP_FREE, 1, 0, FREE_ALL)],
        [(OP_MALLOC_RUN, 3, 1, 1), (OP_MALLOC, 3, 0, 0),
         (OP_MALLOC, 3, 0, -2), (OP_NOP, 0, 0, 0)],
    ], R=3)
    trace([4, 6], [
        [(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 2),
         (OP_MALLOC, 0, 1, 3), (OP_MALLOC, 1, 1, 3)],
        [(OP_MALLOC, 2, 0, 1), (OP_MALLOC, 2, 1, 1)],
        [(OP_FREE, 0, 0, FREE_ALL), (OP_FREE, 1, 0, FREE_ALL),
         (OP_FREE, 0, 1, FREE_ALL), (OP_FREE, 1, 1, FREE_ALL)],
        [(OP_MALLOC, 3, 0, 4), (OP_MALLOC, 3, 1, 4)],
    ], R=4)
    trace([2], [[(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 8)],
                [(OP_FREE, 0, 0, FREE_ALL)], [(OP_MALLOC, 1, 0, 2)]], R=8)
    # the gate: an all-NOP burst leaves everything (peak too) unchanged
    state = init_freelist([5, 3], device=dev)
    state = par.step(state, make_queue([OP_MALLOC], [0], [0], [2],
                                       device=dev), 2)
    par.step(state, make_queue([OP_NOP] * 4, [0] * 4, [0] * 4, [0] * 4,
                               device=dev), 2, gated=True)

    # the sweep shapes of the JAX kernel tests, plus the large shape
    rng = np.random.RandomState(0)
    for Q, C, N, R, scarce, steps in [
            (16, 2, 32, 4, False, 3), (64, 4, 128, 8, False, 3),
            (32, 3, 16, 4, True, 3), (256, 8, 65536, 8, False, 4)]:
        caps = [int(c) for c in (rng.randint(2, max(3, N // 4), C) if scarce
                                 else rng.randint(N // 2, N + 1, C))]
        state = init_freelist(caps, device=dev)
        warm = make_queue(np.full(Q, OP_MALLOC), rng.randint(0, 8, Q),
                          rng.randint(0, C, Q), rng.randint(1, R + 1, Q),
                          device=dev)
        state = par.step(state, warm, R)
        for _ in range(steps):
            state = par.step(state, random_queue(rng, Q, C, N, R, dev), R,
                             gated=bool(rng.rand() < 0.5))
            validate_freelist(state)
        print(f"  parity Q={Q} C={C} N={N} R={R}: ok ({plan_of(Q, C, N)})")

    # lane ids beyond 32 Q: FREE_ALL lanes by binary search, not the bitmap
    wide = rng.randint(0, 2**30, 8)
    for Q, C, N, R in ((64, 4, 128, 8), (512, 2, 35840, 8)):
        state = init_freelist([N] * C, device=dev)
        for step in range(4):
            state = par.step(state, random_queue(rng, Q, C, N, R, dev,
                                                 lanes=wide), R,
                             gated=step % 2 == 1)
            validate_freelist(state)
    print(f"  parity with lane ids up to 2**30: ok")

    # card-sized pools: each burst gated and ungated on the warm state; a
    # nearly full pool sends the decode burst down the sequential grant
    # path, and 131072 pages outgrow a cluster (the global path)
    for pages, warm in ((35840, POOL_WARM), (35840, 35700),
                        (65536, POOL_WARM), (131072, POOL_WARM)):
        state = card_pool(dev, pages, warm)
        for name, (sched, R) in pool_bursts(dev, state).items():
            for gated in (False, True):
                par.step_scheduled(state, sched, R, gated=gated)
        top = int(state.free_top[0])
        print(f"  parity pool [{pages}, {POOL_LANES}], {warm} pages in use "
              f"(top {top}): decode, release and all-NOP bursts, gated and "
              f"ungated, ok (Q=512: {plan_of(512, 2, pages)}; Q=64: "
              f"{plan_of(64, 2, pages)})")

    # 50 bursts at the serving classes (kv_pages 512, scratch 4), state
    # carried, with the admission / decode / release burst widths
    state = init_freelist([512, SERVE_LANES], device=dev)
    for _ in range(50):
        Q = int(rng.choice([8, 12, 24]))
        R = int(rng.choice([1, 7, 16]))
        state = par.step(state, random_queue(rng, Q, 2, 512, R, dev,
                                             lanes=SERVE_LANES), R,
                         gated=bool(rng.rand() < 0.5))
        validate_freelist(state)
    print(f"  parity: {par.bursts} bursts bit-identical, "
          f"max_abs_err={par.max_abs_err}")
    return par


def plain_commit(state, burst, R):
    """Commit a staged burst through the plain version (no kernel)."""
    from repro_torch.core.hmq import schedule
    from repro_torch.core.support_core import _step_scheduled_torch
    return _step_scheduled_torch(state, schedule(burst.build_queue())[0],
                                 R)[0]


def multi_engine_parity(dev, par: Parity) -> None:
    """The bursts that a serve of two engine shards adds, at the card
    phase's shape (deepseek-7b's pool: 512 pages and 4 scratch slots a
    shard, C = 4, stash refill R = 7), kernel against plain bit for bit:
    the merged window burst (refills of both shards, FREE_ALLs of the same
    lane ids in both shards' classes, owner-agnostic frees of cache-owned
    pages), a FREE_ALL over a class holding aliased pages with refcounts 2
    and 3 beside single frees of one reference each, and the in-step R = 1
    emergency burst (gated; live and all-NOP)."""
    from repro_torch.alloc.service import AllocService
    from repro_torch.configs import get_config
    from repro_torch.core import paged_kv as pkv
    from repro_torch.core.freelist import validate_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.models import make_paged_config
    cfg, wl = get_config("deepseek-7b"), WORKLOADS["deepseek-7b"]
    kvcfg = make_paged_config(cfg, seq_len=wl["seq"], lanes=SERVE_LANES,
                              page_size=wl["page"], dtype=torch.bfloat16)
    R = kvcfg.stash_refill
    svc = AllocService(device=dev)
    ts = [pkv.register_paged_tenants(svc, kvcfg, f"e{i}") for i in range(2)]
    lanes = torch.arange(SERVE_LANES, dtype=torch.int32, device=dev)
    rng = np.random.RandomState(13)
    state = svc.init_state()
    # admission of four lanes on each shard, as admit_prefill_many stages it
    for t in ts:
        b = svc.new_burst()
        b.malloc(t.kv, lanes, torch.as_tensor(rng.randint(4, 15, SERVE_LANES),
                                              dtype=torch.int32, device=dev))
        b.malloc(t.scratch, lanes, 1)
        b.refill(t.kv, lanes, R)
        state = plain_commit(state, b, max(14, R))
    # lane 0 of shard 0 demoted its first 6 pages into the cache; lanes 1-3
    # alias pages 0-1 (refcount 3) and 2-3 (refcount 2)
    owner = state.owner[ts[0].kv.size_class].cpu().numpy()
    cached = np.flatnonzero(owner == 0)[:6]
    state = svc.retag_blocks(state, ts[0].kv, cached, pkv.CACHE_OWNER)
    state = svc.bump_refcounts(state, ts[0].kv,
                               np.concatenate([cached[:2]] * 2
                                              + [cached[2:4]]))
    validate_freelist(state)
    n0, widths = par.bursts, []

    def run(burst, R, gated):
        sched = schedule(burst.build_queue())[0]
        widths.append(sched.capacity)
        return par.step_scheduled(state, sched, R, gated=gated)

    b = svc.new_burst()
    for t, below in zip(ts, ([True, False, True, True],
                             [False, True, True, False])):
        b.refill(t.kv, lanes, R, where=torch.tensor(below, device=dev))
    both = torch.tensor([True, True, False, False], device=dev)
    for t in ts:
        pkv.stage_release_ops(t, b, lanes, both)
    pkv.stage_single_frees(ts[0], b, cached[4:6])        # evicted victims
    for gated in (True, False):
        validate_freelist(run(b, R, gated))
    b = svc.new_burst()
    pkv.stage_release_ops(ts[0], b, lanes,
                          torch.ones(SERVE_LANES, dtype=torch.bool,
                                     device=dev))
    pkv.stage_single_frees(ts[0], b, cached[:4])         # one reference each
    after = run(b, 1, False)
    refc = after.refcount[ts[0].kv.size_class, cached[:4]].tolist()
    if refc != [2, 2, 1, 1]:
        fail(f"aliased pages' refcounts after the burst are {refc}, "
             f"expected [2, 2, 1, 1]")
    for where in ([True, False, True, False], [False] * SERVE_LANES):
        b = svc.new_burst()
        b.malloc(ts[1].kv, lanes, 1, where=torch.tensor(where, device=dev))
        validate_freelist(run(b, 1, True))
    print(f"  multi-engine bursts: {par.bursts - n0} bit-identical (merged "
          f"window C={state.num_classes} Q={widths[0]} R={R}, aliased "
          f"FREE_ALL Q={widths[2]}, emergency Q={widths[3]} R=1; "
          f"{plan_of(widths[0], state.num_classes, 512)})")


def zamba2_bursts(dev, par: Parity) -> dict:
    """zamba2-1.2b's support-core bursts at its serving pool
    (``make_paged_config`` at full width, seq 2048, 4 lanes, 16-token
    pages: KV pages, then 4 state slots, then 4 scratch slots), kernel
    against plain bit for bit.  One engine (C = 3): the admission burst as
    ``admit_prefill_many`` stages it (a KV run for each lane's 600-1500
    token prompt, a state slot, a scratch slot, the stash pre-charge), a
    gated decode burst (emergency mallocs and refills) and the FREE_ALL
    release of all three tenants.  Two shards on one service (C = 6): the
    same admission on each, then one merged window burst releasing both
    shards' lanes.  Nothing is in use after either release.  Returns the
    admission at C = 3 and the release at C = 6, for timing."""
    from repro_torch.alloc.service import AllocService
    from repro_torch.configs import get_config
    from repro_torch.core import paged_kv as pkv
    from repro_torch.core.freelist import validate_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.models import make_paged_config
    cfg, wl = get_config("zamba2-1.2b"), WORKLOADS["zamba2-1.2b"]
    kvcfg = make_paged_config(cfg, seq_len=wl["seq"], lanes=SERVE_LANES,
                              page_size=wl["page"], dtype=torch.bfloat16)
    pre = kvcfg.stash_refill
    lanes = torch.arange(SERVE_LANES, dtype=torch.int32, device=dev)
    every = torch.ones(SERVE_LANES, dtype=torch.bool, device=dev)
    prompts = np.random.RandomState(14).randint(600, 1501, SERVE_LANES)
    n_pages = torch.as_tensor(-(-prompts // wl["page"]), dtype=torch.int32,
                              device=dev)
    R_admit = max(int(n_pages.max()), pre)
    timed, n0 = {}, par.bursts

    def run(state, burst, R, gated, name=None):
        sched = schedule(burst.build_queue())[0]
        if name:
            timed[name] = (state, sched, R, gated)
        state = par.step_scheduled(state, sched, R, gated=gated)
        validate_freelist(state)
        return state

    def admit(svc, state, t, name=None):
        b = svc.new_burst()
        b.malloc_run(t.kv, lanes, n_pages)
        b.malloc(t.state, lanes, 1)
        b.malloc(t.scratch, lanes, 1)
        b.refill(t.kv, lanes, pre)
        return run(state, b, R_admit, False, name)

    def none_used(state, what):
        if int(state.used.sum()) != 0:
            fail(f"zamba2 bursts: {state.used.tolist()} blocks in use after "
                 f"the {what} release")

    svc = AllocService(device=dev)
    t = pkv.register_paged_tenants(svc, kvcfg)
    if [h.name for h in t.handles] != ["kv_pages", "state_slots", "scratch"]:
        fail(f"zamba2 tenants registered as {[h.name for h in t.handles]}")
    state = admit(svc, svc.init_state(), t, "zamba2_admit_C3")
    b = svc.new_burst()
    b.malloc(t.kv, lanes, 1, where=torch.tensor([True, False, True, False],
                                                device=dev))
    b.refill(t.kv, lanes, pre, where=torch.tensor([False, True, True, False],
                                                  device=dev))
    state = run(state, b, pre, True)
    b = svc.new_burst()
    pkv.stage_release_ops(t, b, lanes, every)
    none_used(run(state, b, 1, False), "C = 3")
    c3 = state.num_classes

    svc = AllocService(device=dev)
    ts = [pkv.register_paged_tenants(svc, kvcfg, f"e{i}") for i in range(2)]
    state = svc.init_state()
    for t in ts:
        state = admit(svc, state, t)
    b = svc.new_burst()
    for t in ts:
        pkv.stage_release_ops(t, b, lanes, every)
    none_used(run(state, b, 1, False, "zamba2_release_C6"), "C = 6")
    print(f"  zamba2 bursts: {par.bursts - n0} bit-identical (C={c3}: "
          f"admission Q={timed['zamba2_admit_C3'][1].capacity} "
          f"R={R_admit}, gated decode, release; C={state.num_classes}: "
          f"admission on each shard, merged release "
          f"Q={timed['zamba2_release_C6'][1].capacity}; N="
          f"{state.max_capacity}: "
          f"{plan_of(timed['zamba2_admit_C3'][1].capacity, c3, state.max_capacity)}"
          f"); nothing in use after either release")
    return timed


def swa_bursts(dev, par: Parity) -> dict:
    """mixtral-8x7b's support-core bursts at its serving pool
    (``make_paged_config`` at full width, seq 4352, 4 lanes, 16-token
    pages: 1536 KV pages, 4 scratch slots), kernel against plain bit for
    bit: the admission of four 4000-4090-token prompts; a gated decode
    burst carrying emergency mallocs, refills and the overflow single
    frees of recycled pages (each lane's first page, which slid out of
    the window), as ``decode_append(window=...)`` stages them; and a
    window burst in which a single free and its lane's FREE_ALL name the
    same refcount-1 page, which must return once.  Nothing is in use after
    the last release.  Returns the decode and window bursts, for
    timing."""
    from repro_torch.alloc.service import AllocService
    from repro_torch.configs import get_config
    from repro_torch.core import paged_kv as pkv
    from repro_torch.core.freelist import validate_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.models import make_paged_config
    wl = WORKLOADS["mixtral-8x7b"]
    kvcfg = make_paged_config(get_config("mixtral-8x7b"), seq_len=wl["seq"],
                              lanes=SERVE_LANES, page_size=wl["page"],
                              dtype=torch.bfloat16)
    R, kv_cls = kvcfg.stash_refill, 0
    lanes = torch.arange(SERVE_LANES, dtype=torch.int32, device=dev)
    prompts = np.random.RandomState(15).randint(*wl["prompt_lens"],
                                                SERVE_LANES)
    n_pages = torch.as_tensor(-(-prompts // wl["page"]), dtype=torch.int32,
                              device=dev)
    svc = AllocService(device=dev)
    t = pkv.register_paged_tenants(svc, kvcfg)
    timed, n0 = {}, par.bursts

    def run(state, burst, R, gated, name=None):
        sched = schedule(burst.build_queue())[0]
        if name:
            timed[name] = (state, sched, R, gated)
        state = par.step_scheduled(state, sched, R, gated=gated)
        validate_freelist(state)
        return state

    def mask(*bits):
        return torch.tensor(bits, device=dev)

    b = svc.new_burst()
    b.malloc_run(t.kv, lanes, n_pages)
    b.malloc(t.scratch, lanes, 1)
    b.refill(t.kv, lanes, R)
    state = run(svc.init_state(), b, int(n_pages.max()), False)
    owner = state.owner[kv_cls].cpu().numpy()
    first = torch.as_tensor([int(np.flatnonzero(owner == lane)[0])
                             for lane in range(SERVE_LANES)],
                            dtype=torch.int32, device=dev)
    b = svc.new_burst()
    b.malloc(t.kv, lanes, 1, where=mask(True, False, True, False))
    b.refill(t.kv, lanes, R, where=mask(False, True, False, False))
    b.free(t.kv, lanes, torch.where(mask(True, True, False, True), first,
                                    -1))
    used = int(state.used[kv_cls])
    state = run(state, b, R, True, "swa_decode")
    if int(state.used[kv_cls]) != used + 2 + R - 3 or \
            (state.owner[kv_cls, first[[0, 1, 3]].long()] != -1).any():
        fail("swa decode burst: the recycled pages were not returned")
    page = int(np.flatnonzero(state.owner[kv_cls].cpu().numpy() == 0)[0])
    other = int(np.flatnonzero(state.owner[kv_cls].cpu().numpy() == 1)[0])
    lane0 = int((state.owner[kv_cls] == 0).sum())
    top = int(state.free_top[kv_cls])
    b = svc.new_burst()
    pkv.stage_release_ops(t, b, lanes, mask(True, False, False, False))
    pkv.stage_single_frees(t, b, [page, other])
    state = run(state, b, 1, False, "swa_window")
    stack = state.free_stack[kv_cls, :int(state.free_top[kv_cls])].cpu()
    if int(state.free_top[kv_cls]) != top + lane0 + 1 or \
            len(torch.unique(stack)) != len(stack) or \
            int(state.refcount[kv_cls, page]) != 0:
        fail(f"swa window burst: page {page}, named by a single free and "
             f"by its lane's FREE_ALL, was not returned exactly once")
    b = svc.new_burst()
    pkv.stage_release_ops(t, b, lanes, mask(False, True, True, True))
    state = run(state, b, 1, False)
    if int(state.used.sum()) != 0:
        fail(f"swa bursts: {state.used.tolist()} blocks in use after the "
             f"release")
    print(f"  mixtral swa bursts: {par.bursts - n0} bit-identical (N="
          f"{state.max_capacity}: admission R={int(n_pages.max())}, gated "
          f"decode with 3 recycle frees Q={timed['swa_decode'][1].capacity} "
          f"R={R}, a single free and a FREE_ALL on one page Q="
          f"{timed['swa_window'][1].capacity}: returned once; "
          f"{plan_of(timed['swa_decode'][1].capacity, 2, state.max_capacity)}"
          f"); nothing in use after the release")
    return timed


def device_ms(fn, n: int = 100) -> float:
    """Median device time of ``fn``'s launches, from CUDA events.

    Each timed call is queued behind a GPU spin longer than the host takes
    to issue the call, so the events bracket the device work alone rather
    than the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * host_s * 2e9) + 200_000
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def burst_bound_ms(Q: int, C: int, N: int, R: int) -> tuple[float, str]:
    """Least time for one burst: each input read once and each output
    written once over HBM bandwidth, against ~12 integer operations per
    metadata word over the CUDA cores' rate; the larger one."""
    words_in = 4 * Q + 3 * C * N + 6 * C
    words_out = 3 * C * N + 6 * C + Q * R + Q
    bytes_ms = 4 * (words_in + words_out) / HBM_BYTES_PER_S * 1e3
    ops_ms = (12 * C * N + 4 * Q * R) / CUDA_CORE_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def warm_burst(dev, Q, C, N, R, caps) -> tuple:
    """``(state, sched, R, gated=False)``: a random burst on a state that
    three random warm bursts (seed 1) have left."""
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.core.support_core import _step_scheduled_torch
    rng = np.random.RandomState(1)
    state = init_freelist(caps, device=dev)
    warm, _ = schedule(random_queue(rng, Q, C, N, R, dev))
    for _ in range(3):
        state = _step_scheduled_torch(state, warm, R)[0]
    sched, _ = schedule(random_queue(rng, Q, C, N, R, dev))
    return state, sched, R, False


def serve_burst(dev) -> tuple:
    """The burst at the serve's shape (Q=8 C=2 N=512 R=7)."""
    return warm_burst(dev, 2 * SERVE_LANES, 2, 512, 7, [512, SERVE_LANES])


def burst_cases(dev) -> dict:
    """The support-core bursts that are timed, as ``name: (state, sched, R,
    gated)``: the serve's shape, the large shape (Q=256 C=8 N=65536 R=8),
    the three bursts of the card-sized gemma3-1b pool (:func:`card_pool`;
    live decode and all-NOP gated, as ``decode_append`` commits them,
    release ungated) and the release burst of a pool of 131072 pages,
    which takes the global path."""
    cases = {"serve": serve_burst(dev),
             "large": warm_burst(dev, 256, 8, 65536, 8, [65536] * 8)}
    state = card_pool(dev, 35840)
    for name, (sched, R) in pool_bursts(dev, state).items():
        cases[f"pool_{name}"] = (state, sched, R, name != "release")
    state = card_pool(dev, 131072)
    cases["pool_131072_release"] = (state, *pool_bursts(dev, state)["release"],
                                    False)
    return cases


def time_burst(name, state, sched, R, gated) -> dict:
    from repro_torch.core.support_core import _step_scheduled_torch
    from repro_torch.kernels.support_core.ops import card_plan, \
        support_core_burst
    (C, N), Q = state.free_stack.shape, sched.capacity
    plan = card_plan(Q, C, N)
    ms = device_ms(lambda: support_core_burst(state, sched, R, gated=gated))
    plain_ms = device_ms(lambda: _step_scheduled_torch(state, sched, R,
                                                       gated=gated),
                         n=100 if Q <= 64 else 10)
    bound_ms, bound_by = burst_bound_ms(Q, C, N, R)
    mix = "synthetic mix, " if name.endswith(("decode", "release")) else ""
    print(f"  time {name} Q={Q} C={C} N={N} R={R} gated={gated} ({mix}"
          f"{plan.path} path, cluster {plan.cluster}): kernel "
          f"{ms * 1e3:.2f} us/launch, plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})")
    return dict(Q=Q, C=C, N=N, R=R, gated=gated, path=plan.path,
                cluster=plan.cluster, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def launch_floor_ms() -> float:
    """Device time of PyTorch's fill of one int32 word, by
    :func:`device_ms`: about what a launch costs by that clock, which no
    burst can go under."""
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = device_ms(one.zero_)
    print(f"  launch floor: {ms * 1e3:.2f} us (a one-element fill)")
    return ms


# --------------------------------------------------------------------------
# phase 3, the bitmap and buddy policies: the card against the CPU
# --------------------------------------------------------------------------

PLAIN_POLICIES = ("bitmap", "buddy")


def to_cpu(x):
    """A state or queue (a NamedTuple of tensors) copied to the CPU."""
    return type(x)(*[t.cpu() for t in x])


class PolicyParity:
    """Runs a plain policy's burst on the card and on the CPU from the same
    state and requires every output to be identical."""

    def __init__(self, policy: str):
        from repro_torch.alloc import get_policy
        self.policy = get_policy(policy)
        self.bursts = 0

    def step(self, state, queue, R, gated=False):
        from repro_torch.core.hmq import schedule
        return self.step_scheduled(state, schedule(queue)[0], R, gated)

    def step_scheduled(self, state, sched, R, gated=False):
        got = self.policy.step_scheduled(state, sched, R, gated=gated)
        want = self.policy.step_scheduled(to_cpu(state), to_cpu(sched), R,
                                          gated=gated)
        names = list(state._fields) + ["blocks", "ok"]
        for name, a, b in zip(names, [*got[0], got[1], got[2]],
                              [*want[0], want[1], want[2]]):
            if not torch.equal(a.cpu(), b):
                fail(f"{self.policy.name}: card != cpu on {name} (burst "
                     f"{self.bursts}, Q={sched.capacity} "
                     f"C={state.num_classes} N={state.max_capacity} R={R} "
                     f"gated={gated})")
        self.bursts += 1
        return got[0]


def policy_parity(dev) -> dict:
    """Phase 3 for the bitmap and buddy policies (plain PyTorch on the
    card): directed ``OP_MALLOC_RUN`` cases, a 50-burst random trace at the
    serving classes, the gated all-NOP burst and the card-sized gemma3-1b
    pool's decode burst, each on the card and on the CPU, bit for bit.
    Returns the bursts checked per policy."""
    from repro_torch.alloc import get_policy
    from repro_torch.core.freelist import init_freelist, validate_freelist
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC_RUN,
                                          OP_NOP, make_queue)
    checked = {}
    pool = card_pool(dev, 35840)
    pool_decode = pool_bursts(dev, pool)["decode"][0]
    for name in PLAIN_POLICIES:
        par = PolicyParity(name)

        def q(*rows):
            return make_queue(*zip(*rows), device=dev)

        # directed: a run of 3 takes the aligned 4 at 0, a run of 2 the
        # aligned 2 at 4; a run of 8 the 8 at 8; holes at 8, 10, 12, 14 and
        # 1 leave no aligned 4, so a run of 3 falls back to singles; then
        # every lane releases
        state = get_policy(name).init([16], dev)
        state = par.step(state, q((OP_MALLOC_RUN, 0, 0, 3),
                                  (OP_MALLOC_RUN, 1, 0, 2)), 4)
        state = par.step(state, q((OP_MALLOC_RUN, 2, 0, 8)), 8)
        state = par.step(state, q(*[(OP_FREE, 2, 0, b)
                                    for b in (8, 10, 12, 14)],
                                  (OP_FREE, 0, 0, 1)), 1)
        state = par.step(state, q((OP_MALLOC_RUN, 3, 0, 3)), 4)
        lane3 = np.flatnonzero(state.owner[0].cpu().numpy() == 3).tolist()
        state = par.step(state, q(*[(OP_FREE, lane, 0, FREE_ALL)
                                    for lane in range(4)]), 1)
        validate_freelist(state)
        # buddy kept its runs aligned (4-5 at the 2-run, 8-15 at the
        # 8-run); first fit packed them from 0 (3-4, then 5-12)
        want3 = [1, 3, 6] if name == "buddy" else [1, 8, 10]
        if lane3 != want3:
            fail(f"{name}: the fallback run of 3 took {lane3}, expected "
                 f"{want3}")
        splits, merges = int(state.split_count[0]), int(state.merge_count[0])
        if name == "buddy" and not (splits > 7 and merges > 0):
            fail(f"buddy: split/merge counts {splits}/{merges}")
        if name == "bitmap" and (splits or merges):
            fail(f"bitmap: split/merge counts {splits}/{merges}, expected 0")

        # 50 bursts at the serving classes, state carried
        rng = np.random.RandomState(21)
        state = get_policy(name).init([512, SERVE_LANES], dev)
        for _ in range(50):
            Q = int(rng.choice([8, 12, 24]))
            R = int(rng.choice([1, 7, 16]))
            state = par.step(state, random_queue(rng, Q, 2, 512, R, dev,
                                                 lanes=SERVE_LANES), R,
                             gated=bool(rng.rand() < 0.5))
            validate_freelist(state)

        # the gate: an all-NOP burst leaves a state whose stack is not the
        # bitmap's order (a free-list state) bit-identical
        state = init_freelist([5, 3], device=dev)
        state = get_policy("freelist").step_scheduled(
            state, make_queue([1, 1], [0, 1], [0, 1], [2, 1],
                              device=dev), 2)[0]
        nop = make_queue([OP_NOP] * 4, [0] * 4, [0] * 4, [0] * 4, device=dev)
        kept = par.step(state, nop, 2, gated=True)
        if not all(torch.equal(a, b) for a, b in zip(kept, state)):
            fail(f"{name}: the gated all-NOP burst changed the state")

        # one burst on the card-sized gemma3-1b pool (as decode gates it)
        par.step_scheduled(pool, pool_decode, 8, gated=True)
        checked[name] = par.bursts
        print(f"  {name}: {par.bursts} bursts card == cpu bit for bit "
              f"(directed runs: fallback singles {lane3}, split/merge "
              f"{splits}/{merges}; 50-burst trace at [512, {SERVE_LANES}]; "
              f"gated all-NOP; pool [35840, {POOL_LANES}] decode burst "
              f"Q={pool_decode.capacity})")
    return checked


def check_no_sync(dev) -> None:
    """No burst of any policy, and no commit of ops staged through the
    builder, synchronises the host with the card
    (``torch.cuda.set_sync_debug_mode("error")``, which PyTorch calls a
    prototype that does not catch every synchronising op)."""
    from repro_torch.alloc import AllocService, get_policy
    state, sched, R, _ = serve_burst(dev)
    lanes = torch.arange(SERVE_LANES, dtype=torch.int32, device=dev)
    for name in ("freelist", *PLAIN_POLICIES):
        svc = AllocService(policy=name, device=dev)
        kv = svc.register_tenant("kv_pages", 512)
        svc.register_tenant("scratch", SERVE_LANES)
        fresh = svc.init_state()

        def burst():
            b = svc.new_burst()
            b.malloc_run(kv, lanes, 3)
            b.refill(kv, lanes, 2, where=lanes < 2)
            b.free_all(kv, lanes, where=lanes == 3)
            svc.commit(fresh, b, max_blocks_per_req=3, gated=True)
            get_policy(name).step_scheduled(state, sched, R, gated=True)

        burst()                                   # warm, outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            burst()
        except RuntimeError as err:
            fail(f"{name}: a burst synchronised with the host: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"  no host sync in a burst or a staged commit under freelist, "
          f"{', '.join(PLAIN_POLICIES)}")


def time_policies(dev) -> dict:
    """Each plain policy's burst on the card at the serve's shape and at the
    card-sized pool's decode burst, beside the free-list kernel on the same
    burst (CUDA-event medians, :func:`device_ms`)."""
    from repro_torch.alloc import get_policy
    from repro_torch.kernels.support_core.ops import support_core_burst
    state, sched, R, gated = serve_burst(dev)
    pool = card_pool(dev, 35840)
    pool_sched = pool_bursts(dev, pool)["decode"][0]
    shapes = {"serve": (state, sched, R, gated),
              "pool_decode": (pool, pool_sched, 8, True)}
    out = {}
    for shape, (st, sc, r, g) in shapes.items():
        (C, N), Q = st.free_stack.shape, sc.capacity
        n = 100 if Q <= 64 else 5
        row = {"Q": Q, "C": C, "N": N, "R": r, "gated": g,
               "freelist_kernel_ms": device_ms(
                   lambda: support_core_burst(st, sc, r, gated=g), n=n)}
        for name in PLAIN_POLICIES:
            pol = get_policy(name)
            row[f"{name}_ms"] = device_ms(
                lambda: pol.step_scheduled(st, sc, r, gated=g),
                n=n if name == "bitmap" else min(n, 20 if Q <= 64 else 3))
        out[shape] = row
        print(f"  time {shape} Q={Q} C={C} N={N} R={r} gated={g}: bitmap "
              f"{row['bitmap_ms'] * 1e3:.1f} us, buddy "
              f"{row['buddy_ms'] * 1e3:.1f} us (plain PyTorch; buddy places "
              f"its {Q} rows one after another), free-list kernel "
              f"{row['freelist_kernel_ms'] * 1e3:.2f} us")
    return out


# --------------------------------------------------------------------------
# phase 3, attention: kernels against their plain versions on the card
# --------------------------------------------------------------------------

class Errors:
    """Largest |kernel - plain| per kernel over every case checked, and
    the largest row error relative to the row's scale (``ROW_TOL``)."""

    def __init__(self):
        self.max = {"paged": 0.0, "flash": 0.0}
        self.rel = {"paged": 0.0, "flash": 0.0}

    @staticmethod
    def row_rel(got, want) -> float:
        """max over rows of max |got - want| / max |want| (a zero row must
        be matched exactly)."""
        diff = (got.float() - want.float()).abs().flatten(0, -2).amax(1)
        scale = want.float().abs().flatten(0, -2).amax(1)
        return float(torch.where(diff == 0, 0.0, diff / scale).max())

    def check(self, kind, what, got, want, dtype):
        err = float((got.float() - want.float()).abs().max())
        if not err <= TOL[kind][dtype]:        # NaN fails too
            fail(f"{kind} kernel != plain on {what}: max abs err {err:.3e} "
                 f"> {TOL[kind][dtype]}")
        rel = self.row_rel(got, want)
        if not rel <= ROW_TOL[dtype]:
            fail(f"{kind} kernel != plain on {what}: a row's max abs err is "
                 f"{rel:.3e} of its max |plain| > {ROW_TOL[dtype]:.3e}")
        self.max[kind] = max(self.max[kind], err)
        self.rel[kind] = max(self.rel[kind], rel)

    @staticmethod
    def planted(kind, what, fault, want, dtype) -> float:
        """A plain version with a fault planted must fail the row check;
        returns its row error, and whether TOL alone would have let it
        pass is for the caller to print."""
        rel = Errors.row_rel(fault, want)
        if not rel > ROW_TOL[dtype]:
            fail(f"{kind}: the planted fault {what} passes the row check "
                 f"({rel:.3e} <= {ROW_TOL[dtype]:.3e})")
        return rel


def rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                           device=dev).to(dtype)


def paged_pool_case(rng, dev, dtype, B, KV, G, hd, ps, P, L, seq, active):
    """A port-shaped pool ``[N + 1, L, ps, KV, hd]`` (read through layer
    1's view), tables with lane i's pages granted for ``pos < seq[i]``, the
    rest NO_BLOCK, and the new tokens' queries and K/V."""
    n = B * P + 1
    pool_k = rand(rng, (n + 1, L, ps, KV, hd), dtype, dev)
    pool_v = rand(rng, (n + 1, L, ps, KV, hd), dtype, dev)
    perm = rng.permutation(n)[:B * P].reshape(B, P)
    used = np.arange(P)[None, :] * ps < np.asarray(seq)[:, None]
    tables = torch.as_tensor(np.where(used, perm, -1).astype(np.int32),
                             device=dev)
    return dict(q=rand(rng, (B, KV * G, hd), dtype, dev),
                k_pages=pool_k[:, 1], v_pages=pool_v[:, 1],
                block_tables=tables,
                seq_lens=torch.as_tensor(np.asarray(seq, np.int32),
                                         device=dev),
                k_self=rand(rng, (B, KV, hd), dtype, dev),
                v_self=rand(rng, (B, KV, hd), dtype, dev),
                active=torch.as_tensor(np.asarray(active, bool), device=dev))


def paged_args(case, window, self_mode):
    keys = ("q", "k_pages", "v_pages", "block_tables", "seq_lens")
    args = [case[k] for k in keys] + [window]
    extra = {k: case[k] for k in ("k_self", "v_self", "active")} \
        if self_mode else {}
    return args, extra


def paged_parity(dev, errs: Errors) -> None:
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    rng = np.random.RandomState(0)
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, KV, G, hd, ps, P in PAGED_SWEEP:
            for window in (FULL, 19):
                seq = rng.randint(1, P * ps - 1, size=B)
                case = paged_pool_case(rng, dev, dt, B, KV, G, hd, ps, P, 2,
                                       seq, rng.rand(B) < 0.7)
                for self_mode in (False, True):
                    args, kw = paged_args(case, window, self_mode)
                    errs.check("paged", f"sweep B={B} KV={KV} G={G} hd={hd} "
                               f"w={window} self={self_mode} {dt}",
                               op(*args, **kw),
                               paged_attention_plain(*args, **kw), dt)
                    n_cases += 1
        # serving shapes: deepseek-7b, gemma3-1b's local and global layers,
        # zamba2-1.2b's shared block, phi3-medium (G = 4 on 10 KV heads),
        # qwen2 (G = 8), phi-3-vision (hd 96), whisper-medium's decoder
        # (hd 64, 16 on 16, seq_len 448); lane 1 at a page boundary, lane
        # 2 inactive, lane 3 short
        for (KV, G, hd, ps, P, L, seq), windows in (
                ((32, 1, 128, 8, 33, 30, [119, 64, 40, 3]), (FULL,)),
                ((1, 4, 256, 16, 129, 26, [1400, 1024, 700, 611]),
                 (512, FULL)),
                ((32, 1, 64, 16, 129, 6, [1500, 1024, 700, 611]), (FULL,)),
                ((10, 4, 128, 16, 129, 2, [1500, 1024, 700, 611]),
                 (FULL, 300)),
                ((8, 8, 128, 16, 129, 2, [1500, 1024, 700, 611]),
                 (FULL, 300)),
                ((32, 1, 96, 16, 73, 2, [1120, 1024, 700, 611]),
                 (FULL, 300)),
                ((16, 1, 64, 16, 29, 24, [440, 256, 211, 37]), (FULL,))):
            case = paged_pool_case(rng, dev, dt, 4, KV, G, hd, ps, P, L, seq,
                                   [True, True, False, True])
            for window in windows:
                for self_mode in (False, True):
                    args, kw = paged_args(case, window, self_mode)
                    errs.check("paged", f"serving KV={KV} G={G} hd={hd} "
                               f"w={window} self={self_mode} {dt}",
                               op(*args, **kw),
                               paged_attention_plain(*args, **kw), dt)
                    n_cases += 1
        # tests/test_prefix_alias.py's case: position seq_len of lane 0 in
        # a NO_BLOCK slot (read as page 0); an aliased page must read
        # bit-identically to a private copy of it
        q = rand(rng, (2, 4, 32), dt, dev)
        kp, vp = rand(rng, (12, 8, 2, 32), dt, dev), rand(rng, (12, 8, 2, 32),
                                                          dt, dev)
        seq = torch.tensor([24, 22], dtype=torch.int32, device=dev)
        shared = torch.tensor([[0, 1, 2, -1], [0, 1, 3, -1]],
                              dtype=torch.int32, device=dev)
        private = torch.tensor([[0, 1, 2, -1], [10, 11, 3, -1]],
                               dtype=torch.int32, device=dev)
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[10:12], vp2[10:12] = kp[0:2], vp[0:2]
        got = op(q, kp, vp, shared, seq)
        if not torch.equal(got, op(q, kp2, vp2, private, seq)):
            fail(f"paged kernel: shared and private tables differ ({dt})")
        errs.check("paged", f"NO_BLOCK slot {dt}", got,
                   paged_attention_plain(q, kp, vp, shared, seq, FULL), dt)
        n_cases += 2
    torch.cuda.synchronize()
    print(f"  paged attention: {n_cases} cases within tolerance, shared == "
          f"private bit for bit, max_abs_err={errs.max['paged']:.3e}")


def flash_parity(dev, errs: Errors) -> None:
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(1)
    cases = [(2, *s) for s in FLASH_SWEEP] + [
        (2, 37, 37, 4, 1, 256, True, 16),          # ragged Tq, gemma heads
        (1, 100, 100, 2, 1, 16, True, FULL),       # ragged Tq
        (4, 128, 128, 32, 32, 128, True, FULL),    # deepseek-7b prefill
        (4, 1536, 1536, 4, 1, 256, True, 512),     # gemma3-1b local layer
        (4, 1536, 1536, 4, 1, 256, True, FULL),    # gemma3-1b global layer
        (4, 1200, 1200, 32, 32, 64, True, FULL),   # zamba2-1.2b shared block
        (4, 1500, 1500, 40, 10, 128, True, FULL),  # phi3-medium-14b
        (4, 1500, 1500, 64, 8, 128, True, FULL),   # qwen2-72b
        (4, 1100, 1100, 32, 32, 96, True, FULL),   # phi-3-vision: 576 + 524
        (2, 200, 200, 8, 1, 96, True, 64),         # hd 96 at G = 8, windowed
        (4, 224, 224, 16, 16, 64, True, FULL)]     # whisper decoder prefill
    # whisper-medium's non-causal call sites: encoder, cross at prefill
    # and at decode (Tk = 1500 frames, no multiple of a tile)
    cases += [(B, Tq, Tk, 16, 16, 64, False, FULL)
              for B, Tq, Tk in WHISPER_FLASH.values()]
    for dt in (torch.float32, torch.bfloat16):
        for B, Tq, Tk, H, KV, hd, causal, window in cases:
            q = rand(rng, (B, Tq, H, hd), dt, dev)
            k = rand(rng, (B, Tk, KV, hd), dt, dev)
            v = rand(rng, (B, Tk, KV, hd), dt, dev)
            errs.check("flash", f"B={B} Tq={Tq} H={H} KV={KV} hd={hd} "
                       f"causal={causal} w={window} {dt}",
                       flash_attention_op(q, k, v, causal=causal,
                                          window=window),
                       flash_attention_ref(q, k, v, causal=causal,
                                           window=window), dt)
    torch.cuda.synchronize()
    print(f"  flash attention: {2 * len(cases)} cases within tolerance, "
          f"max_abs_err={errs.max['flash']:.3e}")


def flash_edge_parity(dev, errs: Errors) -> None:
    """The tensor-core kernel's edges in bf16: lengths around a 64-row
    tile, windows of 1, 100 and 512, every serving head width (hd 96's
    own swizzle included) and group size; queries scaled by 8 so scores
    reach +-30 and the online softmax rescales with P rounded to bf16."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(4)
    n = 0
    for T in (1, 63, 65, 200, 2048):
        for window in (1, 100, 512):
            for hd in (64, 96, 128, 256):
                for G in (1, 4, 8):
                    q = (torch.as_tensor(rng.randn(1, T, 2 * G, hd)
                                         .astype(np.float32), device=dev)
                         * 8).to(torch.bfloat16)
                    k = rand(rng, (1, T, 2, hd), torch.bfloat16, dev)
                    v = rand(rng, (1, T, 2, hd), torch.bfloat16, dev)
                    errs.check("flash", f"edge T={T} w={window} hd={hd} "
                               f"G={G} bf16 x8",
                               flash_attention_op(q, k, v, window=window),
                               flash_attention_ref(q, k, v, window=window),
                               torch.bfloat16)
                    n += 1
    torch.cuda.synchronize()
    print(f"  flash attention: {n} bf16 edge cases within tolerance, "
          f"max_abs_err={errs.max['flash']:.3e}")


def flash_offset_parity(dev, errs: Errors) -> None:
    """Flash prefill over a cached prefix: query offsets 8, 24, 64, 72 and
    1200 (none a multiple of a query tile), windows none and 512, hd 128
    and 256 with G 1 and 4, ragged Tq, and the two offset serving shapes
    that phase 3 times, in f32 and bf16, against the plain version; offset
    0 bit-identical to the call without one; two launches bit-identical."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(7)
    cases = [(2, Tq, P, 2 * G, 2, hd, window)
             for P in (0, 8, 24, 64, 72, 1200) for Tq in (37, 100)
             for window in (FULL, 512) for hd, G in ((128, 1), (256, 4))]
    cases += [(4, *shape) for shape in OFFSET_SHAPES.values()]
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, Tq, P, H, KV, hd, window in cases:
            q = rand(rng, (B, Tq, H, hd), dt, dev)
            k = rand(rng, (B, P + Tq, KV, hd), dt, dev)
            v = rand(rng, (B, P + Tq, KV, hd), dt, dev)
            got = flash_attention_op(q, k, v, window=window, q_offset=P)
            again = flash_attention_op(q, k, v, window=window, q_offset=P)
            if not torch.equal(got, again):
                fail(f"flash kernel: two launches with offset {P} differ "
                     f"({dt})")
            if P == 0 and not torch.equal(
                    got, flash_attention_op(q, k, v, window=window)):
                fail(f"flash kernel: offset 0 differs from the call without "
                     f"one ({dt})")
            errs.check("flash", f"offset B={B} P={P} Tq={Tq} H={H} KV={KV} "
                       f"w={window} hd={hd} {dt}", got,
                       flash_attention_ref(q, k, v, window=window,
                                           q_offset=P), dt)
            n += 1
    torch.cuda.synchronize()
    print(f"  flash attention: {n} offset cases within tolerance, offset 0 "
          f"bit-identical to no offset, max_abs_err={errs.max['flash']:.3e}")


def swa_holes(case: dict, window: int, ps: int) -> dict:
    """The case with every table slot wholly behind each lane's window set
    to NO_BLOCK, as sliding-window recycling leaves it (the kernel reads
    such a slot as page 0, masked)."""
    seq = case["seq_lens"].long()
    slot = torch.arange(case["block_tables"].shape[1], device=seq.device)
    dead = (slot[None, :] + 1) * ps <= (seq[:, None] + 1 - window)
    return dict(case, block_tables=torch.where(dead, -1,
                                               case["block_tables"]))


def swa_attention_parity(dev, errs: Errors) -> None:
    """mixtral-8x7b's attention shapes against the plain versions, in f32
    and bf16: paged decode over its pool (32 heads on 8 KV heads x 128,
    16-token pages, 273-slot tables) with lanes of 4111-4250
    tokens under the window of 4096 and the slots below it NO_BLOCK, in
    both modes; flash prefill of 4 x 4090 rows (the window does not bind)
    and of 1 x 4100 (it does), checked a row at a time.  The pools hold 2
    layers (the timed case holds the serve's 16).  Each case also holds
    plain versions with a fault planted to the same checks, and fails
    unless the row check rejects them: paged with the window ignored (the
    NO_BLOCK holes read as page 0 unmasked) and with each lane's last
    page lost; flash with the last 64-key tile never read."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    rng = np.random.RandomState(8)
    KV, G, hd, ps, P, _, seq, window = MIXTRAL_PAGED
    n = 0
    faults: dict = {}

    def plant(kind, what, fault, want, dt):
        rel = Errors.planted(kind, what, fault, want, dt)
        err = float((fault.float() - want.float()).abs().max())
        key = (kind, what, str(dt).split(".")[-1])
        old = faults.get(key, (0.0, 0.0))
        faults[key] = (max(old[0], rel), max(old[1], err))

    for dt in (torch.float32, torch.bfloat16):
        case = swa_holes(paged_pool_case(rng, dev, dt, 4, KV, G, hd, ps, P,
                                         2, seq, [True, True, False, True]),
                         window, ps)
        holes = int((case["block_tables"][:, :seq[0] // ps] < 0).sum())
        for self_mode in (False, True):
            args, kw = paged_args(case, window, self_mode)
            want = paged_attention_plain(*args, **kw)
            errs.check("paged", f"mixtral w={window} self={self_mode} with "
                       f"{holes} holes {dt}", op(*args, **kw), want, dt)
            plant("paged", "window ignored", paged_attention_plain(
                *args[:-1], FULL, **kw), want, dt)
            lost = args[4] - ((args[4] - 1) % ps + 1)
            plant("paged", "last page lost", paged_attention_plain(
                *args[:4], lost, window, **kw), want, dt)
            n += 1
        for B, T in MIXTRAL_FLASH:
            q = rand(rng, (B, T, KV * G, hd), dt, dev)
            k = rand(rng, (B, T, KV, hd), dt, dev)
            v = rand(rng, (B, T, KV, hd), dt, dev)
            got = flash_attention_op(q, k, v, window=window)
            cut = (T - 1) // 64 * 64
            for b in range(B):
                want = flash_attention_ref(q[b:b + 1], k[b:b + 1],
                                           v[b:b + 1], window=window)
                errs.check("flash", f"mixtral B={B} T={T} w={window} row "
                           f"{b} {dt}", got[b:b + 1], want, dt)
                plant("flash", "last key tile lost", flash_attention_ref(
                    q[b:b + 1], k[b:b + 1, :cut], v[b:b + 1, :cut],
                    window=window), want, dt)
            n += 1
    torch.cuda.synchronize()
    print(f"  mixtral attention: {n} cases within tolerance (paged with "
          f"{holes} NO_BLOCK slots below the window), max_abs_err paged "
          f"{errs.max['paged']:.3e}, flash {errs.max['flash']:.3e}; max row "
          f"error / row max |plain| paged {errs.rel['paged']:.3e}, flash "
          f"{errs.rel['flash']:.3e} (limits f32 {ROW_TOL[torch.float32]:.0e},"
          f" bf16 {ROW_TOL[torch.bfloat16]:.3e})")
    for (kind, what, dt), (rel, err) in faults.items():
        verdict = "passes" if err <= TOL[kind][getattr(torch, dt)] else \
            "fails"
        print(f"  planted fault, {kind} {what} ({dt}): row error "
              f"{rel:.3e} of the row's max, rejected; max abs err "
              f"{err:.3e} {verdict} the absolute limit "
              f"{TOL[kind][getattr(torch, dt)]}")


def paged_split_parity(dev, errs: Errors) -> None:
    """Lanes whose live range spans no split (inactive), one split,
    exactly one chunk, and every split, at the serving layouts, in both
    modes, against the plain version and the plain split-and-merge with
    the planner's chunk."""
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.paged_attention.ops import plan_splits
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_plain, paged_attention_split)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(5)
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for KV, G, hd, ps, P in ((1, 4, 256, 16, 129), (32, 1, 128, 8, 33),
                                 (10, 4, 128, 16, 129), (8, 8, 128, 16, 129),
                                 (32, 1, 96, 16, 73), (1, 8, 96, 16, 73)):
            for window in (FULL, 512):
                splits, chunk = plan_splits(4, KV, G, P, ps, window, sms)
                seq = [5, chunk - 1, min(P * ps - 1, window + 40), 9]
                case = paged_pool_case(rng, dev, dt, 4, KV, G, hd, ps, P, 2,
                                       seq, [True, True, True, False])
                for self_mode in (False, True):
                    args, kw = paged_args(case, window, self_mode)
                    got = op(*args, **kw)
                    what = (f"split KV={KV} G={G} hd={hd} w={window} "
                            f"self={self_mode} {splits}x{chunk} {dt}")
                    errs.check("paged", what, got,
                               paged_attention_plain(*args, **kw), dt)
                    errs.check("paged", what + " (split plain)", got,
                               paged_attention_split(*args, chunk, **kw), dt)
                    n += 2
    torch.cuda.synchronize()
    print(f"  paged attention: {n} split cases within tolerance (lanes over "
          f"0, 1 and all splits), max_abs_err={errs.max['paged']:.3e}")


def determinism(dev) -> None:
    """Two identical launches of each kernel give identical bits."""
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.support_core.ops import support_core_burst
    rng = np.random.RandomState(6)
    state = init_freelist([512, SERVE_LANES], device=dev)
    sched, _ = schedule(random_queue(rng, 24, 2, 512, 7, dev,
                                     lanes=SERVE_LANES))
    def burst(st, sc, R):
        new, blocks, ok = support_core_burst(st, sc, R)
        return (*new, blocks, ok)
    pool = card_pool(dev, 35840)
    psched, pR = pool_bursts(dev, pool)["decode"]
    runs = {"support core (block path)": lambda: burst(state, sched, 7),
            "support core (cluster path)": lambda: burst(pool, psched, pR)}
    case = paged_pool_case(rng, dev, torch.bfloat16, 4, 1, 4, 256, 16, 129,
                           2, [1400, 1024, 700, 611], [True] * 4)
    args, kw = paged_args(case, FULL, True)
    runs["paged"] = lambda: (op(*args, **kw),)
    case96 = paged_pool_case(rng, dev, torch.bfloat16, 4, 32, 1, 96, 16, 73,
                             2, [1120, 1000, 850, 700], [True] * 4)
    args96, kw96 = paged_args(case96, FULL, True)
    runs["paged hd 96"] = lambda: (op(*args96, **kw96),)
    q = rand(rng, (4, 1536, 4, 256), torch.bfloat16, dev)
    kv = rand(rng, (4, 1536, 1, 256), torch.bfloat16, dev)
    runs["flash"] = lambda: (flash_attention_op(q, kv, kv, window=FULL),)
    q96 = rand(rng, (4, 1088, 32, 96), torch.bfloat16, dev)
    kv96 = rand(rng, (4, 1088, 32, 96), torch.bfloat16, dev)
    runs["flash hd 96"] = lambda: (flash_attention_op(q96, kv96, kv96),)
    qx = rand(rng, (4, 224, 16, 64), torch.bfloat16, dev)
    kvx = rand(rng, (4, 1500, 16, 64), torch.bfloat16, dev)
    runs["flash non-causal"] = lambda: (
        flash_attention_op(qx, kvx, kvx, causal=False),)
    for name, fn in runs.items():
        a, b = fn(), fn()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"{name} kernel: two identical launches differ")
    print(f"  support core: {plan_of(24, 2, 512)}; "
          f"{plan_of(psched.capacity, 2, 35840)}")
    print(f"  determinism: two identical launches bit-identical for "
          f"{', '.join(runs)}")


def time_paged(dev, B, KV, G, hd, ps, P, L, seq, window,
               holes: bool = False) -> dict:
    """The decode call at a serving shape: bf16, self mode on one layer of
    an L-layer pool, every lane active; with ``holes`` the slots behind
    the window NO_BLOCK (:func:`swa_holes`)."""
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    case = paged_pool_case(np.random.RandomState(2), dev, torch.bfloat16, B,
                           KV, G, hd, ps, P, L, seq, [True] * B)
    if holes:
        case = swa_holes(case, window, ps)
    args, kw = paged_args(case, window, True)
    ms = device_ms(lambda: op(*args, **kw))
    plain_ms = device_ms(lambda: paged_attention_plain(*args, **kw))
    live = sum(min(s, window - 1) + 1 for s in seq)   # cached + self
    el = 2
    nbytes = (live * KV * hd * 2 + 2 * B * KV * G * hd) * el \
        + B * 4 * (1 + -(-max(seq) // ps))
    ops = 4 * hd * KV * G * live
    bound = max(nbytes / HBM_BYTES_PER_S, ops / TENSOR_BF16_OPS_PER_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / TENSOR_BF16_OPS_PER_S \
        else "operations"
    shape = dict(B=B, H=KV * G, KV=KV, hd=hd, ps=ps, P=P, seq_lens=list(seq),
                 window=window, live_tokens=live)
    if holes:
        shape["holes"] = int((case["block_tables"] < 0).sum())
    print(f"  time paged {shape}: kernel {ms * 1e3:.2f} us/launch, plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound * 1e3:.3f} us ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, shape=shape)


def time_flash(dev, B, T, H, KV, hd, window, P=0, Tk=None) -> dict:
    """Causal bf16 prefill attention at a serving shape: T queries at
    positions ``[P, P + T)`` over ``P + T`` keys (``P`` > 0: the suffix of
    a prefix-cache hit); with ``Tk``, non-causal attention of T queries
    over Tk keys (whisper's encoder and cross-attention).  The library
    yardstick is ``scaled_dot_product_attention`` (``is_causal`` when
    nothing is masked but the causal triangle, nothing masked when causal
    is off, else a boolean mask), timed here and called nowhere in the
    port."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(3)
    causal = Tk is None
    Tk = P + T if causal else Tk
    q = rand(rng, (B, T, H, hd), torch.bfloat16, dev)
    k = rand(rng, (B, Tk, KV, hd), torch.bfloat16, dev)
    v = rand(rng, (B, Tk, KV, hd), torch.bfloat16, dev)
    ms = device_ms(lambda: flash_attention_op(q, k, v, causal=causal,
                                              window=window, q_offset=P),
                   n=30)
    plain_ms = device_ms(lambda: flash_attention_ref(
        q, k, v, causal=causal, window=window, q_offset=P), n=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not causal:
        library_ms = device_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True),
                               n=30)
    elif window >= Tk and P == 0:
        library_ms = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True), n=30)
    else:
        qpos = P + torch.arange(T, device=dev)
        kpos = torch.arange(Tk, device=dev)
        band = (kpos[None, :] <= qpos[:, None]) \
            & (kpos[None, :] > qpos[:, None] - window)
        library_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=band,
                                            enable_gqa=True), n=30)
    pairs = sum(min(P + i + 1, window) for i in range(T)) if causal \
        else T * Tk
    ops = 4 * hd * pairs * B * H
    # key rows some query can see: the first query (position P) sees none
    # below P - window + 1
    k_lo = max(0, P - window + 1)
    nbytes = 2 * (2 * B * T * H * hd + 2 * B * (Tk - k_lo) * KV * hd)
    t_ops, t_bytes = ops / TENSOR_BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    shape = dict(B=B, T=T, H=H, KV=KV, hd=hd, window=window, pairs=pairs)
    if P:
        shape["q_offset"] = P
    if not causal:
        shape.update(Tk=Tk, causal=False)
    print(f"  time flash {shape}: kernel {ms * 1e3:.2f} us/launch, plain "
          f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.2f} us, bound "
          f"{bound * 1e3:.2f} us ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, shape=shape)


# --------------------------------------------------------------------------
# phases 4 and 5: serving
# --------------------------------------------------------------------------

def make_requests(cfg, wl, prompt_lens):
    """``wl["requests"]`` requests from ``RandomState(0)``: the launcher's
    synthetic mix, or uniform prompt lengths in ``prompt_lens``, each
    request's tokens then (vlm) its ``wl["patches"]`` patch rows or
    (audio) its ``wl["frames"]`` frame rows of ``randn`` in f32, which
    the engine casts to the model's dtype."""
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serve.scheduler import Request
    rng = np.random.RandomState(0)
    if prompt_lens is None:
        return synth_requests(cfg, wl["requests"], rng)
    lens = rng.randint(prompt_lens[0], prompt_lens[1] + 1, wl["requests"])
    reqs = []
    for i, n in enumerate(lens):
        toks = rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32)
        pe = rng.randn(wl["patches"], cfg.d_model).astype(np.float32) \
            if wl.get("patches") else None
        fr = rng.randn(wl["frames"], cfg.d_model).astype(np.float32) \
            if wl.get("frames") else None
        reqs.append(Request(rid=i, tokens=toks, patches=pe, frames=fr))
    return reqs


def time_prefill_passes(eng, times_us: list, hit_us: list | None = None
                        ) -> None:
    """Wrap the engine's prefill so that each pass's wall time, from a
    synchronised start to ``torch.cuda.synchronize()``, lands in
    ``times_us`` -- or in ``hit_us``, when given, for a pass over a cached
    prefix."""
    inner = eng._prefill

    def timed(params, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(params, batch)
        torch.cuda.synchronize()
        hit = hit_us is not None and "prefix_k" in batch
        (hit_us if hit else times_us).append((time.perf_counter() - t0)
                                             * 1e6)
        return res
    eng._prefill = timed


def check_patch_rows(eng, checked: list) -> None:
    """Wrap the engine's admission: after each one, every admitted lane
    must hold its patch rows and its prompt (``P + len(tokens)`` tokens
    in ``seq_lens``); the lengths checked land in ``checked``."""
    inner = eng.admit_many

    def admit(items):
        failed = inner(items)
        seq = eng.state.paged.seq_lens.cpu().tolist()
        for it in items:
            if it.lane in failed:
                continue
            want = len(it.tokens) + (0 if it.patches is None
                                     else len(it.patches))
            if seq[it.lane] != want:
                fail(f"lane {it.lane} holds {seq[it.lane]} tokens after its "
                     f"admission, not patches + prompt = {want}")
            checked.append(want)
        return failed
    eng.admit_many = admit


def check_enc_out(eng, errs: list) -> None:
    """Wrap the engine's admission: after each one, every admitted lane's
    ``enc_out`` must equal the encoder run alone over that request's frames
    (a batch of one, cast as the engine casts them), within bf16 rounding
    of a product of another batch shape (max |diff| <= 2e-2 of the
    output's max |value|); each lane's relative difference lands in
    ``errs``."""
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    inner = eng.admit_many

    def admit(items):
        failed = inner(items)
        launches = FLASH_KERNEL.launches     # the check's own do not count
        for it in items:
            if it.lane in failed:
                continue
            fr = torch.as_tensor(it.frames, dtype=eng.params.embed.dtype,
                                 device=eng.device)[None]
            alone = eng.params.encode(fr)[0].float()
            got = eng.state.enc_out[it.lane].float()
            err = float((got - alone).abs().max() / alone.abs().max())
            if not err <= 2e-2:
                fail(f"lane {it.lane}'s enc_out differs from the encoder run "
                     f"alone by {err:.3e} of its max")
            errs.append(err)
        FLASH_KERNEL.launches = launches
        return failed
    eng.admit_many = admit


def track_recycling(eng, rec: dict) -> None:
    """Wrap the engine's step to keep copies of each step's block tables
    before and after it and of its per-tenant frees (the decode graph
    rewrites its buffers in place: two table copies and one of ``[C]`` in
    the timed step); :func:`recycling_counts` reads them after the
    serve."""
    inner_step, inner_read = eng.step, eng._read_step
    rec.update(steps=[], kv=eng.tenants.kv.size_class)

    def step():
        rec["before"] = eng.state.paged.block_tables.clone()
        return inner_step()

    def read(stats):
        rec["steps"].append((rec.pop("before"),
                             eng.state.paged.block_tables.clone(),
                             stats.tenant.blocks_freed.clone()))
        return inner_read(stats)
    eng.step, eng._read_step = step, read


def recycling_counts(rec: dict) -> dict:
    """From :func:`track_recycling`'s record: each lane's recycled pages
    (table slots that a step turned to NO_BLOCK), the single frees
    (recycles that found the stash full or off) and the most pages any
    lane's table held after a step."""
    before, after, freed = zip(*rec["steps"])
    held = torch.stack(after) >= 0
    return dict(
        recycled=((torch.stack(before) >= 0) & ~held).sum((0, 2)).cpu(),
        flushed=int(torch.stack(freed)[:, rec["kv"]].sum()),
        most=int(held.sum(2).max()))


def serve(cfg, params, dtype, dev, wl, prompt_lens, verbose=False,
          prefill_us=None, patch_rows=None, enc_errs=None, recycling=None,
          stash_size=None, hints=None):
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import make_paged_config
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config
    kvcfg = make_paged_config(cfg, seq_len=wl["seq"], lanes=SERVE_LANES,
                              page_size=wl["page"], dtype=dtype,
                              stash_size=stash_size)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=wl["max_prompt"])
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device=dev,
                        hints=hints)
    if prefill_us is not None:
        time_prefill_passes(eng, prefill_us)
    if cfg.family == "vlm":
        check_patch_rows(eng, [] if patch_rows is None else patch_rows)
    if enc_errs is not None:
        check_enc_out(eng, enc_errs)
    if recycling is not None:
        track_recycling(eng, recycling)
    sched = Scheduler(scfg)
    reqs = make_requests(cfg, wl, prompt_lens)
    step_us: list = []
    steps = serve_loop(eng, sched, reqs, wl["new_tokens"], verbose=verbose,
                       step_times_us=step_us)
    return eng, sched, reqs, steps, step_us


def check_served(eng, sched, reqs) -> None:
    from repro_torch.core.paged_kv import validate_paged_kv
    if len(sched.finished) != len(reqs) or sched.failed or sched.waiting:
        fail(f"served {len(sched.finished)}/{len(reqs)} requests "
             f"({len(sched.failed)} failed, {len(sched.waiting)} waiting)")
    validate_paged_kv(eng.kvcfg, eng.state.paged, eng.tenants)
    if eng.live_pages != 0:
        fail(f"{eng.live_pages} KV pages still live after the last release")


def full_width_config(arch: str):
    """The configuration at its published widths, at ``DEPTH_CUT``'s depth
    where it has one."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in DEPTH_CUT:
        cfg = dataclasses.replace(cfg, num_layers=DEPTH_CUT[arch])
    return cfg


def kv_bytes_per_token(cfg, el: int = 2) -> int:
    """K and V of one token over every KV layer."""
    return cfg.num_attn_layers * 2 * cfg.num_kv_heads \
        * cfg.resolved_head_dim * el


def full_width_params(dev, arch: str):
    """The configuration at its published widths with bf16 weights drawn
    from a seeded generator on the card (a QKV bias drawn like the
    weights, where the config has one)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = full_width_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    hybrid = ""
    if cfg.family == "hybrid":
        spec = params.spec
        hybrid = (f"; Mamba2 d_inner {spec.d_inner}, {spec.heads} SSM heads "
                  f"x {spec.head_dim}, state {spec.n_state}, one shared "
                  f"attention block every {cfg.attn_every} layers "
                  f"({cfg.num_attn_layers} KV layers)")
    if arch in DEPTH_CUT:
        depth = (f"{cfg.num_layers} of {get_config(arch).num_layers} "
                 f"layers (reduced: depth)")
        cut = dict(num_layers=[get_config(arch).num_layers, cfg.num_layers])
        print(f"  reduced: {json.dumps(cut)}")
    else:
        depth = f"{cfg.num_layers} layers (all)"
    extra = ""
    if cfg.qkv_bias:
        b = params.layers[0].bk.float()
        extra += (f"; QKV bias (random, layer 0 bk std {float(b.std()):.4f},"
                  f" RoPE theta {cfg.rope_theta:g})")
    if cfg.family == "vlm":
        extra += (f"; vlm: {cfg.frontend_tokens} patch rows of d_model "
                  f"ahead of each prompt")
    if cfg.family == "ssm":
        extra += (f"; rwkv6: {params.spec.heads} wkv heads x "
                  f"{params.spec.head_dim}, no attention, no K/V")
    if cfg.family == "audio":
        extra += (f"; whisper: {cfg.encoder_layers} encoder layers over "
                  f"{cfg.encoder_seq_len} frame rows, cross-attention after "
                  f"each decoder layer, LayerNorm, GELU MLP with biases")
    if cfg.family == "moe":
        extra += (f"; moe: {cfg.num_experts} experts of d_ff {cfg.d_ff}, "
                  f"top-{cfg.experts_per_token}, capacity factor "
                  f"{cfg.moe_capacity_factor}, f32 router")
    print(f"  {arch}: {depth}, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads x "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.attn_pattern} attention (window {cfg.window}), {cfg.act}, "
          f"bf16{hybrid}{extra}; {param_gb(params):.2f} GB of weights drawn "
          f"in {time.perf_counter() - t0:.1f}s; {kv_bytes_per_token(cfg)} "
          f"bytes of bf16 K/V a token")
    return cfg, params


def param_gb(params) -> float:
    return sum(p.numel() * p.element_size() for p in params.parameters()) \
        / 1e9


def zero_launches() -> None:
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.kernels.paged_attention.ops import PAGED_KERNEL
    from repro_torch.kernels.support_core.ops import KERNEL
    KERNEL.launches = PAGED_KERNEL.launches = FLASH_KERNEL.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.kernels.paged_attention.ops import PAGED_KERNEL
    from repro_torch.kernels.support_core.ops import KERNEL
    return dict(support_core_burst=KERNEL.launches,
                paged_decode_attention=PAGED_KERNEL.launches,
                flash_attention=FLASH_KERNEL.launches)


def check_launches(what: str, launches: dict, want: dict,
                   off_path: tuple = ()) -> None:
    """Each kernel launched as often as the engines' counters say, and at
    least once unless the run's path has no call of it (``off_path``:
    rwkv6 has no attention)."""
    for name, n in launches.items():
        if n != want[name] or (n <= 0 and name not in off_path):
            fail(f"{what}: {name} launches {n} != {want[name]} expected "
                 f"from the engines' counters")


def serve_full_width(dev, arch: str, cfg, params,
                     keep_outputs: bool = False) -> dict:
    """One configuration at its published widths; returns each kernel's
    launches in that run, set to 0 just before it (and, with
    ``keep_outputs``, every request's tokens under ``outputs``)."""
    wl = WORKLOADS[arch]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    from repro_torch.tracing import COUNTERS
    zero_launches()
    counts0 = COUNTERS.read()
    t0 = time.perf_counter()
    prefill_us: list = []
    patch_rows: list = []
    enc_errs = [] if cfg.family == "audio" else None
    recycling = {} if cfg.attn_pattern == "swa" else None
    eng, sched, reqs, steps, step_us = serve(cfg, params, torch.bfloat16,
                                             dev, wl, wl["prompt_lens"],
                                             verbose=True,
                                             prefill_us=prefill_us,
                                             patch_rows=patch_rows,
                                             enc_errs=enc_errs,
                                             recycling=recycling)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_served(eng, sched, reqs)
    swa = {}
    if recycling is not None:
        limit = -(-cfg.window // wl["page"]) + 1
        counts = recycling_counts(recycling)
        per_lane = counts["recycled"].tolist()
        flushed, most = counts["flushed"], counts["most"]
        if most > limit or min(per_lane) <= 0:
            fail(f"{arch}: a lane's table held {most} pages after a step "
                 f"(limit ceil({cfg.window} / {wl['page']}) + 1 = {limit}), "
                 f"or a lane recycled none: {per_lane}")
        swa = dict(recycled_per_lane=per_lane, stash_pushes=sum(per_lane)
                   - flushed, flushes=flushed, most_pages_a_lane=most)
        print(f"  sliding window {cfg.window}: pages recycled per lane "
              f"{per_lane} ({sum(per_lane)}: {sum(per_lane) - flushed} "
              f"pushed to the lane stash, {flushed} flushed as single "
              f"frees); at most {most} pages in a lane's table after any "
              f"step (limit {limit})")
    if eng.state.paged.win is not None:
        swa = split_window_counts(arch, eng, counts0)
    if cfg.family == "vlm":
        if len(patch_rows) != eng.stats.admitted:
            fail(f"{arch}: {len(patch_rows)} admissions checked for their "
                 f"patch rows, {eng.stats.admitted} made")
        print(f"  every one of {len(patch_rows)} admissions holds its "
              f"{wl['patches']} patch rows and its prompt "
              f"({min(patch_rows)}-{max(patch_rows)} tokens, charged as "
              f"pages of {wl['page']})")
    if enc_errs is not None:
        if len(enc_errs) != eng.stats.admitted:
            fail(f"{arch}: {len(enc_errs)} admissions checked for their "
                 f"enc_out, {eng.stats.admitted} made")
        print(f"  every one of {len(enc_errs)} admitted lanes' enc_out "
              f"equals the encoder run alone over its {wl['frames']} frame "
              f"rows (max |diff| / max |enc_out| {max(enc_errs):.3e})")
    s, L = eng.stats, cfg.num_attn_layers
    # whisper: per prefill pass, the encoder's, the decoder's and the
    # cross layers' flash calls; per step, the cross layers' (one query)
    flash_per_pass = cfg.encoder_layers + 2 * L if cfg.encoder_layers else L
    flash_per_step = L if cfg.encoder_layers else 0
    check_launches(arch, launches, dict(
        support_core_burst=s.commits,
        paged_decode_attention=s.decode_steps * L,
        flash_attention=s.prefill_passes * flash_per_pass
        + s.decode_steps * flash_per_step),
        off_path=("paged_decode_attention", "flash_attention")
        if cfg.family == "ssm" else ())
    decode_tokens = sum(len(r.output) for r in reqs) - len(reqs)
    prompts = [r.prompt_len for r in reqs]
    print(f"  served {len(sched.finished)}/{len(reqs)} requests (prompts "
          f"{min(prompts)}-{max(prompts)} tokens) in {steps} decode steps, "
          f"{wall:.2f}s wall; launches: support core {launches['support_core_burst']}"
          f" == commits ({s.hmq_admit_bursts} admit + {s.decode_commits} "
          f"decode + {s.hmq_release_bursts} release), paged "
          f"{launches['paged_decode_attention']} == {s.decode_steps} decode "
          f"steps x {L}, flash {launches['flash_attention']} == "
          f"{s.prefill_passes} prefill passes x {flash_per_pass}"
          f"{f' + {s.decode_steps} steps x {flash_per_step}' if flash_per_step else ''}"
          f"; {s.decode_bursts} decode bursts live")
    tps = decode_tokens / (sum(step_us) / 1e6)
    med = statistics.median(step_us) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    prefill_ms = statistics.median(prefill_us) / 1e3
    card = card_line()
    print(f"  decode {tps:.1f} tokens/s, median decode step {med:.2f} ms, "
          f"peak GPU memory {peak:.2f} GiB in the process, {peak - held:.2f}"
          f" GiB above the {held:.2f} GiB held before the serve (weights "
          f"included there) ({card})")
    print(f"  prefill: {len(prefill_us)} passes, median {prefill_ms:.2f} ms "
          f"wall (each {', '.join(f'{u / 1e3:.2f}' for u in prefill_us)} "
          f"ms; {card})")
    paged, rec = eng.state.paged, eng.state.rec
    pool_gb = 2 * paged.k_pages.numel() * paged.k_pages.element_size() / 1e9
    if paged.win is not None:
        pool_gb += 2 * paged.win.k_pages.numel() \
            * paged.win.k_pages.element_size() / 1e9
    rec_gb = 0.0 if rec is None else sum(
        t.numel() * t.element_size() for t in rec if t is not None) / 1e9
    enc = eng.state.enc_out
    enc_gb = 0.0 if enc is None else enc.numel() * enc.element_size() / 1e9
    print(f"  memory: weights {param_gb(params):.2f} GB, KV pool {pool_gb:.2f}"
          f" GB ({eng.kvcfg.num_kv_layers} KV layers x {eng.kvcfg.num_pages + 1} "
          f"pages, {kv_bytes_per_token(cfg, paged.k_pages.element_size())} "
          f"bytes a token), recurrent state {rec_gb:.3f} GB, encoder outputs "
          f"{enc_gb:.3f} GB")
    for name, rep in eng.tenant_report().items():
        print(f"  {name}: {json.dumps(rep)}")
        if rep["used"] or rep["alloc_count"] != rep["free_count"]:
            fail(f"{arch}: tenant {name} ends with {rep['used']} in use "
                 f"({rep['alloc_count']} allocs, {rep['free_count']} frees)")
    if eng.state.rec is not None:
        # the hybrid grants one slot an admission; rwkv6 none, as the JAX
        # engine (ROADMAP.md, Queue 3)
        want = s.admitted if cfg.family == "hybrid" else 0
        slots = eng.tenant_report()["state_slots"]["alloc_count"]
        if slots != want or (paged.state_slot >= 0).any():
            fail(f"{arch}: {slots} state slots allocated for {s.admitted} "
                 f"admissions (want {want}), or a lane still holds one")
    del eng
    torch.cuda.empty_cache()
    return dict(launches=launches, tokens_per_s=tps, median_step_ms=med,
                peak_gib=peak, serve_gib=peak - held,
                median_prefill_ms=prefill_ms, weight_gb=param_gb(params),
                kv_pool_gb=pool_gb, decode_steps=s.decode_steps,
                prefill_passes=s.prefill_passes, commits=s.commits, **swa,
                **({"outputs": [list(r.output) for r in reqs]}
                   if keep_outputs else {}))


def split_window_counts(arch: str, eng, counts0: dict) -> dict:
    """A split cache's serve, read from the program's counters: the
    window tenant mapped at most its span a lane at admission and
    recycled, its K/V bytes a token against one pool's, and the expert
    rows routed over those computed."""
    from repro_torch.core.paged_kv import page_bytes
    from repro_torch.tracing import COUNTERS
    c = COUNTERS.read()

    def d(name):
        return c.get(name, 0) - counts0.get(name, 0)
    kv = eng.kvcfg
    admitted = d("kv_window_pages.admitted_pages")
    recycled = d("kv_window_pages.recycled")
    if admitted > eng.stats.admitted * kv.window_span or recycled <= 0:
        fail(f"{arch}: the window tenant mapped {admitted} pages for "
             f"{eng.stats.admitted} admissions (at most {kv.window_span} "
             f"each) and recycled {recycled}")
    per_token = (d("kv_pages.held_bytes") + d("kv_window_pages.held_bytes")) \
        / d("kv.held_tokens")
    one_pool = page_bytes(kv, kv.kv_layers) / kv.page_size
    rows = d("moe.rows_routed") / d("moe.rows_computed")
    print(f"  split cache: {kv.num_kv_layers} global layers in "
          f"{kv.num_pages} pages, {len(kv.window_layers)} windowed layers "
          f"in {kv.window_pages}; window pages mapped at admission "
          f"{admitted} (at most {kv.window_span} a lane), recycled "
          f"{recycled}; K/V held {per_token:.0f} bytes a token against "
          f"{one_pool:.0f} in one pool; expert rows routed / computed "
          f"{rows:.3f}")
    return dict(window_admitted_pages=admitted, window_recycled=recycled,
                kv_bytes_per_token=per_token, expert_row_use=rows)


def teacher_forced(dev, arch: str, spec: dict) -> list:
    """``arch`` at full width in f32 with TF32 off (at ``spec["layers"]``
    layers and a capacity factor of ``spec["capacity_factor"]`` where the
    spec gives them): a ``spec["prompt"]``-token prompt (vlm: behind
    ``spec["patches"]`` patch rows of ``randn``; audio: over
    ``spec["frames"]`` frame rows) admitted through the engine, then
    ``spec["steps"]`` decode steps fed given tokens (the seed overwritten,
    so a recurrent family folds no token twice), each step's logits
    against the full forward of the same tokens, patches and frames at
    that step's position (one forward over every token: a causal row does
    not depend on later rows).  Fails above ``spec["tol"]`` of max
    |decode - forward| / max |logit|."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.models.transformer import forward
    from repro_torch.serve.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    cut = {k: spec[v] for k, v in (("num_layers", "layers"),
                                   ("moe_capacity_factor", "capacity_factor"))
           if v in spec}
    cfg = dataclasses.replace(cfg, **cut)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    n, steps, n_patch = spec["prompt"], spec["steps"], spec.get("patches", 0)
    n_frames = spec.get("frames", 0)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, n + steps).astype(np.int32)
    pe = rng.randn(n_patch, cfg.d_model).astype(np.float32) if n_patch \
        else None
    fr = rng.randn(n_frames, cfg.d_model).astype(np.float32) if n_frames \
        else None
    extra = {}
    if pe is not None:
        extra["prefix_embeds"] = torch.as_tensor(pe, device=dev)[None]
    if fr is not None:
        extra["encoder_frames"] = torch.as_tensor(fr, device=dev)[None]
    kvcfg = make_paged_config(cfg, seq_len=spec.get("seq", 1024), lanes=1,
                              page_size=16, dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, params, device=dev)
    if not eng.admit(0, toks[:n], frames=fr, patches=pe):
        fail(f"{arch} teacher-forced: the admission failed")
    ref = forward(params, torch.as_tensor(toks, device=dev)[None],
                  **extra)[0, n_patch + n - 1:]
    errs, holes = [], 0
    for t in range(steps):
        tokens = eng.state.tokens.clone()
        tokens[0] = int(toks[n + t])
        eng.state = eng.state._replace(tokens=tokens)
        eng.state, logits, _ = eng._decode(eng.params, eng.state)
        want = ref[t + 1]
        errs.append(float((logits[0] - want).abs().max() / want.abs().max()))
    if eng.window is not None:
        holes = int((eng.state.paged.block_tables[0] < 0)[
            :int(eng.state.paged.seq_lens[0]) // 16].sum())
        if holes <= 0:
            fail(f"{arch} teacher-forced: no page was recycled")
    behind = f"{n_patch} patch rows and " if n_patch else \
        f"{n_frames} frame rows and " if n_frames else ""
    what = f" ({cfg.num_layers} layers, capacity factor " \
        f"{cfg.moe_capacity_factor}, {holes} pages recycled)" if cut else ""
    print(f"  {arch} teacher-forced, f32, TF32 off{what}: {steps} decode "
          f"steps after {behind}a {n}-token prompt; max |decode - forward| "
          f"/ max |logit| per step: {', '.join(f'{e:.2e}' for e in errs)} "
          f"(tolerance {spec['tol']:g})")
    if not max(errs) <= spec["tol"]:
        fail(f"{arch} teacher-forced decode differs from the forward by "
             f"{max(errs):.3e}")
    del eng, params, ref
    torch.cuda.empty_cache()
    return errs


def device_profile(fn, steps: int) -> tuple[float, float, float]:
    """Device kernel microseconds, launches and wall microseconds (under
    the profiler, ending in a sync) per call of ``fn``, from
    ``torch.profiler`` over ``steps`` calls after one warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in kernels) / steps
    if us <= 0:
        fail("the profiler recorded no device time")
    return us, sum(e.count for e in kernels) / steps, wall_us


def step_profile(dev, arch: str, cfg, params, parts, steps: int = 8
                 ) -> dict:
    """Where ``arch``'s full-width decode step spends the device: its
    phase's first admission batch, 3 warm steps, then ``steps`` steps under
    ``torch.profiler`` (wall, device time, idle share, launches); then, on
    the same lanes' state, each piece of ``parts(eng)`` (key -> (label,
    fn)) alone, as a share of the step's device time and launches."""
    from repro_torch.models import make_paged_config
    from repro_torch.serve.engine import ServingEngine, run_admission
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config
    wl = WORKLOADS[arch]
    kvcfg = make_paged_config(cfg, seq_len=wl["seq"], lanes=SERVE_LANES,
                              page_size=wl["page"], dtype=torch.bfloat16)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=wl["max_prompt"])
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device=dev)
    sched = Scheduler(scfg)
    for req in make_requests(cfg, wl, wl["prompt_lens"]):
        req.max_new_tokens = steps + 8
        sched.submit(req)
    run_admission(eng, sched)
    for _ in range(3):
        eng.step()
    step_us, step_n, wall_us = device_profile(eng.step, steps)
    out = dict(step_device_ms=step_us / 1e3, step_wall_ms=wall_us / 1e3,
               idle_share=1 - step_us / wall_us, launches=step_n)
    print(f"  profile, {steps} decode steps with "
          f"{int(eng.state.paged.active.sum())} lanes active: "
          f"{step_n:.0f} launches a step, device {step_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.2f} ms wall a step under the profiler, idle "
          f"share {out['idle_share']:.3f} ({card_line()})")
    for key, (label, fn) in parts(eng).items():
        us, n, _ = device_profile(fn, steps)
        out[key] = dict(device_share=us / step_us, launch_share=n / step_n,
                        device_ms=us / 1e3)
        print(f"  {label}: {us / 1e3:.3f} ms device time in {n:.0f} "
              f"launches ({us / step_us:.4f} of the step's device time, "
              f"{n / step_n:.4f} of its launches)")
    del eng
    torch.cuda.empty_cache()
    return out


def hybrid_parts(eng) -> dict:
    """zamba2's step pieces: every layer's Mamba2 block, and its SSD
    recurrence (plain PyTorch, as in the reference)."""
    from repro_torch.models import mamba2 as m2
    from repro_torch.models.linear_attention import \
        linear_attention_decode_step
    params, dev = eng.params, eng.device
    rec, spec = eng.state.rec, params.spec
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((SERVE_LANES, spec.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16)
    qk = torch.randn((SERVE_LANES, spec.heads, spec.n_state), generator=gen,
                     device=dev)
    v = torch.randn((SERVE_LANES, spec.heads, spec.head_dim), generator=gen,
                    device=dev)
    decay = -torch.rand((SERVE_LANES, spec.heads, 1), generator=gen,
                        device=dev)

    def blocks():
        for i, layer in enumerate(params.layers):
            m2.mamba2_decode_step(layer.mamba, spec, x, m2.Mamba2DecodeState(
                conv=rec.conv[i], ssm=rec.ssm[i]))

    def ssd():
        for i in range(len(params.layers)):
            linear_attention_decode_step(rec.ssm[i], qk, qk, v, decay)

    return {"mamba2": ("the Mamba2 blocks, every layer", blocks),
            "ssd": ("their SSD recurrence (plain PyTorch)", ssd)}


def moe_parts(eng) -> dict:
    """The moe family's step pieces on the lanes' hidden rows: every
    layer's MoE layer (routing, dispatch, the experts' two batched
    products over all their weights, combine), and its routing alone
    (router product, softmax, top-k, ranks)."""
    from repro_torch.models import moe as mo
    params, dev, cfg = eng.params, eng.device, eng.cfg
    spec = mo.spec_of(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((SERVE_LANES, 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)

    def layers():
        for lp in params.layers:
            mo.moe_apply(lp.moe, spec, h)

    def routing():
        for lp in params.layers:
            mo.route(lp.moe, spec, h[:, 0])

    return {"moe": ("the MoE layers, every layer", layers),
            "routing": ("their routing (router, softmax, top-k, ranks)",
                        routing)}


def rwkv6_parts(eng) -> dict:
    """rwkv6's step pieces: every layer's time mix, and its wkv
    recurrence (plain PyTorch, as in the reference)."""
    from repro_torch.models import rwkv6 as rw
    from repro_torch.models.linear_attention import \
        linear_attention_decode_step
    params, dev = eng.params, eng.device
    rec, spec = eng.state.rec, params.spec
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((SERVE_LANES, spec.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16)
    r, k, v = (torch.randn((SERVE_LANES, spec.heads, spec.head_dim),
                           generator=gen, device=dev) for _ in range(3))
    decay = -torch.rand((SERVE_LANES, spec.heads, spec.head_dim),
                        generator=gen, device=dev)

    def time_mix():
        for i, layer in enumerate(params.layers):
            rw.rwkv6_time_mix_step(layer.tm, spec, x, rw.RWKV6DecodeState(
                wkv=rec.ssm[i], tm_prev=rec.tm_prev[i],
                cm_prev=rec.cm_prev[i]))

    def wkv():
        for i, layer in enumerate(params.layers):
            linear_attention_decode_step(rec.ssm[i], r, k, v, decay,
                                         strict=True, bonus=layer.tm.bonus_u)

    return {"time_mix": ("the time mixes, every layer", time_mix),
            "wkv": ("their wkv recurrence (plain PyTorch)", wkv)}


def whisper_parts(eng) -> dict:
    """whisper's step pieces: the cross K/V projected from every lane's
    ``enc_out`` in every layer (2 x lanes x frames x d x KV*hd
    multiply-adds a layer, anew each step, as the reference does), and the
    cross-attention's flash calls (one query over the frames)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.models.transformer import cross_kv
    params, cfg, enc = eng.params, eng.cfg, eng.state.enc_out
    kv = [cross_kv(cfg, cp, enc) for cp in params.cross_layers]
    q = torch.randn((enc.shape[0], 1, cfg.num_heads, cfg.resolved_head_dim),
                    device=enc.device).to(enc.dtype)

    def project():
        for cp in params.cross_layers:
            cross_kv(cfg, cp, enc)

    def attend():
        for k, v in kv:
            flash_attention_op(q, k, v, causal=False)

    return {"cross_kv": ("the cross K/V projection, every layer", project),
            "cross_attention": ("the cross-attention's flash calls, every "
                                "layer", attend)}


def timed_method(obj, name: str) -> list:
    """Wrap ``obj.name`` so that each call's wall time, from its start to
    ``torch.cuda.synchronize()`` after it, lands in the returned list."""
    inner, times_us = getattr(obj, name), []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        times_us.append((time.perf_counter() - t0) * 1e6)
        return out
    setattr(obj, name, timed)
    return times_us


def shared_prefix_requests(cfg, n: int = MULTI["requests"]):
    """``n`` requests from ``RandomState(0)``: two shared 64-token prefixes,
    request i opening with prefix ``i % 2`` (round-robin routing sends it
    to shard ``i % 2``, the shard that caches that prefix), then a unique
    tail of 8-40 tokens; for the audio family, then each request's frame
    rows of ``randn``."""
    from repro_torch.serve.scheduler import Request
    rng = np.random.RandomState(0)
    heads = [rng.randint(0, cfg.vocab_size, MULTI["prefix"]) for _ in range(2)]
    reqs = [Request(rid=i, tokens=np.concatenate([
        heads[i % 2], rng.randint(0, cfg.vocab_size, rng.randint(8, 41))])
        .astype(np.int32)) for i in range(n)]
    if cfg.family == "audio":
        for r in reqs:
            r.frames = rng.randn(cfg.encoder_seq_len, cfg.d_model).astype(
                np.float32)
    return reqs


def multi_engine(cfg, params, dtype, dev, prefix_cache: bool, alias: bool,
                 policy: str = "freelist", stash_size=None):
    """Two shards of ``SERVE_LANES`` lanes on one service running
    ``policy``, burst windows of ``MULTI["quantum"]`` steps, round robin,
    preemption on, per-shard prefix caches (LRU) in alias or copy mode."""
    from repro_torch.models import make_paged_config
    from repro_torch.serve.multi_engine import MultiEngine
    from repro_torch.serve.scheduler import make_scheduler_config
    kvcfg = make_paged_config(cfg, seq_len=MULTI["seq"], lanes=SERVE_LANES,
                              page_size=MULTI["page"], dtype=dtype,
                              stash_size=stash_size)
    scfg = make_scheduler_config(cfg, kvcfg,
                                 max_prompt_len=MULTI["max_prompt"])
    return MultiEngine(cfg, kvcfg, params, n_engines=MULTI["engines"],
                       sched_cfg=scfg, quantum=MULTI["quantum"],
                       preemption=True, router="round_robin",
                       prefix_cache=prefix_cache, eviction="lru",
                       prefix_alias="alias" if alias else "copy", device=dev,
                       alloc_policy=policy)


def check_multi_served(me, reqs, what: str) -> None:
    if len(me.finished) != len(reqs) or me.failed or me.has_work:
        fail(f"{what}: served {len(me.finished)}/{len(reqs)} requests "
             f"({len(me.failed)} failed)")
    me.validate()


def check_cache_used(me, what: str, alias: bool) -> None:
    """Every shard hit its cache, saved prefill tokens and aliased (alias
    mode) or copied (copy mode) pages; its last occupancy is its cache's
    residue."""
    for i, eng in enumerate(me.engines):
        s = eng.stats
        moved = s.aliased_pages if alias else s.cache_hit_copy_bytes
        if not (s.cache_hits > 0 and s.prefill_tokens_saved > 0
                and moved > 0):
            fail(f"{what}: shard {i} hits {s.cache_hits}, saved "
                 f"{s.prefill_tokens_saved} tokens, aliased "
                 f"{s.aliased_pages} pages, copied "
                 f"{s.cache_hit_copy_bytes} bytes")
        used = eng.tenant_report()[eng.tenants.kv.name]["used"]
        if used != s.cache_pages or eng.cache.pinned:
            fail(f"{what}: shard {i} holds {used} pages at the end, its "
                 f"cache {s.cache_pages} ({eng.cache.pinned} pinned)")


def serve_multi_full_width(dev, cfg, params) -> dict:
    """Phase 4c: the slice's path at full width; returns each kernel's
    launches in that run, set to 0 just before it."""
    reqs = shared_prefix_requests(cfg)
    me = multi_engine(cfg, params, torch.bfloat16, dev, True, True)
    miss_us: list = []
    hit_us: list = []
    for eng in me.engines:
        time_prefill_passes(eng, miss_us, hit_us)
    step_us: list = []
    flush_us = timed_method(me, "_flush_window")
    validate_us = timed_method(me, "validate")
    zero_launches()
    t0 = time.perf_counter()
    windows = me.serve(reqs, max_new_tokens=MULTI["new_tokens"],
                       validate=True, step_times_us=step_us)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    # the deployment's rate: every decode token over the serve's wall time
    # (admission, prefill, engine-steps, window commits), less the I1-I6
    # checks that only this smoke run makes
    serve_s = wall - sum(validate_us) / 1e6
    check_multi_served(me, reqs, "4c")
    check_cache_used(me, "4c", alias=True)
    st, L = me.stats, cfg.num_layers
    commits = sum(e.stats.commits for e in me.engines)
    passes = sum(e.stats.prefill_passes for e in me.engines)
    check_launches("4c", launches, dict(
        support_core_burst=commits + st.window_bursts,
        paged_decode_attention=st.decode_steps * L,
        flash_attention=passes * L))
    decode_tokens = sum(len(r.output) for r in reqs) - len(reqs)
    tps = decode_tokens / serve_s
    med_step = statistics.median(step_us) / 1e3
    prompts = [r.prompt_len for r in reqs]
    print(f"  served {len(me.finished)}/{len(reqs)} requests (prompts "
          f"{min(prompts)}-{max(prompts)} tokens) on {me.n_engines} shards "
          f"in {windows} windows, {st.decode_steps} engine-steps, "
          f"{wall:.2f}s wall ({sum(validate_us) / 1e6:.2f}s of it I1-I6 "
          f"after every window); launches: support "
          f"core {launches['support_core_burst']} == {commits} engine "
          f"commits + {st.window_bursts} window commits, paged "
          f"{launches['paged_decode_attention']} == {st.decode_steps} "
          f"engine-steps x {L}, flash {launches['flash_attention']} == "
          f"{passes} prefill passes x {L}")
    print(f"  window commits {st.window_commits} live of {st.window_bursts}, "
          f"cross-engine burst occupancy "
          f"{st.cross_engine_burst_occupancy:.3f}")
    print(f"  decode {tps:.1f} tokens/s ({decode_tokens} tokens over "
          f"{serve_s:.3f}s of serving); of it engine-steps "
          f"{sum(step_us) / 1e6:.3f}s ({len(step_us)}, median "
          f"{med_step:.2f} ms), window commits {sum(flush_us) / 1e6:.4f}s "
          f"({len(flush_us)}, median {statistics.median(flush_us) / 1e3:.3f}"
          f" ms), the rest (admission, prefill, completions) "
          f"{serve_s - (sum(step_us) + sum(flush_us)) / 1e6:.3f}s")
    for i, eng in enumerate(me.engines):
        s = eng.stats
        print(f"  e{i}: admitted {s.admitted}, cache hits {s.cache_hits} / "
              f"misses {s.cache_misses}, prefill tokens saved "
              f"{s.prefill_tokens_saved}, aliased pages {s.aliased_pages}, "
              f"cache pages {s.cache_pages}, {s.decode_steps} steps "
              f"({s.decode_bursts} with a live emergency burst)")
    med = {k: statistics.median(v) / 1e3 if v else float("nan")
           for k, v in (("hit", hit_us), ("miss", miss_us))}
    print(f"  prefill: {len(hit_us)} passes with a hit, median "
          f"{med['hit']:.2f} ms; {len(miss_us)} without, median "
          f"{med['miss']:.2f} ms")
    for name, d in me.tenant_rollup().items():
        print(f"  rollup {name}: {json.dumps(d)}")
    outs = {r.rid: list(r.output) for r in reqs}
    del me
    off_reqs = shared_prefix_requests(cfg)
    off = multi_engine(cfg, params, torch.bfloat16, dev, False, True)
    off.serve(off_reqs, max_new_tokens=MULTI["new_tokens"])
    check_multi_served(off, off_reqs, "4c cache off")
    diff = sum(a != b for r in off_reqs
               for a, b in zip(r.output, outs[r.rid]))
    print(f"  tokens differing from the cache-off run: {diff} of "
          f"{sum(len(v) for v in outs.values())} (not gated)")
    del off
    torch.cuda.empty_cache()
    return dict(launches=launches, tokens_per_s=tps,
                median_step_ms=med_step,
                window_commit_ms=sum(flush_us) / 1e3,
                window_commits=st.window_commits,
                window_bursts=st.window_bursts,
                occupancy=st.cross_engine_burst_occupancy,
                median_prefill_hit_ms=med["hit"],
                median_prefill_miss_ms=med["miss"], differing_tokens=diff)


# phase 4d: open-loop traffic, the reference LoadgenSpec's lengths with a
# 24-token output cap, on phase 4c's deployment under the buddy policy
OPEN_LOOP = dict(
    policy="buddy", compact_every=2,
    spec=dict(n_requests=24, arrival="poisson", rate=0.5, prompt_alpha=2.0,
              prompt_min=8, prompt_cap=48, output_alpha=1.5, output_min=2,
              output_cap=24, shared_prefix_frac=0.5, shared_prefix_tokens=16,
              priority_frac=0.25, seed=0))
TRACE_PATH = ROOT / "build" / "open_loop.trc"


class CacheBlocks:
    """A prefix cache's block list as it stood at a window's end (the part
    of a :class:`PrefixCache` that the I5/I6 check reads)."""

    def __init__(self, blocks):
        self._blocks = blocks

    def blocks(self):
        return self._blocks


def device_copy(x):
    """A state (a NamedTuple of tensors) copied on its own device: queued
    on the stream, no host read."""
    return type(x)(*[t.clone() for t in x])


def snapshot(me) -> list:
    """Device copies of what I1-I6 read after a window, per shard: the
    shared allocator state, the shard's tables and stash (its cache's
    blocks are host data already).  :func:`snapshot_to_host` moves them to
    the host once the timed run is over."""
    alloc = device_copy(me.alloc)
    out = []
    for eng in me.engines:
        p = eng.state.paged
        out.append((p._replace(
            alloc=alloc, block_tables=p.block_tables.clone(),
            seq_lens=p.seq_lens.clone(), active=p.active.clone(),
            stash=device_copy(p.stash), scratch_slot=p.scratch_slot.clone(),
            k_pages=None, v_pages=None),
            eng.tenants, CacheBlocks(eng.cache.blocks())))
    return out


def snapshot_to_host(snap: list) -> list:
    alloc = to_cpu(snap[0][0].alloc)
    return [(p._replace(alloc=alloc, block_tables=p.block_tables.cpu(),
                        seq_lens=p.seq_lens.cpu(), active=p.active.cpu(),
                        stash=to_cpu(p.stash),
                        scratch_slot=p.scratch_slot.cpu()), tenants, cache)
            for p, tenants, cache in snap]


def open_loop_full_width(dev, cfg, params) -> dict:
    """Phase 4d: the slice's path at full width -- open-loop arrivals on two
    shards under the buddy policy, a compaction pass every two windows, the
    allocator-op trace recorded.  After every window the state I1-I6 read
    is copied on the card, and the allocator state around every pass too;
    the copies reach the host, and are checked and reported, only after
    the timed run.  The timed loop thus holds no host read of the check's
    or of the fragmentation report's; each pass's own plan (one host read
    of the allocator rows) stays in, as in any compacting deployment.
    Returns the run's launches and numbers."""
    from repro_torch.core.paged_kv import validate_paged_kv
    from repro_torch.loadgen import (LoadgenSpec, build_workload,
                                     certify_complete, record_service,
                                     run_open_loop, save_trace)
    me = multi_engine(cfg, params, torch.bfloat16, dev, True, True,
                      policy=OPEN_LOOP["policy"])
    timed = build_workload(LoadgenSpec(**OPEN_LOOP["spec"]), cfg.vocab_size)
    snaps, moves, passes_state = [], [], []
    inner = me.step_window

    def window():
        progressed = inner()
        if me.stats.windows % OPEN_LOOP["compact_every"] == 0:
            before = device_copy(me.alloc)
            moves.append(me.compact())
            passes_state.append((before, device_copy(me.alloc)))
        snaps.append(snapshot(me))
        return progressed

    me.step_window = window
    rec = record_service(me.service)
    zero_launches()
    rep = run_open_loop(me, timed)
    torch.cuda.synchronize()
    launches = read_launches()
    me.service.recorder = None
    trace = certify_complete(rec.finish(), me.engines,
                             me.stats.window_bursts)
    TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
    save_trace(trace, TRACE_PATH)

    if rep.stranded or rep.failed or rep.completed != len(timed):
        fail(f"4d: completed {rep.completed}/{len(timed)}, failed "
             f"{rep.failed}, stranded {rep.stranded}")
    for w, snap in enumerate(snaps):
        for state, tenants, cache in snapshot_to_host(snap):
            try:
                validate_paged_kv(me.kvcfg, state, tenants, cache=cache)
            except AssertionError as err:
                fail(f"4d: I1-I6 after window {w + 1}: {err}")
    st, L = me.stats, cfg.num_layers
    passes = sum(e.stats.prefill_passes for e in me.engines)
    want = dict(support_core_burst=0,
                paged_decode_attention=st.decode_steps * L,
                flash_attention=passes * L)
    if launches != want:
        fail(f"4d: launches {launches}, expected {want} (the buddy policy "
             f"runs plain, so no support-core kernel launch)")
    for i, eng in enumerate(me.engines):
        s = eng.stats
        used = eng.tenant_report()[eng.tenants.kv.name]["used"]
        if not s.mean_run_len > 1:
            fail(f"4d: shard {i} mean run length {s.mean_run_len}")
        if used != s.cache_pages or eng.cache.pinned:
            fail(f"4d: shard {i} holds {used} pages at the end, its cache "
                 f"{s.cache_pages} ({eng.cache.pinned} pinned)")
    total_moves = sum(map(sum, moves))
    frag = {}
    if total_moves:
        k, i = max(((k, i) for k in range(len(moves))
                    for i in range(len(moves[k]))),
                   key=lambda ki: moves[ki[0]][ki[1]])
        kv = me.engines[i].tenants.kv
        before, after = (me.service.fragmentation_report(
            to_cpu(a), tenants=[kv])[kv.name] for a in passes_state[k])
        frag = dict(shard=i, moved=moves[k][i], before=before, after=after)
    prompts = [r.prompt_len for _, r in timed]
    outs = [r.max_new_tokens for _, r in timed]
    print(f"  {len(timed)} requests (prompts {min(prompts)}-{max(prompts)} "
          f"tokens, outputs {min(outs)}-{max(outs)}, "
          f"{sum(r.priority for _, r in timed)} at priority 1), Poisson "
          f"{OPEN_LOOP['spec']['rate']} per step: completed {rep.completed}, "
          f"failed {rep.failed}, stranded {rep.stranded} in {rep.windows} "
          f"windows, {rep.decode_steps} engine-steps, {rep.wall_s:.2f}s "
          f"wall; I1-I6 held after all {len(snaps)} windows")
    print(f"  TTFT p50 {rep.p50_ttft_us:.0f} us, p90 {rep.p90_ttft_us:.0f} "
          f"us, p99 {rep.p99_ttft_us:.0f} us (p50 {rep.p50_ttft_steps:.2f}, "
          f"p99 {rep.p99_ttft_steps:.2f} steps); TPOT p50 "
          f"{rep.p50_tpot_us:.0f} us, p99 {rep.p99_tpot_us:.0f} us; "
          f"{rep.requests_per_s:.3f} requests/s; queue depth mean "
          f"{rep.queue_depth_mean:.2f}, max {rep.queue_depth_max}")
    print(f"  launches: support core {launches['support_core_burst']} "
          f"(buddy is plain), paged {launches['paged_decode_attention']} == "
          f"{st.decode_steps} engine-steps x {L}, flash "
          f"{launches['flash_attention']} == {passes} prefill passes x {L}; "
          f"preemptions {st.preemptions}, live window commits "
          f"{st.window_commits} of {st.window_bursts}")
    print(f"  compaction: {len(moves)} passes, {total_moves} pages moved "
          f"({moves})")
    if frag:
        keys = ("free", "free_extents", "largest_free_run",
                "largest_aligned_run", "external_frag")
        print(f"  fragmentation of shard {frag['shard']}'s kv_pages around "
              f"the pass that moved most ({frag['moved']} pages): before "
              f"{json.dumps({k: frag['before'][k] for k in keys})}, after "
              f"{json.dumps({k: frag['after'][k] for k in keys})}")
    for i, eng in enumerate(me.engines):
        s = eng.stats
        print(f"  e{i}: mean_run_len {s.mean_run_len:.3f} "
              f"({s.extent_pages} pages in {s.contiguous_extents} extents), "
              f"cache hits {s.cache_hits} / misses {s.cache_misses}, aliased "
              f"pages {s.aliased_pages}, preemptions {s.preemptions}, "
              f"splits/merges "
              f"{eng.fragmentation_report()[eng.tenants.kv.name]['split_count']}"
              f"/{eng.fragmentation_report()[eng.tenants.kv.name]['merge_count']}")
    print(f"  trace: {trace.bursts} bursts ({trace.live_bursts} live, "
          f"{trace.ops} ops), {trace.windows} windows, "
          f"{sum(ev[0] == 'retag' for ev in trace.events)} retags, "
          f"{sum(ev[0] == 'bump' for ev in trace.events)} bumps -> "
          f"{TRACE_PATH.relative_to(ROOT)} ({TRACE_PATH.stat().st_size} "
          f"bytes), complete")
    live = me.service.tenant_report(me.alloc)
    result = dict(
        launches=launches, report=rep.as_metrics(),
        mean_run_len=[e.stats.mean_run_len for e in me.engines],
        compaction_moves=total_moves, compaction_passes=len(moves),
        fragmentation=frag, trace_bursts=trace.bursts, live=live)
    del me
    torch.cuda.empty_cache()
    return result


def replay_on_both(trace, policy: str, dev, what: str):
    """``trace`` replayed under ``policy`` on the card (support-core
    launches counted) and on the CPU; fails unless the final states and
    counters are identical and, under the free list, every burst was one
    kernel launch.  Returns ``(card result, cpu result, launches)``."""
    from repro_torch.loadgen import replay_trace
    zero_launches()
    res = replay_trace(trace, policy=policy, device=dev)
    launches = read_launches()["support_core_burst"]
    cpu = replay_trace(trace, policy=policy, device="cpu")
    for field in res.state._fields:
        if not torch.equal(getattr(res.state, field).cpu(),
                           getattr(cpu.state, field)):
            fail(f"4e: {what} under {policy}, {field} differs between the "
                 f"card and the cpu")
    if res.report != cpu.report:
        fail(f"4e: {what} under {policy}, counters differ between the card "
             f"and the cpu")
    want = res.bursts if policy == "freelist" else 0
    if launches != want:
        fail(f"4e: {what} under {policy} made {launches} support-core "
             f"launches, expected {want}")
    return res, cpu, launches


def replay_full_width(dev, live: dict) -> dict:
    """Phase 4e: 4d's tracefile replayed with no model, on the card and on
    the CPU.  As recorded (buddy): the live run's counters exactly.  Its
    single frees, retags and bumps name buddy's block ids, so a replay
    under another policy must refuse it; the trace without them
    (``drop_block_ids``) replays under all three policies, the same
    packets under each, so each rate is its policy's alone.  Every replay:
    card == CPU bit for bit, every free-list burst a kernel launch."""
    from repro_torch.loadgen import load_trace, replay_trace
    trace = load_trace(TRACE_PATH)
    recorded = trace.header["policy"]
    out = {}
    runs = [("recorded", trace, recorded)] + [
        ("without block ids", trace.drop_block_ids(), policy)
        for policy in ("buddy", "freelist", "bitmap")]
    for what, tr, policy in runs:
        res, cpu, launches = replay_on_both(tr, policy, dev, what)
        if what == "recorded" and res.report != live:
            fail(f"4e: the {policy} replay's counters {res.report} are not "
                 f"the live run's {live}")
        rate = res.bursts / res.wall_s
        print(f"  replay of the {what} trace under {policy} on the card: "
              f"{res.bursts} bursts ({res.live_bursts} live, {res.ops} ops) "
              f"in {res.wall_s * 1e3:.1f} ms = {rate:.1f} bursts/s (cpu "
              f"{cpu.wall_s * 1e3:.1f} ms), {launches} kernel launches; "
              f"final state card == cpu"
              + ("; counters == the live run's" if what == "recorded"
                 else ""))
        out[f"{what}/{policy}"] = dict(
            wall_s=res.wall_s, bursts=res.bursts, bursts_per_s=rate,
            cpu_wall_s=cpu.wall_s, launches=launches)
    for policy in ("freelist", "bitmap"):
        try:
            replay_trace(trace, policy=policy, device=dev)
        except ValueError:
            continue
        fail(f"4e: a what-if replay under {policy} of a trace that names "
             f"block ids was not refused")
    print("  the recorded trace under freelist and bitmap: refused (it "
          "names buddy's block ids)")
    return out


def top2_margin(cfg, params_cpu, tokens) -> float:
    from repro_torch.models.transformer import forward
    logits = forward(params_cpu, torch.as_tensor(tokens)[None])[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def device_vs_cpu(dev, arch: str) -> None:
    """Phase 5 for ``arch`` at its reduced config: one engine on the card
    and on the CPU, then the family's multi-shard runs (sliding window:
    the engine again with the stash off, then two shards with the stash
    off, so that every recycle is a single free on a decode or a window
    commit)."""
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced_config(arch)
    params_cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to(dev)
    engine_device_vs_cpu(dev, arch, cfg, params_cpu, params_gpu)
    if cfg.family in ("hybrid", "ssm"):
        # a recurrent family never hits a prefix cache: two shards without
        # one, under the free list and under buddy
        policy_device_vs_cpu(dev, arch, cfg, params_cpu, params_gpu, None,
                             policies=("freelist", "buddy"), cache=False)
    elif cfg.family == "audio":
        audio_multi_device_vs_cpu(dev, arch, cfg, params_cpu, params_gpu)
    elif arch in MULTI_ARCHS:
        multi_device_vs_cpu(dev, arch, cfg, params_cpu, params_gpu)
    elif cfg.attn_pattern == "swa":
        engine_device_vs_cpu(dev, arch, cfg, params_cpu, params_gpu,
                             stash_size=0)
        policy_device_vs_cpu(dev, arch, cfg, params_cpu, params_gpu, None,
                             policies=("freelist",), stash_size=0)


def engine_device_vs_cpu(dev, arch: str, cfg, params_cpu, params_gpu,
                         stash_size=None) -> None:
    """One engine serving phase 5's requests on the card and on the CPU:
    identical tokens, allocator state and paged metadata."""
    runs = {}
    for name, p, d in (("cuda", params_gpu, dev), ("cpu", params_cpu, "cpu")):
        recycling = {} if cfg.attn_pattern == "swa" else None
        eng, sched, reqs, steps, _ = serve(cfg, p, torch.float32, d, SMALL,
                                           SMALL_PROMPTS[arch],
                                           recycling=recycling,
                                           stash_size=stash_size)
        check_served(eng, sched, reqs)
        runs[name] = (eng, reqs, steps, recycling)
    (eg, rg, sg, cg), (ec, rc, sc, cc) = runs["cuda"], runs["cpu"]
    for a, b in zip(rg, rc):
        if a.output != b.output:
            i = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                      if x != y), min(len(a.output), len(b.output)))
            ctx = np.concatenate([b.tokens, np.asarray(b.output[:i],
                                                       np.int32)])
            fail(f"{arch}: request {a.rid} token {i} differs between cuda "
                 f"({a.output[i:i + 1]}) and cpu ({b.output[i:i + 1]}); top-2 "
                 f"logit margin on the cpu there: "
                 f"{top2_margin(cfg, params_cpu, ctx):.3e}")
    if sg != sc:
        fail(f"{arch}: {sg} decode steps on cuda, {sc} on cpu")
    ag, ac = eg.state.paged.alloc, ec.state.paged.alloc
    for field in ag._fields:
        if not torch.equal(getattr(ag, field).cpu(), getattr(ac, field)):
            fail(f"{arch}: allocator state field {field} differs between "
                 f"cuda and cpu")
    for field in ("block_tables", "seq_lens", "active", "scratch_slot",
                  "state_slot"):
        if not torch.equal(getattr(eg.state.paged, field).cpu(),
                           getattr(ec.state.paged, field)):
            fail(f"{arch}: paged state field {field} differs between cuda "
                 f"and cpu")
    if eg.state.paged.win is not None:
        wg, wc = eg.state.paged.win, ec.state.paged.win
        for name, a, b in (("block_tables", wg.block_tables, wc.block_tables),
                           ("stash pages", wg.stash.pages, wc.stash.pages),
                           ("stash depth", wg.stash.depth, wc.stash.depth)):
            if not torch.equal(a.cpu(), b):
                fail(f"{arch}: the window tenant's {name} differ between "
                     f"cuda and cpu")
    recycled = ""
    if cg is not None:
        cg, cc = recycling_counts(cg), recycling_counts(cc)
        got = [cg["recycled"].tolist(), int(cg["flushed"])]
        every = stash_size != 0 or got[1] == sum(got[0])
        if got != [cc["recycled"].tolist(), int(cc["flushed"])] or \
                min(got[0]) <= 0 or not every:
            fail(f"{arch}: pages recycled per lane and flushed {got} on the "
                 f"card, {[cc['recycled'].tolist(), int(cc['flushed'])]} on "
                 f"the cpu")
        recycled = (f"; stash {eg.kvcfg.stash_size}: pages recycled per lane "
                    f"{got[0]}, {got[1]} of them flushed as single frees on "
                    f"the decode burst, on both")
    prompts = [r.prompt_len for r in rg]
    print(f"  {arch} ({cfg.num_layers} layers, {cfg.num_heads} heads on "
          f"{cfg.num_kv_heads} KV heads x {cfg.resolved_head_dim}"
          f"{', QKV bias' if cfg.qkv_bias else ''}"
          f"{', 4 patch rows a request' if cfg.family == 'vlm' else ''}"
          f"{f', {cfg.encoder_seq_len} frame rows a request' if cfg.family == 'audio' else ''}, "
          f"windows {[cfg.window] if cfg.window else 'none'}"
          f"{f', attention every {cfg.attn_every}' if cfg.attn_every else ''}"
          f"): cuda and cpu agree on "
          f"{sum(len(r.output) for r in rg)} tokens over {sg} decode steps "
          f"(prompts {min(prompts)}-{max(prompts)}), allocator state "
          f"bit-identical{recycled}")


def multi_device_vs_cpu(dev, arch: str, cfg, params_cpu, params_gpu) -> None:
    """Two shards with the cache on (alias mode where the attention is
    full, copy mode otherwise) on the card and on the CPU: identical
    tokens, shared allocator state, block tables and stashes; and on the
    card, cache-on tokens equal to cache-off tokens."""
    alias = cfg.attn_pattern == "full"
    runs = {}
    for name, p, d, on in (("cuda", params_gpu, dev, True),
                           ("cpu", params_cpu, "cpu", True),
                           ("cuda, cache off", params_gpu, dev, False)):
        reqs = shared_prefix_requests(cfg, MULTI["small_requests"])
        me = multi_engine(cfg, p, torch.float32, d, on, alias)
        me.serve(reqs, max_new_tokens=MULTI["new_tokens"], validate=True)
        check_multi_served(me, reqs, f"{arch} multi-engine {name}")
        if on:
            check_cache_used(me, f"{arch} multi-engine {name}", alias)
        runs[name] = (me, {r.rid: list(r.output) for r in reqs})
    (mg, og), (mc, oc) = runs["cuda"], runs["cpu"]
    if og != oc:
        fail(f"{arch} multi-engine: tokens differ between cuda and cpu")
    if og != runs["cuda, cache off"][1]:
        fail(f"{arch} multi-engine: cache-on tokens differ from cache-off "
             f"tokens")
    for field in mg.alloc._fields:
        if not torch.equal(getattr(mg.alloc, field).cpu(),
                           getattr(mc.alloc, field)):
            fail(f"{arch} multi-engine: shared allocator field {field} "
                 f"differs between cuda and cpu")
    for i, (eg, ec) in enumerate(zip(mg.engines, mc.engines)):
        pg, pc = eg.state.paged, ec.state.paged
        for field in ("block_tables", "seq_lens", "active"):
            if not torch.equal(getattr(pg, field).cpu(), getattr(pc, field)):
                fail(f"{arch} multi-engine: shard {i} {field} differs "
                     f"between cuda and cpu")
        if not (torch.equal(pg.stash.pages.cpu(), pc.stash.pages)
                and np.array_equal(eg.cache.blocks(), ec.cache.blocks())):
            fail(f"{arch} multi-engine: shard {i} stash or cache differs "
                 f"between cuda and cpu")
    hits = sum(e.stats.cache_hits for e in mg.engines)
    print(f"  {arch} two shards, cache on ({'alias' if alias else 'copy'} "
          f"mode): cuda and cpu agree on {sum(map(len, og.values()))} tokens "
          f"over {mg.stats.decode_steps} engine-steps and {mg.stats.windows} "
          f"windows ({hits} hits, {mg.stats.window_commits} live window "
          f"commits), shared allocator state bit-identical; tokens equal the "
          f"cache-off run's")
    policy_device_vs_cpu(dev, arch, cfg, params_cpu, params_gpu, og)


def audio_multi_device_vs_cpu(dev, arch: str, cfg, params_cpu,
                              params_gpu) -> None:
    """Two shards with the cache on (copy mode), shared-prefix prompts
    over their own frames, on the card and on the CPU: identical tokens
    and shared allocator state; no page demoted into either shard's cache
    (a lane's K/V depends on its audio), and tokens equal the cache-off
    run's on the card."""
    runs = {}
    for name, p, d, on in (("cuda", params_gpu, dev, True),
                           ("cpu", params_cpu, "cpu", True),
                           ("cuda, cache off", params_gpu, dev, False)):
        reqs = shared_prefix_requests(cfg, MULTI["small_requests"])
        me = multi_engine(cfg, p, torch.float32, d, on, False)
        me.serve(reqs, max_new_tokens=MULTI["new_tokens"], validate=True)
        check_multi_served(me, reqs, f"{arch} multi-engine {name}")
        if on and any(e.cache.pages or e.stats.cache_inserts
                      or e.stats.cache_hits for e in me.engines):
            fail(f"{arch} multi-engine {name}: an audio lane was demoted "
                 f"into the cache or hit it")
        runs[name] = (me, {r.rid: list(r.output) for r in reqs})
    (mg, og), (mc, oc) = runs["cuda"], runs["cpu"]
    if og != oc or og != runs["cuda, cache off"][1]:
        fail(f"{arch} multi-engine: tokens differ between cuda and cpu, or "
             f"from the cache-off run")
    for field in mg.alloc._fields:
        if not torch.equal(getattr(mg.alloc, field).cpu(),
                           getattr(mc.alloc, field)):
            fail(f"{arch} multi-engine: shared allocator field {field} "
                 f"differs between cuda and cpu")
    print(f"  {arch} two shards, cache on: cuda and cpu agree on "
          f"{sum(map(len, og.values()))} tokens over "
          f"{mg.stats.decode_steps} engine-steps and {mg.stats.windows} "
          f"windows, shared allocator state bit-identical; no page demoted "
          f"into either cache; tokens equal the cache-off run's")


def policy_device_vs_cpu(dev, arch: str, cfg, params_cpu, params_gpu,
                         want: dict | None, policies=PLAIN_POLICIES,
                         cache: bool = True, stash_size=None) -> None:
    """Phase 5 under each of ``policies``: two shards (with the cache on
    unless ``cache`` is false), stepped window by window on the card and
    on the CPU, one compaction pass after the second window under any
    policy but the free list: the shared allocator state identical after
    every window, the same pages moved, and tokens identical between the
    devices and to ``want`` (the free-list run's; ``None``: the first
    policy's run sets it).  A windowed arch must flush recycled pages on
    the window commits (the single frees staged there are counted on both
    devices and must agree)."""
    alias = cfg.attn_pattern == "full"
    flushes = {}
    for policy in policies:
        runs = {}
        for name, p, d in (("cuda", params_gpu, dev),
                           ("cpu", params_cpu, "cpu")):
            reqs = shared_prefix_requests(cfg, MULTI["small_requests"])
            me = multi_engine(cfg, p, torch.float32, d, cache, alias,
                              policy=policy, stash_size=stash_size)
            me.submit(reqs, max_new_tokens=MULTI["new_tokens"])
            runs[name] = (me, reqs)
            flushes[name] = count_window_flushes(me)
        (mg, rg), (mc, rc) = runs["cuda"], runs["cpu"]
        windows, moved = 0, None
        while mg.has_work or mc.has_work:
            progress = (mg.step_window(validate=True),
                        mc.step_window(validate=True))
            windows += 1
            if progress != (True, True):
                fail(f"{arch} {policy}: window {windows} progressed "
                     f"{progress} (cuda, cpu)")
            if windows == 2 and policy != "freelist":
                moved = (mg.compact(), mc.compact())
                if moved[0] != moved[1]:
                    fail(f"{arch} {policy}: compaction moved {moved[0]} "
                         f"pages on the card, {moved[1]} on the cpu")
                mg.validate()
            for field in mg.alloc._fields:
                if not torch.equal(getattr(mg.alloc, field).cpu(),
                                   getattr(mc.alloc, field)):
                    fail(f"{arch} {policy}: shared allocator field {field} "
                         f"differs between cuda and cpu after window "
                         f"{windows}")
        for me, reqs in runs.values():
            check_multi_served(me, reqs, f"{arch} {policy}")
        og = {r.rid: list(r.output) for r in rg}
        if og != {r.rid: list(r.output) for r in rc}:
            fail(f"{arch} {policy}: tokens differ between cuda and cpu")
        want = og if want is None else want
        if og != want:
            fail(f"{arch} {policy}: tokens differ from the free-list run's")
        if flushes["cuda"] != flushes["cpu"] or (
                cfg.attn_pattern == "swa" and not sum(flushes["cuda"])):
            fail(f"{arch} {policy}: recycled pages flushed on the window "
                 f"commits {flushes['cuda']} (cuda), {flushes['cpu']} (cpu)")
        roll = mg.tenant_rollup()
        cached = sum(e.cache.pages for e in mg.engines if e.cache is not None)
        if any(d["used"] != (cached if name == "kv_pages" else 0)
               for name, d in roll.items()):
            fail(f"{arch} {policy}: tenants in use at the end beyond the "
                 f"caches' {cached} pages: {roll}")
        runs_len = [e.stats.mean_run_len for e in mg.engines]
        compacted = "no compaction" if moved is None else \
            f"compaction after window 2 moved {moved[0]} pages"
        slots = roll.get("state_slots")
        slots = "" if slots is None else (
            f"; state_slots allocs {slots['alloc_count']} frees "
            f"{slots['free_count']} used {slots['used']}")
        flushed = f"; {sum(flushes['cuda'])} recycled pages flushed on " \
            f"the window commits" if cfg.attn_pattern == "swa" else ""
        print(f"  {arch} two shards under {policy}"
              f"{'' if cache else ', no cache'}"
              f"{'' if stash_size is None else f', stash {stash_size}'}: "
              f"cuda and cpu agree on "
              f"{sum(map(len, og.values()))} tokens and the shared "
              f"allocator state (C={mg.alloc.num_classes}) after each of "
              f"{windows} windows; {compacted}; tokens equal the free-list "
              f"run's; mean run length "
              f"{', '.join(f'{x:.2f}' for x in runs_len)}{slots}{flushed}")


def count_window_flushes(me) -> list:
    """Wrap the deployment's window flush: before each, the recycled pages
    its shards' pending steps stage as single frees land in the returned
    list (one host read a window)."""
    counts: list = []
    inner = me._flush_window

    def flush(released, evicted):
        pend = [p.flush_mask for e in me.engines for p in e.pending_ops]
        counts.append(int(torch.stack(pend).sum()) if pend else 0)
        return inner(released, evicted)
    me._flush_window = flush
    return counts


# --------------------------------------------------------------------------
# phase 6: training
# AdamW's learning rate in phase 6 (the JAX Trainer's)
TRAIN_LR = 1e-3
# 6a: the reduced configs of phase 5 (gemma3 at 128 tokens, past its
# window of 64), two steps: one plain, one with grad_accum=2 and
# compression on
TRAIN_SMALL = dict(batch=4, seq=64, window_seq=128)
# 6b: gemma3-1b at its published widths, bf16, remat on, one batch of
# 8 x 1024 tokens (the window of 512 binds on the local layers) trained 8
# times
TRAIN_FULL = dict(arch="gemma3-1b", batch=8, seq=1024, steps=8)
# 6c: gemma3-1b's widths at 2 layers (one local, one global) and a
# vocabulary cut to 16384: 72.6 M parameters, a 0.73 GB checkpoint; 8
# steps of 4 x 256 tokens, a checkpoint every 4, a preemption at step 6.
# Its final loss within TRAIN_PREEMPT["tol"] of an uninterrupted run's
# (bf16; the embedding's backward accumulates with atomics on the card,
# so the two runs round alike only up to the order of those sums)
TRAIN_PREEMPT = dict(layers=2, vocab=16384, batch=4, seq=256, steps=8,
                     every=4, fail_at=6, tol=1e-2)
TRAIN_DIR = ROOT / "build" / "train_checkpoints"


def train_config(arch: str):
    """Phase 5's reduced config of ``arch`` (:func:`reduced_config`)."""
    return reduced_config(arch)


def reduced_config(arch: str):
    """``arch``'s smoke config cut as ``SMALL_DEPTH`` says; a
    ``local_global`` one that the cut left with no global layer (gemma3-1b's
    two of period 6) takes one local layer to one global."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.attention import FULL_WINDOW
    from repro_torch.models.transformer import layer_windows
    cfg = dataclasses.replace(smoke_config(arch), **SMALL_DEPTH.get(arch, {}))
    if cfg.attn_pattern == "local_global" \
            and FULL_WINDOW not in layer_windows(cfg):
        cfg = dataclasses.replace(cfg, local_per_global=1)
    return cfg


def train_device_vs_cpu(dev, arch: str) -> dict:
    """6a: two train steps of ``arch`` at phase 5's reduced config in f32
    (TF32 off) on the card and on the CPU from the same weights and batch:
    one plain, one with ``grad_accum=2`` and compression.  Loss within
    1e-5 and gradient norm within 1e-4 relative at each step; after the
    first, every gradient elementwise through the first moment (``m =
    (1 - b1) g``) within 1e-4 of its leaf's max |m|; after both, each
    parameter within 4 x lr (a near-zero gradient may flip the sign of an
    update in each step, and a compressed value near a rounding boundary
    may round the other way); no flash launch in a train step."""
    from repro_torch.data import TokenSource
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config(arch)
    seq = TRAIN_SMALL["window_seq"] if cfg.window else TRAIN_SMALL["seq"]
    batch = TokenSource(cfg, seed=0).batch(0, 0, TRAIN_SMALL["batch"], seq)
    opt = AdamW(lr=TRAIN_LR)
    steps = (make_train_step(cfg, opt),
             make_train_step(cfg, opt, grad_accum=2,
                             compression=CompressionConfig(enabled=True)))
    params_cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to(dev)
    runs = {}
    for name, params, d in (("cuda", params_gpu, dev),
                            ("cpu", params_cpu, "cpu")):
        params.requires_grad_(True)
        state = opt.init(params)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        before = FLASH_KERNEL.launches
        metrics, first = [], None
        for fn in steps:
            _, state, m = fn(params, state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if first is None:
                first = {n: t.cpu().clone() for n, t in state.m.items()}
        if FLASH_KERNEL.launches != before:
            fail(f"6a {arch}: a train step launched the flash kernel "
                 f"({FLASH_KERNEL.launches - before} times)")
        runs[name] = (params, first, metrics)
    (pg, fg, mg), (pc, fc, mc) = runs["cuda"], runs["cpu"]
    for i, ((lg, ng), (lc, nc)) in enumerate(zip(mg, mc)):
        if not (np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc)
                and abs(ng - nc) <= 1e-4 * nc):
            fail(f"6a {arch} step {i + 1}: loss {lg} / {lc}, grad_norm "
                 f"{ng} / {nc} (cuda / cpu)")
    m_err = max(float((fg[n] - fc[n]).abs().max())
                / max(float(fc[n].abs().max()), 1e-30) for n in fc)
    p_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(pg.parameters(), pc.parameters()))
    if m_err > 1e-4 or p_err > 4 * TRAIN_LR:
        fail(f"6a {arch}: gradients of step 1 {m_err:.3e} of their max "
             f"apart, parameters {p_err:.3e} apart (cuda / cpu)")
    print(f"  {arch} ({cfg.num_layers} layers, {seq} tokens x "
          f"{TRAIN_SMALL['batch']}): cuda and cpu agree over 2 steps (the "
          f"second grad_accum=2 + compression): loss "
          f"{mg[0][0]:.6f} -> {mg[1][0]:.6f} (cpu {mc[1][0]:.6f}), "
          f"grad_norm {mg[1][1]:.6f} (cpu {mc[1][1]:.6f}), step 1's "
          f"gradients within {m_err:.2e} of their max, parameters within "
          f"{p_err:.3e}; 0 flash launches")
    return dict(losses=[m[0] for m in mg], cpu_losses=[m[0] for m in mc],
                grad_rel_err=m_err, max_param_diff=p_err)


def check_flash_refuses_grad(dev) -> None:
    """6a: the forward-only flash op raises on an input that requires a
    gradient (grad mode on), on the card."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    q, k, v = (torch.randn(1, 64, 2, 64, device=dev) for _ in range(3))
    q.requires_grad_(True)
    try:
        flash_attention_op(q, k, v)
    except RuntimeError as e:
        if "forward-only" not in str(e):
            raise
        print("  the flash op raises on an input that requires a gradient")
        return
    fail("the flash op took an input that requires a gradient")


def cuda_ms(fn, n: int = 3) -> float:
    """Median of ``n`` CUDA-event times of ``fn`` after one warm call (for
    calls of milliseconds, where the host's launch overhead hides under
    the device work)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def train_parts(dev, cfg, params, state, opt, batch) -> dict:
    """6b's step split: forward + backward (``loss_fn`` with remat) and the
    AdamW update at full width; then the cross entropy alone on the
    step's logits shape and ``mea_attention`` alone at one layer's
    shapes, each forward + backward, beside the library call that computes
    the same function (``F.cross_entropy``; SDPA, with a boolean band mask
    for the window), timed here only: the baselines of a fused
    cross-entropy kernel and a flash backward kernel (ROADMAP)."""
    import torch.nn.functional as F
    from repro_torch.models import loss_fn
    from repro_torch.models.attention import mea_attention
    from repro_torch.models.losses import softmax_cross_entropy
    named = list(params.named_parameters())

    def fwd_bwd():
        for _, p in named:
            p.grad = None
        loss_fn(params, cfg, batch)[0].backward()
    out = {"forward_backward_ms": cuda_ms(fwd_bwd)}
    grads = {n: p.grad for n, p in named}
    out["adamw_update_ms"] = cuda_ms(lambda: opt.update(grads, state,
                                                        params))
    for _, p in named:
        p.grad = None
    del grads
    B, S, V = TRAIN_FULL["batch"], TRAIN_FULL["seq"], cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn((B, S, V), device=dev, dtype=torch.bfloat16,
                         generator=gen).requires_grad_(True)
    labels = batch["labels"]

    def ce():
        logits.grad = None
        softmax_cross_entropy(logits, labels).sum().backward()

    def ce_lib():
        logits.grad = None
        F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1).long(),
                        reduction="sum").backward()
    out["cross_entropy_ms"] = cuda_ms(ce)
    out["cross_entropy_library_ms"] = cuda_ms(ce_lib)
    # bytes the pair must move: the logits read (twice: forward, backward)
    # and their gradient written
    out["cross_entropy_bound_ms"] = 3 * logits.numel() * 2 \
        / HBM_BYTES_PER_S * 1e3
    del logits
    torch.cuda.empty_cache()
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn((B, S, H, hd), device=dev, dtype=torch.bfloat16,
                    generator=gen).requires_grad_(True)
    k, v = (torch.randn((B, S, KV, hd), device=dev, dtype=torch.bfloat16,
                        generator=gen).requires_grad_(True)
            for _ in range(2))
    qpos = torch.arange(S, device=dev)
    for name, window in (("local", cfg.window), ("global", None)):
        def plain():
            mea_attention(q, k, v, causal=True, window=window).float().sum(
            ).backward()
        mask = qpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= qpos[None, :] > qpos[:, None] - window

        def lib():
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(
                    H // KV, 1), v.transpose(1, 2).repeat_interleave(
                    H // KV, 1), attn_mask=mask).float().sum().backward()
        def forward():
            with torch.no_grad():
                mea_attention(q, k, v, causal=True, window=window)
        out[f"attention_{name}_ms"] = cuda_ms(plain)
        out[f"attention_{name}_forward_ms"] = cuda_ms(forward)
        out[f"attention_{name}_library_ms"] = cuda_ms(lib)
        # forward (QK^T, PV over the keys a query sees) and backward (2x)
        keys = sum(min(i + 1, window or S) for i in range(S))
        out[f"attention_{name}_bound_ms"] = 3 * 4 * B * H * keys * hd \
            / TENSOR_BF16_OPS_PER_S * 1e3
    return out


def train_full_width(dev) -> dict:
    """6b: gemma3-1b at its published widths in bf16, remat on, one batch
    of 8 x 1024 tokens from ``DataPipeline`` trained 8 times through
    ``make_train_step``: every loss finite, the last below the first;
    step times end when the loss is read back.  Then the step's parts."""
    from repro_torch.data import DataPipeline, TokenSource
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step
    arch, B, S = TRAIN_FULL["arch"], TRAIN_FULL["batch"], TRAIN_FULL["seq"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = full_width_params(dev, arch)
    params.requires_grad_(True)
    n_params = sum(p.numel() for p in params.parameters())
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    pipe = DataPipeline(TokenSource(cfg, seed=0), global_batch=B, seq_len=S)
    host = next(pipe)
    pipe.close()
    if host.pop("_step") != 0:
        fail("6b: the pipeline's first batch is not step 0")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    step = make_train_step(cfg, opt, remat=True)
    zero_launches()
    losses, norms, times = [], [], []
    for _ in range(TRAIN_FULL["steps"]):
        t0 = time.perf_counter()
        _, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
    launches = read_launches()
    check_launches(f"6b {arch} train", launches,
                   dict.fromkeys(launches, 0), off_path=tuple(launches))
    peak = torch.cuda.max_memory_allocated()
    state_gb = (sum(p.numel() * p.element_size() * 2 for p in
                    params.parameters()) + 8 * n_params) / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"6b {arch}: losses {losses} (finite, the last below the "
             f"first, expected)")
    med = statistics.median(times)
    card = card_line()
    print(f"  {arch} train, bf16, remat, {B} x {S} tokens: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.4f}' for x in norms)}")
    print(f"  median step {med:.2f} ms ({', '.join(f'{t:.1f}' for t in times)}"
          f"), {B * S / med * 1e3:.1f} tokens/s; peak {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} above the process's "
          f"{base / 2**30:.2f}), {n_params / 1e9:.4f} B parameters, state "
          f"{state_gb:.2f} GB; {card}")
    parts = train_parts(dev, cfg, params, state, opt, batch)
    # each layer's attention: forward + backward, and the remat forward
    from repro_torch.models.transformer import layer_windows
    kinds = ["global" if w >= FULL else "local" for w in layer_windows(cfg)]
    parts["attention_in_step_ms"] = sum(
        parts[f"attention_{k}_ms"] + parts[f"attention_{k}_forward_ms"]
        for k in kinds)
    print("  parts: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    print(f"  the plain attention takes about "
          f"{parts['attention_in_step_ms']:.1f} ms of the {med:.2f} ms step "
          f"({kinds.count('local')} local and {kinds.count('global')} global "
          f"layers, each forward + backward and the remat forward)")
    del params, state, batch
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=norms, step_ms=times,
                median_step_ms=med, tokens_per_s=B * S / med * 1e3,
                peak_gib=peak / 2**30, parameters=n_params,
                state_gb=state_gb, parts=parts, card=card,
                launches=launches)


def _files(step_dir: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())}


def train_preempted(dev) -> dict:
    """6c: the port's ``Trainer`` on the card, bf16, at
    ``TRAIN_PREEMPT``'s reduced gemma3-1b: preempted at step 6, it must
    restart once from step 4 and end within the tolerance of an
    uninterrupted run; the last checkpoint, restored onto the card and
    saved again, gives the same files, and its bf16 leaves come back bit
    for bit."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import (_flatten,
                                                    restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           make_preemption_injector,
                                           train_state_tree)
    tp = TRAIN_PREEMPT
    cfg = dataclasses.replace(get_config("gemma3-1b"),
                              num_layers=tp["layers"], local_per_global=1,
                              vocab_size=tp["vocab"])
    cut = dict(num_layers=[26, tp["layers"]], vocab_size=[262144, tp["vocab"]])
    print(f"  reduced: {json.dumps(cut)}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def tcfg(name):
        return TrainerConfig(total_steps=tp["steps"],
                             checkpoint_every=tp["every"],
                             checkpoint_dir=str(TRAIN_DIR / name),
                             batch_size=tp["batch"], seq_len=tp["seq"],
                             log_every=100)
    zero_launches()
    t0 = time.perf_counter()
    rep = Trainer(cfg, tcfg("preempted"), dtype=torch.bfloat16,
                  fail_injector=make_preemption_injector(tp["fail_at"]),
                  device=dev).run()
    t_pre = time.perf_counter() - t0
    rep2 = Trainer(cfg, tcfg("uninterrupted"), dtype=torch.bfloat16,
                   device=dev).run()
    launches = read_launches()
    check_launches("6c trainer", launches, dict.fromkeys(launches, 0),
                   off_path=tuple(launches))
    if rep.restarts != 1 or rep.restored_from != tp["every"]:
        fail(f"6c: restarts {rep.restarts}, restored from "
             f"{rep.restored_from} (1 and {tp['every']} expected)")
    diff = abs(rep.final_loss - rep2.final_loss)
    if not np.isfinite(rep.final_loss) or diff > tp["tol"]:
        fail(f"6c: final loss {rep.final_loss} after the preemption, "
             f"{rep2.final_loss} without (tolerance {tp['tol']})")
    last = TRAIN_DIR / "preempted" / f"step_{tp['steps']:08d}"
    ckpt_gb = sum(len(b) for b in _files(last).values()) / 1e9
    if ckpt_gb >= 1.0:
        fail(f"6c: the checkpoint holds {ckpt_gb:.2f} GB (under 1 expected)")
    tr = Trainer(cfg, tcfg("preempted"), dtype=torch.bfloat16, device=dev)
    params, state, step = tr.restore_or_init()
    tree = train_state_tree(params, state)
    save_checkpoint(TRAIN_DIR / "again", tree, step)
    if _files(TRAIN_DIR / "again" / last.name) != _files(last):
        fail("6c: the checkpoint restored onto the card and saved again "
             "differs from the one written")
    back, _ = restore_checkpoint(TRAIN_DIR / "again",
                                 train_state_tree(params, state, "meta"))
    n_bf16 = 0
    for key, leaf in _flatten(back).items():
        want = _flatten(tree)[key]
        if leaf.dtype != want.dtype or not torch.equal(
                leaf.view(torch.int16) if leaf.dtype == torch.bfloat16
                else leaf, want.view(torch.int16)
                if want.dtype == torch.bfloat16 else want):
            fail(f"6c: leaf {key} did not round-trip bit for bit")
        n_bf16 += leaf.dtype == torch.bfloat16
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"  trainer: restarts {rep.restarts}, restored from "
          f"{rep.restored_from}, final loss {rep.final_loss:.6f} "
          f"(uninterrupted {rep2.final_loss:.6f}, difference {diff:.2e}), "
          f"{rep.steps_run} steps in {t_pre:.1f}s, median step "
          f"{statistics.median(rep.step_times_ms):.2f} ms, stragglers "
          f"{rep.straggler_steps}; checkpoint {ckpt_gb:.3f} GB; step {step} "
          f"restored onto the card and saved again: the same files, "
          f"{n_bf16} bf16 leaves bit for bit")
    return dict(restarts=rep.restarts, restored_from=rep.restored_from,
                final_loss=rep.final_loss,
                uninterrupted_final_loss=rep2.final_loss,
                loss_difference=diff, checkpoint_gb=ckpt_gb,
                losses=rep.losses, uninterrupted_losses=rep2.losses,
                median_step_ms=statistics.median(rep.step_times_ms),
                launches=launches)


# --------------------------------------------------------------------------
# phase 7, the allocator simulator: its trace kernel against the plain loop
# --------------------------------------------------------------------------

SIM = dict(threads=16, events=4096, saturate=(1 << 24) + 8, global_threads=4096,
           timed=("tcmalloc", "speedmalloc", "mallacc", "speedmalloc-stash"))


def sim_bound_ms(E: int) -> tuple[float, str]:
    """Least time for one trace: the four int32 event rows read once and
    the 9-word result written once over HBM bandwidth, against ~25
    operations an event (the tier logic, three state writes, the byte
    sums, seven counter adds) over the CUDA cores' rate; the larger one."""
    bytes_ms = 4 * (4 * E + 9) / HBM_BYTES_PER_S * 1e3
    ops_ms = 25 * E / CUDA_CORE_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def sim_counts_equal(got, want) -> bool:
    """Every field of two ``SimCounts`` equal bit for bit."""
    a = torch.stack(list(got)).cpu().view(torch.int32)
    b = torch.stack(list(want)).cpu().view(torch.int32)
    return torch.equal(a, b)


def sim_phase(dev, floor_ms: float, trace_path: Path) -> dict:
    """Phase 7: the ``sim_trace`` kernel against its plain version, all
    nine counts bit for bit, for every policy of ``ALL_POLICIES`` on every
    paper workload at its own thread count and at 16 (324 traces of 4096
    events), on the empty trace and, on the global-memory path, at 4096
    threads; the float32 counters' saturation past 2**24 events (kernel
    alone); then the main path -- ``calibration_table(16)`` and the
    recorded open-loop trace through ``replay_sim_policies`` for all nine
    policies -- on the card, each equal to the same call on the CPU, with
    the kernel's launches counted over it."""
    from repro_torch.kernels.sim_trace.ops import KERNEL, card_path, sim_trace
    from repro_torch.kernels.sim_trace.ref import run_trace_plain
    from repro_torch.loadgen import load_trace, replay_sim_policies
    from repro_torch.sim import engine
    from repro_torch.sim.costmodel import calibration_table
    from repro_torch.sim.policies import ALL_POLICIES
    from repro_torch.sim.workloads import (MULTI_THREADED, SIZE_CLASS_BYTES,
                                           SINGLE_THREADED, make_trace)
    sizes = [int(s) for s in SIZE_CLASS_BYTES]
    sizes_dev = torch.tensor(sizes, dtype=torch.int32, device=dev)

    def check(ev, T, what):
        ev_dev = torch.from_numpy(ev).to(dev)
        for name, pol in ALL_POLICIES.items():
            got = sim_trace(ev_dev, T, pol, sizes_dev)
            want = run_trace_plain(ev, T, pol, sizes)
            if not sim_counts_equal(got, want):
                fail(f"7: sim_trace {what} T={T} under {name}: "
                     f"{[float(x) for x in got]} != plain "
                     f"{[float(x) for x in want]}")
        return len(ALL_POLICIES)

    t0 = time.perf_counter()
    traces = 0
    for spec in (*MULTI_THREADED.values(), *SINGLE_THREADED.values()):
        for T in (spec.threads, SIM["threads"]):
            ev = engine._events(make_trace(spec, SIM["events"], T), T)
            traces += check(ev, T, spec.name)
    paper = traces
    traces += check(np.zeros((4, 0), np.int32), SIM["threads"], "empty trace")
    Tg = SIM["global_threads"]
    if card_path(Tg, len(sizes)) != "global" or \
            card_path(SIM["threads"], len(sizes)) != "shared":
        fail("7: sim_trace's state paths are not shared at T=16 and global "
             f"at T={Tg}")
    ev = engine._events(make_trace(MULTI_THREADED["larson"], SIM["events"],
                                   Tg), Tg)
    traces += check(ev, Tg, "larson (global path)")
    print(f"  sim_trace == plain, all nine counts bit for bit: {traces} "
          f"traces ({paper} of 4096 events at the workloads' own threads "
          f"and 16, shared-memory state; the empty trace and larson at "
          f"T={Tg} on the global path under each policy) in "
          f"{time.perf_counter() - t0:.1f}s")

    n = SIM["saturate"]
    sat = torch.zeros((4, n), dtype=torch.int32, device=dev)
    sat[1] = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt = engine.host_counts(sim_trace(sat, 1, ALL_POLICIES["speedmalloc"],
                                       sizes_dev))
    sat_s = time.perf_counter() - t0
    if float(cnt.mallocs) != min(n, 1 << 24) or float(cnt.frees) != 0.0 \
            or float(cnt.peak_bytes) != float(np.float32(n * sizes[0])):
        fail(f"7: {n} mallocs under speedmalloc read {cnt}, expected "
             f"mallocs == {min(n, 1 << 24)} (float32 saturation at 2**24)")
    print(f"  {n} mallocs on thread 0, class 0, under speedmalloc: mallocs "
          f"== {float(cnt.mallocs):.1f} (float32 saturation), peak bytes "
          f"{float(cnt.peak_bytes):.0f}; {sat_s:.3f}s on the card, "
          f"{sat_s / n * 1e9:.1f} ns an event")
    del sat

    timed = {}
    ev = engine._events(make_trace(MULTI_THREADED["larson"], SIM["events"],
                                   SIM["threads"]), SIM["threads"])
    ev_dev = torch.from_numpy(ev).to(dev)
    bound_ms, bound_by = sim_bound_ms(ev.shape[1])
    for name in SIM["timed"]:
        pol = ALL_POLICIES[name]
        ms = device_ms(lambda: sim_trace(ev_dev, SIM["threads"], pol,
                                         sizes_dev), n=50)
        t0 = time.perf_counter()
        for _ in range(5):
            run_trace_plain(ev, SIM["threads"], pol, sizes)
        plain_ms = (time.perf_counter() - t0) / 5 * 1e3
        timed[name] = dict(E=ev.shape[1], T=SIM["threads"], ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by,
                           ns_per_event=ms * 1e6 / ev.shape[1])
        print(f"  time sim_trace larson T={SIM['threads']} E={ev.shape[1]} "
              f"under {name}: kernel {ms * 1e3:.2f} us/trace "
              f"({ms * 1e6 / ev.shape[1]:.1f} ns an event; launch floor "
              f"{floor_ms * 1e3:.2f} us), plain loop on the host "
              f"{plain_ms:.2f} ms, bound {bound_ms * 1e3:.4f} us "
              f"({bound_by})")

    walls = {}
    tables = {}
    for where in ("cpu", "cuda"):
        engine._cached_counts.cache_clear()
        KERNEL.launches = 0
        t0 = time.perf_counter()
        tables[where] = calibration_table(SIM["threads"], device=where)
        walls[where] = time.perf_counter() - t0
        if where == "cuda":
            calib_launches = KERNEL.launches
    if tables["cuda"] != tables["cpu"]:
        fail("7: calibration_table(16) differs between the card and the cpu")
    trace = load_trace(trace_path)
    names = list(ALL_POLICIES)
    t0 = time.perf_counter()
    KERNEL.launches = 0
    swept = replay_sim_policies(trace, names, device=dev)
    sweep_launches = KERNEL.launches
    sweep_s = time.perf_counter() - t0
    if swept != replay_sim_policies(trace, names, device="cpu"):
        fail("7: replay_sim_policies of the recorded trace differs between "
             "the card and the cpu")
    launches = calib_launches + sweep_launches
    want = 7 * len(MULTI_THREADED) + len(names)
    if launches != want:
        fail(f"7: sim_trace launches on the main path {launches} != "
             f"{want} traces run on the card")
    geo = tables["cuda"]["geomean"]
    print(f"  calibration_table(16): card {walls['cuda']:.3f}s, cpu "
          f"{walls['cpu']:.3f}s, equal; geomean speedups over jemalloc "
          + ", ".join(f"{k} {v:.4f}" for k, v in geo.items()))
    print(f"  replay_sim_policies of {trace_path.name} ({trace.bursts} "
          f"bursts), nine policies: card == cpu, {sweep_s * 1e3:.1f} ms on "
          f"the card; sim_trace launches on the main path {launches} "
          f"(= {calib_launches} calibration traces + {sweep_launches})")
    print(card_line())
    head = timed["tcmalloc"]
    return dict(launches=launches, parity_traces=traces, max_abs_err=0.0,
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "ns_per_event")},
                other_policies={k: v for k, v in timed.items()
                                if k != "tcmalloc"},
                saturation=dict(events=n, mallocs=float(cnt.mallocs),
                                seconds=sat_s),
                calibration_wall_s=walls, calibration_geomean=geo,
                replay_sweep=dict(policies=len(names), wall_s=sweep_s,
                                  launches=sweep_launches))


def kernel_signature(name: str) -> str:
    """A demangled kernel name without its return type, namespaces and
    parameter list: ``flash_mma_kernel<(int)256>``."""
    name = name.replace("<unnamed>::", "").replace("(anonymous namespace)::",
                                                   "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    head, sep, tail = name.removeprefix("void ").partition("<")
    return head.split("::")[-1] + sep + tail


NO_SPILL = ("flash_mma_kernel", "flash_attention_kernel",
            "support_core_burst_kernel")


def print_ptxas(kernels) -> None:
    """Each kernel entry's registers, static shared memory and spills as
    ``-Xptxas -v`` printed them (demangled by the toolkit's ``cu++filt``
    when it has one); fails when the support-core kernel or either flash
    kernel spills."""
    from repro_torch.kernels._build import _nvcc, ptxas_report
    filt = Path(_nvcc()).parent / "cu++filt"
    spills = []
    for k in kernels:
        rows = ptxas_report(k.build_log)
        if not rows:
            fail(f"{k.name}: no -Xptxas -v output in its build log")
        names = [r["name"] for r in rows]
        if filt.exists():
            res = subprocess.run([str(filt)], input="\n".join(names),
                                 capture_output=True, text=True)
            if res.returncode == 0 and len(res.stdout.splitlines()) == len(rows):
                names = res.stdout.splitlines()
        for r, name in zip(rows, names):
            short = kernel_signature(name)
            print(f"  ptxas {k.name}: {short}: {r['registers']} registers, "
                  f"{r['smem']} bytes static smem, {r['spill_stores']} / "
                  f"{r['spill_loads']} bytes spill stores / loads")
            if any(n in r["name"] for n in NO_SPILL) and (
                    r["spill_stores"] or r["spill_loads"]):
                spills.append(short)
    if spills:
        fail(f"kernels that must not spill do: {', '.join(spills)}")


# --------------------------------------------------------------------------
# phase 8: the multi-device half on one card
# --------------------------------------------------------------------------

#: phase 8c's production-mesh cells: (arch, shape, the dry run's --mesh)
MESH_CELLS = (("qwen2-72b", "train_4k", "pod"),
              ("mixtral-8x7b", "prefill_32k", "pod"),
              ("phi3.5-moe-42b-a6.6b", "decode_32k", "multipod"),
              ("deepseek-7b", "decode_32k", "pod"))
SHARD_LIMIT = 1 << 30          # no parameter shard above 1 GiB
MESH_CELL_TIMEOUT_S = 900   # from phase 8c's start; they began at phase 3


def local_bytes(params, state) -> int:
    """Bytes the LM's parameters and a serving state hold on this rank
    (a ``DTensor``'s local shard)."""
    from repro_torch.distributed import sharding as sh
    tensors = list(params.parameters()) + [t for _, t in sh._leaves(state)]
    return sum((t.to_local() if sh.is_dtensor(t) else t).numel()
               * t.element_size() for t in tensors)


def sharded_serve(dev, reference: list) -> dict:
    """8a: phase 4's deepseek-7b serve on a one-rank NCCL mesh, the
    parameters placed by ``distribute_params`` and the engine's steps
    built with ``ShardingHints(mesh)``; tokens, launches and I1-I6 as
    phase 4's."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.hints import ShardingHints
    from repro_torch.launch.mesh import make_host_smoke_mesh, process_group
    arch, wl = "deepseek-7b", WORKLOADS["deepseek-7b"]
    with process_group("nccl", 1):
        mesh = make_host_smoke_mesh()
        print(f"  mesh: {mesh}")
        cfg, params = full_width_params(dev, arch)
        sh.distribute_params(cfg, mesh, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        eng, sched, reqs, steps, step_us = serve(
            cfg, params, torch.bfloat16, dev, wl, wl["prompt_lens"],
            hints=ShardingHints(mesh))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check_served(eng, sched, reqs)
        tokens = [list(r.output) for r in reqs]
        if tokens != reference:
            fail("8a: the sharded serve's tokens differ from phase 4's")
        s, L = eng.stats, cfg.num_attn_layers
        check_launches("8a", launches, dict(
            support_core_burst=s.commits,
            paged_decode_attention=s.decode_steps * L,
            flash_attention=s.prefill_passes * L))
        args = local_bytes(params, eng.state)
        peak = torch.cuda.max_memory_allocated()
        kvcfg = eng.kvcfg
        print(f"  served {len(reqs)} requests in {steps} decode steps, "
              f"{wall:.2f}s wall (median step "
              f"{statistics.median(step_us) / 1e3:.2f} ms); tokens == phase "
              f"4's; launches: support core "
              f"{launches['support_core_burst']} == {s.commits} commits, "
              f"paged {launches['paged_decode_attention']} == "
              f"{s.decode_steps} steps x {L}, flash "
              f"{launches['flash_attention']} == {s.prefill_passes} passes "
              f"x {L}; I1-I6 hold")
        del eng, params
        torch.cuda.empty_cache()
    return dict(launches=launches, argument_bytes=args,
                peak_above_args=peak - args, decode_steps=s.decode_steps,
                prefill_passes=s.prefill_passes, commits=s.commits,
                median_step_ms=statistics.median(step_us) / 1e3,
                wall_s=wall, kvcfg=kvcfg, cfg=cfg)


def serve_shape_dry_run(cfg, kvcfg, card: dict) -> dict:
    """8b: the dry run of 8a's configuration and decode shapes on a fake
    one-rank mesh: its argument bytes are the card's, to the byte."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.hints import ShardingHints
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_host_smoke_mesh, process_group
    from repro_torch.launch.roofline import step_model_flops
    from repro_torch.models import abstract_params
    from repro_torch.serve.serve_step import (abstract_serve_state,
                                              make_decode_step)
    lanes, prefilled = kvcfg.max_lanes, WORKLOADS["deepseek-7b"]["seq"] // 2
    with process_group("fake", 1):
        mesh = make_host_smoke_mesh()
        params = sh.distribute_params(cfg, mesh,
                                      abstract_params(cfg, kvcfg.dtype))
        state, tenants = abstract_serve_state(cfg, kvcfg, lanes, prefilled)
        state = sh.distribute_state(cfg, mesh, state)
        step = make_decode_step(cfg, kvcfg, tenants,
                                hints=ShardingHints(mesh))
        rec = count_step(step, (params, state))
    mem = rec["memory"]
    if mem["argument_bytes"] != card["argument_bytes"]:
        fail(f"8b: the dry run's argument bytes {mem['argument_bytes']} != "
             f"{card['argument_bytes']} that 8a's parameters and state hold "
             f"on the card")
    mf = step_model_flops(cfg, "decode", lanes, prefilled)
    print(f"  dry run of one decode step ({lanes} lanes, {prefilled} cached "
          f"tokens, pool {kvcfg.num_pages + 1} pages of {kvcfg.page_size}): "
          f"argument bytes {mem['argument_bytes']} == the card's; temp peak "
          f"{mem['temp_peak_bytes']} bytes (the plain route's) beside the "
          f"card's max_memory_allocated above the arguments "
          f"{card['peak_above_args']} bytes over the whole serve (the "
          f"kernels' route, prefill included); {rec['flops']:.4e} FLOPs "
          f"counted beside model_flops {mf:.4e}; collectives "
          f"{json.dumps(rec['collective_bytes'])}")
    return dict(argument_bytes=mem["argument_bytes"],
                temp_peak_bytes=mem["temp_peak_bytes"],
                card_peak_above_args=card["peak_above_args"],
                flops=rec["flops"], model_flops=mf,
                bytes_accessed=rec["bytes_accessed"])


def start_mesh_cells() -> list:
    """8c's production-mesh dry runs, one process each (one CPU thread),
    all started together; they run on the host's CPUs while the card
    serves phases 3-7, and :func:`mesh_cells` collects them."""
    procs = []
    for arch, shape, mesh in MESH_CELLS:
        code = ("import sys; sys.path.insert(0, 'src'); import torch; "
                "torch.set_num_threads(1); "
                "from repro_torch.launch.dryrun import main; "
                f"main(['--arch', {arch!r}, '--shape', {shape!r}, "
                f"'--mesh', {mesh!r}, '--force'])")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def mesh_cells(procs: list, card: str) -> list:
    """8c: each production-mesh cell must be ``ok`` with no parameter
    shard above 1 GiB; prints its roofline row."""
    from repro_torch.launch.roofline import roofline_row
    rows, deadline = [], time.perf_counter() + MESH_CELL_TIMEOUT_S
    try:
        for (arch, shape, mesh), p in zip(MESH_CELLS, procs):
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            lines = [ln for ln in out.splitlines() if ln.startswith("[")]
            print("\n".join(f"  {ln[:400]}" for ln in lines))
            name = "pod2x16x16" if mesh == "multipod" else "pod16x16"
            row = roofline_row(arch, shape, name)
            if p.returncode or row["status"] != "ok":
                fail(f"8c: {arch} x {shape} x {name}: {row['status']} "
                     f"(exit {p.returncode}): {row.get('reason', '')}")
            if row["param_shard_max_bytes"] > SHARD_LIMIT:
                fail(f"8c: {arch} x {shape}: a parameter shard of "
                     f"{row['param_shard_max_bytes']} bytes > 1 GiB")
            rows.append(row)
            print(f"  roofline {arch} x {shape} x {name}: compute "
                  f"{row['compute_s']:.4f} s, memory {row['memory_s']:.4f} "
                  f"s, collective {row['collective_s']:.4f} s -> "
                  f"{row['dominant']}; {row['hbm_gb_per_dev']:.2f} GB a "
                  f"device (fits 80 GB: {row['fits_80gb']}); largest "
                  f"parameter shard {row['param_shard_max_bytes']} bytes; "
                  f"dry run {row['dryrun_s']:.1f}s (dry-run counts and "
                  f"datasheet peaks of an H100 SXM, not times; this card: "
                  f"{card})")
    finally:
        stop(procs)
    return rows


EXAMPLES = ROOT / "examples"
EXAMPLES_BUDGET_S = 60.0
TRAIN_LM_STEPS = 60


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module, to call its ``main``."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def all_launches() -> dict:
    from repro_torch.kernels.sim_trace.ops import KERNEL as SIM_KERNEL
    return dict(read_launches(), sim_trace=SIM_KERNEL.launches)


def zero_all_launches() -> None:
    from repro_torch.kernels.sim_trace.ops import KERNEL as SIM_KERNEL
    zero_launches()
    SIM_KERNEL.launches = 0


def quickstart_want(q: dict) -> dict:
    """The quickstart's launches as its services and engines count them:
    a free-list commit or replayed burst is one support-core launch (the
    bitmap and buddy policies run plain), an engine-step one paged launch
    a KV layer, a prefill pass one flash launch a KV layer, a sim replay
    one trace-kernel launch a policy."""
    me = q["multi"]
    if me.service.policy.name != "freelist" or \
            q["replay"].bursts != q["trace"].bursts:
        fail("9: the quickstart's open loop ran another policy than the "
             "free list, or its replay skipped bursts")
    if sum(e.stats.decode_steps for e in me.engines) != \
            me.stats.decode_steps:
        fail("9: the quickstart's shards' steps do not sum to the open "
             "loop's engine-steps")
    want = dict(support_core_burst=q["part1"]["freelist_commits"]
                + q["replay"].bursts + me.stats.window_bursts,
                paged_decode_attention=0, flash_attention=0,
                sim_trace=len(q["sims"]))
    for eng in (*q["engines"].values(), *me.engines):
        s, L = eng.stats, eng.cfg.num_attn_layers
        if eng.service.policy.name == "freelist":
            want["support_core_burst"] += s.commits
        want["paged_decode_attention"] += s.decode_steps * L
        want["flash_attention"] += s.prefill_passes * L
    return want


def examples_phase(dev) -> dict:
    """Phase 9: the four examples through their ``main`` on the card;
    returns each one's launches (set to 0 just before it) and its
    numbers."""
    t0 = time.perf_counter()
    out = {}

    qs = load_example("quickstart")
    zero_all_launches()
    t = time.perf_counter()
    q = qs.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = all_launches()
    want = quickstart_want(q)
    if launches != want:
        fail(f"9: the quickstart's launches {launches}, expected {want} from "
             f"its services' and engines' counters")
    for name, n in launches.items():
        if n <= 0:
            fail(f"9: the quickstart launched no {name}")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_part1 = qs.part1_client_api(torch.device("cpu"))
    if cpu_part1 != q["part1"]:
        fail(f"9: part 1 on the card {q['part1']} != on the cpu {cpu_part1}")
    rep, res = q["report"], q["replay"]
    out["quickstart"] = dict(
        launches=launches, wall_s=wall, losses=q["losses"],
        p50_ttft_us=rep.p50_ttft_us, p99_ttft_us=rep.p99_ttft_us,
        completed=rep.completed, windows=rep.windows,
        trace_bursts=q["trace"].bursts, replay_wall_s=res.wall_s,
        replay_bursts=res.bursts, compaction_moves=q["compaction_moves"])
    print(f"  quickstart: {wall:.2f}s; part 1 grants card == cpu "
          f"{cpu_part1['grants']}; launches {launches} == the services' and "
          f"engines' counters; open loop TTFT p50/p99 "
          f"{rep.p50_ttft_us:.0f}/{rep.p99_ttft_us:.0f} us; replay "
          f"{res.bursts} bursts in {res.wall_s * 1e3:.1f} ms", flush=True)
    del q

    zero_all_launches()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        load_example("serve_paged").main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = all_launches()
    print(buf.getvalue(), end="")
    if "served 8 requests in " not in buf.getvalue() or \
            "fails=0" not in buf.getvalue():
        fail("9: torch_serve_paged.py did not serve all 8 requests")
    for name in ("support_core_burst", "paged_decode_attention",
                 "flash_attention"):
        if launches[name] <= 0:
            fail(f"9: torch_serve_paged.py launched no {name}")
    out["serve_paged"] = dict(launches=launches, wall_s=wall)
    print(f"  serve_paged: {wall:.2f}s; launches {launches}", flush=True)

    zero_all_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    train_lm = load_example("train_lm")
    vocab = train_lm.lm_config(small=False).vocab_size
    with tempfile.TemporaryDirectory() as ckpt:
        report = train_lm.main(
            ["--steps", str(TRAIN_LM_STEPS), "--checkpoint-dir", ckpt,
             "--device", "cuda"])
        saved = sorted(p.name for p in Path(ckpt).iterdir())
    wall = time.perf_counter() - t
    launches = all_launches()
    losses = report.losses
    if report.steps_run != TRAIN_LM_STEPS or len(losses) != TRAIN_LM_STEPS \
            or not all(map(math.isfinite, losses)):
        fail(f"9: torch_train_lm.py ran {report.steps_run} steps, losses "
             f"{losses}")
    # the corpus is uniform tokens: the loss can fall only from the
    # initial weights' to ln(vocab), which takes ~150 steps at this rate
    tail = statistics.mean(losses[TRAIN_LM_STEPS // 2:])
    if not tail < losses[0]:
        fail(f"9: lm-100m's loss did not fall: {losses[0]:.4f} at the "
             f"initial weights, a mean of {tail:.4f} over the second half")
    if any(launches.values()):
        fail(f"9: training launched a kernel {launches} (its route is the "
             f"plain attention)")
    med = statistics.median(report.step_times_ms)
    tps = 8 * 256 / (med / 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    out["train_lm"] = dict(launches=launches, wall_s=wall, losses=losses,
                           median_step_ms=med, tokens_per_s=tps,
                           peak_gib=peak, checkpoints=saved)
    print(f"  train_lm: lm-100m {TRAIN_LM_STEPS} steps in {wall:.2f}s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the second half "
          f"{tail:.4f}; ln {vocab} = {math.log(vocab):.4f}), median step "
          f"{med:.2f} ms, "
          f"{tps:.1f} tokens/s, peak {peak:.2f} GiB above the phase's "
          f"start, checkpoints {saved}", flush=True)
    del report

    from repro_torch.sim import engine as sim_engine
    sim_ex = load_example("allocator_sim")
    sim_engine._cached_counts.cache_clear()
    zero_all_launches()
    t = time.perf_counter()
    card_table = sim_ex.main(["--device", "cuda"])
    wall = time.perf_counter() - t
    launches = all_launches()
    traces = sim_engine._cached_counts.cache_info().misses
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_table = sim_ex.main(["--device", "cpu"])
    if card_table != cpu_table:
        fail("9: torch_allocator_sim.py's table differs between the card "
             "and the cpu")
    if launches != dict(support_core_burst=0, paged_decode_attention=0,
                        flash_attention=0, sim_trace=traces) or not traces:
        fail(f"9: torch_allocator_sim.py launched {launches}, expected one "
             f"sim_trace launch for each of its {traces} traces")
    out["allocator_sim"] = dict(launches=launches, wall_s=wall)
    print(f"  allocator_sim: {wall:.2f}s; {traces} traces, one launch "
          f"each; the table card == cpu, character for character",
          flush=True)

    seconds = time.perf_counter() - t0
    print(f"  phase 9: {seconds:.1f}s")
    if seconds > EXAMPLES_BUDGET_S:
        fail(f"9: the examples took {seconds:.1f}s, over the phase's "
             f"{EXAMPLES_BUDGET_S:.0f}s budget")
    return dict(runs=out, seconds=seconds)


T_START = time.perf_counter()


def banner(text: str) -> None:
    """A phase's header line, with the seconds since the run began."""
    print(f"== {text} [{time.perf_counter() - T_START:.1f}s]", flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    global T_START
    T_START = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.kernels.paged_attention.ops import PAGED_KERNEL
    from repro_torch.kernels.sim_trace.ops import KERNEL as SIM_KERNEL
    from repro_torch.kernels.support_core.ops import KERNEL

    banner("1. card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    banner("2. build")
    kernels = (KERNEL, PAGED_KERNEL, FLASH_KERNEL, SIM_KERNEL)
    build_all(kernels)
    for k in kernels:
        print(f"  built {k.so_path.name} in {k.build_seconds:.2f}s")
    print_ptxas(kernels)

    mesh_procs = start_mesh_cells()
    try:
        run_phases(dev, card, mesh_procs)
    finally:
        stop(mesh_procs)


def run_phases(dev, card: str, mesh_procs: list) -> None:
    """Phases 3 to 9 (phase 8c's dry runs were started before phase 3)."""
    banner("3. kernels against plain versions")
    par = kernel_parity(dev)
    multi_engine_parity(dev, par)
    zamba_cases = zamba2_bursts(dev, par)
    swa_cases = swa_bursts(dev, par)
    t_burst = {name: time_burst(name, *case)
               for name, case in {**burst_cases(dev), **zamba_cases,
                                  **swa_cases}.items()}
    floor_ms = launch_floor_ms()
    banner("3. the bitmap and buddy policies: card against cpu")
    pol_checked = policy_parity(dev)
    check_no_sync(dev)
    t_pol = time_policies(dev)
    errs = Errors()
    paged_parity(dev, errs)
    paged_split_parity(dev, errs)
    flash_parity(dev, errs)
    flash_edge_parity(dev, errs)
    flash_offset_parity(dev, errs)
    swa_attention_parity(dev, errs)
    determinism(dev)
    t_paged = {
        "deepseek-7b": time_paged(dev, 4, 32, 1, 128, 8, 33, 30,
                                  [119, 104, 87, 112], FULL),
        "gemma3-1b local": time_paged(dev, 4, 1, 4, 256, 16, 129, 26,
                                      [1400, 1024, 700, 611], 512),
        "gemma3-1b global": time_paged(dev, 4, 1, 4, 256, 16, 129, 26,
                                       [1400, 1024, 700, 611], FULL),
        "zamba2-1.2b": time_paged(dev, *ZAMBA_PAGED, FULL),
        **{arch: time_paged(dev, *shape, FULL)
           for arch, shape in DENSE_PAGED.items()},
        "whisper-medium": time_paged(dev, *WHISPER_PAGED, FULL),
        "mixtral-8x7b": time_paged(dev, 4, *MIXTRAL_PAGED, holes=True),
        "phi3.5-moe-42b-a6.6b": time_paged(dev, 4, 8, 4, 128, 16, 129, 16,
                                           [1500, 1200, 900, 611], FULL)}
    t_flash = {
        "deepseek-7b": time_flash(dev, 4, 128, 32, 32, 128, FULL),
        "gemma3-1b local": time_flash(dev, 4, 1536, 4, 1, 256, 512),
        "gemma3-1b global": time_flash(dev, 4, 1536, 4, 1, 256, FULL),
        "zamba2-1.2b": time_flash(dev, *ZAMBA_FLASH, FULL),
        **{arch: time_flash(dev, *shape, FULL)
           for arch, shape in DENSE_FLASH.items()}}
    for name, (T, P, *shape) in OFFSET_SHAPES.items():
        t_flash[name] = time_flash(dev, 4, T, *shape, P=P)
    t_flash["whisper-medium decoder"] = time_flash(dev, 4, 224, 16, 16, 64,
                                                   FULL)
    for name, (B, Tq, Tk) in WHISPER_FLASH.items():
        t_flash[name] = time_flash(dev, B, Tq, 16, 16, 64, FULL, Tk=Tk)
    for B, T in MIXTRAL_FLASH:
        t_flash[f"mixtral-8x7b {B} x {T}"] = time_flash(dev, B, T, 32, 8, 128,
                                                       4096)
    t_flash["phi3.5-moe-42b-a6.6b"] = time_flash(dev, 4, 1536, 32, 8, 128,
                                                 FULL)

    banner("4. serve deepseek-7b at full width")
    cfg, params = full_width_params(dev, "deepseek-7b")
    served = {"deepseek-7b": serve_full_width(dev, "deepseek-7b", cfg,
                                              params, keep_outputs=True)}
    ds_outputs = served["deepseek-7b"].pop("outputs")
    banner("4c. two engine shards on one support core, deepseek-7b at "
          "full width, prefix caches in alias mode")
    served["deepseek-7b multi-engine"] = serve_multi_full_width(dev, cfg,
                                                                params)
    banner("4d. open loop: Poisson arrivals on two shards under the buddy "
          "policy, deepseek-7b at full width, compaction every two windows, "
          "the allocator-op trace recorded")
    served["deepseek-7b open loop"] = open_loop_full_width(dev, cfg, params)
    banner("4e. the open loop's trace replayed with no model, as "
          "recorded and, without its block ids, under each policy, on the "
          "card and on the cpu")
    replayed = replay_full_width(dev,
                                 served["deepseek-7b open loop"].pop("live"))
    served["replay freelist"] = dict(launches=dict(
        support_core_burst=replayed["without block ids/freelist"]["launches"],
        paged_decode_attention=0, flash_attention=0))
    del params
    torch.cuda.empty_cache()
    banner("4b. serve gemma3-1b at full width")
    cfg, params = full_width_params(dev, "gemma3-1b")
    served["gemma3-1b"] = serve_full_width(dev, "gemma3-1b", cfg, params)
    del params
    torch.cuda.empty_cache()
    banner("4f. serve zamba2-1.2b at full width (38 Mamba2 layers, one "
          "shared attention block after every 6th), then decode against "
          "forward in f32")
    cfg, params = full_width_params(dev, "zamba2-1.2b")
    served["zamba2-1.2b"] = serve_full_width(dev, "zamba2-1.2b", cfg,
                                             params)
    served["zamba2-1.2b"]["profile"] = step_profile(dev, "zamba2-1.2b", cfg,
                                                    params, hybrid_parts)
    del params
    torch.cuda.empty_cache()
    served["zamba2-1.2b"]["teacher_forced_rel_err"] = teacher_forced(
        dev, "zamba2-1.2b", TEACHER)
    for phase, arch, what in (
            ("4g", "phi3-medium-14b", "40 layers, 40 heads on 10 KV heads "
             "x 128"),
            ("4h", "qwen2-72b", "8 of 80 layers, 64 heads on 8 KV heads x "
             "128, random QKV biases"),
            ("4i", "phi-3-vision-4.2b", "32 layers, head dim 96, 576 patch "
             "rows ahead of each prompt")):
        banner(f"{phase}. serve {arch} at full width ({what})")
        cfg, params = full_width_params(dev, arch)
        served[arch] = serve_full_width(dev, arch, cfg, params)
        del params
        torch.cuda.empty_cache()
    served["phi-3-vision-4.2b"]["teacher_forced_rel_err"] = teacher_forced(
        dev, "phi-3-vision-4.2b", VLM_TEACHER)
    for phase, arch, what, parts, spec in (
            ("4j", "rwkv6-7b", "32 RWKV6 layers, 64 wkv heads x 64, no "
             "attention", rwkv6_parts, TEACHER),
            ("4k", "whisper-medium", "24 encoder layers over 1500 frame "
             "rows, 24 decoder layers with cross-attention, 16 heads x 64",
             whisper_parts, AUDIO_TEACHER)):
        banner(f"{phase}. serve {arch} at full width ({what}), then "
              f"decode against forward in f32")
        cfg, params = full_width_params(dev, arch)
        served[arch] = serve_full_width(dev, arch, cfg, params)
        served[arch]["profile"] = step_profile(dev, arch, cfg, params, parts)
        del params
        torch.cuda.empty_cache()
        served[arch]["teacher_forced_rel_err"] = teacher_forced(dev, arch,
                                                                spec)
    for phase, arch, what in (
            ("4l", "mixtral-8x7b", "16 of 32 layers, 8 experts top-2, "
             "sliding window 4096 with page recycling, 32 heads on 8 KV "
             "heads x 128"),
            ("4m", "phi3.5-moe-42b-a6.6b", "16 of 32 layers, 16 experts "
             "top-2, full attention"),
            ("4n", "mellum2-12b-a2.5b", "28 layers, 21 sliding-window "
             "(1024) and 7 full with YaRN RoPE, 64 experts top-8 in "
             "grouped products, 32 heads on 4 KV heads x 128, a split "
             "cache")):
        banner(f"{phase}. serve {arch} at full width ({what})")
        t0 = time.perf_counter()
        cfg, params = full_width_params(dev, arch)
        served[arch] = serve_full_width(dev, arch, cfg, params)
        if arch == "mixtral-8x7b":
            served[arch]["profile"] = step_profile(dev, arch, cfg, params,
                                                   moe_parts)
        del params
        torch.cuda.empty_cache()
        if arch == "mixtral-8x7b":
            banner("4l'. mixtral-8x7b decode against forward in f32 (2 "
                  "layers, capacity factor 4)")
            served[arch]["teacher_forced_rel_err"] = teacher_forced(
                dev, arch, MOE_TEACHER)
        served[arch]["phase_s"] = time.perf_counter() - t0
        print(f"  phase {phase}: {served[arch]['phase_s']:.1f}s")

    banner("5. device against cpu")
    for arch in ("deepseek-7b", "gemma3-1b", "zamba2-1.2b",
                 "phi3-medium-14b", "qwen2-72b", "phi-3-vision-4.2b",
                 "rwkv6-7b", "whisper-medium", "mixtral-8x7b",
                 "phi3.5-moe-42b-a6.6b", "mellum2-12b-a2.5b"):
        device_vs_cpu(dev, arch)

    banner("6a. train: card against cpu, two steps at the reduced "
          "configs in f32")
    check_flash_refuses_grad(dev)
    trained = {arch: train_device_vs_cpu(dev, arch) for arch in (
        "deepseek-7b", "gemma3-1b", "zamba2-1.2b", "phi3-medium-14b",
        "qwen2-72b", "phi-3-vision-4.2b", "rwkv6-7b", "whisper-medium",
        "mixtral-8x7b", "phi3.5-moe-42b-a6.6b")}
    banner("6b. train gemma3-1b at full width (bf16, remat, 8 x 1024 "
          "tokens, one batch 8 times)")
    full = train_full_width(dev)
    served["gemma3-1b train"] = dict(launches=full.pop("launches"))
    banner("6c. the trainer on the card: a preemption at step 6, restart "
          "from the checkpoint of step 4")
    preempt = train_preempted(dev)
    served["gemma3-1b trainer"] = dict(launches=preempt.pop("launches"))
    print(json.dumps({"train": {"card_vs_cpu": trained, "full_width": full,
                                "preempted": preempt}}))

    banner("7. sim: the allocator simulator's trace kernel against its "
          "plain loop; calibration_table(16) and the open loop's trace "
          "through every sim policy, card against cpu")
    sim = sim_phase(dev, floor_ms, TRACE_PATH)

    banner("8a. deepseek-7b at full width on a one-rank NCCL mesh: the "
          "sharded decode step and prefill, phase 4's traffic")
    sharded = sharded_serve(dev, ds_outputs)
    served["deepseek-7b one-rank mesh"] = dict(
        launches=sharded.pop("launches"))
    banner("8b. the same configuration and decode shapes dry-run on a fake "
          "one-rank mesh")
    dry = serve_shape_dry_run(sharded.pop("cfg"), sharded.pop("kvcfg"),
                              sharded)
    banner("8c. production-mesh dry runs (fake process groups of 256 and "
          "512 ranks, meta tensors)")
    cells = mesh_cells(mesh_procs, card)
    print(json.dumps({"mesh": {"one_rank_serve": sharded, "dry_run": dry,
                               "cells": cells}}))

    banner("9. the four examples on the card: torch_quickstart.py, "
           "torch_serve_paged.py, torch_train_lm.py (lm-100m, 60 steps), "
           "torch_allocator_sim.py")
    examples = examples_phase(dev)
    sim["launches_by_run"] = {"7. sim": sim["launches"]}
    for name, run in examples["runs"].items():
        launches_run = run.pop("launches")
        sim["launches_by_run"][f"example {name}"] = launches_run.pop(
            "sim_trace")
        served[f"example {name}"] = dict(launches=launches_run)
    sim["launches"] = sum(sim["launches_by_run"].values())
    print(json.dumps({"examples": examples}))

    banner("10. result")
    print(card)            # again here, where a tail of the output keeps it

    def launches(name):
        by_run = {a: s["launches"][name] for a, s in served.items()}
        return dict(launches=sum(by_run.values()), launches_by_run=by_run)

    def timed(t, main_key):
        out = dict(t[main_key])
        out["other_shapes"] = {k: v for k, v in t.items() if k != main_key}
        return out

    kernels_line = [
        dict(name="support_core_burst", route="cuda",
             source="src/repro_torch/kernels/support_core/csrc/support_core.cu",
             replaces="src/repro/kernels/support_core/support_core_kernel.py:205",
             **launches("support_core_burst"), max_abs_err=par.max_abs_err,
             parity_bursts=par.bursts,
             multi_engine={k: v for k, v in
                           served["deepseek-7b multi-engine"].items()
                           if k != "launches"},
             **{k: t_burst["serve"][k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
             library_ms=None, launch_floor_ms=floor_ms,
             large_shape=t_burst["large"],
             pool_shapes={k: v for k, v in t_burst.items()
                          if k.startswith("pool_")},
             hybrid_shapes={k: v for k, v in t_burst.items()
                            if k.startswith("zamba2_")},
             swa_shapes={k: v for k, v in t_burst.items()
                         if k.startswith("swa_")},
             zamba2_serve={k: v for k, v in served["zamba2-1.2b"].items()
                           if k != "launches"},
             dense_serves={a: {k: v for k, v in served[a].items()
                               if k != "launches"}
                           for a in DENSE_PAGED},
             family_serves={a: {k: v for k, v in served[a].items()
                                if k != "launches"}
                            for a in ("rwkv6-7b", "whisper-medium",
                                      "mixtral-8x7b",
                                      "phi3.5-moe-42b-a6.6b")},
             plain_policies=dict(card_vs_cpu_bursts=pol_checked,
                                 times=t_pol),
             open_loop={k: v for k, v in
                        served["deepseek-7b open loop"].items()
                        if k != "launches"},
             replay=replayed),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/"
                    "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/paged_attention.py:92",
             **launches("paged_decode_attention"),
             max_abs_err=errs.max["paged"],
             **timed(t_paged, "deepseek-7b")),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:83",
             **launches("flash_attention"), max_abs_err=errs.max["flash"],
             **timed(t_flash, "deepseek-7b")),
        dict(name="sim_trace", route="cuda",
             source="src/repro_torch/kernels/sim_trace/csrc/sim_trace.cu",
             replaces="src/repro/sim/engine.py:50",
             **{k: sim[k] for k in ("launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by")},
             library_ms=None, launch_floor_ms=floor_ms,
             **{k: v for k, v in sim.items() if k not in (
                 "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by")}),
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
