#!/usr/bin/env python3
"""Proof on one NVIDIA card that the PyTorch/CUDA port builds, is right and
serves.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each fails the run on its own; nothing is caught and ignored):

1. device  — a CUDA card is required; prints its name and power limit;
2. build   — builds every hand-written kernel from the checkout's sources
             (one nvcc per source, started together) and the host CABAC
             lane engine (cc), which must be the engine in use;
3. kernels — each kernel against its plain PyTorch version at the main
             paths' shapes (llama3-8b and deepseek-moe-16b; the D = 64
             flash instances at musicgen-medium's heads; the grouped
             kernel at deepseek-v3-671b's 256-expert banks), with stated
             tolerances, timed beside its plain version, a one-call PyTorch
             yardstick (where one exists) and its bound; rd_quant's levels
             must equal the plain version's exactly on layer 0 of every
             full-width leaf, embed and head;
4. parity  — the llama3-8b smoke model (f32, q8) served on the card and on
             the CPU from the same converted weights: greedy tokens must be
             identical and prefill logits close; q8 levels and scales made
             on the card must equal the CPU's bit for bit; then the codec:
             deepcabac-rd (the rd_quant kernel on the card, its plain
             version on the CPU), serve-q8 and deepcabac-v3 containers
             written from the card equal the CPU's byte for byte, and a
             container served on the card gives the CPU's greedy tokens;
             then the deepseek-moe-16b smoke model the same way, once with
             tokens dropped past the experts' capacity, and once in bf16
             (the bf16 kernel instances the full-width models run: logits
             within TOL_MOE_BF16_LOGITS, no greedy token may differ);
             the smoke models run the f32 kernel instances;
5. deploy RD — eq. (11) level assignment of the whole full-width tree
             (11 leaves) through the kernel, 44 launches, device time
             against its bound and the rate model's bits per parameter;
6. serve   — llama3-8b at full width (32 layers, seeded random init) on
             the q8 backend, then the bf16 one: 4 requests of 128 prompt
             tokens and 32 new tokens, greedy; launch counters and the
             dispatch report prove the path ran through the kernels, and
             the card's q8 quantization of layer 0, the embedding and the
             head equals the CPU's bit for bit.  Each backend is served
             twice in one process, under ``eager_steps()`` and from CUDA
             graphs (the session's default): greedy tokens and launch
             counts must be equal, and each run reports decode ms/step,
             device busy ms/step and the idle share of the traced ticks
             (from graphs also the replay's time by CUDA events and the
             idle share of an untraced tick), one prefill forward's ms
             and peak memory (graph pools included);
7. deploy serve — full width cut to 1 layer: a deepcabac-rd container
             (every float leaf of rank >= 2, embed and head included)
             encoded from the card, served through
             ``ServeEngine.from_compressed`` on the q8 backend (the
             container backend's load of it was cut for time: 8 serves a
             full-width container on that backend); tokens must equal a
             session on the in-memory tree
             with the same policy applied, launch counts must match the
             path, the dispatch report must be empty;
8. MoE serve — once the llama3-8b tensors are freed, deepseek-moe-16b at
             full width (14 of its 28 layers: SERVE_MOE_LAYERS) served as
             in 6, every routed-expert
             product through dequant_matmul_grouped; then cut to 2 layers
             (the dense one and one MoE layer), a serve-q8 container served
             on the container backend with the in-memory q8 session's
             tokens and launch counts;
9. MoE serve, f32 — deepseek-moe-16b at its published widths in f32,
             2 layers, on q8 (4 x 128 prompt tokens + 12 new, greedy): the
             f32 kernel instances at full width; greedy tokens equal the
             same session's on the CPU, prefill logits within
             TOL_MOE_F32_LOGITS, launch counts of the path, an empty
             dispatch report, and the device busy time per decode step
             with the grouped kernel's share; eager and from graphs, as
             in 6;
10. search parity (after 4) — the smoke llama3-8b in f32 on the card and
             on the CPU: rd_sweep (F = 1) gives the same points, policy and
             policy bytes; search_dc_v2 and search_dc_v1 (one sigma for
             both) with the eval NLL computed on each device choose the
             same hyperparameters and write identical blobs (grids of 2
             deltas x 2 lambdas and 2 S values, cut for time);
11. fim     — fisher_for on llama3-8b at full width, 1 layer: in bf16 on
             the card (finite, wq/wk/wv nonzero: gradients pass through
             attention, which under grad takes the scan, so no kernel
             launches), then in f32 on the card against the CPU;
12. variational — variational_fim at the same width in f32, 4 steps:
             sigma finite and > 0, vd_sparsify runs, ms/step, peak memory;
13. rd_sweep — rd_sweep on the 1-layer full-width llama3-8b (bf16) with
             the bench's fast grid at one delta (RD_SWEEP_DELTAS), both
             lambdas: rd_quant and flash_attention launch
             the predicted counts, the report stays empty, the policy
             re-encodes to the sweep's bytes; every point and the split
             of the seconds (assignment, statistics, encode, decode,
             proxy);
14. delta_swap (after 7) — delta checkpoints and the live weight swap at
             llama3-8b's published widths, 1 layer (DELTA_SWAP_LAYERS),
             trained in f32 on the
             card: ``CheckpointManager(codec="deepcabac-delta",
             delta_every=4, sharded=True, min_quant_ndim=3)`` saves a
             keyframe over a (data 1, model 4) MeshSpec and two P-frames,
             one AdamW step each; a q8 session cold-started from the
             keyframe's manifest serves 4 x 128 prompt tokens from graphs
             and takes each P-frame by ``swap_weights`` with the four
             requests in flight: leaves equal to a cold start from the host
             chain decode bit for bit, every coded tensor changed, no
             capture after a swap, a later request equal to that cold
             start (prefill logits bit for bit, tokens), launches of the
             path as predicted, an empty report; the seconds of the saves,
             the cold start and each swap (tc decode, q8 conversion,
             ``copy_``), the host CABAC rates and the bytes of each frame;
             its step directories, the leaf digests of its three q8 trees
             and the late request's logits row and tokens go on to 28;
15. parity_variants (after 4) — the smoke qwen3-8b, qwen1.5-4b,
             mistral-nemo-12b, qwen2-vl-7b, musicgen-medium and
             deepseek-v3-671b (f32, q8; qwen2-vl-7b also bf16) on the card
             and on the CPU: identical greedy tokens, close logits, equal
             q8 levels; reports hold only MLA's d != dv records;
16. serve_dense (after 9) — qwen3-8b at published widths cut to 6 of its
             36 layers (SERVE_DENSE_LAYERS), served as in 6 (the q8 check
             of layer 0, then q8 and bf16, eager and graphs);
17. serve_mla — deepseek-v3-671b at published widths cut to 4 layers (3
             dense, 1 MoE of 256 experts top-8), built on q8 leaf by leaf
             and served as in 6; launches as predicted, no flash launch,
             only the d != dv (192 != 128) records; one full-width MLA
             block in f32, card against CPU;
18. embeds_full — musicgen-medium (6 of 48 layers, the D = 64 flash
             instance) and qwen2-vl-7b (4 of 28 layers, M-RoPE over a
             patch grid and text) at their published widths on q8
             (EMBEDS_FULL_LAYERS): ``prefill(embeds=...)`` of 4 x 128
             and 31 decode steps fed back through a stub frontend table;
             then each at 2 layers in f32, card tokens equal to the CPU's;
19. tune (after 17) — the autotuner (``kernels.autotune``) on the card,
             into its own cache file: dequant_matmul at every distinct
             (M, K, N) of the MLA cut's decode step (its 42 calls, recorded
             at the op) and at llama3-8b's decode and prefill projections,
             rd_quant at the full llama3-8b tree's n buckets; every
             candidate checked against the plain version (rd_quant:
             levels equal); a table of default and tuned tiles and times
             beside the bound;
20. serve_mla_tuned — the MLA cut from graphs with the tuned cache:
             tokens and launches equal to 17's, decode ms/step and the
             dequant_matmul calls' device ms beside 17's;
21. pins    — impl pins on the card: the llama3-8b smoke model with
             dequant_matmul pinned to ref (no launch of it, tokens equal
             to the default's), a strict flash_attention=cuda pin with a
             ragged kv_len raises KernelDispatchError and the same call
             unpinned records its fallback; the launcher's
             --kernel-impl and --strict-kernels likewise;
22. parity_ssm (after 15) — the smoke mamba2-2.7b and zamba2-2.7b in f32
             and in bf16 on q8, card against CPU: prompts of mixed lengths
             (one of a single token) through the session, greedy tokens
             identical on both and from graphs and eagerly on the card,
             close prefill logits, equal q8 levels; reports hold exactly
             the reference's loop-dequant records (LOOP_DEQUANT);
23. serve_ssm, serve_hybrid (after 16) — mamba2-2.7b (16 of 64 layers)
             and zamba2-2.7b (18 of 54 layers: 3 groups, its shared block
             through the D = 80 flash instance) at published widths
             (SSM_SERVE_LAYERS), served as in 6, with the decode step's
             byte bound (weights as stored, the f32 state read and
             written, tails and attention cache);
24. serve_hybrid_f32 — zamba2-2.7b at its published widths in f32, one
             group deep (6 mixers and the shared block: the D = 80 f32
             flash instance), on q8 eagerly and from graphs; tokens equal
             to the same session's on the CPU, logits within
             TOL_MOE_F32_LOGITS;
25. parity_paged (after 22) — the llama3-8b smoke model (f32, q8, int8
             cache) served paged on the card and on the CPU: a pool that
             forces parks (restores on a worker thread), prompts sharing
             an 8-token prefix; tokens and the page counters equal on
             both; every kind of paged step captured and replayed;
26. serve_paged (after 6, on its tree) — llama3-8b at full width on q8
             with an int8 cache on the grid ``calibrate_kv_cache_delta``
             gives, 8 requests (a 128-token system prompt and 24-38 of
             their own) of 24 tokens over 4 slots of 192 from graphs, (a)
             also eagerly ((b)-(d)'s eager runs cut for time): (a) slot
             mode, (b) paged in pages of 16 (tokens and logits rows
             equal (a)'s bit for bit), (c) with prefix sharing
             (7 hits, 56 pages, 376 prefill tokens), (d) on a pool of 3
             slots (auto-parks, every parked page restored); a manual park
             and resume (restored pages = parked ones); launches of the
             path, reports empty but for (c)'s ragged-kv_len records, no
             shape captured twice; ``kv_report`` of each run;
27. serve_mla_paged (after 17) — the MLA cut paged against slot mode
             (nested latent pools, the grouped kernel), partings listed;
28. zoo (right after 14, on its chain) — ``ModelZoo`` on the card: the
             keyframe and both P-frames registered as three models into
             one content-addressed ShardStore (dedup >= 2, bytes equal to
             the manifests'), served on q8 through ``ZooRouter`` under a
             budget of 2.5 models: a cold admission, a warm one
             (``warm_from``), a stall, an eviction and a second warm
             admission; leaves equal 14's digests, the last model's
             prefill logits and tokens equal 14's cold start, memory grows
             and returns by ``model_resident_bytes`` within ZOO_MEM_TOL
             (no ``gc.collect()``), the budget holds every step, launches
             as counted, an empty report; ingest, admission and eviction
             figures, decode ms/step.

29. train (after 12) — training at llama3-8b's published widths, 2 of
             32 layers, 8-bit AdamW moments and EF, batches of 8 x 128:
             (a) ``train_loop`` straight for 6 steps (ms/step, tokens/s,
             peak memory; no kernel under grad, an empty report); (b) the
             same with raw async checkpoints every 6 steps, SIGTERM in
             step 4 (the loop ends after it with a final save) and a
             resumed loop to 6 (its cadence save at 6, not written twice):
             the saves are steps 4 and 6, losses and the final state
             equal (a)'s bit for bit
             (deterministic algorithms on); (c) ``make_prefill_step`` and
             8 greedy ``make_decode_step``s on the trained params: the
             tokens of ``ServeEngine.generate``, flash launched once a
             layer, an empty report; the profiler's split of a step
             (forward+backward, EF, AdamW) and its idle share beside the
             step's bound; (d) ``python -m repro_torch.launch.train
             --smoke --steps 20 --compress-grads --ckpt-dir ...``: the loss
             falls and the DeepCABAC checkpoint restores; the smoke
             llama3-8b and deepseek-moe-16b steps card against CPU.  Its
             directories under ``build/train/`` (up to 3 x 12 GB) are
             removed.
30. mesh_restore (right after 14, on its chain; the distribution phases
             run on a one-rank NCCL world, its rendezvous a FileStore
             under ``build/``) — the keyframe by ``restore_on_mesh`` and
             the first P-frame by ``restore_on_mesh_delta`` onto the card's
             (data 1, model 1) DeviceMesh, every leaf a DTensor equal to
             the host decode bit for bit; ``restore_local_slices`` of
             device 0 of SWAP_MESH decoding fewer values than the
             manifest; a bf16 backend with ``mesh=`` serving the keyframe
             from graphs with the tokens of the same load without a mesh,
             one flash launch a prefill and layer, an empty report;
31. collectives (after 30) — ``cross_pod_psum_compressed`` of a
             llama3-8b ``w_gate``-shaped f32 tensor on a pod axis of 1
             equal to ``q8_decode(q8_encode(x))`` bit for bit, its wire
             bytes a value; ``gpipe_apply`` with one stage over 4
             microbatches of 4 x 128 x 4096 through a llama3-8b MLP block
             in bf16 equal to the block in sequence bit for bit; ms of
             each;
32. train_dp (after 29) — ``train_loop`` on the NCCL DeviceMesh
             (data 1, model 1: the sharded step of ``distributed.fsdp``
             with every box the whole leaf and every collective over one
             rank, the all-reduced stop flag, the closing barrier) at 29's
             width against the mesh-free step, 3 steps each from one seed:
             losses and the whole state equal bit for bit on the card
             (deterministic algorithms on), ms/step of both; at smoke
             width a sharded CABAC save of ``train_loop`` on the mesh
             byte-identical to one process's save of the mesh-free state,
             and the loop resumed on the mesh (``restore(mesh=layout)``)
             equal to the mesh-free loop resumed from the same step; the
             prefill step on the mesh launches flash once a layer with the
             mesh-free prefill's logits;
33. dryrun (after 29, before 32) — the dry run's account on fake
             tensors: (a) ``python -m repro_torch.launch.dryrun --arch
             llama3-8b --shape train_4k --mesh single`` and ``--mesh
             multi``, two subprocesses at once, each on a fake world of
             256 / 512 ranks with fake CUDA tensors: exit 0 with nothing
             allocated on the card, per-rank FLOPs, bytes, collectives by
             kind, argument and peak bytes, and all ranks' FLOPs within
             DRYRUN_FLOPS_TOL of ``train_step_bound``'s at 256 x 4096, 32
             layers, every difference named (``dryrun_named_flops``); (b)
             meanwhile 29's configuration (2 layers, 8 x 128, 8-bit
             moments, EF, mesh-free) traced in this process: nothing
             allocated, FLOPs against the bound likewise, the traced peak
             within DRYRUN_PEAK_TOL of the peak 29 (a) measured over its
             step TRAIN_PEAK_STEP (no extra real step).  No kernel runs.

Every phase but 20 runs under the default kernel policy with an empty
tuning cache (``REPRO_TORCH_KERNEL_TUNE_CACHE`` points at a fresh file
under ``build/``), so a stale cache on the machine changes nothing.
13 runs at 1 layer (RD_SWEEP_LAYERS) and one delta (RD_SWEEP_DELTAS), 14
and 28 at 1 (DELTA_SWAP_LAYERS), 16 at 6 (SERVE_DENSE_LAYERS), 18 at 6
and 4 (EMBEDS_FULL_LAYERS), 23 at 16 and 18 (SSM_SERVE_LAYERS), 11 at 1
(FIM_LAYERS), 29 at 6 steps (TRAIN_STEPS), 10 with smaller DC grids
(DC_DELTAS, DC_S_GRID) and 8 at 14 layers (SERVE_MOE_LAYERS), so that the
rest fit the time limit.

The line before the last is the card's name and power limit; one line
before it is the ``{"kernels": [...]}`` summary; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  It imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12            # f32 outside the tensor cores
BF16_FLOPS = 989e12          # bf16 tensor cores, f32 accumulation

# full width, by model: (K, N) of the q8 projections and the head, with
# the number of calls per forward pass
DM_SHAPES = {
    "llama3-8b": [((4096, 4096), 64, "wq,wo"), ((4096, 1024), 64, "wk,wv"),
                  ((4096, 14336), 64, "w_gate,w_up"),
                  ((14336, 4096), 32, "w_down"), ((4096, 128256), 1, "head")],
    "deepseek-moe-16b": [((2048, 2048), 112, "wq,wk,wv,wo"),
                         ((2048, 64), 27, "router"),
                         ((2048, 2816), 54, "sh_gate,sh_up"),
                         ((2816, 2048), 27, "sh_down"),
                         ((2048, 10944), 2, "dense w_gate,w_up"),
                         ((10944, 2048), 1, "dense w_down"),
                         ((2048, 102400), 1, "head")],
}
DM_ROWS = (1, 4, 16, 512)    # decode rows at 1 and 4 slots; 16
#                              (continuous batching); prefill B*S
DM_PREFILL_M = DM_ROWS[-1]
# deepseek-v3-671b's MLA projections (4 layers: calls per forward pass of
# the 4-layer serve) at a 4-slot decode step and a 4 x 128 prefill; the
# latents' up-projection w_uk / w_uv takes the whole cache at decode: M =
# 4 slots x 160 positions
DM_MLA_SHAPES = [((7168, 1536), 4, "w_dq", (4, 512)),
                 ((1536, 24576), 4, "w_uq", (4, 512)),
                 ((7168, 512), 4, "w_dkv", (4, 512)),
                 ((7168, 64), 4, "w_kr", (4, 512)),
                 ((512, 16384), 8, "w_uk,w_uv", (640, 512)),
                 ((16384, 7168), 4, "wo", (4, 512))]
# deepseek-moe-16b's expert banks: E experts, (K, N) with calls per forward
# pass, and rows per expert: the capacity buffer of a 4-slot decode step
# (4 x cap 8) and of a 4 x 128-token prefill (4 x cap 16)
GROUPED_E = 64
GROUPED_SHAPES = [((2048, 1408), 54, "w_gate,w_up"), ((1408, 2048), 27,
                                                      "w_down")]
GROUPED_ROWS = (32, 64)
# deepseek-v3-671b's expert banks: 256 experts, (K, N) with calls per
# forward pass, and rows per expert at 1 and 4 slots (4 x cap 8; a 4 x 128
# prefill's capacity buffer is 4 x cap 8 too: 128 x 8 x 1.25 / 256 < 8).
# The bank is 3.76 GB of levels; its plain version is computed 32 experts
# at a time (f32 of the whole bank is 15 GB), and the torch.bmm yardstick
# multiplies a bf16 bank (7.5 GB)
GROUPED_V3_E = 256
GROUPED_V3_SHAPES = [((7168, 2048), 2, "w_gate,w_up"),
                     ((2048, 7168), 1, "w_down")]
GROUPED_V3_ROWS = (8, 32)
GROUPED_V3_CHUNK = 32
# the other dense variants and MLA: their smoke models run card against
# CPU (f32, q8; qwen2-vl-7b also in bf16), prefill logits within
# TOL_VARIANT_LOGITS of max|logit| (the readings are 3.0e-7 in bf16 and
# 6.2e-7 to 1.1e-6 in f32, NVIDIA H100 80GB HBM3, 700 W, so a kernel fault
# that moves the logits by 1e-4 or more fails); deepseek-v3-671b served at its
# published widths cut to SERVE_MLA_LAYERS (its 3 leading dense layers and
# one MoE layer); an embeddings model's generated token t is fed back as
# row t % EMBED_TABLE_ROWS of a seeded stub frontend table, its 2-layer f32
# runs (EMBED_F32_LAYERS) take EMBED_F32_NEW_TOKENS tokens
VARIANTS = ("qwen3-8b", "qwen1.5-4b", "mistral-nemo-12b", "qwen2-vl-7b",
            "musicgen-medium", "deepseek-v3-671b")
TOL_VARIANT_LOGITS = 1e-4
SERVE_MLA_LAYERS = 4
# serve_moe's depth, cut for time from 28 (the proof run of the sharded
# train state took 1167.4 s against a 1150 s mark; its MoE layers repeat
# one shape class, so 14 of them launch the same kernel instances)
SERVE_MOE_LAYERS = 14
# the paged serves: llama3-8b at full width, int8 cache on the
# calibrated grid, pages of 16 tokens over 4 slots of 192 (12 pages each);
# every prompt is a shared 128-token system prompt (8 pages) and tokens of
# its own, 24 to 38 (prompts of 152 to 166: distinct lengths, so slot mode
# prefills each alone too), 24 new tokens each
PAGED_PAGE = 16
PAGED_SLOTS = 4
PAGED_MAX_LEN = 192
PAGED_SYSTEM = 128
PAGED_OWN = tuple(range(24, 40, 2))
PAGED_NEW = 24
PAGED_TIGHT_POOL = 37        # 3 full slots (3 x 12 pages) + the scratch page
PAGED_MANUAL_PARK = (4, 8)   # the manual park's ticks: park, resume
MLA_PAGED_LENS = (120, 122, 124, 126)
MLA_PAGED_NEW = 16
EMBED_TABLE_ROWS = 4096
EMBED_F32_LAYERS = 2
# embeds_full's bf16 depth, cut for time from 48 and 28 layers (their
# layers repeat one shape class each; 12 and 7 before the distribution
# phases came)
EMBEDS_FULL_LAYERS = {"musicgen-medium": 6, "qwen2-vl-7b": 4}
EMBED_F32_NEW_TOKENS = 12
# flash attention's (H, G) and D at full width: llama3-8b, deepseek-moe-16b
# (D = 128), musicgen-medium (D = 64)
FLASH_HEADS = ((32, 8), (16, 16))
FLASH_D64_HEADS = (24, 24)
FLASH_D80_HEADS = (32, 32)   # zamba2-2.7b's shared attention block
TOL_F32 = 1e-4               # relative to max|plain|: f32 sums in other order
TOL_FLASH_BF16 = 2e-2        # bf16 output and p rounded to bf16 before PV
# bf16 smoke deepseek-moe-16b, card against CPU, relative to max|logit|:
# the reading is 3.4e-7 (NVIDIA H100 80GB HBM3, 700 W), so a kernel fault
# that moves the logits by 1e-4 or more fails
TOL_MOE_BF16_LOGITS = 1e-4
PROF_STEPS = (4, 8)          # decode ticks traced by torch.profiler
#                              (tick 3 warms the tracer up)
# rd_quant: the llama3-8b winner of the committed RD sweep (BENCH_rd.json)
RD_DELTA_REL, RD_LAM, RD_WINDOW, RD_PASSES = 0.006, 1e-5, 4, 2
# rd_quant's operations per element and pass, as the source states them
# (loop control and address arithmetic left out):
RD_OPS_NN = 8                # w/step, rint, 2 clips; prev_sig test and
#                              select; l0 and l1 selects
RD_OPS_CAND = 30             # per candidate, f32: add, 2 clips, step*k, w-,
#   square, ==0, abs, to int, <0, 2 rate adds, lam*, +, < (15); integer and
#   selects: zero-candidate select, <=num_gr, a-1, a-num_gr, clz, 31-,
#   +num_gr, class select, <n_classes, table load, magnitude select, sign
#   select, rate select, 2 best selects (15)
# None of them fuses into an FMA (the _rn intrinsics), so each takes one of
# the SM's 128 lane-issue slots per cycle: half the FMA-counted f32 peak.
# Integer operations run on 64 lanes per SM, so this rate keeps the bound
# a lower bound.
ISSUE_OPS_PER_S = F32_FLOPS / 2
DEPLOY_LAYERS = 2            # depth of the 2-layer full-width cuts
DELTA_SWAP_LAYERS = 1        # delta_swap's depth (cut from 2 for time:
#                              its saves code the stacked layers)
DEPLOY_SERVE_LAYERS = 1      # depth of the deepcabac-rd container served
#                              (cut from 2 in PR 21 for time: its host
#                              CABAC encode and three decodes go with the
#                              embed and head, 1.05 G of its 1.27 G values)
# deepseek-moe-16b in f32 at full width, DEPLOY_LAYERS deep: new tokens per
# request (11 ticks in all: the first holds the prefill, the second
# captures the decode graph, ticks 4-7 are traced as in the other serves,
# ticks 2 and 8-10 timed), and the card-vs-CPU limit on prefill logits
# relative to max|logit| (f32 through every layer: the f32 kernel
# instances' sums in another order)
MOE_F32_NEW_TOKENS = 12
TOL_MOE_F32_LOGITS = 1e-4
# the search loop's phases: the FIM's batches (fisher_for's defaults), the
# variational FIM's steps and its bytes per parameter in f32 (mu, rho, their
# four AdamW moments, their gradients, one sampled copy: 4 + 4 + 16 + 8 + 4,
# and room for one leaf's temporaries: the embedding's, at full width)
FIM_BATCHES, FIM_BATCH, FIM_SEQ = 2, 2, 16
VD_STEPS = 4
# fim's depth, cut from DEPLOY_LAYERS (2) for time: its f32 CPU reference
# took 17.6 s of the phase
FIM_LAYERS = 1
VD_BYTES_PER_PARAM = 44
# the training phase: llama3-8b at its published widths cut to 2 of its 32
# layers (1.487 G parameters), LoopConfig's default batch, 8-bit moments and
# EF; a straight loop, a preempted one (SIGTERM while step TRAIN_SIGTERM_AT
# + 1 runs) resumed from its raw async checkpoints, prefill + decode steps,
# the launcher at smoke size (its loss must fall over TRAIN_CLI_STEPS), and
# the smoke models' steps card against CPU (f32: losses rel TOL_TRAIN_LOSS;
# params within TOL_TRAIN_PARAM of max|p| but for TRAIN_PART_SHARE of a
# leaf, codes within TRAIN_CODE_TOL: a code on a rounding boundary rounds
# either way after last-bit differences in the gradients)
# (TRAIN_STEPS cut from 12 to 6 for time, the cadence from 4 to 6 steps
# and the SIGTERM moved from step 6 to step 4: two 12 GB raw saves
# fewer.  The SIGTERM step stays off the cadence, so the preempted loop
# ends with its final save; the resumed loop's last step is a cadence
# save, which the final save does not write again)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 6, 8, 128
TRAIN_CKPT_EVERY = 6
TRAIN_SIGTERM_AT = 3
TRAIN_PROMPTS, TRAIN_DECODE = 4, 8
TRAIN_PEAK_STEP = 3          # the step of (a) whose peak memory is read
#                              alone (the dry run's traced peak is held
#                              to it)
TRAIN_CLI_STEPS = 20
TRAIN_SMOKE_STEPS = 3
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_PARAM, TRAIN_PART_SHARE, TRAIN_CODE_TOL = 1e-3, 0.005, 2
TRAIN_DIR = ROOT / "build" / "train"
# the dry run (launch/dryrun.py): llama3-8b's train_4k cell on fake worlds
# of 256 and 512 ranks (the production meshes), each ``python -m
# repro_torch.launch.dryrun`` in a subprocess with fake CUDA tensors, and
# the train phase's configuration (mesh-free) traced in this process; the
# traced FLOPs within DRYRUN_FLOPS_TOL of train_step_bound's with every
# difference named (dryrun_named_flops), the traced peak within
# DRYRUN_PEAK_TOL of the train phase's measured peak of one step
DRYRUN_ARCH, DRYRUN_SHAPE = "llama3-8b", "train_4k"
DRYRUN_FLOPS_TOL = 0.01
DRYRUN_PEAK_TOL = 0.10
DRYRUN_TIMEOUT = 300
# distribution on a one-rank NCCL world (rendezvous: a FileStore under
# build/): the data-parallel step against the mesh-free one at the train
# phase's width (DP_STEPS steps each, the same seed and batches); the
# compressed cross-pod sum of a llama3-8b w_gate-shaped f32 tensor on a pod
# axis of 1; gpipe_apply with one stage over GPIPE_MICRO microbatches of
# GPIPE_ROWS x 4096 through one llama3-8b MLP block in bf16; the mesh
# restores of delta_swap's chain
DIST_STORE = ROOT / "build" / "dist_store"
MESH_RESTORE_WORKERS = 8     # the card machine's host cores: tensors decode
#                              and move on a thread pool
DP_STEPS = 3
# train_dp's smoke-width sharded save (step DP_SAVE_STEPS) and resume (to
# DP_RESUME_STEPS), 8-bit moments + EF, DP_SMOKE_BATCH x DP_SMOKE_SEQ
DP_SAVE_STEPS, DP_RESUME_STEPS = 2, 4
DP_SMOKE_BATCH, DP_SMOKE_SEQ = 4, 16
DP_CKPT_DIR = ROOT / "build" / "train_dp_ckpt"
PSUM_SHAPE = (1, 4096, 14336)
GPIPE_MICRO, GPIPE_ROWS = 4, (4, 128)
# rd_sweep: benchmarks/rd_sweep_bench.py's --fast grid, min_ndim=3 (the
# stacked layer matrices: embed and head stay raw)
RD_SWEEP_LAYERS = 1          # the sweep's depth (its launches of rd_quant
#                              go with the 7 stacked tensors, not the depth)
SWEEP = dict(delta_rels=(1e-3, 6e-3), lambdas=(0.0, 1e-5), prompts=3,
             decode_steps=6, fim_batches=1, min_ndim=3)
# the full-width sweep's deltas: the fast grid's 6e-3 alone (cut from both
# for time: each grid point is a host CABAC encode and decode of the
# covered tensors, about 27 s; a lambda = 0 and a lambda > 0 point remain)
RD_SWEEP_DELTAS = (6e-3,)
# qwen3-8b's serve at its published widths, cut from 36 layers for time
# (its layers bring no kernel shape beyond llama3-8b's)
SERVE_DENSE_LAYERS = 6       # 12 before the distribution phases came
# search parity at smoke size: the sweep's logit KL card vs CPU (a sum over
# the vocabulary of f32 log-probability differences), the DC grids and the
# accuracy budget on minus the eval NLL.  On the seeded smoke weights each
# grid has points on both sides of the budget (a CPU run: DC-v2 keeps 0.02
# of the deltas and passes at lambda 0 only, DC-v1 passes at S = 32 only),
# so the choice is not a fallback.  DC-v1 runs lambda = 0 alone: its F_i
# (the empirical FIM of random weights, 1e-6 and less) make any lambda > 0
# zero most weights, which lowers a random model's NLL.  (The grids were
# cut for time from 4 deltas and 3 S values: 9 and 4 evaluations a device,
# now 5 and 3.)
TOL_KL_ABS = 1e-6
DC_DELTAS = (0.02, 0.05)
DC_LAMBDAS = (0.0, 1e-4)
DC_S_GRID = (16.0, 32.0)
DC_V1_LAMBDAS = (0.0,)
SEARCH_TOL = 0.005
# delta_swap: llama3-8b at full width, DELTA_SWAP_LAYERS deep, trained in
# f32:
# the steps saved (a keyframe and two P-frames, one AdamW step apart at
# SWAP_LR), the keyframe cadence, the save mesh (shard math only, one
# card), the new tokens of each of the 4 requests (the first from the
# prefill), the decode ticks before each swap, the late request's new
# tokens, and the disk the step directories take at most (the embedding
# and head stay raw in every frame: 4.2 GB each)
SWAP_STEPS = (1, 2, 3)
SWAP_LR = 1e-5
SWAP_DELTA_EVERY = 4
SWAP_MESH = {"data": 1, "model": 4}
SWAP_NEW_TOKENS = 32
SWAP_TICKS = 8
SWAP_LATE_TOKENS = 8
SWAP_DISK_BYTES = 20 * 2**30
# the zoo on delta_swap's chain: its models (steps 1, 2, 3 in order) and the
# limit, relative to one model's model_resident_bytes, on how far the
# card's memory_allocated may move from the accounting at an admission or
# an eviction (the logits buffer, graph inputs and allocator blocks are
# not accounted)
ZOO_MODELS = ("base", "v1", "v2")
ZOO_MEM_TOL = 0.02
# the new tokens of v1's second request: 4 more than the others', so when
# base and v1's first request finish, v1 is still busy and base is the only
# idle model: v2's admission evicts it and warms from v1 through one
# P-frame (from base it would decode two), and v2 steps alone at its end
ZOO_V1_SECOND_TOKENS = SWAP_LATE_TOKENS + 4
# the SSM and hybrid families: their smoke models run card against CPU (f32
# and bf16, q8), mamba2-2.7b and zamba2-2.7b serve at published widths
# (SSM_SERVE_LAYERS deep); zamba2-2.7b also in f32 at one group
# of its layers (HYBRID_F32_LAYERS: 6 mixers and the shared block, the
# D = 80 f32 flash instance on a served path), card against CPU.  Under q8
# the reference dequantizes the mixer tensors in its loop (no fused
# consumer), and records each once: LOOP_DEQUANT, the names the reference
# records (tests/test_torch_ssm.py holds this list to it on the CPU)
SSM_ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
# their full-width serves' depth, cut for time from 64 and 54 layers (no
# kernel shape class past zamba2's first group of 6 mixers and its shared
# block; three groups keep the shared block's reuse across groups)
SSM_SERVE_LAYERS = {"mamba2-2.7b": 16, "zamba2-2.7b": 18}
LOOP_DEQUANT = ("w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x_w", "conv_b_w",
                "conv_c_w", "out_proj")
SSM_PROMPT_LENS = (16, 16, 1, 9, 5, 16)     # a 1-token prompt among them
HYBRID_F32_LAYERS = 6
# the kernel tuning cache: every phase serves with an empty one (a stale
# file of the machine's cannot change a phase), except serve_mla_tuned,
# which reads what the tune phase wrote; tune's rd_quant sizes are the full
# llama3-8b tree's leaves (wk/wv, wq/wo/embed/head, the MLP: one n bucket
# each), bf16, its levels checked against the plain version on a prefix
TUNE_DIR = ROOT / "build" / "chip_smoke_tune"
EMPTY_TUNE_CACHE = TUNE_DIR / "empty.json"
TUNED_CACHE = TUNE_DIR / "tuned.json"
RD_TUNE_N = (32 * 4096 * 1024, 32 * 4096 * 4096, 32 * 4096 * 14336)
RD_TUNE_PREFIX = 1 << 24


def log(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(fn, min_ms: float = 30.0, max_iters: int = 200) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events after warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = max(3, min(max_iters, int(math.ceil(min_ms / est))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_graph(fn) -> float:
    """Mean device time of ``fn()`` in ms without the host's cost of
    issuing it: as many calls as take about 2 ms (1 to 20) captured in one
    CUDA graph, whose replays are timed by :func:`time_ms`.  The serving
    kernels' rows and their library yardsticks are all timed so: an eager
    loop of a call of a few microseconds measures Python and the launch
    path (15-30 us per call beside an H100) rather than the card, and one
    yardstick serves every row."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = max((time.perf_counter() - t0) * 1e3, 1e-3)
    reps = max(1, min(20, int(2.0 / est)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay) / reps
    del graph
    return ms


def rel_err(got, want):
    import torch
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    total = time.perf_counter() - t0
    for name, log_text in _build.BUILD_LOG.items():
        for line in log_text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] built {sorted(secs)} in {total:.2f} s (per source: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()) + ")")
    import os
    from repro_torch.core import cabac_vec
    t0 = time.perf_counter()
    engine = cabac_vec.resolve_backend("auto")
    check(engine == "c", f"host CABAC engine is {engine!r}, not the C "
          "lane engine: no C compiler on this machine?")
    host_s = time.perf_counter() - t0
    log(f"[build] host CABAC lane engine: C ({host_s:.2f} s), "
        f"{cabac_vec.default_threads()} threads on {os.cpu_count()} cores")
    return {"seconds": total, "per_source": secs, "host_engine": engine,
            "host_engine_s": host_s,
            "cabac_threads": cabac_vec.default_threads()}


def _matmul_peak(x_bytes):
    """The rate a dequantize-matmul's operations can reach.  A bf16 x times
    an int8 level (exactly a bf16) is exact in f32, and the per-column scale
    factors out of the sum over K, so the bf16 tensor cores with f32 sums
    compute the function: the bf16 peak bounds it.  A f32 x splits exactly
    into three bf16 pieces (bf16x3: 8 bits each, each piece times a level
    exact in f32), so the same function runs on the tensor cores at three
    MMAs per product: BF16_FLOPS / 3, the rate dequant_matmul's tensor-core
    instance computes a f32 x at."""
    return BF16_FLOPS if x_bytes == 2 else BF16_FLOPS / 3


def _dm_bound(m, k, n, x_bytes):
    nbytes = m * k * x_bytes + k * n + 4 * n + 4 * m * n
    flops = 2.0 * m * k * n
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / _matmul_peak(x_bytes)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_dequant(device):
    """dequant_matmul vs its plain version at every main-path shape and
    DM_ROWS (deepseek-v3-671b's MLA projections at their own rows): the
    decode instance at M <= 8, the tensor-core one above."""
    import torch
    from repro_torch.kernels.dequant_matmul.ops import (dequant_matmul_cuda,
                                                        schedule)
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    cases = [(a, *shape, DM_ROWS) for a, shapes in DM_SHAPES.items()
             for shape in shapes] + [("deepseek-v3-671b", *shape)
                                     for shape in DM_MLA_SHAPES]
    for arch, (k, n), calls, names, m_rows in cases:
        # rotate weight copies so each call reads its weights from HBM,
        # as a decode step does (the L2 holds 50 MB)
        copies = max(1, math.ceil(120e6 / (k * n)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=device,
                            dtype=torch.int8) for _ in range(copies)]
        sc = torch.rand(n, generator=gen, device=device) * 0.01 + 1e-4
        w_deq = ws[0].float() * sc        # library yardstick's operand
        w_bf16 = w_deq.bfloat16()         # cuBLAS speed reference's
        for m in m_rows:
            kc, splits, _, bm = schedule(m, k, n, sms)
            inst = "decode" if m <= 8 else "tensor_core"
            for xdt in (torch.float32, torch.bfloat16):
                x = torch.randn((m, k), generator=gen, device=device
                                ).to(xdt)
                got = dequant_matmul_cuda(x, ws[0], sc)
                want = dequant_matmul_ref(x, ws[0], sc)
                torch.cuda.synchronize()
                abs_e, rel_e = rel_err(got, want)
                check(torch.isfinite(got).all().item(),
                      f"dequant_matmul non-finite at m={m} k={k} n={n}")
                check(rel_e <= TOL_F32,
                      f"dequant_matmul m={m} k={k} n={n} {xdt}: rel err "
                      f"{rel_e:.3g} > {TOL_F32}")
                it = iter(range(1 << 30))

                def kernel():
                    return dequant_matmul_cuda(x, ws[next(it) % copies], sc)
                ms, eager = time_ms_graph(kernel), time_ms(kernel)
                plain = time_ms(lambda: dequant_matmul_ref(x, ws[0], sc))
                xf = x.float()
                lib = time_ms_graph(lambda: torch.matmul(xf, w_deq))
                bound, by = _dm_bound(m, k, n, x.element_size())
                row = {"arch": arch, "m": m, "k": k, "n": n,
                       "x": str(xdt)[6:], "instance": inst, "kc": kc,
                       "splits": splits, "bm": bm,
                       "calls_per_forward": calls, "weights": names,
                       "max_abs_err": abs_e, "max_rel_err": rel_e,
                       "ms": ms, "eager_ms": eager, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bound,
                       "bound_by": by}
                extra = ""
                if xdt == torch.bfloat16:
                    # cuBLAS on a bf16 weight: a speed reference at this
                    # shape, not the same function
                    xb = x.bfloat16()
                    row["bf16_matmul_ms"] = time_ms_graph(
                        lambda: torch.matmul(xb, w_bf16))
                    extra = f"  bf16 matmul {row['bf16_matmul_ms']:.4f}"
                rows.append(row)
                log(f"[kernels] dequant_matmul m={m:4d} k={k:5d} n={n:6d} "
                    f"x={str(xdt)[6:]:8s} ({inst}, S={splits}) err "
                    f"{rel_e:.2e}  kernel {ms:.4f} ms (eager {eager:.4f})  "
                    f"plain {plain:.4f}  library {lib:.4f}{extra}  bound "
                    f"{bound:.4f} ({by})")
        del ws, w_deq, w_bf16
    return rows


def _flash_peak(elt):
    """The rate attention's two products can reach: bf16 operands on the
    bf16 tensor cores; f32 operands by the 3xTF32 split (three TF32
    products per product, TF32 at half the bf16 rate): BF16_FLOPS / 6, the
    rate the kernel's f32 instance computes at."""
    return BF16_FLOPS if elt == 2 else BF16_FLOPS / 6


def _flash_bound(b, sq, skv, h, g, d, elt):
    nbytes = (2 * b * sq * h * d + 2 * b * skv * g * d) * elt
    pairs = sum(min(skv, i + 1 + (skv - sq)) for i in range(sq))
    flops = 4.0 * d * b * h * pairs
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / _flash_peak(elt)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_flash(device):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import _flash_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    b = 4
    rows = []
    cases = [(hg, 128) for hg in FLASH_HEADS] + [(FLASH_D64_HEADS, 64),
                                                  (FLASH_D80_HEADS, 80)]
    for (h, g), d, s in [(hg, d, s) for hg, d in cases for s in (128, 100)]:
        for dt, tol in ((torch.bfloat16, TOL_FLASH_BF16),
                        (torch.float32, TOL_F32)):
            q = torch.randn((b, s, h, d), generator=gen, device=device
                            ).to(dt)
            k = torch.randn((b, s, g, d), generator=gen, device=device
                            ).to(dt)
            v = torch.randn((b, s, g, d), generator=gen, device=device
                            ).to(dt)
            rep = h // g

            def plain():
                qf = q.permute(0, 2, 1, 3).reshape(b * h, s, d)
                kf = k.permute(0, 2, 1, 3).repeat_interleave(
                    rep, dim=1).reshape(b * h, s, d)
                vf = v.permute(0, 2, 1, 3).repeat_interleave(
                    rep, dim=1).reshape(b * h, s, d)
                return flash_attention_ref(qf, kf, vf).reshape(
                    b, h, s, d).permute(0, 2, 1, 3)

            got = _flash_cuda(q, k, v)
            want = plain()
            torch.cuda.synchronize()
            abs_e, rel_e = rel_err(got, want)
            check(torch.isfinite(got.float()).all().item(),
                  f"flash_attention non-finite at S={s} {dt}")
            check(rel_e <= tol, f"flash_attention S={s} {dt}: rel err "
                  f"{rel_e:.3g} > {tol}")
            # ms and library_ms from CUDA-graph replays (time_ms_graph); the
            # eager loops' times are kept beside them
            ms = time_ms_graph(lambda: _flash_cuda(q, k, v))
            eager = time_ms(lambda: _flash_cuda(q, k, v))
            plain_ms = time_ms(plain)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            lib = time_ms_graph(sdpa)
            lib_eager = time_ms(sdpa)
            bound, by = _flash_bound(b, s, s, h, g, d, q.element_size())
            rows.append({"b": b, "s": s, "h": h, "g": g, "d": d,
                         "dtype": str(dt)[6:],
                         "instance": ("tc_bf16" if dt == torch.bfloat16
                                      else "tc_f32"),
                         "max_abs_err": abs_e,
                         "max_rel_err": rel_e, "ms": ms, "eager_ms": eager,
                         "plain_ms": plain_ms, "library_ms": lib,
                         "library_eager_ms": lib_eager, "bound_ms": bound,
                         "bound_by": by})
            log(f"[kernels] flash_attention B={b} S={s} H={h} G={g} D={d} "
                f"{str(dt)[6:]:8s} err {rel_e:.2e}  kernel {ms:.4f} ms "
                f"(eager {eager:.4f})  plain {plain_ms:.4f}  library "
                f"{lib:.4f} (eager {lib_eager:.4f})  bound {bound:.5f} "
                f"({by})")
    return rows


def _grouped_bound(e, m, k, n, x_bytes, scale_floats):
    nbytes = e * m * k * x_bytes + e * k * n + 4 * scale_floats + 4 * e * m * n
    flops = 2.0 * e * m * k * n
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / _matmul_peak(x_bytes)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_grouped(device):
    """dequant_matmul_grouped vs its plain version at deepseek-moe-16b's
    expert shapes, both x types (bf16: the bf16 models' path; f32: the f32
    models', split into three bf16 pieces in the kernel: mma.sync at the
    decode rows, wgmma at the prefill rows) in both scale forms at decode
    and prefill rows (M = 32 and 64)."""
    import torch
    from repro_torch.kernels.dequant_matmul.ops import \
        dequant_matmul_grouped_cuda
    from repro_torch.kernels.dequant_matmul.ref import \
        dequant_matmul_grouped_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    e = GROUPED_E
    rows = []
    for (k, n), calls, names in GROUPED_SHAPES:
        # 184.5 MB of levels per call: every call reads them from HBM
        wq = torch.randint(-127, 128, (e, k, n), generator=gen,
                           device=device, dtype=torch.int8)
        for form, sshape in (("shared", (n,)), ("per_expert", (e, n))):
            sc = torch.rand(sshape, generator=gen, device=device) * 0.01 \
                + 1e-4
            w_deq = wq.float() * (sc if sc.dim() == 1 else sc[:, None, :])
            for m, xdt in [(m, dt) for dt in (torch.bfloat16, torch.float32)
                           for m in GROUPED_ROWS]:
                x = torch.randn((e, m, k), generator=gen, device=device
                                ).to(xdt)
                inst = ("tc_bf16" if xdt == torch.bfloat16 else
                        "tc_f32" if m <= 32 else "wgmma_f32")
                got = dequant_matmul_grouped_cuda(x, wq, sc)
                want = dequant_matmul_grouped_ref(x, wq, sc)
                torch.cuda.synchronize()
                abs_e, rel_e = rel_err(got, want)
                check(torch.isfinite(got).all().item(),
                      f"dequant_matmul_grouped non-finite at E={e} m={m} "
                      f"k={k} n={n} {form} {xdt}")
                check(rel_e <= TOL_F32,
                      f"dequant_matmul_grouped E={e} m={m} k={k} n={n} "
                      f"{form} {xdt}: rel err {rel_e:.3g} > {TOL_F32}")
                del got, want
                def kernel():
                    return dequant_matmul_grouped_cuda(x, wq, sc)
                ms, eager = time_ms_graph(kernel), time_ms(kernel)
                plain = time_ms(lambda: dequant_matmul_grouped_ref(x, wq, sc),
                                max_iters=20)
                xf = x.float()
                lib = time_ms_graph(lambda: torch.bmm(xf, w_deq))
                bound, by = _grouped_bound(e, m, k, n, x.element_size(),
                                           sc.numel())
                rows.append({"e": e, "m": m, "k": k, "n": n,
                             "x": str(xdt)[6:], "instance": inst,
                             "scale": form, "calls_per_forward": calls,
                             "weights": names, "max_abs_err": abs_e,
                             "max_rel_err": rel_e, "ms": ms,
                             "eager_ms": eager, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bound,
                             "bound_by": by})
                log(f"[kernels] dequant_matmul_grouped E={e} m={m:3d} "
                    f"k={k:5d} n={n:5d} x={str(xdt)[6:]:8s} ({inst}) "
                    f"scale={form:10s} err {rel_e:.2e}  "
                    f"kernel {ms:.4f} ms (eager {eager:.4f})  plain "
                    f"{plain:.4f}  library {lib:.4f}  bound {bound:.4f} "
                    f"({by})")
            del w_deq
        del wq
    return rows


def phase_kernels_grouped_v3(device):
    """dequant_matmul_grouped at deepseek-v3-671b's expert banks (E = 256,
    bf16 x, the stacked (N,) scale) against its plain version, computed
    GROUPED_V3_CHUNK experts at a time (the same function: each expert's
    product is independent), at 1 and 4 slots' rows.  The torch.bmm
    yardstick multiplies the bank dequantized to bf16 (an f32 bank would
    be 15 GB)."""
    import torch
    from repro_torch.kernels.dequant_matmul.ops import \
        dequant_matmul_grouped_cuda
    from repro_torch.kernels.dequant_matmul.ref import \
        dequant_matmul_grouped_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    e, c = GROUPED_V3_E, GROUPED_V3_CHUNK
    rows = []
    for (k, n), calls, names in GROUPED_V3_SHAPES:
        wq = torch.randint(-127, 128, (e, k, n), generator=gen,
                           device=device, dtype=torch.int8)
        sc = torch.rand((n,), generator=gen, device=device) * 0.01 + 1e-4
        w_bf16 = torch.empty((e, k, n), dtype=torch.bfloat16, device=device)
        for i in range(0, e, c):
            w_bf16[i:i + c] = (wq[i:i + c].float() * sc).to(torch.bfloat16)
        for m in GROUPED_V3_ROWS:
            x = torch.randn((e, m, k), generator=gen, device=device).to(
                torch.bfloat16)

            def plain():
                return torch.cat([dequant_matmul_grouped_ref(
                    x[i:i + c], wq[i:i + c], sc) for i in range(0, e, c)])

            def kernel():
                return dequant_matmul_grouped_cuda(x, wq, sc)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            abs_e, rel_e = rel_err(got, want)
            check(torch.isfinite(got).all().item(),
                  f"dequant_matmul_grouped non-finite at E={e} m={m} k={k} "
                  f"n={n}")
            check(rel_e <= TOL_F32, f"dequant_matmul_grouped E={e} m={m} "
                  f"k={k} n={n}: rel err {rel_e:.3g} > {TOL_F32}")
            del got, want
            ms, eager = time_ms_graph(kernel), time_ms(kernel)
            plain_ms = time_ms(plain, max_iters=5)
            lib = time_ms_graph(lambda: torch.bmm(x, w_bf16))
            bound, by = _grouped_bound(e, m, k, n, 2, n)
            rows.append({"e": e, "m": m, "k": k, "n": n, "x": "bfloat16",
                         "instance": "tc_bf16", "scale": "shared",
                         "calls_per_forward": calls, "weights": names,
                         "max_abs_err": abs_e, "max_rel_err": rel_e,
                         "ms": ms, "eager_ms": eager, "plain_ms": plain_ms,
                         "library_ms": lib, "library_bank": "bfloat16",
                         "bound_ms": bound, "bound_by": by})
            log(f"[kernels] dequant_matmul_grouped E={e} m={m:3d} k={k:5d} "
                f"n={n:5d} x=bfloat16 (tc_bf16) scale=shared err "
                f"{rel_e:.2e}  kernel {ms:.4f} ms (eager {eager:.4f})  "
                f"plain {plain_ms:.4f}  library (bf16 bank) {lib:.4f}  "
                f"bound {bound:.4f} ({by})")
            del x
        del wq, w_bf16
        torch.cuda.empty_cache()
    return rows


def q8_mismatches(flat_raw, device, cpu="cpu"):
    """Entries of the q8 levels and scales of ``flat_raw`` (flat names ->
    tensors) quantized on ``device`` that differ from the CPU's."""
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.compression.tree import unflatten

    def quantized(dev):
        return flatten_tree(quantize_tree_q8(unflatten(
            {k: v.to(dev) for k, v in flat_raw.items()})))
    on_dev, on_cpu = quantized(device), quantized(cpu)
    return sum(int((on_dev[k].cpu() != on_cpu[k]).sum()) for k in on_cpu)


def phase_parity(device, cpu="cpu"):
    """Smoke llama3-8b (f32, q8) on ``device`` and on the CPU from the same
    converted weights: identical greedy tokens, close prefill logits, and
    q8 levels and scales that the card makes identical to the CPU's."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.convert import params_from_numpy, tensor_to_numpy
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.session import ServeConfig, ServeSession

    cfg = configs.get("llama3-8b", smoke=True)
    raw = init_params(cfg, 0, device=cpu)
    flat_q8 = {k: tensor_to_numpy(v)
               for k, v in flatten_tree(quantize_tree_q8(raw)).items()}
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    out = {}
    for dev in (device, cpu):
        tree = params_from_numpy(flat_q8, dev)
        sess = ServeSession(cfg, tree, backend="q8", device=dev,
                            serve_cfg=ServeConfig(slots=4, max_len=32))
        hs = [sess.submit(p, max_new_tokens=12) for p in prompts]
        sess.run()
        logits, _ = prefill(sess.params, cfg,
                            tokens=torch.from_numpy(prompts).to(dev),
                            max_len=32)
        out[str(dev)] = (np.stack([h.result() for h in hs]),
                         logits.float().cpu().numpy())
    (tok_d, lo_d), (tok_c, lo_c) = out[str(device)], out[cpu]
    check(np.array_equal(tok_d, tok_c),
          f"greedy tokens differ between {device} and cpu:\n{tok_d}\n{tok_c}")
    err = float(np.max(np.abs(lo_d - lo_c)) / np.max(np.abs(lo_c)))
    check(err <= TOL_F32 * 10, f"prefill logits differ: rel {err:.3g}")
    # the card's quantization against the CPU's, on the f32 smoke tree and
    # on its bf16 cast (the full-width tree is bf16)
    mism = {str(dt)[6:]: q8_mismatches(
        {k: v.to(dt) for k, v in flatten_tree(raw).items()}, device)
        for dt in (torch.float32, torch.bfloat16)}
    check(not any(mism.values()), f"q8 entries quantized on {device} that "
          f"differ from the CPU's: {mism}")
    log(f"[parity] smoke q8 f32: {tok_d.size} greedy tokens identical on "
        f"{device} and cpu; prefill logits rel diff {err:.2e}; q8 levels "
        f"and scales made on the card equal the CPU's (f32 and bf16 trees)")
    return {"tokens_identical": True, "logits_rel_diff": err,
            "q8_mismatch_card_vs_cpu": mism}


def rd_policy_rules(leaves: dict) -> dict:
    """Policy payload over ``leaves`` (flat name -> tensor): Delta =
    RD_DELTA_REL * std of the tensor (of layer 0 for a stacked leaf),
    lambda RD_LAM, the operating point the committed sweep chose."""
    from repro_torch.compression.quantizers import relative_step
    rules = {}
    for name, w in leaves.items():
        sample = w[0] if name.startswith("layers/") else w
        rules[name] = {"step": relative_step(sample, RD_DELTA_REL),
                       "lam": RD_LAM, "kind": "rd-grid"}
    return {"format": "repro-tensor-policy", "version": 1,
            "meta": {"delta_rel": RD_DELTA_REL, "lam": RD_LAM}, "rules": rules}


def covered_leaves(params) -> dict:
    """The leaves deepcabac-rd quantizes: float tensors of rank >= 2."""
    from repro_torch.compression import flatten_tree
    return {k: v for k, v in flatten_tree(params).items()
            if v.dim() >= 2 and v.is_floating_point()}


def _rd_bound(n, elt, passes, window=RD_WINDOW, fisher=False):
    """Least time of ``passes`` rd_quant passes over n elements: each pass
    reads w and writes int32 levels, every pass after the first reads the
    previous levels; the operations at the un-fused issue rate."""
    nbytes = n * (passes * (elt + 4) + (passes - 1) * 4 + (4 * passes
                                                          if fisher else 0))
    ops = n * passes * (RD_OPS_NN + (2 * window + 2)
                        * (RD_OPS_CAND + (1 if fisher else 0)))
    t_b, t_f = nbytes / HBM_BYTES_PER_S, ops / ISSUE_OPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), \
        t_b * 1e3, t_f * 1e3


def phase_kernels_rd(params, policy):
    """rd_quant against its plain version on layer 0 of every covered
    full-width leaf, embed and head: levels must be equal exactly."""
    import torch
    from repro_torch.compression.rd_search import nearest_level_f64
    from repro_torch.core.rate_model import estimate_bin_probs_torch
    from repro_torch.kernels.rd_quant import rd_quant
    from repro_torch.kernels.rd_quant.coeffs import pack_coeffs
    from repro_torch.kernels.rd_quant.ref import rd_quant_ref

    rows = []
    for name, w in covered_leaves(params).items():
        x = (w[0] if name.startswith("layers/") else w).reshape(-1)
        step = policy["rules"][name]["step"]
        nn, amax = nearest_level_f64(x, step)
        probs = estimate_bin_probs_torch(nn)
        del nn
        sc, mg = pack_coeffs(probs)
        kw = dict(step=step, lam=RD_LAM, window=RD_WINDOW,
                  max_level=amax + RD_WINDOW + 1, passes=RD_PASSES)
        # the public wrapper, as rd_assign_levels calls it; the plain
        # version on the same card tensor
        got = rd_quant(x, None, probs, **kw)
        want = rd_quant_ref(x, None, sc, mg, num_gr=probs.num_gr, **kw)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max().item())
        mism = int((got != want).sum().item())
        check(mism == 0, f"rd_quant {name} layer 0 {tuple(x.shape)}: {mism} "
              f"levels differ from the plain version (max |diff| {diff})")
        nz = float((got != 0).float().mean().item())
        del got, want
        ms = time_ms(lambda: rd_quant(x, None, probs, **kw))
        plain = time_ms(lambda: rd_quant_ref(x, None, sc, mg,
                                             num_gr=probs.num_gr, **kw),
                        max_iters=3)
        bound, by, t_b, t_f = _rd_bound(x.numel(), x.element_size(),
                                        RD_PASSES)
        shape = tuple(w.shape[1:] if name.startswith("layers/") else w.shape)
        rows.append({"leaf": name, "shape": list(shape), "n": x.numel(),
                     "dtype": str(x.dtype)[6:], "step": step,
                     "max_level": kw["max_level"], "nonzero_share": nz,
                     "max_abs_err": diff, "mismatches": mism, "ms": ms,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "bytes_ms": t_b, "ops_ms": t_f, "library_ms": None})
        log(f"[kernels] rd_quant {name:18s} {str(shape):16s} levels equal "
            f"(max_level {kw['max_level']}, nonzero {nz:.3f})  kernel "
            f"{ms:.4f} ms  plain {plain:.3f}  bound {bound:.4f} ({by})")
    return rows


def phase_parity_codec(device, cpu="cpu"):
    """The smoke tree's containers written from the card equal the CPU's
    byte for byte (deepcabac-rd: the kernel on the card, its plain version
    on the CPU), and a container served on the card gives the CPU's greedy
    tokens."""
    import numpy as np
    import torch
    from repro_torch import compression, configs
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine

    cfg = configs.get("llama3-8b", smoke=True)
    raw = init_params(cfg, 0, device=cpu)
    policy = rd_policy_rules(covered_leaves(raw))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tree = {k: v.to(dt) for k, v in compression.flatten_tree(raw).items()}
        on_dev = {k: v.to(device) for k, v in tree.items()}
        res = {}
        for name, kw in (("deepcabac-rd", {"policy_table": policy,
                                            "assign": "kernel"}),
                         ("serve-q8", {}),
                         ("deepcabac-v3", {"delta_rel": RD_DELTA_REL,
                                           "lam": RD_LAM})):
            registry.reset_launch_counts()
            blob_dev = compression.get(name, **kw).compress(on_dev).blob
            launches = registry.launch_counts()["rd_quant"]
            blob_cpu = compression.get(name, **kw).compress(tree).blob
            check(blob_dev == blob_cpu, f"{name} {dt}: the container written "
                  f"from {device} differs from the CPU's ({len(blob_dev)} vs "
                  f"{len(blob_cpu)} bytes)")
            if name == "deepcabac-rd" and torch.device(device).type == \
                    "cuda":
                want = 2 * RD_PASSES * len(policy["rules"])
                check(launches == want, f"deepcabac-rd on {device}: "
                      f"{launches} rd_quant launches, want {want}")
            res[name] = {"bytes": len(blob_dev), "rd_quant_launches":
                         launches}
        out[str(dt)[6:]] = res
    blob = compression.get("deepcabac-rd", policy_table=policy,
                           assign="kernel").compress(
        {k: v.to(device) for k, v in compression.flatten_tree(raw).items()}
    ).blob
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    for backend in ("container", "q8"):
        toks = [ServeEngine.from_compressed(cfg, blob, max_len=32,
                                            backend=backend, device=dev
                                            ).generate(prompts, 12)
                for dev in (device, cpu)]
        check(np.array_equal(toks[0], toks[1]), f"{backend}: greedy tokens "
              f"from the container differ between {device} and cpu")
        out[f"served_{backend}"] = "tokens identical"
    log(f"[parity] codec: deepcabac-rd / serve-q8 / deepcabac-v3 containers "
        f"from {device} equal the CPU's byte for byte (f32 and bf16); "
        f"container served on {device} = cpu greedy tokens (container, q8)")
    return out


def phase_parity_moe(device, cpu="cpu"):
    """Smoke deepseek-moe-16b (f32, q8) on ``device`` and on the CPU from
    the same converted weights, once as configured and once with the
    capacity factor lowered so that tokens are dropped: identical greedy
    tokens, close prefill logits, and q8 levels and scales (the 4-D expert
    banks included) that the card makes identical to the CPU's."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.convert import params_from_numpy, tensor_to_numpy
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.session import ServeConfig, ServeSession

    cfg = configs.get("deepseek-moe-16b", smoke=True)
    # 40-token prompts at capacity factor 0.25: each row routes 2 x 40
    # tokens to 8 experts of capacity 8, so at least 16 are dropped per
    # row and MoE layer at prefill
    cases = (("smoke", cfg, 16), ("drops", cfg.replace(capacity_factor=0.25),
                                  40))
    dcfg, dlen = cases[1][1], cases[1][2]
    dropped = dlen * dcfg.top_k - dcfg.num_experts * moe_capacity(dlen, dcfg)
    check(dropped > 0, f"the drop case drops nothing: {dropped}")
    raw = init_params(cfg, 0, device=cpu)
    flat_q8 = {k: tensor_to_numpy(v)
               for k, v in flatten_tree(quantize_tree_q8(raw)).items()}
    rng = np.random.default_rng(2)
    prompts_of = {name: rng.integers(0, cfg.vocab_size, (4, plen)).astype(
        np.int32) for name, _, plen in cases}
    out = {}
    for dev in (device, cpu):
        tree = params_from_numpy(flat_q8, dev)
        for name, c, plen in cases:
            prompts = prompts_of[name]
            sess = ServeSession(c, tree, backend="q8", device=dev,
                                serve_cfg=ServeConfig(slots=4,
                                                      max_len=plen + 12))
            hs = [sess.submit(p, max_new_tokens=12) for p in prompts]
            sess.run()
            logits, _ = prefill(sess.params, c,
                                tokens=torch.from_numpy(prompts).to(dev),
                                max_len=plen + 12)
            out[name, str(dev)] = (np.stack([h.result() for h in hs]),
                                   logits.float().cpu().numpy())
    err = 0.0
    for name, _, _ in cases:
        (tok_d, lo_d), (tok_c, lo_c) = out[name, str(device)], out[name, cpu]
        check(np.array_equal(tok_d, tok_c), f"moe {name}: greedy tokens "
              f"differ between {device} and cpu:\n{tok_d}\n{tok_c}")
        err = max(err, float(np.max(np.abs(lo_d - lo_c))
                             / np.max(np.abs(lo_c))))
    check(err <= TOL_F32 * 10, f"moe prefill logits differ: rel {err:.3g}")
    mism = {str(dt)[6:]: q8_mismatches(
        {k: v.to(dt) for k, v in flatten_tree(raw).items()}, device)
        for dt in (torch.float32, torch.bfloat16)}
    check(not any(mism.values()), f"moe q8 entries quantized on {device} "
          f"that differ from the CPU's: {mism}")
    log(f"[parity] smoke deepseek-moe-16b q8 f32: greedy tokens identical on "
        f"{device} and cpu, as configured and with >= {dropped} tokens "
        f"dropped per row and MoE layer at prefill; prefill logits rel diff "
        f"{err:.2e}; q8 levels and scales (4-D expert banks included) made "
        f"on the card equal the CPU's (f32 and bf16 trees)")
    return {"tokens_identical": True, "logits_rel_diff": err,
            "q8_mismatch_card_vs_cpu": mism,
            "drops": {"capacity_factor": dcfg.capacity_factor,
                      "prompt_len": dlen,
                      "dropped_per_row_at_least": dropped}}


def phase_parity_moe_bf16(device, cpu="cpu"):
    """Smoke deepseek-moe-16b in bf16 (params and compute), q8, on
    ``device`` and on the CPU from the same converted weights: the path of
    the full-width models' bf16 kernel instances (flash attention's and the
    grouped matmul's tensor-core ones) held at model level.  Prefill logits
    must agree within TOL_MOE_BF16_LOGITS of max|logit|; greedy tokens that
    differ are counted, 0 expected, and any fails the phase."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.convert import params_from_numpy, tensor_to_numpy
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.session import ServeConfig, ServeSession

    cfg = configs.get("deepseek-moe-16b", smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    raw = init_params(cfg, 0, device=cpu)
    flat_q8 = {k: tensor_to_numpy(v)
               for k, v in flatten_tree(quantize_tree_q8(raw)).items()}
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    out, launches = {}, None
    for dev in (device, cpu):
        tree = params_from_numpy(flat_q8, dev)
        sess = ServeSession(cfg, tree, backend="q8", device=dev,
                            serve_cfg=ServeConfig(slots=4, max_len=28))
        hs = [sess.submit(p, max_new_tokens=12) for p in prompts]
        registry.reset_launch_counts()
        sess.run()
        if dev == device:
            launches = registry.launch_counts()
        logits, _ = prefill(sess.params, cfg,
                            tokens=torch.from_numpy(prompts).to(dev),
                            max_len=28)
        out[str(dev)] = (np.stack([h.result() for h in hs]),
                         logits.float().cpu().numpy())
    (tok_d, lo_d), (tok_c, lo_c) = out[str(device)], out[cpu]
    check(np.isfinite(lo_d).all(), "moe bf16 smoke: non-finite logits")
    err = float(np.max(np.abs(lo_d - lo_c)) / np.max(np.abs(lo_c)))
    differ = int((tok_d != tok_c).sum())
    log(f"[parity] smoke deepseek-moe-16b q8 bf16: prefill logits rel diff "
        f"{err:.2e} (tolerance {TOL_MOE_BF16_LOGITS}); {differ} of "
        f"{tok_d.size} greedy tokens differ between {device} and cpu; "
        f"launches on the card {launches}")
    check(launches["dequant_matmul_grouped"] > 0 and
          launches["flash_attention"] > 0,
          f"moe bf16 smoke: the bf16 kernels did not run: {launches}")
    check(err <= TOL_MOE_BF16_LOGITS,
          f"moe bf16 prefill logits differ: rel {err:.3g}")
    check(differ == 0, f"moe bf16 smoke: {differ} greedy tokens differ "
          f"between {device} and cpu:\n{tok_d}\n{tok_c}")
    return {"logits_rel_diff": err, "tokens_differ": differ,
            "tokens": int(tok_d.size), "launches": launches}


def clear_reports() -> None:
    """Empty the dispatch report and the model's set of loop-dequantized
    tensors already reported (each is recorded once per process), so that
    a phase's report does not depend on the phases before it."""
    from repro_torch.kernels import registry
    from repro_torch.models import transformer
    transformer._reported_loop_dequant.clear()
    registry.clear_dispatch_report()


def _record_key(r) -> tuple:
    """(op, kind, reason) of a record; a loop dequant's reason is the
    tensor's name."""
    reason = r["reason"]
    if r["kind"] == "loop_dequant":
        reason = reason.split(":", 1)[0]
    return (r["op"], r["kind"], reason)


def allowed_records(cfg, backend="q8") -> set:
    """The dispatch records a run of ``cfg`` may leave: MLA's attention has
    d != dv, so its prefills take the scan, recorded, as the reference's
    do (``repro/kernels/flash_attention/ops.py``); an SSM or hybrid model
    on q8 dequantizes its mixer tensors in the loop, recorded once each
    (LOOP_DEQUANT), as the reference's does; nothing else."""
    out = set()
    if cfg.attention == "mla":
        d = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        out.add(("flash_attention", "fallback",
                 f"d != dv ({d} != {cfg.v_head_dim})"))
    if cfg.family in ("ssm", "hybrid") and backend == "q8":
        out |= {("dequant_matmul", "loop_dequant", n) for n in LOOP_DEQUANT}
    return out


def report_ok(cfg, report, backend="q8") -> bool:
    """Every record allowed, and every allowed record present (MLA's
    prefills ran the scan, once a call; the SSM's mixers were dequantized
    in the loop, recorded once a tensor)."""
    got = [_record_key(r) for r in report]
    loops = [k for k in got if k[1] == "loop_dequant"]
    return len(loops) == len(set(loops)) and set(got) == allowed_records(
        cfg, backend)


def pos3d_grid(b, gh, gw, n_text, device):
    """(3, b, gh * gw + n_text) M-RoPE streams of an image followed by
    text: a (gh, gw) patch grid (t = 0, h = row, w = column), then text
    positions from max(gh, gw) on, equal in all three streams."""
    import torch
    hh = torch.arange(gh * gw) // gw
    ww = torch.arange(gh * gw) % gw
    text = max(gh, gw) + torch.arange(n_text)
    st = torch.stack([torch.cat([torch.zeros(gh * gw, dtype=torch.long),
                                 text]), torch.cat([hh, text]),
                      torch.cat([ww, text])])
    return st[:, None, :].expand(3, b, st.shape[1]).contiguous().to(device)


def embed_inputs(cfg, b, s, seed, device, dtype=None):
    """A prompt of precomputed embeddings (b, s, d), its pos3d for an
    M-RoPE model (a patch grid over half the prompt, then text), and the
    stub frontend's table (EMBED_TABLE_ROWS, d): made on the CPU from a
    seeded generator and moved, so the card and the CPU see the same."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dt = dtype or getattr(torch, cfg.compute_dtype)
    emb = torch.randn((b, s, cfg.d_model), generator=g).to(dt)
    table = torch.randn((min(EMBED_TABLE_ROWS, cfg.vocab_size),
                         cfg.d_model), generator=g).to(dt)
    pos3d = None
    if cfg.m_rope:
        side = max(int((s // 2) ** 0.5), 1)
        pos3d = pos3d_grid(b, side, side, s - side * side, "cpu")
    return (emb.to(device), None if pos3d is None else pos3d.to(device),
            table.to(device))


def greedy_embeds(params, cfg, embeds, pos3d, table, new_tokens):
    """An embeddings model's greedy loop: ``prefill(embeds=...)``, then
    ``new_tokens - 1`` decode steps, each fed the stub table's row of the
    last token (t % rows) and, for M-RoPE, the text position after the
    prompt's largest.  Returns (tokens (B, new_tokens), prefill logits
    (B, V) f32 on the host, prefill ms, decode ms per step), by the host
    clock around synchronised work."""
    import torch
    from repro_torch.models.transformer import decode_step, prefill
    b, s = embeds.shape[:2]
    on_card = embeds.is_cuda

    def sync():
        if on_card:
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, embeds=embeds, pos3d=pos3d,
                             max_len=s + new_tokens)
    tok = logits.argmax(-1)
    sync()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    first = logits.float().cpu().numpy()
    toks = [tok]
    nxt = None if pos3d is None else pos3d.amax(dim=(0, 2)) + 1     # (B,)
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        e = table[tok % table.shape[0]][:, None, :]
        p3 = None if nxt is None else (nxt + i)[None, :, None].expand(3, b,
                                                                      1)
        logits, caches = decode_step(params, cfg, caches, s + i, embeds=e,
                                     pos3d=p3)
        tok = logits.argmax(-1)
        toks.append(tok)
    sync()
    decode_ms = 1e3 * (time.perf_counter() - t0) / max(new_tokens - 1, 1)
    return (torch.stack(toks, 1).cpu().numpy(), first, prefill_ms,
            decode_ms)


def phase_parity_variants(device, cpu="cpu"):
    """The six other smoke models (VARIANTS: qk-norm, QKV bias, M-RoPE and
    embeddings in, layernorm and gelu, MLA) in f32 on q8, and qwen2-vl-7b
    once more in bf16, on ``device`` and on the CPU from the same converted
    weights: identical greedy tokens (token models through the session,
    embeddings models through ``greedy_embeds``), close prefill logits,
    q8 levels and scales made on the card equal to the CPU's, and
    dispatch reports that hold only MLA's d != dv records."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.convert import params_from_numpy, tensor_to_numpy
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.session import ServeConfig, ServeSession

    cases = [(a, "float32") for a in VARIANTS] + [("qwen2-vl-7b",
                                                    "bfloat16")]
    res = {}
    for arch, dtype in cases:
        cfg = configs.get(arch, smoke=True).replace(param_dtype=dtype,
                                                    compute_dtype=dtype)
        raw = init_params(cfg, 0, device=cpu)
        flat_q8 = {k: tensor_to_numpy(v)
                   for k, v in flatten_tree(quantize_tree_q8(raw)).items()}
        rng = np.random.default_rng(6)
        prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        out = {}
        for dev in (device, cpu):
            tree = params_from_numpy(flat_q8, dev)
            clear_reports()
            registry.reset_launch_counts()
            if cfg.embed_input:
                sess = ServeSession(cfg, tree, backend="q8", device=dev,
                                    serve_cfg=ServeConfig(slots=4,
                                                          max_len=28))
                hs = [sess.submit(p, max_new_tokens=12) for p in prompts]
                sess.run()
                tokens = np.stack([h.result() for h in hs])
                logits, _ = prefill(sess.params, cfg,
                                    tokens=torch.from_numpy(prompts).to(dev),
                                    max_len=28)
                logits = logits.float().cpu().numpy()
            else:
                emb, p3, table = embed_inputs(cfg, 4, 16, 6, dev)
                tokens, logits, _, _ = greedy_embeds(tree, cfg, emb, p3,
                                                     table, 12)
            out[str(dev)] = (tokens, logits, registry.launch_counts(),
                             registry.dispatch_report())
        (tok_d, lo_d, launches, report), (tok_c, lo_c, _, _) = \
            out[str(device)], out[cpu]
        what = f"{arch} {dtype} smoke"
        err = float(np.max(np.abs(lo_d - lo_c)) / np.max(np.abs(lo_c)))
        tol = TOL_VARIANT_LOGITS
        mism = q8_mismatches(flatten_tree(raw), device)
        differ = int((tok_d != tok_c).sum())
        log(f"[parity] {what} q8: {differ} of {tok_d.size} greedy tokens "
            f"differ between {device} and cpu; prefill logits rel diff "
            f"{err:.2e} (tolerance {tol}); card launches {launches}; "
            f"q8 mismatches {mism}; report {len(report)} records "
            f"{sorted({r['reason'] for r in report})}")
        check(np.isfinite(lo_d).all(), f"{what}: non-finite logits")
        check(differ == 0, f"{what}: greedy tokens differ between "
              f"{device} and cpu:\n{tok_d}\n{tok_c}")
        check(err <= tol, f"{what}: prefill logits differ: rel {err:.3g}")
        check(mism == 0, f"{what}: {mism} q8 entries quantized on {device} "
              "differ from the CPU's")
        on_card = torch.device(device).type == "cuda"
        check(not on_card or report_ok(cfg, report), f"{what}: dispatch "
              f"report {report}, want only {allowed_records(cfg)}")
        check(not on_card or launches["dequant_matmul"] > 0 and
              (launches["flash_attention"] > 0) == (cfg.attention != "mla")
              and (launches["dequant_matmul_grouped"] > 0) ==
              (cfg.family == "moe"),
              f"{what}: the card's launches {launches} are not the path's")
        res[f"{arch}/{dtype}"] = {"logits_rel_diff": err,
                                  "tokens_differ": differ,
                                  "launches": launches,
                                  "report": sorted({r["reason"]
                                                    for r in report}),
                                  "q8_mismatch_card_vs_cpu": mism}
    return res


def _session_tokens(cfg, tree, device, prompts, new_tokens, eager=False):
    """Greedy tokens of ``prompts`` (a list of 1-D int32 arrays) through a
    q8 session over 4 slots on ``device`` (from CUDA graphs on the card
    unless ``eager``), as a list per request."""
    import contextlib

    from repro_torch.serve.session import (ServeConfig, ServeSession,
                                           eager_steps)
    with eager_steps() if eager else contextlib.nullcontext():
        sess = ServeSession(cfg, tree, backend="q8", device=device,
                            serve_cfg=ServeConfig(
                                slots=4, max_len=max(map(len, prompts))
                                + new_tokens))
        hs = [sess.submit(p, max_new_tokens=new_tokens) for p in prompts]
        sess.run()
    return [h.tokens for h in hs], sess.params


def phase_parity_ssm(device, cpu="cpu"):
    """The SSM and hybrid smoke models (mamba2-2.7b, zamba2-2.7b) in f32 and
    in bf16 on q8, on ``device`` and on the CPU from the same converted
    weights: prompts of mixed lengths (SSM_PROMPT_LENS, a 1-token prompt
    among them) through the session, greedy tokens identical on both
    devices and, on the card, from graphs and eagerly; prefill logits
    within TOL_VARIANT_LOGITS of max|logit|; q8 levels and scales made on
    the card equal to the CPU's; reports that hold exactly the reference's
    loop-dequant records (LOOP_DEQUANT)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.convert import params_from_numpy, tensor_to_numpy
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import init_params, prefill

    res = {}
    for arch in SSM_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = configs.get(arch, smoke=True).replace(param_dtype=dtype,
                                                        compute_dtype=dtype)
            raw = init_params(cfg, 0, device=cpu)
            flat_q8 = {k: tensor_to_numpy(v) for k, v in
                       flatten_tree(quantize_tree_q8(raw)).items()}
            rng = np.random.default_rng(7)
            prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
                       for n in SSM_PROMPT_LENS]
            batch = np.stack([p for p in prompts if len(p) == 16])
            out = {}
            for dev in (device, cpu):
                tree = params_from_numpy(flat_q8, dev)
                clear_reports()
                registry.reset_launch_counts()
                tokens, params = _session_tokens(cfg, tree, dev, prompts, 12)
                launches = registry.launch_counts()
                report = registry.dispatch_report()
                eager, _ = _session_tokens(cfg, tree, dev, prompts, 12,
                                           eager=True)
                logits, _ = prefill(params, cfg,
                                    tokens=torch.from_numpy(batch).to(dev),
                                    max_len=28)
                out[str(dev)] = (tokens, eager, logits.float().cpu().numpy(),
                                 launches, report)
            (tok_d, eag_d, lo_d, launches, report), (tok_c, _, lo_c, _,
                                                     rep_c) = \
                out[str(device)], out[cpu]
            what = f"{arch} {dtype} smoke"
            err = float(np.max(np.abs(lo_d - lo_c)) / np.max(np.abs(lo_c)))
            differ = sum(a != b for t, u in zip(tok_d, tok_c)
                         for a, b in zip(t, u)) + sum(
                len(t) != len(u) for t, u in zip(tok_d, tok_c))
            graph_differ = sum(a != b for t, u in zip(tok_d, eag_d)
                               for a, b in zip(t, u))
            mism = q8_mismatches(flatten_tree(raw), device)
            names = sorted(_record_key(r)[2] for r in report)
            log(f"[parity] {what} q8: {differ} of "
                f"{sum(map(len, tok_c))} greedy tokens differ between "
                f"{device} and cpu, {graph_differ} between graphs and eager; "
                f"prefill logits rel diff {err:.2e} (tolerance "
                f"{TOL_VARIANT_LOGITS}); card launches {launches}; q8 "
                f"mismatches {mism}; report {names}")
            check(np.isfinite(lo_d).all(), f"{what}: non-finite logits")
            check(differ == 0, f"{what}: greedy tokens differ between "
                  f"{device} and cpu:\n{tok_d}\n{tok_c}")
            check(graph_differ == 0, f"{what}: graph tokens differ from the "
                  f"eager ones:\n{tok_d}\n{eag_d}")
            check(err <= TOL_VARIANT_LOGITS, f"{what}: prefill logits "
                  f"differ: rel {err:.3g}")
            check(mism == 0, f"{what}: {mism} q8 entries quantized on "
                  f"{device} differ from the CPU's")
            for rep_ in (report, rep_c):
                check(report_ok(cfg, rep_), f"{what}: dispatch report "
                      f"{rep_}, want only {allowed_records(cfg)}")
            on_card = torch.device(device).type == "cuda"
            check(not on_card or launches["dequant_matmul"] > 0 and
                  (launches["flash_attention"] > 0) ==
                  (cfg.family == "hybrid") and
                  launches["dequant_matmul_grouped"] == 0,
                  f"{what}: the card's launches {launches} are not the "
                  "path's")
            res[f"{arch}/{dtype}"] = {"logits_rel_diff": err,
                                      "tokens_differ": differ,
                                      "graph_tokens_differ": graph_differ,
                                      "launches": launches,
                                      "report": names,
                                      "q8_mismatch_card_vs_cpu": mism}
    return res


def phase_deploy_rd(params, policy):
    """Eq. (11) assignment of every covered leaf of the full-width tree
    through the kernel (the tentpole's device route), traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.compression.rd_search import rd_assign_levels
    from repro_torch.core.rate_model import estimate_level_bits_torch
    from repro_torch.kernels import registry

    leaves = covered_leaves(params)
    n_total = sum(w.numel() for w in leaves.values())
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    bits = {}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, w in leaves.items():
            rule = policy["rules"][name]
            lv = rd_assign_levels(w, rule["step"], rule["lam"],
                                  window=RD_WINDOW, passes=RD_PASSES)
            bits[name] = estimate_level_bits_torch(lv)
            del lv
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launch_counts()["rd_quant"]
    want = 2 * RD_PASSES * len(leaves)
    check(launches == want, f"full-tree RD assignment: {launches} rd_quant "
          f"launches, want {want}")
    events = prof.key_averages()
    kern = _kernel_ms(events, "rd_quant_pass")
    busy, top = _device_time(events)
    check(kern > 0, "the profiler saw no rd_quant_pass device time")
    # 1 + 1 refinement assignments of RD_PASSES passes each
    _, _, t_b, t_f = _rd_bound(n_total, 2, RD_PASSES)
    t_b, t_f = 2 * t_b, 2 * t_f
    bound, by = max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
    bpp = sum(bits.values()) / n_total
    log(f"[deploy] RD assignment of the full tree ({len(leaves)} leaves, "
        f"{n_total / 1e9:.3f} G values): {launches} rd_quant launches, "
        f"kernel {kern:.2f} ms on the device against a {bound:.2f} ms bound "
        f"({by}), device busy {busy:.1f} ms, wall {wall:.2f} s; rate model "
        f"{bpp:.4f} bits/param")
    return {"leaves": len(leaves), "values": n_total, "launches": launches,
            "kernel_ms": kern, "bound_ms": bound, "bound_by": by,
            "bytes_ms": t_b, "ops_ms": t_f, "device_busy_ms": busy,
            "top_device_ms": dict(top), "wall_s": wall,
            "bits_per_param": bpp, "bits_by_leaf": bits}


def phase_deploy_serve(device):
    """Full width cut to DEPLOY_SERVE_LAYERS layers: deepcabac-rd container
    from the card, served from the blob on q8, against a session on the
    in-memory tree with the same policy applied.  The host CABAC decode
    rate is the q8 load's own record decodes.  (Its load on the container
    backend, another host decode of the blob, was cut for time;
    ``phase_container_moe`` serves a full-width container there.)"""
    import numpy as np
    import torch
    from repro_torch import compression, configs
    from repro_torch.core import codec as core_codec
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.backends import get_backend

    cfg = configs.get("llama3-8b").replace(
        num_layers=DEPLOY_SERVE_LAYERS)
    params = init_params(cfg, 0, device=device)
    leaves = covered_leaves(params)
    policy = rd_policy_rules(leaves)
    n_params = sum(v.numel() for v in
                   compression.flatten_tree(params).values())
    n_coded = sum(v.numel() for v in leaves.values())
    codec = compression.get("deepcabac-rd", policy_table=policy)
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    entries = codec.quantize_entries(params)          # the kernel route
    torch.cuda.synchronize()
    rd_s = time.perf_counter() - t0
    launches = registry.launch_counts()["rd_quant"]
    check(launches == 2 * RD_PASSES * len(leaves),
          f"deploy encode: {launches} rd_quant launches, want "
          f"{2 * RD_PASSES * len(leaves)}")
    t0 = time.perf_counter()
    art = codec.compress_entries(entries)             # host CABAC
    enc_s = time.perf_counter() - t0
    blob, bpp = art.blob, art.report["bits_per_param"]
    del entries, art                     # the host levels (int64) go
    log(f"[deploy] llama3-8b full width, {DEPLOY_SERVE_LAYERS} layers: "
        f"{n_params / 1e9:.3f} G params, {n_coded / 1e9:.3f} G RD-coded "
        f"({len(leaves)} leaves, embed and head included); RD on the card "
        f"{rd_s:.2f} s ({launches} rd_quant launches); host CABAC encode "
        f"{enc_s:.1f} s ({n_coded / enc_s / 1e6:.1f} M values/s) on the card "
        f"machine's host; blob {len(blob) / 2**20:.1f} MiB, "
        f"{bpp:.4f} bits/param")
    # the reference invariant: the tree with the policy applied serves the
    # container's weights (its RD assignment runs through the kernel again)
    tree_pol = get_backend("bf16", policy_table=policy).load(cfg, params)
    del params
    gc.collect()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    new_tokens = 32
    per_fwd = per_forward_launches(cfg)["dequant_matmul"]
    out = {"layers": DEPLOY_SERVE_LAYERS, "params": n_params,
           "rd_coded": n_coded,
           "leaves": len(leaves), "rd_quant_launches": launches,
           "rd_s": rd_s, "encode_s": enc_s,
           "encode_values_per_s": n_coded / enc_s, "blob_bytes": len(blob),
           "bits_per_param": bpp,
           "policy_steps": {k: r["step"] for k, r in policy["rules"].items()}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = _PartClock()
    clock.wrap(core_codec, "decode_record", "decode")
    t0 = time.perf_counter()
    try:
        eng = ServeEngine.from_compressed(cfg, blob, max_len=160,
                                          backend="q8", device=device)
        torch.cuda.synchronize()
    finally:
        clock.restore()
    load_s = time.perf_counter() - t0
    dec_s = clock.secs["decode"]
    out.update(decode_s=dec_s, decode_values_per_s=n_coded / dec_s)
    log(f"[deploy] host CABAC decode {dec_s:.1f} s ("
        f"{n_coded / dec_s / 1e6:.1f} M values/s) of the q8 load's "
        f"records")
    clear_reports()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = registry.launch_counts()
    report = registry.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    fwd = 1 + eng._session(len(prompts)).stats["decode_steps"]
    ref = ServeEngine(cfg, tree_pol, max_len=160, backend="q8",
                      device=device).generate(prompts, new_tokens)
    check(np.array_equal(toks, ref), "deploy q8: greedy tokens from the "
          "container differ from the policy-applied tree's")
    check(not report, f"deploy q8: dispatch report not empty: {report}")
    check(counts["flash_attention"] == cfg.num_layers,
          f"deploy q8: {counts['flash_attention']} flash launches, want "
          f"{cfg.num_layers} (one prefill)")
    check(counts["dequant_matmul"] == per_fwd * fwd,
          f"deploy q8: {counts['dequant_matmul']} dequant_matmul "
          f"launches, want {per_fwd} x {fwd} passes")
    out["q8"] = {"load_s": load_s, "generate_s": gen_s,
                 "forward_passes": fwd, "launches": counts,
                 "dispatch_report": report, "max_memory_allocated": peak,
                 "tokens_equal_policy_tree": True,
                 "first_row_tail": toks[0, -8:].tolist()}
    log(f"[deploy] q8: load {load_s:.1f} s (decode + transfer), "
        f"4 x 128 + 32 greedy in {gen_s:.2f} s, tokens equal the "
        f"policy-applied tree's, launches {counts}, peak "
        f"{peak / 2**30:.2f} GiB")
    del eng
    del tree_pol
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_step(cfg, params, opt, acfg, step):
    """One AdamW step of ``train_loss`` on the pipeline's batch ``step``
    (FIM_BATCH x FIM_SEQ), ``params`` and ``opt`` updated in place;
    returns the loss."""
    import torch
    from repro_torch.compression.tree import flatten_tree, unflatten
    from repro_torch.data.pipeline import make_batch, to_device
    from repro_torch.models.transformer import train_loss
    from repro_torch.optim.adamw import adamw_update

    batch = to_device(make_batch(cfg, step, batch=FIM_BATCH, seq=FIM_SEQ),
                      next(_leaves(params)).device)
    flat = flatten_tree(params)
    leaves = [p.detach().requires_grad_(True) for p in flat.values()]
    loss = train_loss(unflatten(dict(zip(flat, leaves))), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    del leaves
    with torch.no_grad():
        adamw_update(unflatten(dict(zip(flat, grads))), opt, params, acfg)
    return float(loss.detach())


def _tensor_bytes(manifest) -> dict:
    """Payload bytes of a step's manifest by record encoding."""
    out: dict = {}
    for tinfo in manifest["tensors"].values():
        n = sum(s["length"] for s in tinfo["shards"])
        out[tinfo["encoding"]] = out.get(tinfo["encoding"], 0) + n
    return out


def _q8_leaves_equal(got: dict, want: dict) -> list:
    """Names of the serving leaves (q8, q8s and the rest) that differ."""
    import torch
    from repro_torch.compression.tree import flatten_tree
    a, b = flatten_tree(got), flatten_tree(want)
    if sorted(a) != sorted(b):
        return ["<tree structure>"]
    return [k for k in a if a[k].dtype != b[k].dtype
            or not torch.equal(a[k], b[k])]


def _tree_digests(tree) -> dict:
    """sha256 of every serving leaf's bytes (its dtype and shape first),
    read on the host: a tree's fingerprint that outlives the tree."""
    import hashlib

    import torch
    from repro_torch.compression.tree import flatten_tree
    out = {}
    for name, t in flatten_tree(tree).items():
        h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().data)
        out[name] = h.hexdigest()
    return out


def phase_delta_swap(device):
    """Delta ("P-frame") checkpoints and the live weight swap at llama3-8b's
    published widths, cut to DELTA_SWAP_LAYERS layers: the f32 training
    state on the card saved as a sharded keyframe over SWAP_MESH (shard
    math only) and two P-frames, each one AdamW step later, by
    ``CheckpointManager`` (deepcabac-delta, min_quant_ndim=3: the stacked
    layer matrices are CABAC-coded, embed, head and norms stay raw); a
    graph-replaying q8 session cold-started from the keyframe's manifest
    serves 4 x 128 prompt tokens, and each P-frame is swapped in with the
    four requests in flight.  After each swap the resident leaves must
    equal, bit for bit, those of a q8 tree built from the host chain
    decode (each P-frame applied on the host to the previous frame's
    levels, from the keyframe's as its cold start decoded them; the
    keyframe's second decode was cut for time), every coded tensor must
    have changed
    levels, and the decode graph must not be captured again; a request
    admitted after the last swap must give that cold session's prefill
    logits bit for bit and its greedy tokens; the path's kernel launches
    must be ``per_forward_launches``' and the dispatch report empty.

    Hands the ``mesh_restore`` and ``zoo`` phases (``out["handover"]``)
    its chain: the step directories (left on disk unless this phase
    fails), the keyframe's coded levels as the cold start decoded them and
    the host chain decode of the first P-frame (its entries), the leaf
    digests of the three q8 trees (the keyframe's cold start, the chain's
    cold starts of both P-frames), the prompts, and the late request's
    cold prefill logits row and greedy tokens."""
    import resource
    import shutil

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                        MeshSpec, delta, sharded)
    from repro_torch.compression.tree import flatten_tree
    from repro_torch.core import codec as core_codec
    from repro_torch.kernels import registry
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.serve import session as session_mod
    from repro_torch.serve.backends import get_backend
    from repro_torch.serve.session import ServeConfig, ServeSession

    root = ROOT / "build" / "delta_swap"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    check(free >= SWAP_DISK_BYTES, f"delta_swap: {free / 2**30:.1f} GiB free "
          f"under {root}, the phase writes up to "
          f"{SWAP_DISK_BYTES / 2**30:.0f} GiB")
    torch.cuda.reset_peak_memory_stats()
    cfg_t, params = _full_cut(device, num_layers=DELTA_SWAP_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    flat = flatten_tree(params)
    n_params = sum(v.numel() for v in flat.values())
    coded = sorted(k for k, v in flat.items() if v.dim() >= 3)
    n_coded = sum(flat[k].numel() for k in coded)
    del flat
    acfg = AdamWConfig(lr=SWAP_LR)
    opt = adamw_init(params, acfg)
    mgr = CheckpointManager(CheckpointConfig(
        str(root), codec="deepcabac-delta", delta_every=SWAP_DELTA_EVERY,
        sharded=True, min_quant_ndim=3, keep=3))
    mesh = MeshSpec.from_any(SWAP_MESH)
    clock = _PartClock()

    def gc_clock(phase, info, t0=[0.0]):
        # the host's garbage collections while the session serves
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            clock.secs["gc"] = clock.secs.get("gc", 0.0) + \
                time.perf_counter() - t0[0]
    clock.wrap(delta, "encode_delta_chunks_batched", "tc_encode")
    clock.wrap(sharded, "encode_level_chunks_batched", "intra_encode")
    clock.wrap(sharded, "decode_level_chunks_batched", "intra_decode")
    clock.wrap(core_codec, "decode_delta_chunks_batched", "tc_decode")
    clock.wrap(session_mod, "_copy_into", "copy")
    passed = False
    out = {"layers": cfg_t.num_layers, "params": n_params,
           "coded_values": n_coded, "coded_tensors": coded,
           "mesh": SWAP_MESH, "delta_every": SWAP_DELTA_EVERY, "lr": SWAP_LR}
    try:
        save_s, losses = [], []
        for step in SWAP_STEPS:
            if step > SWAP_STEPS[0]:
                losses.append(_train_step(cfg_t, params, opt, acfg, step))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save({"params": params, "step": np.int64(step)}, step,
                     mesh=mesh)
            save_s.append(time.perf_counter() - t0)
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        train_peak = torch.cuda.max_memory_allocated()
        metas, files = [], []
        for step in SWAP_STEPS:
            d = root / f"step_{step:08d}"
            metas.append(json.loads((d / "meta.json").read_text()))
            m = sharded.load_manifest(str(d))
            files.append({"payload_bytes": sharded.manifest_payload_bytes(m),
                          "by_encoding": _tensor_bytes(m)})
        check([m["kind"] for m in metas] == ["keyframe", "delta", "delta"]
              and [m["chain_depth"] for m in metas] == [0, 1, 2],
              "delta_swap: chain "
              f"{[(m['kind'], m['chain_depth']) for m in metas]}")
        enc = dict(clock.secs)
        out.update(save_s=save_s, losses=losses, metas=metas, files=files,
                   train_peak_bytes=train_peak,
                   intra_encode_values_per_s=n_coded / enc["intra_encode"],
                   tc_encode_values_per_s=2 * n_coded / enc["tc_encode"])

        # the server: the full-width model in its serving dtype (bf16),
        # cold-started on q8 from the keyframe's manifest
        cfg = configs.get("llama3-8b").replace(
            num_layers=DELTA_SWAP_LAYERS)
        scfg = ServeConfig(slots=4, max_len=160)
        backend = get_backend("q8", track_levels=True)
        clock.wrap(backend, "_convert", "q8_convert")
        t0 = time.perf_counter()
        sess = ServeSession(cfg, str(root / f"step_{SWAP_STEPS[0]:08d}"),
                            backend=backend, serve_cfg=scfg, device=device)
        torch.cuda.synchronize()
        out["cold_start_s"] = time.perf_counter() - t0
        digests = {SWAP_STEPS[0]: _tree_digests(sess.params)}
        # the keyframe's coded levels as the cold start decoded them on the
        # host: the host chain decode of each P-frame starts from them
        key_levels = dict(backend._levels)
        out["intra_decode_values_per_s"] = \
            n_coded / clock.secs["intra_decode"]
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
        handles = [sess.submit(p, SWAP_NEW_TOKENS) for p in prompts]
        clock.wrap(sess, "_admit", "admit")
        clock.wrap(sess.graphs, "_capture", "capture")
        gc.callbacks.append(gc_clock)
        clear_reports()
        registry.reset_launch_counts()
        tick_ms: list = []

        def ticks(n):
            for _ in range(n):
                t0 = time.perf_counter()
                sess.step()
                tick_ms.append(1e3 * (time.perf_counter() - t0))

        swaps = []
        ticks(SWAP_TICKS)
        for k, step in enumerate(SWAP_STEPS[1:]):
            pre = [list(h.tokens) for h in handles]
            before_levels = dict(backend._levels)
            caps = sess.graphs.stats["captures"]
            part0 = dict(clock.secs)
            t0 = time.perf_counter()
            n_upd = sess.swap_weights(str(root / f"step_{step:08d}"))
            torch.cuda.synchronize()
            swap_s = time.perf_counter() - t0
            split = {p: clock.secs.get(p, 0.0) - part0.get(p, 0.0)
                     for p in ("tc_decode", "q8_convert", "copy")}
            unchanged = [n for n in coded
                         if np.array_equal(before_levels[n].levels,
                                           backend._levels[n].levels)]
            check(not unchanged, f"delta_swap: step {step} changed no level "
                  f"of {unchanged}")
            # the host chain decode of this step: its P-frame on top of
            # the previous frame's levels (the keyframe's from the cold
            # start's decode; its raw leaves are full records in every
            # P-frame)
            t0 = time.perf_counter()
            ents = delta._apply_delta_file(
                dict(key_levels) if k == 0 else ents,
                str(root / f"step_{step:08d}"), None, step)
            chain_s = time.perf_counter() - t0
            if k == 0:                  # mesh_restore's reference (the
                first_ents = dict(ents)  # next P-frame replaces records)
            cold_tree = get_backend("q8").load_entries(cfg, ents,
                                                       device=device)
            digests[step] = _tree_digests(cold_tree)
            bad = _q8_leaves_equal(sess.params, cold_tree)
            check(not bad, f"delta_swap: after the swap of step {step} the "
                  f"resident leaves differ from the chain's cold start: "
                  f"{bad}")
            if k < len(SWAP_STEPS) - 2:
                del cold_tree
                ticks(SWAP_TICKS)
            else:
                while sess.pending:
                    ticks(1)
            check(sess.graphs.stats["captures"] == caps,
                  f"delta_swap: the swap of step {step} was followed by a "
                  f"capture ({caps} -> {sess.graphs.stats['captures']})")
            check(all(h.tokens[:len(p)] == p for h, p in zip(handles, pre)),
                  f"delta_swap: a token emitted before the swap of step "
                  f"{step} changed")
            swaps.append({"step": step, "updated": n_upd, "seconds": swap_s,
                          **{f"{p}_s": v for p, v in split.items()},
                          "chain_restore_s": chain_s,
                          "tc_decode_values_per_s": n_coded /
                          split["tc_decode"]})
        check(all(h.done and len(h.tokens) == SWAP_NEW_TOKENS
                  for h in handles), "delta_swap: a request did not finish")
        # a request admitted after the last swap, on the swapped session
        # and on a session over the chain's cold start
        late = sess.submit(prompts[0], SWAP_LATE_TOKENS)
        sess._admit()
        late_logits = sess.logits[:1].clone()
        sess.run()
        launches = registry.launch_counts()
        report = registry.dispatch_report()
        prefills = 2
        fwd = prefills + sess.stats["decode_steps"]
        per_fwd = per_forward_launches(cfg)
        check(not report, f"delta_swap: dispatch report not empty: {report}")
        check(launches["dequant_matmul"] == per_fwd["dequant_matmul"] * fwd,
              f"delta_swap: {launches['dequant_matmul']} dequant_matmul "
              f"launches, want {per_fwd['dequant_matmul']} x {fwd} passes")
        check(launches["flash_attention"] == cfg.num_layers * prefills,
              f"delta_swap: {launches['flash_attention']} flash launches, "
              f"want {cfg.num_layers} x {prefills} prefills")
        cold = ServeSession.from_loaded(cfg, cold_tree, backend="q8",
                                        serve_cfg=scfg, device=device)
        ref = cold.submit(prompts[0], SWAP_LATE_TOKENS)
        cold._admit()
        check(torch.equal(late_logits, cold.logits[:1]),
              "delta_swap: the late request's prefill logits differ from "
              "the chain's cold start")
        cold.run()
        check(late.tokens == ref.tokens, f"delta_swap: late tokens "
              f"{late.tokens} != the cold start's {ref.tokens}")
        out["handover"] = {
            "root": str(root), "steps": SWAP_STEPS, "digests": digests,
            "prompts": prompts, "key_levels": key_levels,
            "chain_step": SWAP_STEPS[1], "chain_entries": first_ents,
            "late_logits": late_logits.cpu().numpy()[0].copy(),
            "late_tokens": list(ref.tokens)}
        check(bool(torch.isfinite(late_logits).all()) and
              list(late_logits.shape) == [1, cfg.vocab_size],
              "delta_swap: late prefill logits not finite or misshaped")
        del cold, cold_tree, sess, ents, first_ents
        # tick 1 holds the prefill and tick 2 captures the decode graph
        decode_before = float(np.median(tick_ms[2:SWAP_TICKS]))
        decode_after = float(np.median(tick_ms[2 * SWAP_TICKS:]))
        out.update(serve_split_s={p: clock.secs.get(p, 0.0)
                                  for p in ("admit", "capture", "gc")})
        out.update(swaps=swaps, launches=launches, dispatch_report=report,
                   forward_passes=fwd, decode_steps_tick_ms=tick_ms,
                   decode_ms_per_step_before=decode_before,
                   decode_ms_per_step_after=decode_after,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   host_peak_rss_bytes=1024 * resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss,
                   late_tokens=late.tokens)
        passed = True
    finally:
        clock.restore()
        if gc_clock in gc.callbacks:
            gc.callbacks.remove(gc_clock)
        if not passed:               # else the zoo phase removes it after use
            shutil.rmtree(root, ignore_errors=True)
    kb = out["files"]
    bits = [8 * f["payload_bytes"] / n_params for f in kb]
    log(f"[delta_swap] llama3-8b full width, {cfg_t.num_layers} layers "
        f"({n_params / 1e9:.3f} G params, {n_coded / 1e9:.4f} G coded in "
        f"{len(coded)} stacked tensors): saves {_fmt(save_s[0])} s "
        f"(keyframe, sharded over {SWAP_MESH}), "
        f"{_fmt(save_s[1])} and {_fmt(save_s[2])} s (P-frames, one AdamW "
        f"step each, losses {losses}); payloads "
        f"{[f['payload_bytes'] for f in kb]} B = "
        f"{[round(b, 4) for b in bits]} bits/param (by encoding "
        f"{[f['by_encoding'] for f in kb]}); intra encode "
        f"{out['intra_encode_values_per_s'] / 1e6:.1f} M values/s, tc "
        f"encode {out['tc_encode_values_per_s'] / 1e6:.1f} M values/s, "
        f"intra decode {out['intra_decode_values_per_s'] / 1e6:.1f} M "
        f"values/s; q8 cold start from the manifest "
        f"{out['cold_start_s']:.2f} s")
    for i, s in enumerate(out["swaps"]):
        chain = ("the whole chain" if i == 0 else
                 "its link on the previous step's")
        log(f"[delta_swap] swap of step {s['step']} with 4 requests in "
            f"flight: {s['updated']} tensors in {s['seconds']:.2f} s (tc "
            f"decode {s['tc_decode_s']:.2f} s = "
            f"{s['tc_decode_values_per_s'] / 1e6:.1f} M values/s, q8 "
            f"conversion {s['q8_convert_s']:.2f} s, copy_ "
            f"{s['copy_s'] * 1e3:.2f} ms); leaves equal the chain's cold "
            f"start (host chain decode {s['chain_restore_s']:.2f} s, "
            f"{chain}), no capture after it")
    log(f"[delta_swap] decode {decode_before:.2f} ms/step before the swaps, "
        f"{decode_after:.2f} after (ticks 1 and 2: {_fmt(tick_ms[0])} and "
        f"{_fmt(tick_ms[1])} ms; in the serving ticks admissions "
        f"{_fmt(out['serve_split_s']['admit'])} s, the decode graph's "
        f"capture {_fmt(out['serve_split_s']['capture'])} s, host garbage "
        f"collection {_fmt(out['serve_split_s']['gc'])} s); late request "
        f"equals the cold start (prefill logits bit for bit, tokens); "
        f"launches {out['launches']} "
        f"over {out['forward_passes']} forward passes, empty report; peak "
        f"{out['max_memory_allocated'] / 2**30:.2f} GiB on the card "
        f"(training {out['train_peak_bytes'] / 2**30:.2f}), host peak RSS "
        f"{out['host_peak_rss_bytes'] / 2**30:.2f} GiB")
    return out


def _rss_bytes() -> int:
    """Resident set size of this process now (Linux ``/proc``)."""
    import os
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _storages(tree) -> dict:
    """Address -> bytes of each distinct storage under ``tree``'s
    leaves."""
    from repro_torch.compression.tree import flatten_tree
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in flatten_tree(tree).values()}


def phase_zoo(device, swap):
    """The model zoo (``serve.zoo``) at llama3-8b's published widths, cut
    to DELTA_SWAP_LAYERS layers, on delta_swap's chain (no checkpoint of
    its own): ``base``, ``v1`` and ``v2`` registered from its steps 1, 2
    and 3 into one ShardStore, served on q8 under a budget of 2.5
    models' ``model_resident_bytes`` through ``ZooRouter``: ``prompts[0]``
    to each (SWAP_LATE_TOKENS new tokens), then a second request to
    ``v1`` (ZOO_V1_SECOND_TOKENS), all submitted at once.  ``v2`` stalls
    while ``base`` and ``v1`` serve, then the idle ``base`` is evicted and
    ``v2`` warms from ``v1``.
    Checks: the store's logical and physical bytes equal the manifests'
    (payloads plus each manifest's JSON) and dedup >= 2; every admitted
    tree's leaves equal delta_swap's digests for its step; ``v2``'s
    prefill logits row equals the chain's cold start bit for bit, and its
    tokens; a cold admission grows ``memory_allocated`` by its
    ``model_resident_bytes`` within ZOO_MEM_TOL of it, a warm one by no
    more; an eviction (no ``gc.collect()``) returns its bytes less those
    a resident session shares, within ZOO_MEM_TOL; the budget holds after
    every router step; launches are ``per_forward_launches`` times the
    forward passes and ``flash_per_prefill`` times the prefills; the
    report is empty; each session's decode graph replays from its second
    use.  The seconds of the ingest and of each admission's parts."""
    import resource
    import shutil

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import delta, sharded
    from repro_torch.core import codec as core_codec
    from repro_torch.kernels import registry
    from repro_torch.serve import backends
    from repro_torch.serve import session as session_mod
    from repro_torch.serve.session import ServeConfig
    from repro_torch.serve.zoo import (AdmissionStall, ModelZoo, ZooConfig,
                                       ZooRouter, model_resident_bytes)

    src = Path(swap["root"])
    root = ROOT / "build" / "zoo"
    clock = _PartClock()
    try:
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        cfg = configs.get("llama3-8b").replace(num_layers=DELTA_SWAP_LAYERS)
        scfg = ServeConfig(slots=4, max_len=160)
        one = model_resident_bytes(cfg, scfg, backend="q8")
        budget = 2 * one + one // 2
        steps = dict(zip(ZOO_MODELS, swap["steps"]))
        # the chain is linear (step s chains to s - 1), so a model at step
        # s holds the files of steps 1..s
        link = {}
        for s in swap["steps"]:
            d = src / f"step_{s:08d}"
            link[s] = (sharded.manifest_payload_bytes(sharded.load_manifest(
                str(d))) + (d / sharded.MANIFEST_NAME).stat().st_size)
        logical = sum(link[t] for s in steps.values() for t in link
                      if t <= s)
        physical = sum(link.values())
        free = shutil.disk_usage(root).free
        check(free >= physical + 2**30, f"zoo: {free / 2**30:.1f} GiB free "
              f"under {root}, the store needs {physical / 2**30:.1f} GiB "
              "and 1 GiB to spare")
        zoo = ModelZoo(str(root), ZooConfig(hbm_budget=budget, backend="q8",
                                            serve=scfg), device=device)
        t0 = time.perf_counter()
        for m, s in steps.items():
            zoo.register(m, cfg, str(src / f"step_{s:08d}"))
        ingest_s = time.perf_counter() - t0
        store = zoo.store.report()
        check(store["logical_bytes"] == logical and
              store["physical_bytes"] == physical,
              f"zoo: store holds {store['logical_bytes']} logical / "
              f"{store['physical_bytes']} physical bytes, the manifests "
              f"give {logical} / {physical}")
        check(store["dedup_ratio"] >= 2.0,
              f"zoo: dedup ratio {store['dedup_ratio']} < 2")

        clock.wrap(delta, "restore_levels", "restore")
        clock.wrap(core_codec, "decode_delta_chunks_batched", "tc_decode")
        clock.wrap(backends.Q8Backend, "_convert", "q8_convert")
        clock.wrap(session_mod.ServeSession, "__init__", "session_build")
        events: list = []
        stalls: list = []
        graphs: dict = {}          # model -> its sessions' graph counters
        mark = [torch.cuda.memory_allocated()]
        v2_rows: list = []
        real_admit, real_evict = zoo.admit, zoo.evict

        def admit(model_id):
            fresh = zoo.session(model_id) is None
            mark[0] = torch.cuda.memory_allocated()
            part0 = dict(clock.secs)
            try:
                sess = real_admit(model_id)
            except AdmissionStall:
                stalls.append(model_id)
                raise
            if not fresh:
                return sess
            growth = torch.cuda.memory_allocated() - mark[0]
            rep = zoo.zoo_report()["models"][model_id]
            got = _tree_digests(sess.params)
            want = swap["digests"][steps[model_id]]
            bad = sorted(n for n in set(got) | set(want)
                         if got.get(n) != want.get(n))
            check(not bad, f"zoo: {model_id}'s {rep['last_admit']} "
                  f"admission differs from delta_swap's step "
                  f"{steps[model_id]} in {bad}")
            if rep["last_admit"] == "cold":
                check(abs(growth - one) <= ZOO_MEM_TOL * one,
                      f"zoo: cold admission of {model_id} grew "
                      f"memory_allocated by {growth} B, accounted {one}")
            else:
                check(growth <= (1 + ZOO_MEM_TOL) * one,
                      f"zoo: warm admission of {model_id} grew "
                      f"memory_allocated by {growth} B > {one}")
            if model_id == "v2":
                sample = sess._sample

                def first_rows(row, req):
                    if not req.tokens:
                        v2_rows.append(row.copy())
                    return sample(row, req)
                sess._sample = first_rows
            events.append({
                "event": "admit", "model": model_id,
                "kind": rep["last_admit"], "seconds": rep["admit_s"],
                **{f"{p}_s": clock.secs.get(p, 0.0) - part0.get(p, 0.0)
                   for p in ("restore", "tc_decode", "q8_convert",
                             "session_build")},
                "growth_bytes": growth, "accounted_bytes": one,
                "rss_bytes": _rss_bytes()})
            return sess

        def evict(model_id):
            sess = zoo.session(model_id)
            if sess is None:
                return real_evict(model_id)
            others = set()
            for m, s in zoo._resident.items():
                if m != model_id:
                    others |= set(_storages(s.params))
            shared = sum(n for p, n in _storages(sess.params).items()
                         if p in others)
            graphs.setdefault(model_id, []).append(
                {**sess.graphs.stats,
                 "decode_steps": sess.stats["decode_steps"]})
            del sess
            before = torch.cuda.memory_allocated()
            real_evict(model_id)
            after = torch.cuda.memory_allocated()
            mark[0] = after
            returned = before - after
            check(abs(returned - (one - shared)) <= ZOO_MEM_TOL * one,
                  f"zoo: evicting {model_id} returned {returned} B, want "
                  f"{one} - {shared} shared")
            events.append({"event": "evict", "model": model_id,
                           "returned_bytes": returned,
                           "shared_bytes": shared, "accounted_bytes": one})

        zoo.admit, zoo.evict = admit, evict
        router = ZooRouter(zoo)
        prompts = swap["prompts"]
        traffic = [("base", prompts[0], SWAP_LATE_TOKENS),
                   ("v1", prompts[0], SWAP_LATE_TOKENS),
                   ("v2", prompts[0], SWAP_LATE_TOKENS),
                   ("v1", prompts[1], ZOO_V1_SECOND_TOKENS)]
        clear_reports()
        registry.reset_launch_counts()
        handles = [(m, router.submit(m, p, n)) for m, p, n in traffic]
        ticks: list = []
        while router.pending:
            check(len(ticks) < 100, "zoo: the router did not drain")
            before = {m: (dict(s.graphs.stats), s.stats["prefill_tokens"])
                      for m, s in zoo._resident.items() if s.pending}
            n_events = len(events) + len(stalls)
            t0 = time.perf_counter()
            router.step()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            check(zoo.resident_bytes() <= budget, f"zoo: resident "
                  f"{zoo.resident_bytes()} B over the budget {budget}")
            # a decode-only replay tick of one model: it alone stepped, no
            # admission, eviction, stall, prefill or capture in the tick
            decode = None
            if len(before) == 1 and len(events) + len(stalls) == n_events:
                (m, (g0, p0)), = before.items()
                s = zoo.session(m)
                if (s is not None and s.stats["prefill_tokens"] == p0 and
                        s.graphs.stats["replays"] == g0["replays"] + 1 and
                        s.graphs.stats["captures"] == g0["captures"]):
                    decode = m
            ticks.append({"ms": ms, "models": sorted(before),
                          "resident": zoo.resident(), "decode_of": decode})
        launches = registry.launch_counts()
        report = registry.dispatch_report()
        for m, s in zoo._resident.items():
            graphs.setdefault(m, []).append(
                {**s.graphs.stats, "decode_steps": s.stats["decode_steps"]})
        kinds = [e["kind"] for e in events if e["event"] == "admit"]
        evicted = [e["model"] for e in events if e["event"] == "evict"]
        check(stalls and evicted == ["base"] and
              kinds == ["cold", "warm", "warm"],
              f"zoo: want stalls, base evicted, a cold and two warm "
              f"admissions; got stalls {stalls}, evictions {evicted}, "
              f"admissions {kinds}")
        check(all(h.done and len(h.result()) == n for (_, h), (_, _, n)
                  in zip(handles, traffic)), "zoo: a request did not finish")
        toks = {i: list(map(int, h.result())) for i, (_, h)
                in enumerate(handles)}
        check(toks[2] == swap["late_tokens"], f"zoo: v2's tokens {toks[2]} "
              f"!= the chain's cold start {swap['late_tokens']}")
        check(len(v2_rows) == 1 and np.array_equal(v2_rows[0],
                                                    swap["late_logits"]),
              "zoo: v2's prefill logits row differs from the chain's cold "
              "start")
        runs = [g for gs in graphs.values() for g in gs]
        fwd = sum(g["eager"] + g["replays"] for g in runs)
        prefills = fwd - sum(g["decode_steps"] for g in runs)
        per_fwd = per_forward_launches(cfg)
        check(not report, f"zoo: dispatch report not empty: {report}")
        check(launches["dequant_matmul"] == per_fwd["dequant_matmul"] * fwd,
              f"zoo: {launches['dequant_matmul']} dequant_matmul launches, "
              f"want {per_fwd['dequant_matmul']} x {fwd} passes")
        check(launches["flash_attention"] == flash_per_prefill(cfg) *
              prefills, f"zoo: {launches['flash_attention']} flash "
              f"launches, want {flash_per_prefill(cfg)} x {prefills} "
              "prefills")
        check(all(g["captures"] >= 1 and
                  g["replays"] >= g["decode_steps"] - 1 for g in runs),
              f"zoo: a session's decode graph did not replay: {graphs}")
        decode_ms = {m: float(np.median([t["ms"] for t in ticks
                                         if t["decode_of"] == m]))
                     for m in {t["decode_of"] for t in ticks} - {None}}
        check("v2" in decode_ms, "zoo: no decode replay tick of v2 alone")
        report_zoo = zoo.zoo_report()
        zoo.admit, zoo.evict = real_admit, real_evict
        zoo.close()
        zoo.store.close()
        out = {"layers": cfg.num_layers, "accounted_bytes": one,
               "hbm_budget": budget, "ingest_s": ingest_s,
               "ingest_gb_per_s": store["stats"]["bytes_ingested"] /
               ingest_s / 1e9, "store": store, "events": events,
               "stalls": stalls, "ticks": ticks, "graphs": graphs,
               "launches": launches, "dispatch_report": report,
               "forward_passes": fwd, "prefills": prefills,
               "decode_ms_per_step": decode_ms, "zoo_report": report_zoo,
               "tokens": toks,
               "host_peak_rss_bytes": 1024 * resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss}
    finally:
        clock.restore()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(src, ignore_errors=True)
    log(f"[zoo] llama3-8b full width, {cfg.num_layers} layer(s), q8, "
        f"budget {budget} B = 2.5 x {one} B accounted: ingest of 3 models "
        f"in {ingest_s:.2f} s ({out['ingest_gb_per_s']:.2f} GB/s); store "
        f"{store['logical_bytes']} B logical, {store['physical_bytes']} B "
        f"physical, dedup {store['dedup_ratio']}; stalls {stalls}")
    for e in events:
        if e["event"] == "admit":
            log(f"[zoo] {e['kind']} admission of {e['model']}: "
                f"{e['seconds']:.2f} s (restore {e['restore_s']:.2f}, tc "
                f"decode {e['tc_decode_s']:.2f}, q8 conversion "
                f"{e['q8_convert_s']:.2f}, session build "
                f"{e['session_build_s'] * 1e3:.2f} ms); memory_allocated "
                f"+{e['growth_bytes']} B against {e['accounted_bytes']} "
                f"accounted; host RSS {e['rss_bytes'] / 2**30:.2f} GiB")
        else:
            log(f"[zoo] eviction of {e['model']}: memory_allocated "
                f"-{e['returned_bytes']} B ({e['shared_bytes']} B shared "
                f"with a resident session, {e['accounted_bytes']} "
                f"accounted)")
    log(f"[zoo] decode ms/step from graphs (one model stepping) "
        f"{ {m: round(v, 3) for m, v in decode_ms.items()} }; launches "
        f"{launches} over {fwd} forward passes ({prefills} prefills), "
        f"empty report; v2's prefill logits and tokens equal the chain's "
        f"cold start; host peak RSS {out['host_peak_rss_bytes'] / 2**30:.2f}"
        f" GiB")
    return out


def _serve_full(cfg, params, backend, device, prompts, new_tokens,
                mode="graph"):
    """Drive one full-width session, its steps replayed from CUDA graphs
    (``mode="graph"``, the session's default on the card) or run eagerly
    under ``eager_steps()`` (``"eager"``); return timings and launch
    counts, the greedy tokens (``tokens``) and one prefill forward's
    logits (``logits``, on the host), which the caller takes out.  Ticks
    ``PROF_STEPS[0]`` to ``PROF_STEPS[1] - 1`` are traced, after one tick
    that warms the tracer up; their own idle share is the headline
    (``device_idle_share``).  The tracer records device activity only
    (kernels and the runtime calls that launch them): what is read from
    the trace is device time, and an eager tick's CPU ops would multiply
    the events, whose processing took most of an eager SSM serve.  In
    graph mode the decode graph's replays are also timed by CUDA events
    (``decode_replay_ms``), which with the untraced ticks gives a share
    that no tracer touches
    (``untraced_idle_share``).  After the run the prompts come once more
    as one admission that ends at its first token, so the session runs
    one more prefill alone: in graph mode the shape's second use, which
    captures its graph, and the forward is timed as replays of the
    session's own graph; eagerly, as the model's prefill."""
    import contextlib

    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import prefill
    from repro_torch.serve.session import (ServeConfig, ServeSession,
                                           eager_steps)
    from torch.profiler import ProfilerActivity, profile, schedule

    b, s = prompts.shape
    prof_steps = PROF_STEPS
    n_prof = prof_steps[1] - prof_steps[0]
    trace = {}

    def read_trace(p):
        events = p.key_averages()
        trace["busy"], trace["top"] = _device_time(events)
        trace["split"] = {name: _kernel_ms(events, key) / n_prof
                          for name, key in (
                              ("dequant_matmul_grouped", "dm_grouped"),
                              ("dequant_matmul", ("dm_decode", "dm_tc")),
                              ("flash_attention", "flash_fwd"))}

    sess = ServeSession(cfg, params, backend=backend, device=device,
                        serve_cfg=ServeConfig(slots=b,
                                              max_len=s + new_tokens))
    hs = [sess.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_reports()
    registry.reset_launch_counts()
    step_s, captured = [], []
    prof, prof_wall = None, 0.0
    t_all = time.perf_counter()
    def steps_mode():
        return eager_steps() if mode == "eager" else contextlib.nullcontext()

    with steps_mode():
        while sess.pending:
            i = len(step_s)
            if i == prof_steps[0] - 1:
                # one warm-up tick: the tracer misses device work launched
                # just after it starts (a whole 1 ms graph replay)
                prof = profile(activities=[ProfilerActivity.CUDA],
                               schedule=schedule(wait=0, warmup=1,
                                                 active=n_prof, repeat=1),
                               on_trace_ready=read_trace)
                prof.__enter__()
            if i == prof_steps[0]:
                t_prof = time.perf_counter()
            n_cap = sess.graphs.stats["captures"]
            t0 = time.perf_counter()
            sess.step()                   # host copy of the logits syncs
            step_s.append(time.perf_counter() - t0)
            captured.append(sess.graphs.stats["captures"] > n_cap)
            if prof_steps[0] - 1 <= i < prof_steps[1]:
                if i == prof_steps[1] - 1:
                    torch.cuda.synchronize()
                    prof_wall = time.perf_counter() - t_prof
                prof.step()
                if i == prof_steps[1] - 1:
                    prof.__exit__(None, None, None)
    total = time.perf_counter() - t_all
    launches = registry.launch_counts()
    report = registry.dispatch_report()
    tokens = np.stack([h.result() for h in hs])
    graph_stats = dict(sess.graphs.stats)
    decode_steps = sess.stats["decode_steps"]
    replay_ms = (time_ms(lambda: sess.graphs.replay_only(("decode",)))
                 if mode == "graph" else None)
    # one prefill forward on its own, without the scheduler around it: the
    # first tick also holds a decode step, and the host's share of a tick
    # moves by more than a prefill's device time
    for p in prompts:
        sess.submit(p, max_new_tokens=1)
    with steps_mode():
        sess.step()
    logits = sess.logits[:b].clone()
    if mode == "graph":
        key = ("prefill", b, s, False)
        check(key in sess.graphs._graphs, f"{cfg.name} {backend}: the "
              f"prefill was not captured: {sess.graphs.stats}")
        prefill_fwd_ms = time_ms(lambda: sess.graphs.replay_only(key))
    else:
        prompt_t = torch.from_numpy(prompts).to(device)
        prefill_fwd_ms = time_ms(lambda: prefill(
            sess.params, cfg, tokens=prompt_t, max_len=s + new_tokens))
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all().item())
    check(prof_wall > 0 and "busy" in trace, f"{cfg.name} {backend}: "
          f"{len(step_s)} ticks, fewer than the traced ones {prof_steps}")
    # decode ticks: not the first (it holds the prefills), none that
    # captured a graph, none traced or warming the tracer up
    plain_steps = [t for j, t in enumerate(step_s)
                   if j > 0 and not captured[j] and
                   not prof_steps[0] - 1 <= j < prof_steps[1]]
    decode = sorted(plain_steps)
    decode_ms = 1e3 * decode[len(decode) // 2]
    busy, top, split = trace["busy"], trace["top"], trace["split"]
    wall_ms = 1e3 * prof_wall / n_prof
    if busy is not None:
        split["other"] = busy / n_prof - sum(split.values())
    res = {"backend": backend, "mode": mode, "launches": launches,
           "dispatch_report": report, "graph_stats": graph_stats,
           "decode_steps": decode_steps,
           "first_step_ms": 1e3 * step_s[0],
           "prefill_ms": 1e3 * step_s[0] - decode_ms,
           "prefill_forward_ms": prefill_fwd_ms,
           "decode_ms_per_step_median": decode_ms,
           "decode_ms_per_step_mean": 1e3 * sum(decode) / len(decode),
           "decode_ticks_timed": len(decode),
           "profiled_steps": list(prof_steps),
           "profiled_wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": (None if busy is None
                                       else busy / n_prof),
           "device_idle_share": (None if busy is None
                                 else 1.0 - busy / (1e3 * prof_wall)),
           "untraced_idle_share": (None if replay_ms is None
                                   else 1.0 - replay_ms / decode_ms),
           "tick_ms": [1e3 * t for t in step_s],
           "capture_ticks": [j for j, c in enumerate(captured) if c],
           "decode_replay_ms": replay_ms,
           "top_device_ms_per_step": {k: v / n_prof for k, v in top},
           "device_split_ms_per_step": split,
           "grouped_ms_per_step": split["dequant_matmul_grouped"],
           "total_s_with_trace": total,
           "decode_tokens_per_s": b / (decode_ms / 1e3),
           "max_memory_allocated": peak, "logits_finite": finite,
           "logits_shape": list(logits.shape),
           "first_row_tail": tokens[0, -8:].tolist(),
           "tokens": tokens, "logits": logits.float().cpu().numpy()}
    del sess, logits
    return res


def _serve_modes(cfg, params, backend, device, prompts, new_tokens):
    """``_serve_full`` eagerly, then with graphs, in one process: greedy
    tokens and launch counts must be equal in both modes and the dispatch
    report empty in each (for MLA: MLA's d != dv records only).  Returns
    the graph run with the eager run's numbers under ``"eager"`` (tokens
    and logits of the graph run).  Its
    ``launches`` are the eager run's, which the wrappers counted where
    they launched; a replay credits its capture's counts instead
    (``launches_graph``, checked equal)."""
    import numpy as np
    import torch
    runs = {}
    for mode in ("eager", "graph"):
        runs[mode] = _serve_full(cfg, params, backend, device, prompts,
                                 new_tokens, mode=mode)
        gc.collect()
        torch.cuda.empty_cache()
        r = runs[mode]
        split = r["device_split_ms_per_step"]
        log(f"[serve] {cfg.name} {backend} {mode}: decode "
            f"{r['decode_ms_per_step_median']:.2f} ms/step median, device "
            f"busy {_fmt(r['device_busy_ms_per_step'])} ms/step (traced), "
            f"idle {_fmt(r['device_idle_share'])} of a traced tick, decode "
            f"graph replay {_fmt(r['decode_replay_ms'])} ms by CUDA events "
            f"(idle {_fmt(r['untraced_idle_share'])} of an untraced tick), "
            f"prefill forward {r['prefill_forward_ms']:.2f} ms, "
            f"peak {r['max_memory_allocated'] / 2**30:.2f} GiB, split "
            f"{ {k: round(v, 3) for k, v in split.items()} }, "
            f"graphs {r['graph_stats']}")
        check(report_ok(cfg, r["dispatch_report"], backend), f"{cfg.name} "
              f"{backend} {mode}: dispatch report {r['dispatch_report']}, "
              f"want only {allowed_records(cfg, backend)}")
    eager, graph = runs["eager"], runs["graph"]
    differ = int((eager["tokens"] != graph["tokens"]).sum())
    check(differ == 0, f"{cfg.name} {backend}: {differ} greedy tokens "
          f"differ between the graph and the eager session")
    check(eager["launches"] == graph["launches"],
          f"{cfg.name} {backend}: launches differ between the modes: eager "
          f"{eager['launches']}, graph {graph['launches']}")
    check(graph["graph_stats"]["replays"] >= graph["decode_steps"] - 1,
          f"{cfg.name} {backend}: {graph['graph_stats']} for "
          f"{graph['decode_steps']} decode steps")
    check(np.isfinite(eager["logits"]).all(), f"{cfg.name} {backend}: "
          "non-finite eager logits")
    log(f"[serve] {cfg.name} {backend}: prefill logits from the graph "
        f"against the eager step: max abs diff "
        f"{float(np.max(np.abs(eager['logits'] - graph['logits']))):.3g}")
    graph["launches_graph"] = graph["launches"]
    graph["launches"] = eager["launches"]
    graph["eager"] = {k: v for k, v in eager.items()
                      if k not in ("tokens", "logits")}
    return graph


def _fmt(v):
    return "None" if v is None else f"{v:.3f}"


def _device_time(events):
    """Total device time (ms) in a profiler window's ``key_averages()`` and
    the eight largest kernels; (None, []) if the profiler saw no device
    time.  Only device events are summed: a CPU op's self device time
    repeats its kernels', and a user annotation (the schedule's
    ``ProfilerStep#n``) is drawn on the device's timeline over the kernels
    it spans."""
    rows = []
    for evt in events:
        if str(evt.device_type).endswith("CUDA") and \
                evt.self_device_time_total > 0 and \
                not getattr(evt, "is_user_annotation", False) and \
                not evt.key.startswith("ProfilerStep"):
            rows.append((evt.key, evt.self_device_time_total / 1e3))
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows), rows[:8]


def _kernel_ms(events, names) -> float:
    """Device time (ms) of the kernels whose name holds ``names`` (a
    string or a tuple of them) in a profiler window's
    ``key_averages()``."""
    names = (names,) if isinstance(names, str) else names
    return sum(e.self_device_time_total for e in events
               if str(e.device_type).endswith("CUDA") and
               any(n in e.key for n in names)) / 1e3


def per_forward_launches(cfg) -> dict:
    """Kernel launches of one q8 forward pass, counted from the model's
    structure: per dense layer the attention projections (GQA 4; MLA 7:
    w_dq, w_uq, w_dkv, w_kr, w_uk, w_uv, wo, 6 without a q LoRA) and 3 MLP;
    per MoE layer the attention's, the router and 3 shared-expert
    projections through dequant_matmul and 3 expert-bank products through
    dequant_matmul_grouped; an SSM layer none (its mixer tensors are
    dequantized in the loop); the hybrid's shared block once per group
    (4 + 3); the untied head."""
    n_layers = cfg.num_layers
    attn = 4 if cfg.attention != "mla" else 6 + bool(cfg.q_lora_rank)
    if cfg.family in ("ssm", "hybrid"):
        groups = (n_layers // cfg.shared_attn_every
                  if cfg.family == "hybrid" else 0)
        return {"dequant_matmul": (attn + 3) * groups + 1,
                "dequant_matmul_grouped": 0}
    if cfg.family == "dense":
        return {"dequant_matmul": (attn + 3) * n_layers + 1,
                "dequant_matmul_grouped": 0}
    nd = cfg.first_dense_layers
    return {"dequant_matmul": (attn + 3) * nd + (attn + 4) * (n_layers - nd)
            + 1, "dequant_matmul_grouped": 3 * (n_layers - nd)}


def flash_per_prefill(cfg) -> int:
    """flash_attention launches of one prefill: one per layer, none for
    MLA (d != dv takes the scan) or an SSM model, one per group of the
    hybrid (its shared block)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return 0 if cfg.attention in ("mla", "none") else cfg.num_layers


def init_full(device, arch, **overrides):
    import torch
    from repro_torch import configs
    from repro_torch.models.transformer import init_params

    cfg = configs.get(arch).replace(**overrides)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {arch} full width, {cfg.num_layers} layers: "
        f"{n_params / 1e9:.3f} B parameters ({cfg.param_dtype}) initialised "
        f"in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def decode_byte_bound(cfg, params, backend, slots, max_len) -> dict:
    """The bytes one decode step over ``slots`` rows must move, and their
    time at HBM_BYTES_PER_S: every weight once at its stored precision (on
    q8 the leaves the serving rule quantizes as int8 levels and f32 scales;
    the embedding's ``slots`` rows only), the f32 SSM state read and
    written, the conv tails read and written and the attention cache read
    (whole: the decode attention reads every position of its buffer)."""
    from repro_torch.compression import flatten_tree
    from repro_torch.compression.quantizers import serve_q8_policy
    w = 0
    for name, t in flatten_tree(params).items():
        if name == "embed":
            elt = 1 if backend == "q8" else t.element_size()
            w += slots * t.shape[1] * elt
        elif backend == "q8" and serve_q8_policy(name, t):
            scales = t.shape[0] * t.shape[-1] if t.dim() >= 3 else t.shape[-1]
            w += t.numel() + 4 * scales
        else:
            w += t.numel() * t.element_size()
    elt = 4 if cfg.compute_dtype == "float32" else 2
    rows = cfg.num_layers * slots
    state = 2 * rows * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
    tails = 2 * rows * (cfg.ssm_conv - 1) * (
        cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state) * elt
    attn = 0
    if cfg.family == "hybrid":
        attn = (2 * (cfg.num_layers // cfg.shared_attn_every) * slots *
                max_len * cfg.num_kv_heads * cfg.head_dim *
                (1 if cfg.q8_cache else elt))
    total = w + state + tails + attn
    return {"weight_bytes": w, "state_bytes": state,
            "cache_bytes": tails + attn, "bytes": total,
            "ms": 1e3 * total / HBM_BYTES_PER_S}


def _layer0_sample(params) -> dict:
    """Layer 0 of every stacked leaf, and every unstacked leaf."""
    from repro_torch.compression import flatten_tree
    return {k: (v[:1] if k.split("/", 1)[0] in ("layers", "dense_layers")
                else v) for k, v in flatten_tree(params).items()}


def phase_serve(cfg, params, device):
    import gc
    import numpy as np
    import torch
    # the q8 backend quantizes this tree on the card: hold layer 0 of every
    # stacked leaf, the embedding and the head against the CPU, bit for bit
    t0 = time.perf_counter()
    mism = q8_mismatches(_layer0_sample(params), device)
    check(mism == 0, f"{cfg.name} full width: {mism} q8 entries quantized "
          "on the card differ from the CPU's")
    log(f"[serve] {cfg.name} full width q8 of layer 0 (of each stack), "
        f"embed and head: card equals CPU bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    new_tokens = 32
    per_fwd = per_forward_launches(cfg)
    out = {"q8_mismatch_card_vs_cpu": mism}
    for backend in ("q8", "bf16"):
        r = _serve_modes(cfg, params, backend, device, prompts, new_tokens)
        del r["tokens"], r["logits"]
        fwd = 1 + r["decode_steps"]
        e = r["eager"]
        log(f"[serve] {cfg.name} {backend}: graphs: prefill "
            f"{r['prefill_ms']:.1f} ms (first tick {r['first_step_ms']:.1f} "
            f"ms, eager by design; one forward alone "
            f"{r['prefill_forward_ms']:.1f} ms, eager "
            f"{e['prefill_forward_ms']:.1f}), decode "
            f"{r['decode_ms_per_step_median']:.2f} ms/step median (eager "
            f"{e['decode_ms_per_step_median']:.2f}; "
            f"{r['decode_tokens_per_s']:.1f} tok/s at 4 slots), peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB (eager "
            f"{e['max_memory_allocated'] / 2**30:.2f}), device busy "
            f"{_fmt(r['device_busy_ms_per_step'])} ms and idle "
            f"{_fmt(r['device_idle_share'])} of a traced tick (eager "
            f"{_fmt(e['device_busy_ms_per_step'])} and "
            f"{_fmt(e['device_idle_share'])}), idle "
            f"{_fmt(r['untraced_idle_share'])} of an untraced tick by the "
            f"replay's CUDA events, launches {r['launches']} in "
            f"both modes, report {len(r['dispatch_report'])} records")
        what = f"{cfg.name} {backend}"
        check(r["logits_finite"], f"{what}: non-finite logits")
        check(r["logits_shape"] == [4, cfg.vocab_size],
              f"{what}: logits shape {r['logits_shape']}")
        check(report_ok(cfg, r["dispatch_report"], backend),
              f"{what}: dispatch report {r['dispatch_report']}, want only "
              f"{allowed_records(cfg, backend)}")
        check(r["launches"]["flash_attention"] == flash_per_prefill(cfg),
              f"{what}: {r['launches']['flash_attention']} flash launches, "
              f"want {flash_per_prefill(cfg)} (one prefill)")
        if cfg.family in ("ssm", "hybrid"):
            bound = decode_byte_bound(cfg, params, backend, 4,
                                      128 + new_tokens)
            r["decode_bound"] = bound
            log(f"[serve] {what}: decode byte bound {bound['ms']:.3f} ms "
                f"per step ({bound['weight_bytes'] / 1e9:.3f} GB of "
                f"weights as stored, {bound['state_bytes'] / 1e9:.3f} GB of "
                f"f32 state read and written, "
                f"{bound['cache_bytes'] / 1e9:.4f} GB of conv tails and "
                f"attention cache); graphs at "
                f"{r['decode_ms_per_step_median'] / bound['ms']:.1f}x it")
        if backend == "q8":
            for kern, n in per_fwd.items():
                check(r["launches"][kern] == n * fwd,
                      f"{cfg.name} q8: {r['launches'][kern]} {kern} "
                      f"launches, want {n} x {fwd} passes")
        out[backend] = r
    return out


def phase_container_moe(device):
    """deepseek-moe-16b at full width cut to DEPLOY_LAYERS layers (the
    dense one and one MoE layer), packed as a serve-q8 container (int8
    records, no entropy coding) and served through
    ``ServeEngine.from_compressed`` on the container backend: tokens and
    launch counts must equal the in-memory q8 session's."""
    import numpy as np
    import torch
    from repro_torch import compression
    from repro_torch.kernels import registry
    from repro_torch.serve import ServeEngine

    cfg, params = init_full(device, "deepseek-moe-16b",
                            num_layers=DEPLOY_LAYERS)
    t0 = time.perf_counter()
    blob = compression.get("serve-q8").compress(params).blob
    pack_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    new_tokens = 32
    res = {"layers": cfg.num_layers, "blob_bytes": len(blob),
           "pack_s": pack_s}
    for backend in ("q8", "container"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = (ServeEngine(cfg, params, max_len=160, backend="q8",
                           device=device) if backend == "q8" else
               ServeEngine.from_compressed(cfg, blob, max_len=160,
                                           backend="container",
                                           device=device))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        clear_reports()
        registry.reset_launch_counts()
        toks = eng.generate(prompts, new_tokens)
        counts = registry.launch_counts()
        report = registry.dispatch_report()
        fwd = 1 + eng._session(len(prompts)).stats["decode_steps"]
        check(not report, f"moe {backend}: dispatch report not empty: "
              f"{report}")
        for kern, n in per_forward_launches(cfg).items():
            check(counts[kern] == n * fwd, f"moe {backend}: {counts[kern]} "
                  f"{kern} launches, want {n} x {fwd} passes")
        check(counts["flash_attention"] == cfg.num_layers,
              f"moe {backend}: {counts['flash_attention']} flash launches")
        res[backend] = {"load_s": load_s, "launches": counts,
                        "forward_passes": fwd, "tokens": toks}
        del eng
    check(np.array_equal(res["q8"]["tokens"], res["container"]["tokens"]),
          "moe container: greedy tokens differ from the in-memory q8 "
          "session's")
    check(res["q8"]["launches"] == res["container"]["launches"],
          "moe container: launch counts differ from the q8 session's")
    for backend in ("q8", "container"):
        res[backend]["first_row_tail"] = \
            res[backend].pop("tokens")[0, -8:].tolist()
    log(f"[deploy] deepseek-moe-16b full width, {cfg.num_layers} layers: "
        f"serve-q8 container {len(blob) / 2**20:.1f} MiB packed in "
        f"{pack_s:.1f} s, loaded on container in "
        f"{res['container']['load_s']:.1f} s; 4 x 128 + 32 greedy tokens "
        f"equal the in-memory q8 session's, launches "
        f"{res['container']['launches']} on both, empty dispatch report")
    del params, blob
    return res


def phase_serve_moe_f32(device, cpu="cpu"):
    """deepseek-moe-16b at its published widths in f32 (params and compute),
    cut to DEPLOY_LAYERS layers (the dense one and one MoE layer), served
    on q8: 4 requests of 128 prompt tokens and MOE_F32_NEW_TOKENS new ones,
    greedy, through the f32 kernel instances (flash attention's 3xTF32 one
    at prefill, the grouped matmul's bf16x3 one, dequant_matmul with a f32
    x).  The same q8 tree served by the port on the CPU must give the same
    greedy tokens and prefill logits within TOL_MOE_F32_LOGITS of
    max|logit|; the launch counts must be the path's, the dispatch report
    empty.  Device busy time per decode step and the grouped kernel's
    share come from the profiler, as in phase_serve."""
    import numpy as np
    import torch
    from repro_torch.compression import quantize_tree_q8

    cfg, params = init_full(device, "deepseek-moe-16b",
                            num_layers=DEPLOY_LAYERS, param_dtype="float32",
                            compute_dtype="float32")
    tree = quantize_tree_q8(params)           # on the card; q8 passes it on
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    new_tokens = MOE_F32_NEW_TOKENS
    r = _serve_modes(cfg, tree, "q8", device, prompts, new_tokens)
    tok_d, lo_d = r.pop("tokens"), r.pop("logits")
    fwd = 1 + r["decode_steps"]
    what = "deepseek-moe-16b f32"
    check(r["logits_finite"] and np.isfinite(lo_d).all(),
          f"{what}: non-finite logits")
    check(r["logits_shape"] == [4, cfg.vocab_size],
          f"{what}: logits shape {r['logits_shape']}")
    check(not r["dispatch_report"],
          f"{what}: dispatch report not empty: {r['dispatch_report']}")
    check(r["launches"]["flash_attention"] == cfg.num_layers,
          f"{what}: {r['launches']['flash_attention']} flash launches, want "
          f"{cfg.num_layers} (one prefill)")
    for kern, n in per_forward_launches(cfg).items():
        check(r["launches"][kern] == n * fwd, f"{what}: "
              f"{r['launches'][kern]} {kern} launches, want {n} x {fwd} "
              "passes")
    e = r["eager"]
    check(e["device_busy_ms_per_step"] is not None and
          e["grouped_ms_per_step"] > 0,
          f"{what}: the profiler saw no grouped kernel time: "
          f"{e['top_device_ms_per_step']}")
    # the same session on the CPU, from the same q8 tree
    tok_c, lo_c, cpu_s = _cpu_session(cfg, tree, prompts, new_tokens, cpu)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    err = float(np.max(np.abs(lo_d - lo_c)) / np.max(np.abs(lo_c)))
    differ = int((tok_d != tok_c).sum())
    busy = r["device_busy_ms_per_step"] or e["device_busy_ms_per_step"]
    share = r["grouped_ms_per_step"] / busy
    log(f"[serve] {what}, {cfg.num_layers} layers on q8, graphs (eager in "
        f"brackets): prefill forward {r['prefill_forward_ms']:.2f} ms "
        f"({e['prefill_forward_ms']:.2f}), decode "
        f"{r['decode_ms_per_step_median']:.2f} ms/step median "
        f"({e['decode_ms_per_step_median']:.2f}), device busy "
        f"{_fmt(r['device_busy_ms_per_step'])} ms per decode step "
        f"({_fmt(e['device_busy_ms_per_step'])}), idle "
        f"{_fmt(r['device_idle_share'])} ({_fmt(e['device_idle_share'])}) "
        f"of a traced tick, {_fmt(r['untraced_idle_share'])} of an "
        f"untraced one by the replay's CUDA events, "
        f"of which the grouped kernel {r['grouped_ms_per_step']:.3f} ms "
        f"({share:.3f}); launches {r['launches']} in both modes; peak "
        f"{r['max_memory_allocated'] / 2**30:.2f} GiB "
        f"({e['max_memory_allocated'] / 2**30:.2f}); against the CPU "
        f"({cpu_s:.1f} s): prefill logits rel diff {err:.2e} (tolerance "
        f"{TOL_MOE_F32_LOGITS}), {differ} of {tok_d.size} greedy tokens "
        f"differ")
    check(err <= TOL_MOE_F32_LOGITS,
          f"{what}: prefill logits differ from the CPU's: rel {err:.3g}")
    check(differ == 0, f"{what}: {differ} greedy tokens differ between "
          f"{device} and cpu:\n{tok_d}\n{tok_c}")
    r.update({"layers": cfg.num_layers, "logits_rel_diff_vs_cpu": err,
              "tokens_differ_vs_cpu": differ, "cpu_session_s": cpu_s,
              "grouped_share_of_busy": share})
    return r


def _cpu_session(cfg, tree, prompts, new_tokens, cpu="cpu"):
    """The q8 session of ``tree`` copied to the CPU over ``prompts`` (4 x
    S): greedy tokens, one prefill's logits (f32, on the host) and the
    seconds both took."""
    import numpy as np
    import torch
    from repro_torch.compression import flatten_tree
    from repro_torch.compression.tree import unflatten
    from repro_torch.models.transformer import prefill
    from repro_torch.serve.session import ServeConfig, ServeSession

    tree_cpu = unflatten({k: v.cpu() for k, v in flatten_tree(tree).items()})
    max_len = prompts.shape[1] + new_tokens
    t0 = time.perf_counter()
    sess = ServeSession(cfg, tree_cpu, backend="q8", device=cpu,
                        serve_cfg=ServeConfig(slots=4, max_len=max_len))
    hs = [sess.submit(p, max_new_tokens=new_tokens) for p in prompts]
    sess.run()
    tok_c = np.stack([h.result() for h in hs])
    lo_c, _ = prefill(sess.params, cfg, tokens=torch.from_numpy(prompts),
                      max_len=max_len)
    lo_c = lo_c.float().numpy()
    cpu_s = time.perf_counter() - t0
    del sess, tree_cpu
    gc.collect()
    return tok_c, lo_c, cpu_s


def phase_serve_hybrid_f32(device, cpu="cpu"):
    """zamba2-2.7b at its published widths in f32 (params and compute),
    HYBRID_F32_LAYERS deep (one group: its mixers, then the shared block
    through the D = 80 f32 flash instance), served on q8 eagerly and from
    graphs (4 x 128 prompt tokens + MOE_F32_NEW_TOKENS, greedy); the same
    q8 tree served on the CPU gives the same greedy tokens and prefill
    logits within TOL_MOE_F32_LOGITS of max|logit|; launches of the path;
    the report holds the loop-dequant records only."""
    import numpy as np
    import torch
    from repro_torch.compression import quantize_tree_q8

    cfg, params = init_full(device, "zamba2-2.7b",
                            num_layers=HYBRID_F32_LAYERS,
                            param_dtype="float32", compute_dtype="float32")
    tree = quantize_tree_q8(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    new_tokens = MOE_F32_NEW_TOKENS
    r = _serve_modes(cfg, tree, "q8", device, prompts, new_tokens)
    tok_d, lo_d = r.pop("tokens"), r.pop("logits")
    fwd = 1 + r["decode_steps"]
    what = f"zamba2-2.7b f32, {cfg.num_layers} layers"
    check(r["logits_finite"] and np.isfinite(lo_d).all(),
          f"{what}: non-finite logits")
    check(r["launches"]["flash_attention"] == flash_per_prefill(cfg),
          f"{what}: {r['launches']['flash_attention']} flash launches, want "
          f"{flash_per_prefill(cfg)} (one prefill)")
    for kern, n in per_forward_launches(cfg).items():
        check(r["launches"][kern] == n * fwd, f"{what}: "
              f"{r['launches'][kern]} {kern} launches, want {n} x {fwd} "
              "passes")
    tok_c, lo_c, cpu_s = _cpu_session(cfg, tree, prompts, new_tokens, cpu)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    err = float(np.max(np.abs(lo_d - lo_c)) / np.max(np.abs(lo_c)))
    differ = int((tok_d != tok_c).sum())
    e = r["eager"]
    log(f"[serve] {what} on q8, graphs (eager in brackets): prefill forward "
        f"{r['prefill_forward_ms']:.2f} ms ({e['prefill_forward_ms']:.2f}), "
        f"decode {r['decode_ms_per_step_median']:.2f} ms/step median "
        f"({e['decode_ms_per_step_median']:.2f}), launches {r['launches']}; "
        f"against the CPU ({cpu_s:.1f} s): prefill logits rel diff "
        f"{err:.2e} (tolerance {TOL_MOE_F32_LOGITS}), {differ} of "
        f"{tok_d.size} greedy tokens differ")
    check(err <= TOL_MOE_F32_LOGITS,
          f"{what}: prefill logits differ from the CPU's: rel {err:.3g}")
    check(differ == 0, f"{what}: {differ} greedy tokens differ between "
          f"{device} and cpu:\n{tok_d}\n{tok_c}")
    r.update({"layers": cfg.num_layers, "logits_rel_diff_vs_cpu": err,
              "tokens_differ_vs_cpu": differ, "cpu_session_s": cpu_s})
    return r


def init_q8_leafwise(cfg, device) -> dict:
    """``init_params(cfg, 0)``'s tree on q8, built leaf by leaf: each leaf
    is drawn (a stacked one a layer at a time), quantized where the serving
    rule quantizes it and dropped, so the full-precision tree is never
    whole (deepseek-v3's 256-expert bank is 11.3 G parameters)."""
    import torch
    from repro_torch.compression.quantizers import (quantize_leaf,
                                                    serve_q8_policy)
    from repro_torch.compression.tree import unflatten
    from repro_torch.models.transformer import iter_params

    t0 = time.perf_counter()
    flat, n = {}, 0
    for name, leaf in iter_params(cfg, 0, device=device):
        n += leaf.numel()
        flat[name] = (quantize_leaf(leaf) if serve_q8_policy(name, leaf)
                      else leaf)
        del leaf
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name} full width, {cfg.num_layers} layers: "
        f"{n / 1e9:.3f} B parameters ({cfg.param_dtype}) drawn and "
        f"quantized leaf by leaf in {time.perf_counter() - t0:.1f} s")
    return unflatten(flat)


def mla_cut(device):
    """deepseek-v3-671b at its published widths cut to SERVE_MLA_LAYERS
    layers (the 3 leading dense layers, d_ff 18432, and one MoE layer of
    256 experts top-8), bf16, built on q8 leaf by leaf: (cfg, tree), served
    by ``serve_mla`` and, after ``tune``, by ``serve_mla_tuned``."""
    from repro_torch import configs
    cfg = configs.get("deepseek-v3-671b").replace(
        num_layers=SERVE_MLA_LAYERS)
    return cfg, init_q8_leafwise(cfg, device)


def phase_serve_mla(cfg, tree, device, cpu="cpu"):
    """The MLA cut (``mla_cut``) served as ``_serve_modes`` does (4 x 128 +
    32 greedy, eagerly and from graphs, under the default policy and an
    empty tuning cache): tokens and launches equal in both modes,
    dequant_matmul and dequant_matmul_grouped launched as
    ``per_forward_launches`` predicts, no flash launch, and only the d !=
    dv (192 != 128) records.  Then one full-width MLA block in f32 on q8
    (prefill of 2 x 64, a ragged decode step) on the card against the
    CPU."""
    import numpy as np
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    r = _serve_modes(cfg, tree, "q8", device, prompts, 32)
    fwd = 1 + r["decode_steps"]
    e = r["eager"]
    what = f"deepseek-v3-671b {cfg.num_layers} layers q8"
    check(r["logits_finite"], f"{what}: non-finite logits")
    check(r["logits_shape"] == [4, cfg.vocab_size],
          f"{what}: logits shape {r['logits_shape']}")
    check(r["launches"]["flash_attention"] == 0,
          f"{what}: {r['launches']['flash_attention']} flash launches")
    for kern, n in per_forward_launches(cfg).items():
        check(r["launches"][kern] == n * fwd, f"{what}: "
              f"{r['launches'][kern]} {kern} launches, want {n} x {fwd} "
              "passes")
    log(f"[serve] {what}: graphs (eager in brackets): prefill forward "
        f"{r['prefill_forward_ms']:.2f} ms ({e['prefill_forward_ms']:.2f}), "
        f"decode {r['decode_ms_per_step_median']:.2f} ms/step median "
        f"({e['decode_ms_per_step_median']:.2f}), device busy "
        f"{_fmt(r['device_busy_ms_per_step'])} "
        f"({_fmt(e['device_busy_ms_per_step'])}) ms per step, of which "
        f"the grouped kernel {r['grouped_ms_per_step']:.3f}, idle "
        f"{_fmt(r['device_idle_share'])} traced, "
        f"{_fmt(r['untraced_idle_share'])} untraced; launches "
        f"{r['launches']}; peak {r['max_memory_allocated'] / 2**30:.2f} GiB")
    r["layers"] = cfg.num_layers
    r["prompts_seed"] = 7
    r["block_f32"] = _mla_block_f32(device, cpu)
    return r


def _mla_block_f32(device, cpu="cpu"):
    """One deepseek-v3-671b MLA block at its published widths in f32 on q8
    (its 7 projections, 187 M parameters, drawn on the CPU from a seed and
    quantized there): a 2 x 64 prefill into an f32 latent cache, then a
    decode step at ragged offsets, on the card and on the CPU; the outputs'
    distance relative to max|cpu| and the latents' must be within
    TOL_F32."""
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.compression.tree import unflatten
    from repro_torch.models.attention import mla_attention
    from repro_torch.models.transformer import _layout

    cfg = configs.get("deepseek-v3-671b").replace(
        num_layers=1, family="dense", first_dense_layers=0,
        param_dtype="float32", compute_dtype="float32")
    g = torch.Generator().manual_seed(11)
    leaves = {}
    for name, (shape, init, _) in _layout(cfg).items():
        if name.startswith("layers/attn/"):
            leaves[name] = (torch.ones(shape) if init == "ones" else
                            torch.randn(shape, generator=g) * init[1])
    p_cpu = quantize_tree_q8(unflatten(leaves))["layers"]["attn"]
    p_cpu = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                 else v[0]) for k, v in p_cpu.items()}
    p_dev = unflatten({k: v.to(device) for k, v in
                       flatten_tree(p_cpu).items()})
    b, s, max_len = 2, 64, 80
    x = torch.randn((b, s, cfg.d_model), generator=g)
    x1 = torch.randn((b, 1, cfg.d_model), generator=g)
    cp = torch.tensor([64, 40])
    out = {}
    t0 = time.perf_counter()
    for dev, p in ((cpu, p_cpu), (str(device), p_dev)):
        cache = {"ckv": torch.zeros((b, max_len, cfg.kv_lora_rank),
                                    device=dev),
                 "kr": torch.zeros((b, max_len, cfg.qk_rope_head_dim),
                                   device=dev)}
        pos = torch.arange(s, device=dev).expand(b, s)
        y, cache = mla_attention(x.to(dev), p, cfg, pos, cache=cache,
                                 qpos_canonical=True)
        y1, cache = mla_attention(x1.to(dev), p, cfg, cp.to(dev)[:, None],
                                  cache=cache, cache_pos=cp.to(dev))
        out[dev] = [t.cpu() for t in (y, y1, cache["ckv"], cache["kr"])]
    dist = {name: rel_err(out[str(device)][i], out[cpu][i])[1]
            for i, name in enumerate(("prefill", "decode", "ckv", "kr"))}
    log(f"[serve] deepseek-v3-671b MLA block, full width, f32 on q8: card "
        f"against cpu, rel distance {dist} (tolerance {TOL_F32}; "
        f"{time.perf_counter() - t0:.1f} s)")
    for name, d in dist.items():
        check(d <= TOL_F32, f"MLA block f32 {name}: card vs cpu rel {d:.3g}")
    return dist


def use_tuning_cache(path) -> None:
    """Point the port's tuning cache at ``path`` (the registry loads the
    file on its next plan)."""
    import os
    from repro_torch.kernels import tune
    os.environ[tune.ENV_VAR] = str(path)


def mla_decode_shapes(cfg, tree, device) -> list:
    """(M, K, N, x dtype) of every dequant_matmul call of one decode step of
    the MLA cut (4 slots after a 4 x 128 prefill, the cache 160 long), in
    call order, recorded at the op's ``cuda`` impl for that one step."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.models.transformer import decode_step, prefill

    spec = kernels.spec("dequant_matmul")
    impl = spec.impls["cuda"]
    calls = []

    def record(x, w_q, scale, **tiles):
        calls.append((math.prod(x.shape[:-1]), x.shape[-1], w_q.shape[1],
                      str(x.dtype)[6:]))
        return impl.fn(x, w_q, scale, **tiles)

    gen = torch.Generator(device=device).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                         device=device)
    logits, caches = prefill(tree, cfg, tokens=toks, max_len=160)
    spec.impls["cuda"] = dataclasses.replace(impl, fn=record)
    try:
        decode_step(tree, cfg, caches, 128, tokens=logits.argmax(-1))
    finally:
        spec.impls["cuda"] = impl
    torch.cuda.synchronize()
    want = per_forward_launches(cfg)["dequant_matmul"]
    check(len(calls) == want, f"MLA decode step: {len(calls)} "
          f"dequant_matmul calls recorded, want {want}")
    return calls


def phase_tune(device, mla_shapes, cache_path):
    """``autotune`` on the card, written to ``cache_path`` (not the cache
    the serving phases read): dequant_matmul at every distinct (M, K, N)
    of the MLA cut's decode step (``mla_shapes``: its 42 calls, w_kr,
    w_dkv, w_dq and the M = 640 up-projections among them) and at
    llama3-8b's decode (M = 4, the head's x in f32) and prefill (M = 512)
    projections; rd_quant at the n buckets of the full llama3-8b tree's
    encode (bf16 leaves).  Every candidate is checked before it is timed:
    dequant_matmul's within TOL_F32 of the plain version, rd_quant's levels
    equal to the first candidate's, and those equal to the plain version's
    on the first RD_TUNE_PREFIX values (a level depends on its element and
    the one before it only).  Prints, per shape, the default tiles and
    time, the tuned tiles and time, the bound and the candidates."""
    import torch
    from repro_torch.kernels import tune
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
    from repro_torch.kernels.rd_quant.ops import rd_quant_plain

    cache = tune.TuningCache(cache_path)
    plain = {}

    def check_dm(shape, tiles, out):
        if shape not in plain:
            (x, wq, sc), _ = tune_inputs("dequant_matmul", shape)
            plain[shape] = dequant_matmul_ref(x, wq, sc)
        _, rel = rel_err(out, plain[shape])
        check(rel <= TOL_F32, f"tune dequant_matmul {shape} {tiles}: rel "
              f"err {rel:.3g} > {TOL_F32}")

    def check_rd(shape, tiles, out):
        first = plain.get(shape)
        if first is None:
            (w, f, probs), kw = tune_inputs("rd_quant", shape)
            want = rd_quant_plain(w[:RD_TUNE_PREFIX], f, probs, **kw)
            mism = int((out[:RD_TUNE_PREFIX] != want).sum().item())
            check(mism == 0, f"tune rd_quant {shape} {tiles}: {mism} levels "
                  "differ from the plain version")
            plain[shape] = out.clone()
            return
        mism = int((out != first).sum().item())
        check(mism == 0, f"tune rd_quant {shape} {tiles}: {mism} levels "
              "differ from the first candidate's")

    dm_shapes = sorted(set(mla_shapes)) + [
        (4, k, n, "float32" if names == "head" else "bfloat16")
        for (k, n), _, names in DM_SHAPES["llama3-8b"]] + [
        (DM_PREFILL_M, k, n, "bfloat16")
        for (k, n), _, names in DM_SHAPES["llama3-8b"] if names != "head"]
    rows = []
    t0 = time.perf_counter()
    res = tune.autotune("dequant_matmul", dm_shapes, cache=cache,
                        force=True, verify=check_dm, save=False)
    for r in res.values():
        m, k, n, xdt = r["shape"]
        bound, _ = _dm_bound(m, k, n, 2 if xdt == "bfloat16" else 4)
        rows.append({"op": "dequant_matmul", **r, "bound_us": 1e3 * bound,
                     "mla": tuple(r["shape"]) in set(mla_shapes)})
    dm_s = time.perf_counter() - t0
    plain.clear()
    rd_shapes = [(n, "bfloat16") for n in RD_TUNE_N]
    res = tune.autotune("rd_quant", rd_shapes, cache=cache, force=True,
                        verify=check_rd, save=False)
    plain.clear()
    for r in res.values():
        bound, *_ = _rd_bound(r["shape"][0], 2, 2)
        rows.append({"op": "rd_quant", **r, "bound_us": 1e3 * bound})
    cache.save()
    torch.cuda.empty_cache()
    for r in rows:
        gain = r["default_time_us"] / r["time_us"]
        log(f"[tune] {r['op']} {str(tuple(r['shape'])):32s} default "
            f"{r['default_tiles']} {r['default_time_us']:.2f} us, tuned "
            f"{r['tiles']} {r['time_us']:.2f} us ({gain:.2f}x), bound "
            f"{r['bound_us']:.2f} us, {r['configs']} candidates")
    log(f"[tune] {len(rows)} shapes ({len(dm_shapes)} dequant_matmul in "
        f"{dm_s:.1f} s); winners in {cache_path}, every candidate checked")
    return {"rows": rows, "cache": str(cache_path),
            "dequant_matmul_s": dm_s}


def tune_inputs(op, shape):
    """The example inputs ``autotune`` made for ``shape`` (seeded)."""
    from repro_torch import kernels
    return kernels.spec(op).example_inputs(shape, "cuda")


def phase_serve_mla_tuned(cfg, tree, device, serve_mla, tune_res):
    """The MLA cut served with the tuned cache, eagerly and from graphs
    (``_serve_modes``: 4 x 128 + 32 greedy, the prompts of ``serve_mla``):
    every dequant_matmul plan of the decode step hits the cache; both
    modes give the same tokens and launches (the graphs froze the tuned
    plans the eager steps ran), the launches equal ``serve_mla``'s, the
    report holds only the d != dv records, and the prefill logits (their
    head at M = 4 takes a tuned tile) are within TOL_F32 of
    ``serve_mla``'s.  A tuned K split sums dequant_matmul's f32 partial
    sums in another order, and this bf16 model rounds each output to
    bf16, so decode tokens may part from ``serve_mla``'s after a near
    tie: the first differing decode step of each row is reported.  Decode
    ms/step and the dequant_matmul calls' device ms per step beside
    ``serve_mla``'s."""
    import numpy as np
    import torch
    from repro_torch import kernels

    use_tuning_cache(tune_res["cache"])
    try:
        for shape in {tuple(r["shape"][:3]) for r in tune_res["rows"]
                      if r.get("mla")}:
            m, k, n = shape
            plan = kernels.get("dequant_matmul").plan(
                torch.empty((m, k), device=device),
                torch.empty((k, n), dtype=torch.int8, device=device),
                torch.empty(n, device=device))
            check(plan.cache_hit, f"serve_mla_tuned: {shape} missed the "
                  f"tuned cache: {plan}")
        rng = np.random.default_rng(serve_mla["prompts_seed"])
        prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
        r = _serve_modes(cfg, tree, "q8", device, prompts, 32)
    finally:
        use_tuning_cache(EMPTY_TUNE_CACHE)
    what = "deepseek-v3-671b tuned"
    check(r["launches"] == serve_mla["launches"],
          f"{what}: launches {r['launches']}, serve_mla "
          f"{serve_mla['launches']}")
    _, rel = rel_err(torch.from_numpy(r["logits"]),
                     torch.from_numpy(serve_mla["logits"]))
    check(rel <= TOL_F32, f"{what}: prefill logits rel {rel:.3g} from "
          f"serve_mla's > {TOL_F32}")
    tok, tok0 = r["tokens"], np.asarray(serve_mla["tokens"])
    differ = tok != tok0
    first = [int(np.argmax(row)) if row.any() else None for row in differ]
    dm, dm0 = (x["device_split_ms_per_step"]["dequant_matmul"]
               for x in (r, serve_mla))
    log(f"[serve] {what}: graphs: decode {r['decode_ms_per_step_median']:.2f}"
        f" ms/step (serve_mla {serve_mla['decode_ms_per_step_median']:.2f}),"
        f" {per_forward_launches(cfg)['dequant_matmul']} dequant_matmul "
        f"calls {dm:.3f} ms per step ({dm0:.3f}), device busy "
        f"{_fmt(r['device_busy_ms_per_step'])} "
        f"({_fmt(serve_mla['device_busy_ms_per_step'])}), replay "
        f"{_fmt(r['decode_replay_ms'])} "
        f"({_fmt(serve_mla['decode_replay_ms'])}) ms; eager "
        f"{r['eager']['decode_ms_per_step_median']:.2f} "
        f"({serve_mla['eager']['decode_ms_per_step_median']:.2f}); tokens "
        f"and launches equal in both modes, launches equal to serve_mla's; "
        f"prefill logits rel {rel:.3g} from serve_mla's; "
        f"{int(differ.sum())} of {differ.size} tokens differ from "
        f"serve_mla's, first per row at {first}")
    r["prefill_logits_rel_vs_serve_mla"] = rel
    r["tokens_differ_vs_serve_mla"] = int(differ.sum())
    r["first_differing_token"] = first
    del r["tokens"], r["logits"]
    return r


def phase_pins(device):
    """Impl pins on the card.  The llama3-8b smoke model (f32, q8) served
    with dequant_matmul pinned to ``ref``: the plain version on the card,
    no dequant_matmul launch, tokens equal to the default policy's run.
    flash_attention pinned to ``cuda`` under a strict policy with a ragged
    kv_len raises KernelDispatchError; unpinned, the same call falls back
    to the scan and records it.  Then the launcher: ``--kernel-impl
    dequant_matmul=ref`` (llama3-8b --smoke) launches no dequant_matmul,
    and ``--strict-kernels --kernel-impl flash_attention=cuda`` on
    deepseek-v3-671b --smoke (d != dv) raises."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.session import ServeConfig, ServeSession

    cfg = configs.get("llama3-8b", smoke=True)
    params = init_params(cfg, 0, device=device)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    runs = {}
    for name, pol in (("default", kernels.KernelPolicy()),
                      ("dequant_matmul=ref", kernels.KernelPolicy()
                       .override("dequant_matmul", "ref"))):
        kernels.reset_launch_counts()
        clear_reports()
        sess = ServeSession(cfg.replace(kernels=pol), params, backend="q8",
                            device=device,
                            serve_cfg=ServeConfig(slots=4, max_len=32))
        hs = [sess.submit(p, max_new_tokens=12) for p in prompts]
        sess.run()
        runs[name] = (np.stack([h.result() for h in hs]),
                      kernels.launch_counts(), kernels.dispatch_report())
    (tok, launches, rep), (tok_r, launches_r, rep_r) = runs.values()
    check(launches["dequant_matmul"] > 0 and
          launches_r["dequant_matmul"] == 0,
          f"pins: dequant_matmul launches {launches} default, "
          f"{launches_r} pinned to ref")
    check(not rep and not rep_r, f"pins: reports {rep}, {rep_r}")
    check(np.array_equal(tok, tok_r), f"pins: tokens differ with "
          f"dequant_matmul=ref:\n{tok}\n{tok_r}")
    g = torch.Generator(device=device).manual_seed(5)
    q = torch.randn((2, 16, 4, 32), generator=g, device=device)
    kv = torch.randn((2, 16, 2, 32), generator=g, device=device)
    qpos = torch.arange(16, device=device).expand(2, 16)
    kv_len = torch.tensor([16, 9], device=device, dtype=torch.int32)
    fa = kernels.get("flash_attention")
    strict = kernels.KernelPolicy(strict=True).override("flash_attention",
                                                        "cuda")
    clear_reports()
    try:
        fa(q, kv, kv, qpos, kv_len=kv_len, policy=strict)
        raised = None
    except kernels.KernelDispatchError as e:
        raised = str(e)
    check(raised is not None and "ragged" in raised,
          f"pins: strict flash_attention=cuda with a ragged kv_len: {raised}")
    clear_reports()
    fa(q, kv, kv, qpos, kv_len=kv_len)
    rec = kernels.dispatch_report()
    check([(r["requested"], r["impl"], r["kind"]) for r in rec] ==
          [(None, "scan", "fallback")] and "ragged" in rec[0]["reason"],
          f"pins: unpinned ragged call recorded {rec}")
    # the launcher, in this process
    kernels.reset_launch_counts()
    clear_reports()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.main(["--smoke", "--backend", "q8", "--steps", "8",
                    "--kernel-impl", "dequant_matmul=ref"])
    cli = kernels.launch_counts()
    check(cli["dequant_matmul"] == 0 and cli["flash_attention"] > 0,
          f"pins: launcher with dequant_matmul=ref launched {cli}")
    check("'dequant_matmul': 0" in text.getvalue(),
          f"pins: launcher printed {text.getvalue()}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(["--arch", "deepseek-v3-671b", "--smoke", "--backend",
                        "q8", "--steps", "4", "--strict-kernels",
                        "--kernel-impl", "flash_attention=cuda"])
        cli_raised = None
    except kernels.KernelDispatchError as e:
        cli_raised = str(e)
    check(cli_raised is not None and "d != dv" in cli_raised,
          f"pins: launcher strict flash_attention=cuda on MLA: {cli_raised}")
    log(f"[pins] llama3-8b smoke on {device}: dequant_matmul=ref launched "
        f"no dequant_matmul ({launches['dequant_matmul']} by default), "
        f"{tok.size} tokens equal; strict flash_attention=cuda with a "
        f"ragged kv_len raised ({raised}); unpinned it recorded "
        f"{rec[0]['reason']!r}; launcher --kernel-impl dequant_matmul=ref "
        f"launches {cli}; --strict-kernels flash_attention=cuda on "
        f"deepseek-v3-671b --smoke raised ({cli_raised})")
    return {"launches_default": launches, "launches_ref": launches_r,
            "tokens_equal": True, "strict_raised": raised,
            "fallback_record": rec[0], "launcher_launches": cli,
            "launcher_strict_raised": cli_raised}


def phase_embeds_full(device, cpu="cpu"):
    """The embeddings models at their published widths, cut in depth
    (EMBEDS_FULL_LAYERS), bf16 on q8: musicgen-medium (layernorm, gelu,
    head dim 64: the D = 64 flash instance) and qwen2-vl-7b (M-RoPE with a
    patch grid and text positions, rep-7 GQA): ``prefill(embeds=...)`` of
    4 x 128, then 31 decode steps (32 tokens) fed back through the stub
    table, eagerly; launches as predicted, an empty report.  Then each at
    EMBED_F32_LAYERS layers in f32 on q8, card against CPU: greedy tokens
    equal, prefill logits within TOL_MOE_F32_LOGITS."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree
    from repro_torch.compression.tree import unflatten
    from repro_torch.kernels import registry

    res = {}
    for arch in ("musicgen-medium", "qwen2-vl-7b"):
        cfg = configs.get(arch).replace(num_layers=EMBEDS_FULL_LAYERS[arch])
        tree = init_q8_leafwise(cfg, device)
        emb, p3, table = embed_inputs(cfg, 4, 128, 8, device)
        torch.cuda.reset_peak_memory_stats()
        clear_reports()
        registry.reset_launch_counts()
        toks, lo, pre_ms, dec_ms = greedy_embeds(tree, cfg, emb, p3, table,
                                                 32)
        launches, report = registry.launch_counts(), registry.dispatch_report()
        peak = torch.cuda.max_memory_allocated()
        what = f"{arch} {cfg.num_layers} layers q8 bf16"
        check(np.isfinite(lo).all() and lo.shape == (4, cfg.vocab_size),
              f"{what}: prefill logits {lo.shape}, finite "
              f"{np.isfinite(lo).all()}")
        check(not report, f"{what}: dispatch report not empty: {report}")
        check(launches["flash_attention"] == cfg.num_layers,
              f"{what}: {launches['flash_attention']} flash launches")
        for kern, n in per_forward_launches(cfg).items():
            check(launches[kern] == n * 32, f"{what}: {launches[kern]} "
                  f"{kern} launches, want {n} x 32 passes")
        log(f"[embeds] {what}: prefill(embeds=4 x 128) {pre_ms:.2f} ms, "
            f"decode {dec_ms:.2f} ms/step eager over 31 steps, launches "
            f"{launches}, empty report, peak {peak / 2**30:.2f} GiB; first "
            f"row tail {toks[0, -8:].tolist()}")
        res[arch] = {"layers": cfg.num_layers, "prefill_ms": pre_ms,
                     "decode_ms_per_step": dec_ms, "launches": launches,
                     "max_memory_allocated": peak,
                     "first_row_tail": toks[0, -8:].tolist()}
        del tree, emb, p3, table
        gc.collect()
        torch.cuda.empty_cache()
        # the same widths in f32, EMBED_F32_LAYERS deep, card against CPU
        cfg = cfg.replace(num_layers=EMBED_F32_LAYERS, param_dtype="float32",
                          compute_dtype="float32")
        tree = init_q8_leafwise(cfg, device)
        trees = {str(device): tree, cpu: unflatten(
            {k: v.cpu() for k, v in flatten_tree(tree).items()})}
        out = {}
        t0 = time.perf_counter()
        for dev in (str(device), cpu):
            emb, p3, table = embed_inputs(cfg, 4, 128, 9, dev)
            registry.reset_launch_counts()
            out[dev] = greedy_embeds(trees[dev], cfg, emb, p3, table,
                                     EMBED_F32_NEW_TOKENS)
            if dev == str(device):
                f32_launches = registry.launch_counts()
        cpu_s = time.perf_counter() - t0
        (tok_d, lo_d, _, _), (tok_c, lo_c, _, _) = out[str(device)], out[cpu]
        err = float(np.max(np.abs(lo_d - lo_c)) / np.max(np.abs(lo_c)))
        differ = int((tok_d != tok_c).sum())
        what = f"{arch} {cfg.num_layers} layers f32"
        log(f"[embeds] {what} on q8: card against cpu ({cpu_s:.1f} s): "
            f"prefill logits rel diff {err:.2e} (tolerance "
            f"{TOL_MOE_F32_LOGITS}), {differ} of {tok_d.size} greedy tokens "
            f"differ; card launches {f32_launches}")
        check(err <= TOL_MOE_F32_LOGITS, f"{what}: prefill logits differ "
              f"from the CPU's: rel {err:.3g}")
        check(differ == 0, f"{what}: {differ} greedy tokens differ between "
              f"{device} and cpu:\n{tok_d}\n{tok_c}")
        check(f32_launches["flash_attention"] == cfg.num_layers,
              f"{what}: {f32_launches['flash_attention']} flash launches")
        res[arch]["f32"] = {"layers": cfg.num_layers,
                            "logits_rel_diff_vs_cpu": err,
                            "tokens_differ_vs_cpu": differ,
                            "launches": f32_launches, "seconds": cpu_s}
        del tree, trees, out
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the paper's search loop: the FIM, the variational FIM, the RD sweep
# ---------------------------------------------------------------------------

def _full_cut(device, num_layers=DEPLOY_LAYERS, **overrides):
    """llama3-8b at its published widths, cut to ``num_layers`` layers."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    cfg = configs.get("llama3-8b").replace(num_layers=num_layers,
                                           **overrides)
    return cfg, init_params(cfg, 0, device=device)


def _fisher_leaves(cfg, params, what):
    """fisher_for(FIM_BATCHES x FIM_BATCH x FIM_SEQ) of ``params`` with the
    launch counts and the dispatch report of the run: (flat F, seconds,
    launches)."""
    import torch
    from repro_torch.compression import flatten_tree
    from repro_torch.compression.rd_search import fisher_for
    from repro_torch.kernels import registry

    on_card = next(iter(flatten_tree(params).values())).is_cuda
    if on_card:
        torch.cuda.synchronize()
    clear_reports()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    f = flatten_tree(fisher_for(cfg, params, batches=FIM_BATCHES,
                                batch=FIM_BATCH, seq=FIM_SEQ))
    if on_card:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, report = registry.launch_counts(), registry.dispatch_report()
    check(not report, f"fim {what}: dispatch report not empty: {report}")
    check(not any(launches.values()), f"fim {what}: kernels launched under "
          f"grad (the training path takes none): {launches}")
    for name, v in f.items():
        check(v.dtype == torch.float32 and
              bool(torch.isfinite(v).all().item()),
              f"fim {what}: {name} is not a finite f32 tensor")
    for name in ("wq", "wk", "wv"):
        check(float(f[f"layers/attn/{name}"].abs().max()) > 0,
              f"fim {what}: F of layers/attn/{name} is zero: no gradient "
              "reached the attention projections")
    return f, secs, launches


def phase_fim(device, cpu="cpu"):
    """The empirical FIM (``fisher_for``) of the full-width llama3-8b cut
    to FIM_LAYERS layers: in its bf16 on the card (every leaf finite,
    wq/wk/wv nonzero, no kernel launched, empty report), then in f32 on the
    card against the same f32 weights on the CPU, per leaf within TOL_F32
    of max|F|."""
    import torch
    from repro_torch.compression import flatten_tree
    from repro_torch.compression.tree import unflatten

    cfg, params = _full_cut(device, num_layers=FIM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    _, bf16_s, launches = _fisher_leaves(cfg, params, "bf16")
    bf16_peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32, params = _full_cut(device, num_layers=FIM_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    f_card, f32_s, _ = _fisher_leaves(cfg32, params, "f32 card")
    f32_peak = torch.cuda.max_memory_allocated()
    f_card = {k: v.cpu() for k, v in f_card.items()}
    params_cpu = unflatten({k: v.cpu()
                            for k, v in flatten_tree(params).items()})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    f_cpu, cpu_s, _ = _fisher_leaves(cfg32, params_cpu, "f32 cpu")
    del params_cpu
    errs = {}
    for name, want in f_cpu.items():
        errs[name] = rel_err(f_card[name], want)[1]
        check(errs[name] <= TOL_F32, f"fim f32: {name} on the card is "
              f"{errs[name]:.3g} of max|F| from the CPU's (> {TOL_F32})")
    worst = max(errs, key=errs.get)
    n = sum(v.numel() for v in f_cpu.values())
    log(f"[fim] llama3-8b full width, {cfg.num_layers} layers "
        f"({n / 1e9:.3f} G params), fisher_for({FIM_BATCHES} x {FIM_BATCH} "
        f"x {FIM_SEQ}): bf16 on the card {bf16_s:.2f} s (peak "
        f"{bf16_peak / 2**30:.2f} GiB), f32 on the card {f32_s:.2f} s (peak "
        f"{f32_peak / 2**30:.2f} GiB), f32 on the CPU {cpu_s:.2f} s; every "
        f"leaf finite, wq/wk/wv nonzero, launches {launches}, empty report; "
        f"card vs CPU (f32) worst leaf {worst} at {errs[worst]:.2e} of "
        f"max|F| (tolerance {TOL_F32})")
    return {"layers": cfg.num_layers, "params": n, "bf16_card_s": bf16_s,
            "f32_card_s": f32_s, "f32_cpu_s": cpu_s,
            "bf16_peak_bytes": bf16_peak, "f32_peak_bytes": f32_peak,
            "launches": launches, "rel_err_card_vs_cpu": errs}


def phase_variational(device):
    """``variational_fim`` on the full-width llama3-8b in f32, VD_STEPS
    steps, DEPLOY_LAYERS deep if (mu, rho), their AdamW moments, their
    gradients and one sampled copy (VD_BYTES_PER_PARAM) fit in nine tenths
    of the card, else one layer: sigma finite and > 0, vd_sparsify runs;
    ms/step and the peak memory."""
    import torch
    from repro_torch import configs
    from repro_torch.compression import flatten_tree
    from repro_torch.core.fim import variational_fim, vd_sparsify
    from repro_torch.data.pipeline import make_batch, to_device
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import param_specs, train_loss

    total = torch.cuda.get_device_properties(device).total_memory
    layers = DEPLOY_LAYERS
    full = configs.get("llama3-8b")
    while layers > 1:
        n = sum(math.prod(s) for s, _ in param_specs(
            full.replace(num_layers=layers)).values())
        if VD_BYTES_PER_PARAM * n <= 0.9 * total:
            break
        layers -= 1
    cfg, params = _full_cut(device, num_layers=layers,
                            param_dtype="float32", compute_dtype="float32")
    n = sum(v.numel() for v in flatten_tree(params).values())
    batches = [to_device(make_batch(cfg, i, batch=FIM_BATCH, seq=FIM_SEQ),
                         device) for i in range(FIM_BATCHES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_reports()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    res = variational_fim(lambda p, b: train_loss(p, b, cfg), params,
                          batches, steps=VD_STEPS, seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, report = registry.launch_counts(), registry.dispatch_report()
    check(not report, f"variational: dispatch report not empty: {report}")
    check(not any(launches.values()), f"variational: kernels launched "
          f"under grad: {launches}")
    del params
    sigma = flatten_tree(res.sigma)
    for name, s in sigma.items():
        check(bool(torch.isfinite(s).all().item()) and
              float(s.min()) > 0, f"variational: sigma of {name} is not "
              "finite and positive")
    kept = flatten_tree(vd_sparsify(res))
    pruned = sum(int((v == 0).sum()) for v in kept.values()) / n
    s_med = {k: float(v.float().median()) for k, v in sigma.items()}
    del res, sigma, kept
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[variational] llama3-8b full width in f32, {layers} layers "
        f"({n / 1e9:.3f} G params): variational_fim {VD_STEPS} steps in "
        f"{secs:.2f} s ({1e3 * secs / VD_STEPS:.1f} ms/step, the first "
        f"step's allocations included), peak {peak / 2**30:.2f} GiB "
        f"({peak / n:.1f} B/param) of {total / 2**30:.1f} GiB; sigma finite "
        f"and > 0 in every leaf; vd_sparsify prunes {pruned:.4f} of the "
        f"weights; no kernel launched, empty report")
    return {"layers": layers, "params": n, "steps": VD_STEPS, "seconds": secs,
            "ms_per_step": 1e3 * secs / VD_STEPS, "peak_bytes": peak,
            "peak_bytes_per_param": peak / n, "card_bytes": total,
            "pruned_share": pruned, "sigma_median": s_med}


# ---------------------------------------------------------------------------
# training (train/steps.py, train/loop.py, launch/train.py)
# ---------------------------------------------------------------------------

def _timed_manager(log: dict):
    """A ``CheckpointManager`` subclass for the loop module that records
    each save's seconds from its call to the end of its write (async
    saves included), of the write alone (``state.npz`` encoded into its
    file, the params container, fsyncs, rename) and its bytes on disk,
    the seconds each ``save`` call held the loop, and each restore's
    seconds, into ``log``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    starts: dict = {}
    log.update(saves=[], held_s=[], restores=[])

    class Timed(CheckpointManager):
        def save(self, state, step, **kw):
            t0 = time.perf_counter()
            starts.setdefault(step, []).append(t0)
            super().save(state, step, **kw)
            log["held_s"].append(time.perf_counter() - t0)

        def _write(self, payloads, meta, step):
            t0 = time.perf_counter()
            super()._write(payloads, meta, step)
            t1 = time.perf_counter()
            d = Path(self.cfg.directory) / f"step_{step:08d}"
            log["saves"].append({
                "step": step, "seconds": t1 - starts[step].pop(0),
                "write_s": t1 - t0,
                "bytes": sum(f.stat().st_size for f in d.iterdir())})

        def restore(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().restore(*args, **kw)
            log["restores"].append(time.perf_counter() - t0)
            return out

    return Timed


def _state_mismatches(got: dict, want: dict) -> list:
    """Flat names whose tensors (or scalars) differ in any bit (floats
    compared as their bit patterns, so a NaN equals itself)."""
    import torch
    from repro_torch.compression.tree import flatten_tree
    g, w = flatten_tree(got), flatten_tree(want)
    bad = sorted(set(g) ^ set(w))
    for k in sorted(set(g) & set(w)):
        a, b = g[k], w[k]
        if isinstance(a, torch.Tensor):
            same = _bits_equal(a, b)
        else:
            same = int(a) == int(b)
        if not same:
            bad.append(k)
    return bad


def train_step_bound(cfg, batch, seq) -> dict:
    """The train step's least time on the card: the matmul FLOPs of
    forward and backward (6 x the matmul parameters x the tokens, plus
    the attention products, 12 B S^2 d a layer) at the bf16 tensor-core
    peak, but the untied head's at the f32 peak (``_head_logits``
    multiplies in f32, as the reference does), then the bytes the step
    must move (params, moments and their scales, error feedback: each
    read once and written once) at the HBM rate.  The parts add: the
    optimizer's pass needs every gradient.  ``all_bf16_ms`` counts the
    head at the bf16 rate too."""
    from repro_torch.compression.q8 import q8_scale_shape
    from repro_torch.models.transformer import param_specs
    specs = param_specs(cfg)
    n = sum(math.prod(s) for s, _ in specs.values())
    n_mm = sum(math.prod(s) for k, (s, _) in specs.items()
               if len(s) >= 2 and k != "embed")
    n_head = math.prod(specs["head"][0])
    tokens = batch * seq
    flops = 6 * n_mm * tokens + 12 * batch * seq * seq * cfg.d_model \
        * cfg.num_layers
    head_flops = 6 * n_head * tokens
    pbytes = 2 if cfg.param_dtype == "bfloat16" else 4
    scales = sum(4 * math.prod(q8_scale_shape(tuple(s)))
                 for s, _ in specs.values())
    moved = 2 * (n * (pbytes + 2 + 4) + 2 * scales)
    flops_ms = 1e3 * ((flops - head_flops) / BF16_FLOPS
                      + head_flops / F32_FLOPS)
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    return {"params": n, "matmul_params": n_mm, "tokens": tokens,
            "flops": flops, "head_f32_flops": head_flops, "bytes": moved,
            "bytes_per_param": moved / n, "flops_ms": flops_ms,
            "bytes_ms": bytes_ms, "bound_ms": flops_ms + bytes_ms,
            "all_bf16_ms": 1e3 * flops / BF16_FLOPS + bytes_ms}


def _train_split(cfg, state, step_fn, first_step):
    """Two steps of ``state`` under ``torch.profiler`` (CPU and CUDA
    activity; a warm-up step first): device busy ms a step, the idle
    share of the traced wall time, and the split of the busy time into
    EF and AdamW (the kernels launched inside ``step_fn``'s
    ``train_step/ef`` and ``train_step/adamw`` ranges) and the rest
    (forward and backward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.data.pipeline import make_batch
    steps_traced = 2
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=steps_traced,
                                     repeat=1))
    wall = 0.0
    with prof:
        for i in range(1 + steps_traced):
            batch = make_batch(cfg, first_step + i, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, metrics = step_fn(state, batch)
            state.update(new)
            float(metrics["loss"])
            torch.cuda.synchronize()
            if i:
                wall += time.perf_counter() - t0
            prof.step()
    events = prof.key_averages()
    busy, top = _device_time(events)
    if busy is None:
        return {"busy_ms_per_step": None, "note": "the profiler saw no "
                "device time", "wall_ms_per_step": 1e3 * wall / steps_traced}
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.key in ("train_step/ef", "train_step/adamw") and
              not str(e.device_type).endswith("CUDA")}
    ef = ranges.get("train_step/ef")
    adam = ranges.get("train_step/adamw")
    split = None
    if ef and adam:
        split = {"fwd_bwd_ms": (busy - ef - adam) / steps_traced,
                 "ef_ms": ef / steps_traced,
                 "adamw_ms": adam / steps_traced}
    return {"busy_ms_per_step": busy / steps_traced,
            "wall_ms_per_step": 1e3 * wall / steps_traced,
            "idle_share": 1.0 - busy / (1e3 * wall),
            "split": split,
            "top_device_ms_per_step": {k: v / steps_traced for k, v in top}}


def _smoke_steps(device, cpu="cpu"):
    """TRAIN_SMOKE_STEPS steps of the llama3-8b and deepseek-moe-16b smoke
    models in f32 with 8-bit moments and error feedback, on the card and
    on the CPU from the same weights and batches: losses within
    TOL_TRAIN_LOSS; parameters within TOL_TRAIN_PARAM of each leaf's
    max|p| but for TRAIN_PART_SHARE of a leaf's weights, and moment codes
    within TRAIN_CODE_TOL (a code on a rounding boundary rounds either
    way after last-bit differences in the gradients, as in
    ``tests/test_torch_train.py``)."""
    import torch
    from repro_torch import configs
    from repro_torch.compression.tree import flatten_tree, unflatten
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.compress import CompressionConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step

    out = {}
    opt = AdamWConfig(lr=1e-2, quantized_moments=True)
    comp = CompressionConfig(enabled=True)
    for arch in ("llama3-8b", "deepseek-moe-16b"):
        cfg = configs.get(arch, smoke=True)
        states = {d: init_train_state(cfg, opt, comp, device=d)
                  for d in (cpu, device)}
        states[device]["params"] = unflatten(
            {k: v.to(device) for k, v in
             flatten_tree(states[cpu]["params"]).items()})
        _, make = make_train_step(cfg, None, opt, comp, total_steps=12,
                                  warmup=2)
        fn = make(None, None)
        losses = {d: [] for d in states}
        for i in range(TRAIN_SMOKE_STEPS):
            batch = make_batch(cfg, i, batch=2, seq=16, seed=0)
            for d, st in states.items():
                losses[d].append(float(fn(st, batch)[1]["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(losses[device], losses[cpu]))
        check(rel <= TOL_TRAIN_LOSS, f"train {arch} smoke: card losses "
              f"{losses[device]} vs CPU {losses[cpu]} (rel {rel:.2e})")
        got, want = (flatten_tree(states[d]) for d in (device, cpu))
        worst_share, worst_code = 0.0, 0
        for k, w in want.items():
            if not isinstance(w, torch.Tensor):
                check(int(got[k]) == int(w), f"train {arch}: {k}")
                continue
            g = got[k].cpu()
            if k.startswith("params/"):
                far = (g - w).abs() > TOL_TRAIN_PARAM * w.abs().max()
                worst_share = max(worst_share, float(far.float().mean()))
            elif w.dtype == torch.int8:
                worst_code = max(worst_code, int(
                    (g.to(torch.int16) - w.to(torch.int16)).abs().max()))
        check(worst_share <= TRAIN_PART_SHARE and
              worst_code <= TRAIN_CODE_TOL, f"train {arch} smoke: card vs "
              f"CPU parameters part in {worst_share:.4f} of a leaf (> "
              f"{TRAIN_PART_SHARE}) or codes by {worst_code} (> "
              f"{TRAIN_CODE_TOL})")
        out[arch] = {"losses_card": losses[device],
                     "losses_cpu": losses[cpu], "loss_rel": rel,
                     "param_part_share": worst_share,
                     "code_max_diff": worst_code}
    return out


def phase_train(device):
    """The training path on the card: llama3-8b at its published widths
    cut to TRAIN_LAYERS layers, 8-bit AdamW moments and error-feedback
    gradient compression, batches of TRAIN_BATCH x TRAIN_SEQ.  (a) a
    straight ``train_loop`` of TRAIN_STEPS steps; (b) the same with raw
    async checkpoints every TRAIN_CKPT_EVERY steps under ``build/``,
    SIGTERM sent while step TRAIN_SIGTERM_AT + 1 runs, off the cadence
    (the loop ends after it with a final save), then a resumed loop to the
    end (its last step a cadence save, not written twice): the saves are
    those two steps, its
    losses and final state equal (a)'s bit for bit (under
    ``torch.use_deterministic_algorithms``); (c) ``make_prefill_step`` and
    TRAIN_DECODE greedy ``make_decode_step``s on the trained params: the
    tokens of ``ServeEngine.generate`` (bf16), flash_attention launched
    once a layer, an empty report; the profiler's split of a step;
    (d) the documented launcher on the smoke model, whose loss falls and
    whose DeepCABAC checkpoint restores; the smoke models' steps card
    against CPU.  Every directory it writes is removed."""
    import os
    import shutil
    import signal
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import (CheckpointConfig,
                                                CheckpointManager)
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.compress import CompressionConfig
    from repro_torch.kernels import registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import loop as loop_mod
    from repro_torch.train.steps import (init_train_state, make_decode_step,
                                         make_prefill_step, make_train_step)

    cfg = configs.get("llama3-8b").replace(num_layers=TRAIN_LAYERS)
    opt = AdamWConfig(quantized_moments=True)
    comp = CompressionConfig(enabled=True)
    loop = loop_mod.LoopConfig(total_steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, ckpt_every=TRAIN_CKPT_EVERY)
    bound = train_step_bound(cfg, TRAIN_BATCH, TRAIN_SEQ)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out: dict = {"layers": TRAIN_LAYERS, "steps": TRAIN_STEPS,
                 "batch": [TRAIN_BATCH, TRAIN_SEQ], "bound": bound}
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        # (a) straight
        captured = {}
        init = loop_mod.init_train_state

        def capture(*args, **kw):
            captured["state"] = init(*args, **kw)
            return captured["state"]
        step_peak: dict = {}
        make_step = loop_mod.make_train_step

        def peak_of_one_step(*args, **kw):
            # the peak of step TRAIN_PEAK_STEP alone (the dry run's traced
            # peak is held to it); the loop's peak before the reset is
            # kept and taken with the one after
            step_fn_, jitted = make_step(*args, **kw)

            def jitted_peak(state, probe):
                fn, calls = jitted(state, probe), [0]

                def fn_peak(st, b):
                    calls[0] += 1
                    if calls[0] != TRAIN_PEAK_STEP:
                        return fn(st, b)
                    torch.cuda.synchronize()
                    step_peak["loop_before"] = \
                        torch.cuda.max_memory_allocated()
                    step_peak["start"] = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    res = fn(st, b)
                    torch.cuda.synchronize()
                    step_peak["peak"] = torch.cuda.max_memory_allocated()
                    return res
                return fn_peak
            return step_fn_, jitted_peak
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        clear_reports()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(loop_mod, "init_train_state", capture), \
                mock.patch.object(loop_mod, "make_train_step",
                                  peak_of_one_step):
            res_a = loop_mod.train_loop(cfg, None, loop, opt, comp,
                                        device=device)
        torch.cuda.synchronize()
        secs_a = time.perf_counter() - t0
        peak = max(step_peak["loop_before"], torch.cuda.max_memory_allocated())
        launches = registry.launch_counts()
        report = registry.dispatch_report()
        check(not report, f"train (a): dispatch report not empty: {report}")
        check(not any(launches.values()), f"train (a): kernels launched "
              f"under grad (attention takes the scan): {launches}")
        check(res_a.final_step == TRAIN_STEPS and
              all(math.isfinite(x) for x in res_a.losses),
              f"train (a): {res_a.final_step} steps, losses {res_a.losses}")
        state_a = captured["state"]
        step_ms = sorted(1e3 * t for t in res_a.step_times[2:])
        ms = step_ms[len(step_ms) // 2]
        out["a"] = {"losses": res_a.losses, "seconds": secs_a,
                    "step_ms": [1e3 * t for t in res_a.step_times],
                    "ms_per_step": ms, "tokens_per_s":
                        1e3 * TRAIN_BATCH * TRAIN_SEQ / ms,
                    "peak_bytes": peak,
                    "peak_bytes_per_param": peak / bound["params"],
                    "step_peak_bytes": step_peak["peak"],
                    "step_start_bytes": step_peak["start"],
                    "stragglers": res_a.straggler_steps}
        log(f"[train] (a) llama3-8b full width, {TRAIN_LAYERS} layers "
            f"({bound['params'] / 1e9:.3f} G params, {cfg.param_dtype}), "
            f"8-bit moments "
            f"+ EF, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: "
            f"losses {res_a.losses[0]:.4f} -> {res_a.losses[-1]:.4f}, "
            f"{ms:.2f} ms/step (median after 2; bound "
            f"{bound['bound_ms']:.2f} = {bound['flops_ms']:.2f} FLOPs + "
            f"{bound['bytes_ms']:.2f} bytes; {bound['all_bf16_ms']:.2f} "
            f"with the f32 head at the bf16 rate), "
            f"{out['a']['tokens_per_s']:.0f} tokens/s, peak "
            f"{peak / 2**30:.2f} GiB ({peak / bound['params']:.2f} "
            f"B/param), no kernel launched, empty report")

        # (b) preempted at step TRAIN_SIGTERM_AT, then resumed
        ck = CheckpointConfig(str(TRAIN_DIR / "b"), params_mode="raw",
                              async_save=True, keep=2)
        timing: dict = {}

        def hooked(cfg_, step, **kw):
            if step == TRAIN_SIGTERM_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            return make_batch(cfg_, step, **kw)
        make_step = loop_mod.make_train_step

        def capture_step(*args, **kw):
            # the state the loop trains (the resumed run's: restored from
            # its checkpoint), updated in place by the step
            step_fn_, jitted = make_step(*args, **kw)

            def jitted_capture(state, probe):
                captured["state"] = state
                return jitted(state, probe)
            return step_fn_, jitted_capture
        t0 = time.perf_counter()
        with mock.patch.object(loop_mod, "CheckpointManager",
                               _timed_manager(timing)):
            with mock.patch.object(loop_mod, "make_batch", hooked):
                cut = loop_mod.train_loop(cfg, None, loop, opt, comp, ck,
                                          device=device)
            cut_s = time.perf_counter() - t0
            steps_on_disk = CheckpointManager(ck).steps()
            check(cut.final_step == TRAIN_SIGTERM_AT + 1 and
                  steps_on_disk[-1] == TRAIN_SIGTERM_AT + 1,
                  f"train (b): SIGTERM in step {TRAIN_SIGTERM_AT + 1} "
                  f"ended at {cut.final_step}, on disk {steps_on_disk}")
            t0 = time.perf_counter()
            with mock.patch.object(loop_mod, "make_train_step",
                                   capture_step):
                resumed = loop_mod.train_loop(cfg, None, loop, opt, comp,
                                              ck, device=device)
            resumed_s = time.perf_counter() - t0
        steps_on_disk = CheckpointManager(ck).steps()
        check(cut.losses == res_a.losses[:len(cut.losses)] and
              resumed.losses == res_a.losses[len(cut.losses):],
              f"train (b): losses {cut.losses} + {resumed.losses} are not "
              f"the straight run's {res_a.losses} bit for bit")
        check(steps_on_disk[-1] == TRAIN_STEPS and
              len(timing["restores"]) == 1, f"train (b): on disk "
              f"{steps_on_disk}, {len(timing['restores'])} restores")
        saved_steps = [sv_["step"] for sv_ in timing["saves"]]
        check(saved_steps == [TRAIN_SIGTERM_AT + 1, TRAIN_STEPS],
              f"train (b): saved steps {saved_steps}, want the preempted "
              f"loop's final save at {TRAIN_SIGTERM_AT + 1} and the "
              f"resumed loop's cadence save at {TRAIN_STEPS}, once")
        bad = _state_mismatches(captured.pop("state"), state_a)
        check(not bad, f"train (b): the resumed run's final state differs "
              f"from the straight run's in {bad}")
        out["b"] = {"cut_losses": cut.losses,
                    "resumed_losses": resumed.losses, "cut_s": cut_s,
                    "resumed_s": resumed_s, "saves": timing["saves"],
                    "held_s": timing["held_s"],
                    "restores_s": timing["restores"],
                    "steps_on_disk": steps_on_disk}
        sv = timing["saves"]
        log(f"[train] (b) SIGTERM in step {TRAIN_SIGTERM_AT + 1}: the loop "
            f"ended at {cut.final_step} with a final save; resumed from "
            f"{cut.final_step} to {resumed.final_step}: losses and the "
            f"final params, 8-bit moments, EF and counters equal (a)'s bit "
            f"for bit; saves (raw, async) "
            + ", ".join(f"step {s['step']} {s['seconds']:.2f} s (write "
                        f"{s['write_s']:.2f}) {s['bytes'] / 1e9:.2f} GB"
                        for s in sv)
            + f"; restores " + ", ".join(
                f"{t:.2f}" for t in out["b"]["restores_s"]) + " s")
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # (c) prefill and greedy decode steps on the trained params
    params = state_a["params"]
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (TRAIN_PROMPTS, TRAIN_SEQ)) \
        .astype(np.int32)
    max_len = TRAIN_SEQ + TRAIN_DECODE + 1
    prefill = make_prefill_step(cfg, None, max_len=max_len)
    decode = make_decode_step(cfg, None)
    clear_reports()
    registry.reset_launch_counts()
    toks = torch.from_numpy(prompts).to(device, torch.int64)
    logits, caches = prefill(params, {"tokens": toks})
    got = [logits.argmax(-1)]
    for i in range(TRAIN_DECODE):
        pos = torch.full((TRAIN_PROMPTS,), TRAIN_SEQ + i, dtype=torch.int32,
                         device=device)
        logits, caches = decode(params, caches, {"tokens": got[-1]}, pos)
        got.append(logits.argmax(-1))
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    report = registry.dispatch_report()
    got = torch.stack(got, 1).cpu().numpy()
    del caches, logits
    check(launches["flash_attention"] == TRAIN_LAYERS and
          not launches["dequant_matmul"] and not report,
          f"train (c): launches {launches} (flash_attention "
          f"{TRAIN_LAYERS} expected), report {report}")
    engine = ServeEngine(cfg, params, max_len=max_len, backend="bf16",
                         device=device)
    want = engine.generate(prompts, TRAIN_DECODE + 1)[:, TRAIN_SEQ:]
    del engine
    check(np.array_equal(got, want), f"train (c): make_prefill_step / "
          f"make_decode_step tokens {got.tolist()} != ServeEngine's "
          f"{want.tolist()}")
    out["c"] = {"launches": launches, "tokens": got.tolist()}
    log(f"[train] (c) make_prefill_step + {TRAIN_DECODE} make_decode_steps "
        f"on the trained params: {TRAIN_PROMPTS} x {TRAIN_DECODE + 1} greedy "
        f"tokens equal ServeEngine.generate's (bf16); launches {launches}, "
        f"empty report")

    # the profiler's split of a step, on (a)'s state
    _, make = make_train_step(cfg, None, opt, comp, total_steps=TRAIN_STEPS)
    step_fn = make(None, None)
    out["trace"] = _train_split(cfg, state_a, lambda s, b: step_fn(s, b),
                                TRAIN_STEPS)
    del state_a, params, captured
    gc.collect()
    torch.cuda.empty_cache()
    tr = out["trace"]
    if tr.get("split"):
        sp = tr["split"]
        split_txt = (f"forward+backward {sp['fwd_bwd_ms']:.2f}, EF "
                     f"{sp['ef_ms']:.2f}, AdamW {sp['adamw_ms']:.2f} ms")
    else:
        split_txt = "split not measured (no device time in the ranges)"
    log(f"[train] traced step: busy {_fmt(tr.get('busy_ms_per_step'))} of "
        f"{tr['wall_ms_per_step']:.2f} ms (idle "
        f"{_fmt(tr.get('idle_share'))}); {split_txt}")

    # (d) the documented launcher, smoke size
    cli_dir = TRAIN_DIR / "cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "llama3-8b", "--smoke", "--steps", str(TRAIN_CLI_STEPS),
             "--ckpt-dir", str(cli_dir), "--compress-grads"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(SRC)})
        cli_s = time.perf_counter() - t0
        check(res.returncode == 0, f"train (d): the launcher failed: "
              f"{res.stderr[-2000:]}")
        line = res.stdout.strip().splitlines()[-1]
        vals = dict(kv.split("=") for kv in line.split())
        check(int(vals["steps"]) == TRAIN_CLI_STEPS and
              float(vals["last_loss"]) < float(vals["first_loss"]),
              f"train (d): the launcher's loss did not fall: {line}")
        smoke = configs.get("llama3-8b", smoke=True)
        template = init_train_state(smoke, AdamWConfig(lr=1e-3), comp,
                                    device=device)
        st, meta = CheckpointManager(CheckpointConfig(str(cli_dir))) \
            .restore(template, device=device)
        check(meta["codec"] == "ckpt-nearest" and
              int(st["step"]) == TRAIN_CLI_STEPS and
              all(bool(torch.isfinite(p).all()) for p in
                  _leaves(st["params"])),
              f"train (d): the launcher's checkpoint restored to step "
              f"{int(st['step'])} with codec {meta['codec']}")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out["d"] = {"line": line, "seconds": cli_s,
                "ckpt_compressed_bytes": meta["params_compressed_bytes"],
                "ckpt_raw_bytes": meta["params_raw_bytes"]}
    log(f"[train] (d) python -m repro_torch.launch.train --smoke --steps "
        f"{TRAIN_CLI_STEPS} --compress-grads --ckpt-dir ...: {line} "
        f"({cli_s:.1f} s); its ckpt-nearest step restores "
        f"({meta['params_compressed_bytes']} of {meta['params_raw_bytes']} "
        f"bytes)")

    out["smoke"] = _smoke_steps(device)
    log("[train] smoke steps card vs CPU (f32, 8-bit moments, EF): "
        + "; ".join(f"{a} losses rel {v['loss_rel']:.2e}, params part in "
                    f"{v['param_part_share']:.4f}, codes within "
                    f"{v['code_max_diff']}" for a, v in out["smoke"].items()))
    out["launches"] = out["c"]["launches"]
    return out


# ---------------------------------------------------------------------------
# the dry run (launch/dryrun.py, launch/hlo_analysis.py)
# ---------------------------------------------------------------------------

def dryrun_named_flops(cfg, batch, seq, model_axis: int) -> dict:
    """What a traced train step's FLOPs (every rank's summed) differ from
    ``train_step_bound``'s by, each named: ``norms``, the bound counts
    the stacked (L, d) norm scales as matmul parameters; ``kv_shared``,
    on a model axis of t above the G key/value heads each rank projects
    the one head its query heads share, so t heads' ``wk`` and ``wv``
    products are computed where the whole step has G; ``scan_pad``, the
    attention scan pads the keys to a multiple of ``attn_kv_block``;
    ``heads_width``, the bound's attention term takes d where the heads
    span H x Dh (0 where they are equal)."""
    from repro_torch.models.transformer import param_specs
    tokens, layers = batch * seq, cfg.num_layers
    norms = sum(math.prod(s) for k, (s, _) in param_specs(cfg).items()
                if len(s) == 2 and k.startswith("layers/"))
    g, width = cfg.num_kv_heads, cfg.num_heads * cfg.head_dim
    extra_heads = model_axis - g if model_axis > 1 and g % model_axis \
        else 0
    block = cfg.attn_kv_block
    padded = -(-seq // block) * block
    return {"norms": -6 * norms * tokens,
            "kv_shared": 6 * tokens * layers * 2 * cfg.d_model
            * cfg.head_dim * extra_heads,
            "scan_pad": 12 * batch * seq * (padded - seq) * width * layers,
            "heads_width": 12 * batch * seq * seq * (width - cfg.d_model)
            * layers}


def _dryrun_flops(res, cfg, batch, seq, model_axis, what) -> dict:
    """The traced FLOPs of all ranks against ``train_step_bound``'s plus
    the named differences, within DRYRUN_FLOPS_TOL."""
    total = res["flops_per_device"] * res["n_chips"]
    bound = train_step_bound(cfg, batch, seq)["flops"]
    named = dryrun_named_flops(cfg, batch, seq, model_axis)
    want = bound + sum(named.values())
    rel = abs(total - want) / want
    check(rel <= DRYRUN_FLOPS_TOL, f"dryrun {what}: traced FLOPs {total:.6e} "
          f"(x {res['n_chips']} ranks) against the bound's {bound:.6e} + "
          f"named {named} = {want:.6e}: rel {rel:.2e}")
    return {"traced": total, "bound": bound, "named": named,
            "expected": want, "rel": rel, "raw_ratio": total / bound}


def phase_dryrun(device, train):
    """(a) ``python -m repro_torch.launch.dryrun --arch llama3-8b --shape
    train_4k --mesh single`` and ``--mesh multi`` in two subprocesses at
    once (fake worlds of 256 and 512 ranks, fake CUDA tensors): each
    exits 0 with nothing allocated on the card; per-rank FLOPs, bytes,
    collectives by kind, argument and peak bytes; all ranks' FLOPs
    against ``train_step_bound`` at 32 layers and 256 x 4096.  (b) While
    they run, the train phase's configuration (``TRAIN_LAYERS`` layers,
    8-bit moments and EF, ``TRAIN_BATCH`` x ``TRAIN_SEQ``, mesh-free)
    traced here: nothing allocated, its FLOPs against the bound, its peak
    against the peak the train phase measured over step
    ``TRAIN_PEAK_STEP``.  No kernel is launched (training launches none);
    the ``kernels`` line is unchanged."""
    import os

    import torch
    from repro_torch import configs
    from repro_torch.distributed.compress import CompressionConfig
    from repro_torch.launch import dryrun
    from repro_torch.optim.adamw import AdamWConfig

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    procs, paths = {}, {}
    for kind in ("single", "multi"):
        paths[kind] = Path(dryrun.cell_path(DRYRUN_ARCH, DRYRUN_SHAPE, kind))
        paths[kind].unlink(missing_ok=True)
        procs[kind] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_ARCH, "--shape", DRYRUN_SHAPE, "--mesh", kind],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out: dict = {}
    try:
        # (b) the train phase's configuration, mesh-free
        cfg = configs.get(DRYRUN_ARCH).replace(num_layers=TRAIN_LAYERS)
        inputs = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ),
                                 dtype=torch.int32, device="meta")
                  for k in ("tokens", "labels")}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trace = dryrun.trace_train(cfg, AdamWConfig(quantized_moments=True),
                                   CompressionConfig(enabled=True), inputs,
                                   device=device)
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        check(after == before, f"dryrun (b): the trace allocated "
              f"{after - before} bytes on the card")
        res = dryrun.analyze(trace, 1)
        del trace
        flops = _dryrun_flops(res, cfg, TRAIN_BATCH, TRAIN_SEQ, 1,
                              "(b) the train configuration")
        measured = train["a"]["step_peak_bytes"]
        peak = res["memory"]["peak_bytes"]
        rel = abs(peak - measured) / measured
        check(rel <= DRYRUN_PEAK_TOL, f"dryrun (b): traced peak "
              f"{peak / 2**30:.3f} GiB against the train phase's measured "
              f"{measured / 2**30:.3f} GiB (rel {rel:.3f})")
        out["b"] = {**res, "flops": flops, "trace_s": secs,
                    "measured_peak_bytes": measured,
                    "measured_start_bytes": train["a"]["step_start_bytes"],
                    "peak_rel": rel}
        mem = res["memory"]
        log(f"[dryrun] (b) llama3-8b {TRAIN_LAYERS} layers, {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}, 8-bit moments + EF, mesh-free, traced in "
            f"{secs:.1f} s: FLOPs {flops['traced']:.6e} = bound "
            f"{flops['bound']:.6e} + named {flops['named']} within "
            f"{flops['rel']:.2e}; peak {peak / 2**30:.3f} GiB against "
            f"{measured / 2**30:.3f} measured over step {TRAIN_PEAK_STEP} "
            f"(rel {rel:.3f}; the step began with "
            f"{train['a']['step_start_bytes'] / 2**30:.3f} GiB allocated, "
            f"the trace's arguments {mem['argument_bytes'] / 2**30:.3f}); "
            f"by range " + ", ".join(
                f"{k} {v['flops']:.3e} FLOPs {v['bytes'] / 1e9:.2f} GB"
                for k, v in res["per_comp"].items()))
    finally:
        texts = {}
        for kind, p in procs.items():
            try:
                texts[kind] = p.communicate(timeout=DRYRUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                texts[kind] = p.communicate()

    # (a) the production cells
    cfg = configs.get(DRYRUN_ARCH)
    seq, batch, _ = configs.SHAPES[DRYRUN_SHAPE]
    for kind, p in procs.items():
        stdout, stderr = texts[kind]
        check(p.returncode == 0, f"dryrun (a) {kind}: exit {p.returncode}: "
              f"{stdout[-1500:]}{stderr[-2500:]}")
        res = json.loads(paths[kind].read_text())
        check(res["device_allocated_bytes"] == 0,
              f"dryrun (a) {kind}: {res['device_allocated_bytes']} bytes "
              "allocated on the card")
        flops = _dryrun_flops(res, cfg, batch, seq, 16, f"(a) {kind}")
        out[kind] = {**res, "flops": flops}
        log(f"[dryrun] (a) {DRYRUN_ARCH} {DRYRUN_SHAPE} on the fake "
            f"{res['n_chips']}-rank world: {dryrun.summary(res)}; all ranks' "
            f"FLOPs {flops['traced']:.6e} = bound {flops['bound']:.6e} "
            f"(x{flops['raw_ratio']:.4f}) + named {flops['named']} within "
            f"{flops['rel']:.2e}; by range " + ", ".join(
                f"{k} {v['flops']:.3e} FLOPs {v['bytes'] / 1e9:.2f} GB "
                f"{v['collective_bytes'] / 1e9:.3f} GB coll"
                for k, v in res["per_comp"].items()))
    return out


# ---------------------------------------------------------------------------
# distribution on a one-rank NCCL world (distributed/, launch/mesh.py,
# checkpoint restores onto a DeviceMesh, a backend's mesh=)
# ---------------------------------------------------------------------------

def nccl_world() -> str:
    """Initialise the one-rank NCCL process group the distribution phases
    run on; its rendezvous is a ``FileStore`` under ``build/`` (no
    network).  Returns the backend's name."""
    import torch
    import torch.distributed as dist
    DIST_STORE.parent.mkdir(parents=True, exist_ok=True)
    DIST_STORE.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(DIST_STORE), 1),
                            rank=0, world_size=1)
    check(dist.get_backend() == "nccl", f"process group on "
          f"{dist.get_backend()}, not NCCL")
    return dist.get_backend()


def _bits_equal(a, b) -> bool:
    """Equal dtype, shape and bits (``b`` moved to ``a``'s device)."""
    import torch
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    b = b.to(a.device)
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.view(as_int.get(a.dtype, a.dtype)),
                        b.view(as_int.get(b.dtype, b.dtype))))


def phase_mesh_restore(device, swap):
    """Restores onto the card's ``DeviceMesh`` (data 1, model 1) from
    delta_swap's chain, without a new encode: ``restore_on_mesh`` of the
    keyframe, every leaf a DTensor whose local tensor equals, bit for
    bit, the keyframe's host decode (its coded levels as delta_swap's cold
    start decoded them through ``restore_flat``'s path, its raw records
    read here, dequantized as ``restore_flat`` dequantizes them);
    ``restore_on_mesh_delta`` of the first P-frame against delta_swap's
    host chain decode of that step (the P-frame applied to the keyframe's
    levels, as ``restore_flat_delta`` resolves it; reused, not decoded
    again, for time: a frame of the chain rereads the raw embed and head,
    so the last P-frame would cost one more); ``restore_local_slices`` of
    device 0 of
    SWAP_MESH decoding fewer values than the manifest holds; and a bf16
    backend with ``mesh=`` loading the keyframe into a graph-replaying
    ``ServeSession`` whose greedy tokens equal those of the same
    backend's load of the same entries without a mesh, with flash
    launched once a prefill and layer and an empty report."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.checkpoint import delta, sharded
    from repro_torch.checkpoint.sharded import MeshSpec
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import device_mesh, make_local_mesh
    from repro_torch.serve.backends import get_backend
    from repro_torch.serve.session import ServeConfig, ServeSession

    root = Path(swap["root"])
    steps = swap["steps"]
    key = root / f"step_{steps[0]:08d}"
    mesh = device_mesh(make_local_mesh(1, 1), device)
    out: dict = {"mesh": {"data": 1, "model": 1}}
    secs = {}

    t0 = time.perf_counter()
    placed = sharded.restore_on_mesh(str(key), mesh,
                                     workers=MESH_RESTORE_WORKERS)
    torch.cuda.synchronize()
    secs["restore_on_mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    manifest = sharded.load_manifest(str(key))
    entries = dict(swap.pop("key_levels"))
    for name, tinfo in sorted(manifest["tensors"].items()):
        if name not in entries:         # raw records: not tracked levels
            entries[name] = sharded.assemble_slice(
                str(key), name, tinfo, num_gr=manifest.get("num_gr"),
                dequantize=False)
    secs["host_raw_records"] = time.perf_counter() - t0

    def want_of(rec):
        return rec if isinstance(rec, torch.Tensor) else rec.dequantize()
    bad = sorted(set(placed) ^ set(entries))
    for name, rec in entries.items():
        got = placed.get(name)
        if not (isinstance(got, DTensor) and
                _bits_equal(got.to_local(), want_of(rec))):
            bad.append(name)
    check(not bad, f"mesh_restore: restore_on_mesh of the keyframe differs "
          f"from its host decode in {bad}")
    out["keyframe_tensors"] = len(placed)
    out["keyframe_coded"] = sum(not isinstance(r, torch.Tensor)
                                for r in entries.values())
    del placed

    t0 = time.perf_counter()
    pstep = swap["chain_step"]
    on_mesh = delta.restore_on_mesh_delta(str(root), pstep, mesh,
                                          workers=MESH_RESTORE_WORKERS)
    torch.cuda.synchronize()
    secs["restore_on_mesh_delta"] = time.perf_counter() - t0
    chain = swap.pop("chain_entries")
    bad = sorted(set(on_mesh) ^ set(chain))
    for name, rec in chain.items():
        got = on_mesh.get(name)
        if not (isinstance(got, DTensor) and
                _bits_equal(got.to_local(), want_of(rec))):
            bad.append(name)
    check(not bad, f"mesh_restore: restore_on_mesh_delta of step "
          f"{pstep} differs from the host chain in {bad}")
    del on_mesh, chain

    stats = sharded.RestoreStats()
    t0 = time.perf_counter()
    sharded.restore_local_slices(str(key), MeshSpec.from_any(SWAP_MESH), [0],
                                 stats=stats)
    secs["local_slices"] = time.perf_counter() - t0
    total = sharded.manifest_total_values(sharded.load_manifest(str(key)))
    check(0 < stats.decoded_values < total, f"mesh_restore: device 0 of "
          f"{SWAP_MESH} decoded {stats.decoded_values} of {total} values")
    out["local_slices"] = {**stats.as_dict(), "manifest_values": total}

    cfg = configs.get("llama3-8b").replace(num_layers=DELTA_SWAP_LAYERS)
    prompts = swap["prompts"]
    scfg = ServeConfig(slots=len(prompts),
                       max_len=prompts.shape[1] + SWAP_LATE_TOKENS)
    runs = {}
    for mode in ("mesh", "plain"):
        gc.collect()
        torch.cuda.empty_cache()
        clear_reports()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        if mode == "mesh":
            sess = ServeSession(cfg, str(key),
                                backend=get_backend("bf16", mesh=mesh),
                                serve_cfg=scfg, device=device)
        else:
            be = get_backend("bf16")
            sess = ServeSession.from_loaded(
                cfg, be.load_entries(cfg, entries, device), backend=be,
                serve_cfg=scfg, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        hs = [sess.submit(p, SWAP_LATE_TOKENS) for p in prompts]
        sess.run()
        torch.cuda.synchronize()
        runs[mode] = {"tokens": [list(h.tokens) for h in hs],
                      "launches": registry.launch_counts(),
                      "report": registry.dispatch_report(),
                      "graphs": dict(sess.graphs.stats), "load_s": load_s,
                      "leaf_types": sorted({type(v).__name__ for v in
                                            _leaves(sess.params)})}
        sess.close()
        del sess
    del entries
    m, p = runs["mesh"], runs["plain"]
    check(m["tokens"] == p["tokens"], f"mesh_restore: the mesh-loaded "
          f"session's tokens {m['tokens']} != the plain load's "
          f"{p['tokens']}")
    check(m["launches"]["flash_attention"] == flash_per_prefill(cfg) and
          not m["launches"]["dequant_matmul"] and not m["report"] and
          m["launches"] == p["launches"] and m["leaf_types"] == ["Tensor"],
          f"mesh_restore: launches {m['launches']} (plain "
          f"{p['launches']}; {flash_per_prefill(cfg)} flash expected), "
          f"report {m['report']}, leaves {m['leaf_types']}")
    check(m["graphs"]["replays"] > 0, f"mesh_restore: the session replayed "
          f"no graph: {m['graphs']}")
    out.update(seconds=secs, serve=runs, launches=m["launches"])
    log(f"[mesh_restore] delta_swap's chain onto the card's DeviceMesh "
        f"(data 1, model 1), NCCL: restore_on_mesh of the keyframe "
        f"{secs['restore_on_mesh']:.2f} s ({out['keyframe_tensors']} "
        f"DTensors equal its host decode bit for bit: "
        f"{out['keyframe_coded']} coded, as delta_swap's cold start decoded "
        f"them, and raw records read in {secs['host_raw_records']:.2f} s); "
        f"restore_on_mesh_delta of step {pstep} "
        f"{secs['restore_on_mesh_delta']:.2f} s (= delta_swap's host chain "
        f"decode of it); restore_local_slices of device 0 of "
        f"{SWAP_MESH} decoded {stats.decoded_values} of {total} values in "
        f"{secs['local_slices']:.2f} s; a bf16 backend with mesh= loaded "
        f"in {m['load_s']:.2f} s (plain {p['load_s']:.2f}), "
        f"{len(prompts)} x {SWAP_LATE_TOKENS} greedy tokens equal the plain "
        f"load's, graphs {m['graphs']}, launches {m['launches']}, empty "
        f"report")
    return out


def phase_collectives(device):
    """The collectives at full width on the one-rank NCCL world:
    ``cross_pod_psum_compressed`` of a llama3-8b ``w_gate``-shaped f32
    tensor PSUM_SHAPE on a (pod 1, data 1, model 1) mesh equals
    ``q8_decode(q8_encode(x))`` bit for bit (its wire bytes per value
    and ms beside the plain q8 round trip's); ``gpipe_apply`` with one
    stage over GPIPE_MICRO microbatches of GPIPE_ROWS x d_model through
    one llama3-8b MLP block in bf16 equals the block applied to each
    microbatch in sequence bit for bit (ms beside it)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import configs
    from repro_torch.compression.q8 import q8_decode, q8_encode
    from repro_torch.distributed.compress import cross_pod_psum_compressed
    from repro_torch.distributed.pipeline_stage import gpipe_apply
    from repro_torch.launch.mesh import device_mesh, make_local_mesh
    from repro_torch.models.layers import swiglu_mlp

    mesh = device_mesh(make_local_mesh(1, 1, pod=1), device)
    g = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(PSUM_SHAPE, generator=g, device=device)
    xd = DTensor.from_local(x, mesh, [Shard(0), Replicate(), Replicate()],
                            run_check=False)
    stats: dict = {}
    y = cross_pod_psum_compressed(xd, mesh, stats=stats)
    want = q8_decode(*q8_encode(x[0]))
    check(isinstance(y, DTensor) and tuple(y.shape) == PSUM_SHAPE and
          _bits_equal(y.to_local()[0], want), "collectives: the compressed "
          "psum on a pod axis of 1 is not q8_decode(q8_encode(x))")
    wire = stats["wire_bytes"] / stats["elements"]
    check(wire <= 1.04, f"collectives: {wire:.4f} wire bytes a value")
    psum_ms = time_ms(lambda: cross_pod_psum_compressed(xd, mesh))
    q8_ms = time_ms(lambda: q8_decode(*q8_encode(x[0])))
    del x, xd, y, want

    cfg = configs.get("llama3-8b")
    d, f = cfg.d_model, cfg.d_ff
    params = {k: (0.02 * torch.randn((1, *shape), generator=g,
                                     device=device)).to(torch.bfloat16)
              for k, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                               ("w_down", (f, d)))}
    x_mb = torch.randn((GPIPE_MICRO, *GPIPE_ROWS, d), generator=g,
                       device=device).to(torch.bfloat16)

    def block(p, xm):
        return swiglu_mlp(xm, p, cfg.act, policy=cfg.kernels)
    stage = {k: v[0] for k, v in params.items()}
    got = gpipe_apply(block, params, x_mb, mesh, axis="pod")
    seq = torch.stack([block(stage, xm) for xm in x_mb])
    check(_bits_equal(got, seq), "collectives: gpipe_apply with one stage "
          "differs from the block applied in sequence")
    gpipe_ms = time_ms(lambda: gpipe_apply(block, params, x_mb, mesh,
                                           axis="pod"))
    seq_ms = time_ms(lambda: [block(stage, xm) for xm in x_mb])
    out = {"psum": {"shape": list(PSUM_SHAPE), "wire_bytes_per_value": wire,
                    **stats, "ms": psum_ms, "q8_roundtrip_ms": q8_ms},
           "gpipe": {"microbatches": GPIPE_MICRO, "rows": list(GPIPE_ROWS),
                     "ms": gpipe_ms, "sequential_ms": seq_ms}}
    log(f"[collectives] cross_pod_psum_compressed {PSUM_SHAPE} f32 on a pod "
        f"axis of 1 (NCCL): = q8_decode(q8_encode(x)) bit for bit, "
        f"{wire:.5f} wire bytes a value (f32: 4), {psum_ms:.3f} ms (the "
        f"plain q8 round trip {q8_ms:.3f}); gpipe_apply, 1 stage, "
        f"{GPIPE_MICRO} x {GPIPE_ROWS} x {d} bf16 through a llama3-8b MLP "
        f"block: = the block in sequence bit for bit, {gpipe_ms:.3f} ms "
        f"(sequence {seq_ms:.3f})")
    return out


def phase_train_dp(device):
    """The data-parallel train step on the one-rank NCCL world's
    (data 1, model 1) ``DeviceMesh`` at the train phase's width
    (llama3-8b, TRAIN_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ, 8-bit
    moments + EF): DP_STEPS steps of the mesh-free step and DP_STEPS of
    ``train_loop`` on the mesh (the sharded step: the state built and
    updated as the rank's boxes, here the whole leaves; the stop flag
    all-reduced each step, the closing barrier; no checkpoint) from the
    same seed and batches, under deterministic algorithms: losses and the
    whole state (parameters, moments, EF, counters) equal bit for bit,
    compared on the card; ms/step of each (median after the first); at
    smoke width :func:`_dp_save_resume`; then ``make_prefill_step`` on
    the mesh launches flash once a layer, with the mesh-free prefill's
    logits bit for bit and an empty report."""
    import os
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed.compress import CompressionConfig
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import device_mesh, make_local_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop as loop_mod
    from repro_torch.train.steps import (init_train_state, make_prefill_step,
                                         make_train_step)

    cfg = configs.get("llama3-8b").replace(num_layers=TRAIN_LAYERS)
    opt = AdamWConfig(quantized_moments=True)
    comp = CompressionConfig(enabled=True)
    mesh = device_mesh(make_local_mesh(1, 1), device)
    runs = {}
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        # the mesh-free step, DP_STEPS steps (the loop's schedule: warmup
        # and cosine over DP_STEPS)
        state = init_train_state(cfg, opt, comp, seed=0, device=device)
        _, make = make_train_step(cfg, None, opt, comp, total_steps=DP_STEPS)
        fn = make(state, None)
        losses, ms = [], []
        for i in range(DP_STEPS):
            batch = make_batch(cfg, i, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                               seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        runs["mesh_free"] = {"state": state, "losses": losses,
                             "step_ms": ms,
                             "ms_per_step": float(np.median(ms[1:]))}
        del state
        # train_loop on the mesh (the state it trains, updated in place)
        captured = {}
        init = loop_mod.init_train_state

        def capture(*args, **kw):
            captured["state"] = init(*args, **kw)
            return captured["state"]
        with mock.patch.object(loop_mod, "init_train_state", capture):
            res = loop_mod.train_loop(
                cfg, mesh, loop_mod.LoopConfig(
                    total_steps=DP_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ),
                opt, comp, device=device)
        check(res.final_step == DP_STEPS, f"train_dp: train_loop on the "
              f"mesh ended at step {res.final_step}")
        ms = [1e3 * t for t in res.step_times]
        runs["mesh"] = {"state": captured.pop("state"),
                        "losses": res.losses, "step_ms": ms,
                        "ms_per_step": float(np.median(ms[1:]))}
        free_s, mesh_s = runs["mesh_free"], runs["mesh"]
        check(mesh_s["losses"] == free_s["losses"], f"train_dp: losses "
              f"{mesh_s['losses']} on the mesh, {free_s['losses']} without")
        bad = _state_mismatches(mesh_s.pop("state"), free_s["state"])
        check(not bad, f"train_dp: the mesh step's state differs from the "
              f"mesh-free step's in {bad}")
        params = free_s.pop("state")["params"]
        t0 = time.perf_counter()
        save_resume = _dp_save_resume(device, mesh, opt, comp)
        save_resume["seconds"] = time.perf_counter() - t0
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TRAIN_PROMPTS, TRAIN_SEQ))).to(device)
        want, _ = make_prefill_step(cfg, None)(params, {"tokens": toks})
        clear_reports()
        registry.reset_launch_counts()
        got, caches = make_prefill_step(cfg, mesh)(params, {"tokens": toks})
        torch.cuda.synchronize()
        launches = registry.launch_counts()
        report = registry.dispatch_report()
        del caches, params
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
    check(launches["flash_attention"] == TRAIN_LAYERS and not report and
          _bits_equal(got, want), f"train_dp: the prefill step on the mesh "
          f"launched {launches} ({TRAIN_LAYERS} flash expected), report "
          f"{report}, logits equal: {_bits_equal(got, want)}")
    out = {"steps": DP_STEPS, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "launches": launches, "save_resume": save_resume, **runs}
    log(f"[train_dp] llama3-8b full width, {TRAIN_LAYERS} layers, 8-bit "
        f"moments + EF, {TRAIN_BATCH} x {TRAIN_SEQ}: {DP_STEPS} steps of "
        f"train_loop on the NCCL DeviceMesh (data 1, model 1) equal the "
        f"mesh-free steps bit for bit (losses {runs['mesh']['losses']}, "
        f"the whole state); at smoke width the mesh loop's sharded save "
        f"equals one process's save of the mesh-free state byte for byte "
        f"({save_resume['files']} files) and its resume on the mesh the "
        f"mesh-free resume (losses {save_resume['resumed']}) in "
        f"{save_resume['seconds']:.1f} s; "
        f"{runs['mesh']['ms_per_step']:.2f} ms/step on the mesh, "
        f"{runs['mesh_free']['ms_per_step']:.2f} without (median after the "
        f"first); the mesh's prefill step launched {launches}, logits equal "
        f"the mesh-free prefill's, empty report")
    return out


def _dp_save_resume(device, mesh, opt, comp) -> dict:
    """The llama3-8b smoke model, ``opt`` / ``comp`` (8-bit moments, EF):
    ``train_loop`` on ``mesh`` saves step DP_SAVE_STEPS as a sharded
    CABAC step (gathered to the writer, written over the mesh's shape);
    the mesh-free step's state after the same steps, saved by one process
    with the same save mesh, gives the same directory byte for byte.
    Then ``train_loop`` on the mesh resumes from its step
    (``restore(mesh=layout)``) to DP_RESUME_STEPS, and the mesh-free loop
    from a copy of the same step: losses equal bit for bit."""
    import shutil

    from repro_torch import configs
    from repro_torch.checkpoint.manager import (CheckpointConfig,
                                                CheckpointManager)
    from repro_torch.checkpoint.sharded import MeshSpec
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = configs.get("llama3-8b", smoke=True)
    shutil.rmtree(DP_CKPT_DIR, ignore_errors=True)

    def ckpt(name):
        return CheckpointConfig(str(DP_CKPT_DIR / name), sharded=True,
                                keep=10)

    def loop(steps):
        return LoopConfig(total_steps=steps, batch=DP_SMOKE_BATCH,
                          seq=DP_SMOKE_SEQ, ckpt_every=DP_SAVE_STEPS)
    saved = train_loop(cfg, mesh, loop(DP_SAVE_STEPS), opt, comp,
                       ckpt("mesh"), device=device)
    state = init_train_state(cfg, opt, comp, seed=0, device=device)
    _, make = make_train_step(cfg, None, opt, comp,
                              total_steps=DP_SAVE_STEPS)
    fn = make(state, None)
    free_losses = []
    for i in range(DP_SAVE_STEPS):
        state, m = fn(state, make_batch(cfg, i, batch=DP_SMOKE_BATCH,
                                        seq=DP_SMOKE_SEQ, seed=0))
        free_losses.append(float(m["loss"]))
    CheckpointManager(ckpt("free")).save(state, DP_SAVE_STEPS,
                                         mesh=MeshSpec.from_any(mesh))
    step = f"step_{DP_SAVE_STEPS:08d}"
    got, want = DP_CKPT_DIR / "mesh" / step, DP_CKPT_DIR / "free" / step
    names = sorted(p.name for p in want.iterdir())
    differ = [n for n in names if not (got / n).exists() or
              (got / n).read_bytes() != (want / n).read_bytes()]
    check(sorted(p.name for p in got.iterdir()) == names and not differ,
          f"train_dp: the mesh loop's sharded save differs from the "
          f"mesh-free save in {differ}")
    check(saved.losses == free_losses, f"train_dp: smoke losses "
          f"{saved.losses} on the mesh, {free_losses} without")
    shutil.copytree(got, DP_CKPT_DIR / "free_resume" / step)
    on_mesh = train_loop(cfg, mesh, loop(DP_RESUME_STEPS), opt, comp,
                         ckpt("mesh"), device=device)
    free = train_loop(cfg, None, loop(DP_RESUME_STEPS), opt, comp,
                      ckpt("free_resume"), device=device)
    check(on_mesh.losses == free.losses and
          len(free.losses) == DP_RESUME_STEPS - DP_SAVE_STEPS,
          f"train_dp: resumed losses {on_mesh.losses} on the mesh, "
          f"{free.losses} without")
    shutil.rmtree(DP_CKPT_DIR, ignore_errors=True)
    return {"files": len(names), "losses": saved.losses,
            "resumed": on_mesh.losses}


class _PartClock:
    """Seconds of a phase's parts (the RD sweep's, the live swap's), each
    ended by a synchronize so the device work lands in its own part: the
    module functions and methods the phase calls are wrapped for the
    phase and restored after it.  In the sweep, ``assign`` includes the
    bin statistics of the assignment's refinement loop, which
    ``bin_stats`` also counts; ``blobs`` keeps every container the sweep
    writes, in order."""

    def __init__(self):
        self.secs: dict = {}
        self.blobs: list = []
        self._undo: list = []

    def wrap(self, owner, attr, part, keep_blob=False):
        import torch
        real = getattr(owner, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            self.secs[part] = self.secs.get(part, 0.0) + \
                time.perf_counter() - t0
            if keep_blob:
                self.blobs.append(out.blob)
            return out
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, real))

    def restore(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)


def _sweep_search():
    from repro_torch.compression.rd_search import RDSearchConfig
    return RDSearchConfig(**{**SWEEP, "delta_rels": RD_SWEEP_DELTAS})


def predicted_sweep_launches(res, search, n_covered, layers) -> dict:
    """rd_quant and flash_attention launches of one rd_sweep: every
    assignment at lambda > 0 runs (1 + 1 refinement) x RD_PASSES passes;
    stage A assigns every covered tensor at each grid point, stage B each
    one at the winner's step and at each refine factor, then the refined
    table once more (if any tensor was refined) and the final codec.  The
    proxy prefills twice per measurement (the session's admission, then
    the logits), for the reference tree and every measured candidate."""
    per = 2 * RD_PASSES * n_covered
    lam_pos = sum(lam > 0 for lam in search.lambdas) * len(search.delta_rels)
    revalidated = res.refined_tensors > 0 or res.reverted
    winner = per if res.winner.lam > 0 else 0
    rd = (per * lam_pos + winner * (1 + len(search.refine_factors))
          + winner * (int(revalidated) + 1))
    measures = len(res.points) + int(revalidated) + 1
    return {"rd_quant": rd, "flash_attention": 2 * layers * (1 + measures)}


def phase_rd_sweep(device):
    """``rd_sweep`` on the full-width llama3-8b cut to RD_SWEEP_LAYERS
    layers (bf16) with the bench's fast grid (SWEEP, min_ndim=3: the
    stacked layer matrices; embed and head stay raw): rd_quant and
    flash_attention launch the predicted counts, the dispatch report stays
    empty, and the policy re-applied through the registry writes the
    sweep's final container byte for byte.  Prints every point and the
    split of the phase's seconds."""
    import torch
    from repro_torch import compression
    from repro_torch.compression import codec as codec_mod
    from repro_torch.compression import rd_search
    from repro_torch.kernels import registry

    cfg, params = _full_cut(device, num_layers=RD_SWEEP_LAYERS)
    search = _sweep_search()
    covered = {k: v for k, v in compression.flatten_tree(params).items()
               if v.dim() >= search.min_ndim and v.is_floating_point()}
    n_cov = sum(v.numel() for v in covered.values())
    clock = _PartClock()
    clock.wrap(rd_search, "rd_assign_levels", "assign")
    clock.wrap(rd_search, "estimate_bin_probs_torch", "bin_stats")
    clock.wrap(rd_search, "estimate_level_bits_torch", "level_bits")
    clock.wrap(rd_search, "fisher_for", "fim")
    clock.wrap(codec_mod.Codec, "compress_entries", "encode", keep_blob=True)
    clock.wrap(rd_search, "decompress", "decode")
    clock.wrap(rd_search.TaskProxy, "_greedy_tokens", "proxy_serve")
    clock.wrap(rd_search.TaskProxy, "_log_probs", "proxy_logits")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_reports()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = rd_search.rd_sweep(cfg, params, search)
        torch.cuda.synchronize()
    finally:
        clock.restore()
    wall = time.perf_counter() - t0
    launches, report = registry.launch_counts(), registry.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    want = predicted_sweep_launches(res, search, len(covered),
                                    cfg.num_layers)
    check(not report, f"rd_sweep: dispatch report not empty: {report}")
    for kern, n in want.items():
        check(launches[kern] == n, f"rd_sweep: {launches[kern]} {kern} "
              f"launches, predicted {n}")
    check(launches["dequant_matmul"] == launches[
        "dequant_matmul_grouped"] == 0, f"rd_sweep: launches {launches}")
    t0 = time.perf_counter()
    blob = compression.get("deepcabac-rd", policy_table=res.policy.to_dict(),
                           num_gr=search.num_gr,
                           min_ndim=search.min_ndim).compress(params).blob
    reencode_s = time.perf_counter() - t0
    check(blob == clock.blobs[-1] and len(blob) == res.policy_bytes,
          f"rd_sweep: the policy re-encodes to {len(blob)} bytes, the sweep "
          f"wrote {res.policy_bytes}")
    del params, blob
    gc.collect()
    torch.cuda.empty_cache()
    secs = dict(clock.secs)
    stats = secs.get("bin_stats", 0.0) + secs.get("level_bits", 0.0)
    split = {"assignment": secs.get("assign", 0.0) - secs.get("bin_stats",
                                                              0.0),
             "statistics": stats, "encode": secs.get("encode", 0.0),
             "decode": secs.get("decode", 0.0),
             "proxy": secs.get("proxy_serve", 0.0)
             + secs.get("proxy_logits", 0.0),
             "fim": secs.get("fim", 0.0)}
    split["other"] = wall - sum(split.values())
    for p in res.points:
        log(f"[rd_sweep] point delta_rel={p.delta_rel:g} lam={p.lam:g}: "
            f"{p.bytes} bytes, token_err {p.token_err:.4f}, logit_kl "
            f"{p.logit_kl:.3e}, on_front {p.on_front}")
    log(f"[rd_sweep] llama3-8b full width, {cfg.num_layers} layers, "
        f"{len(covered)} covered leaves ({n_cov / 1e6:.1f} M values): winner "
        f"delta_rel={res.winner.delta_rel:g} lam={res.winner.lam:g}, policy "
        f"{res.policy_bytes} bytes (token_err {res.policy_token_err:.4f}, "
        f"logit_kl {res.policy_logit_kl:.3e}), {res.refined_tensors} tensors "
        f"refined, reverted {res.reverted}; {wall:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in split.items())
        + f"; launches {launches} (predicted {want}), empty report; peak "
        f"{peak / 2**30:.2f} GiB; the policy re-encodes to the sweep's "
        f"bytes ({reencode_s:.1f} s)")
    return {"layers": cfg.num_layers, "covered_leaves": len(covered),
            "covered_values": n_cov,
            "points": [p.to_dict() for p in res.points],
            "winner": res.winner.to_dict(), "policy": res.policy.to_dict(),
            "policy_bytes": res.policy_bytes,
            "policy_token_err": res.policy_token_err,
            "policy_logit_kl": res.policy_logit_kl,
            "refined_tensors": res.refined_tensors,
            "reverted": res.reverted, "seconds": wall, "split_s": split,
            "parts_s": secs, "launches": launches, "predicted": want,
            "peak_bytes": peak, "reencode_s": reencode_s}


def _eval_nll(cfg, like: dict, batches, log_to: list):
    """An eval_fn for the DC searches: minus the mean NLL of a
    reconstructed flat dict over ``batches``, on ``like``'s devices and
    dtypes; each value is appended to ``log_to``."""
    import torch
    from repro_torch.compression.tree import unflatten
    from repro_torch.models.transformer import train_loss

    def eval_fn(rec: dict) -> float:
        tree = unflatten({k: torch.as_tensor(rec[k]).to(v.device, v.dtype)
                          for k, v in like.items()})
        with torch.no_grad():
            nll = sum(float(train_loss(tree, b, cfg)) for b in batches)
        value = -nll / len(batches)
        log_to.append(value)
        return value
    return eval_fn


def _first_flip(evals: dict, floor: float, device, cpu):
    """The first eval_fn call whose verdict (>= floor) differs between the
    two runs, as (index, card value, cpu value), or None."""
    a, b = evals[str(device)], evals[cpu]
    for i, (x, y) in enumerate(zip(a, b)):
        if (x >= floor) != (y >= floor):
            return i, x, y
    return None


def phase_search_parity(device, cpu="cpu"):
    """The search loops at smoke size (llama3-8b, f32) on the card and on
    the CPU from the same weights: rd_sweep with F = 1 (assign="kernel":
    the rd_quant kernel on the card, its plain version on the CPU) gives
    the same points (bytes and token_err exactly, logit_kl within
    TOL_KL_ABS), policy and policy bytes; search_dc_v2 and search_dc_v1
    (one sigma for both runs: 1/sqrt(F) of the empirical FIM, taken on
    the CPU) with the eval NLL computed where the weights are choose the
    same hyperparameters and write identical blobs."""
    import numpy as np
    import torch
    from repro_torch import compression, configs
    from repro_torch.compression.rd_search import (RDSearchConfig,
                                                   fisher_for, rd_sweep)
    from repro_torch.compression.tree import unflatten
    from repro_torch.core import deepcabac as dc
    from repro_torch.data.pipeline import make_eval_batches, to_device
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import init_params

    cfg = configs.get("llama3-8b", smoke=True)
    flat_cpu = compression.flatten_tree(init_params(cfg, 0, device=cpu))
    flats = {str(device): {k: v.to(device) for k, v in flat_cpu.items()},
             cpu: flat_cpu}
    out = {}
    search = RDSearchConfig(**{**SWEEP, "fim_batches": 0, "min_ndim": 2,
                               "assign": "kernel"})
    t0 = time.perf_counter()
    sweeps = {}
    for dev, flat in flats.items():
        registry.reset_launch_counts()
        sweeps[dev] = rd_sweep(cfg, unflatten(dict(flat)), search)
        if dev == str(device):
            sweep_launches = registry.launch_counts()
    a, b = sweeps[str(device)], sweeps[cpu]
    for p, q in zip(a.points, b.points):
        same = (p.bytes, p.token_err, p.on_front) == \
            (q.bytes, q.token_err, q.on_front)
        check(same and abs(p.logit_kl - q.logit_kl) <= TOL_KL_ABS,
              f"search parity: sweep point {p.to_dict()} on {device} != "
              f"{q.to_dict()} on cpu")
    check(a.policy.to_dict() == b.policy.to_dict() and
          a.policy_bytes == b.policy_bytes,
          f"search parity: sweep policy differs ({a.policy_bytes} vs "
          f"{b.policy_bytes} bytes)")
    check(sweep_launches["rd_quant"] > 0 and
          sweep_launches["flash_attention"] > 0,
          f"search parity: the smoke sweep on the card launched "
          f"{sweep_launches}")
    out["rd_sweep"] = {"points": [p.to_dict() for p in a.points],
                       "policy_bytes": a.policy_bytes,
                       "launches_card": sweep_launches,
                       "seconds": time.perf_counter() - t0}
    # DC-v1 / DC-v2: quantization on the host (f64 oracle), eval where the
    # weights are
    evals_b = [to_device(b_, cpu) for b_ in make_eval_batches(
        cfg, 2, batch=2, seq=16)]
    sigma = {k: torch.rsqrt(f + 1e-12) for k, f in compression.flatten_tree(
        fisher_for(cfg, unflatten(dict(flat_cpu)), batches=2)).items()}
    for method in ("dc-v2", "dc-v1"):
        evals, results = {}, {}
        t0 = time.perf_counter()
        for dev, flat in flats.items():
            evals[dev] = []
            batches = [{k: v.to(dev) for k, v in b_.items()}
                       for b_ in evals_b]
            fn = _eval_nll(cfg, flat, batches, evals[dev])
            orig = fn(flat)
            if method == "dc-v2":
                results[dev] = dc.search_dc_v2(
                    flat, fn, orig, tol=SEARCH_TOL, deltas=DC_DELTAS,
                    lambdas=DC_LAMBDAS)
            else:
                results[dev] = dc.search_dc_v1(
                    flat, sigma, fn, orig, tol=SEARCH_TOL, s_grid=DC_S_GRID,
                    lambdas=DC_V1_LAMBDAS)
        r_d, r_c = results[str(device)], results[cpu]
        if r_d.hyperparams != r_c.hyperparams or r_d.blob != r_c.blob:
            flip = _first_flip(evals, evals[cpu][0] - SEARCH_TOL, device,
                               cpu)
            _fail(f"search parity {method}: {device} chose "
                  f"{r_d.hyperparams} ({len(r_d.blob)} bytes), cpu "
                  f"{r_c.hyperparams} ({len(r_c.blob)} bytes); first "
                  f"flipped eval (index, {device}, cpu): {flip}")
        diff = float(np.max(np.abs(np.array(evals[str(device)])
                                   - np.array(evals[cpu]))))
        out[method] = {"chosen": r_d.hyperparams, "bytes": len(r_d.blob),
                       "evals": len(evals[cpu]),
                       "max_eval_diff_card_vs_cpu": diff,
                       "seconds": time.perf_counter() - t0}
        log(f"[search] smoke llama3-8b {method}: {device} and cpu choose "
            f"{r_d.hyperparams} ({len(r_d.blob)} bytes, identical blobs) "
            f"over {len(evals[cpu])} evaluations (largest eval difference "
            f"{diff:.2e}) in {out[method]['seconds']:.1f} s")
    log(f"[search] smoke llama3-8b rd_sweep: card = cpu on "
        f"{len(a.points)} points, the policy and {a.policy_bytes} policy "
        f"bytes (card launches {sweep_launches})")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# paged KV serving
# ---------------------------------------------------------------------------

def phase_parity_paged(device, cpu="cpu"):
    """The llama3-8b smoke model in f32 on q8 with an int8 cache, served
    paged on the card and on the CPU from the same converted weights: a
    pool small enough to park (restores on a worker thread) and prompts
    that share an 8-token prefix (suffix prefills), with repeated prompt
    shapes so that the card captures and replays every kind of paged step
    (admission prefill, suffix prefill, compacted decode).  Tokens and
    the scheduler's and pool's counters must be equal on both."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.convert import params_from_numpy, tensor_to_numpy
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.session import ServeConfig, ServeSession

    cfg = configs.get("llama3-8b", smoke=True).replace(q8_cache=True)
    flat_q8 = {k: tensor_to_numpy(v) for k, v in flatten_tree(
        quantize_tree_q8(init_params(cfg, 0, device=cpu))).items()}
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, cfg.vocab_size, 8)
    prompts = [np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, n)])
               .astype(np.int32) for n in (3, 3, 3, 5, 5)]
    prompts += [rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
                for _ in range(3)]
    scfg = ServeConfig(slots=4, max_len=48, kv_page_size=4,
                       kv_pool_pages=24, kv_restore_workers=1)
    out = {}
    for dev in (device, cpu):
        sess = ServeSession(cfg, params_from_numpy(flat_q8, dev),
                            backend="q8", device=dev, serve_cfg=scfg)
        hs = [sess.submit(p, max_new_tokens=16) for p in prompts]
        sess.run()
        kv = {k: v for k, v in sess._kv.stats.items() if k != "restore_s"}
        out[str(dev)] = {"tokens": [h.tokens for h in hs],
                         "sched": dict(sess.stats), "kv": kv,
                         "graph_stats": dict(sess.graphs.stats),
                         "graphs": sorted({k[0] for k in
                                           sess.graphs._graphs}),
                         "graphs_captured": len(sess.graphs._graphs)}
        sess.close()
    d, c = out[str(device)], out[cpu]
    check(d["tokens"] == c["tokens"], f"parity_paged: tokens differ "
          f"between {device} and cpu:\n{d['tokens']}\n{c['tokens']}")
    check(d["sched"] == c["sched"] and d["kv"] == c["kv"],
          f"parity_paged: counters differ: {d['sched']} {d['kv']} against "
          f"{c['sched']} {c['kv']}")
    check(c["sched"]["parks"] > 0 and c["kv"]["prefix_hits"] > 0 and
          c["kv"]["pages_restored"] > 0, f"parity_paged: no park, "
          f"restore or prefix hit: {c['sched']} {c['kv']}")
    if device != cpu:
        want = ["decode_paged", "partial_prefill", "prefill_paged"]
        check(d["graphs"] == want and d["graph_stats"]["replays"] > 0 and
              d["graph_stats"]["captures"] == d["graphs_captured"],
              f"parity_paged: graphs {d['graphs']} {d['graph_stats']}, "
              f"want each of {want} captured once and replayed")
    log(f"[parity] smoke paged (f32 q8, int8 cache, pool 24 pages of 4): "
        f"{sum(len(t) for t in d['tokens'])} greedy tokens identical on "
        f"{device} and cpu; parks {c['sched']['parks']}, prefix hits "
        f"{c['kv']['prefix_hits']}, pages restored "
        f"{c['kv']['pages_restored']} on both; graphs {d['graph_stats']} "
        f"of {d['graphs']}")
    return {"tokens_identical": True, "counters": c,
            "graph_stats": d["graph_stats"], "graphs": d["graphs"]}


def _row_log(sess) -> tuple:
    """Wrap ``sess._sample``: per request id, (sha1 of the logits row it
    sampled from, that row's top-2 gap) for every token; and a one-item
    list of the seconds the wrapper itself took, which the caller takes
    out of its tick times."""
    import hashlib
    import numpy as np
    rows: dict = {}
    cost = [0.0]
    sample = sess._sample

    def wrapped(row, req):
        t0 = time.perf_counter()
        top = np.partition(row, -2)[-2:]
        rows.setdefault(req.id, []).append(
            (hashlib.sha1(np.ascontiguousarray(row).tobytes()).hexdigest(),
             float(top[1] - top[0])))
        cost[0] += time.perf_counter() - t0
        return sample(row, req)
    sess._sample = wrapped
    return rows, cost


def _partings(want, got, want_rows) -> list:
    """Each request whose tokens part from ``want``'s: the first parting
    step (0 = the prefill's token) and the top-2 gap of ``want``'s logits
    row there."""
    out = []
    for i, (a, b) in enumerate(zip(want, got)):
        steps = [j for j in range(min(len(a), len(b))) if a[j] != b[j]]
        if steps:
            j = steps[0]
            out.append({"request": i, "step": j,
                        "top2_gap": want_rows[i][j][1]})
    return out


def _drive(cfg, tree, backend, device, prompts, new_tokens, scfg, mode,
           manual_park=None):
    """One session over ``tree`` (``ServeSession.from_loaded``: no second
    load) fed ``prompts`` at once, run to the end eagerly
    (``mode="eager"``) or from CUDA graphs; launches and the dispatch
    report are counted from 0 over the run.  Returns tokens, logits-row
    hashes and gaps, the median of the decode-only ticks (no admission,
    park, resume or capture in the tick), the decode graph's replay time
    by CUDA events and the idle share of an untraced tick it gives, peak
    memory, ``kv_report``, the graph counters and launches.  Tick times
    leave out the seconds the logits-row log took.
    ``manual_park`` = (t1, t2): after tick t1 request 1 is parked, after
    t2 resumed, its pages restored at once (``_admit_paged``) and compared
    with the parked ones byte for byte."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.serve.session import ServeSession, eager_steps

    sess = ServeSession.from_loaded(cfg, tree, backend=backend,
                                    serve_cfg=scfg, device=device)
    rows, cost = _row_log(sess)
    hs = [sess.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_reports()
    registry.reset_launch_counts()
    paged = scfg.kv_page_size is not None
    ticks, plain, park = [], [], {}
    replays_at_park = None

    def state():
        return (sess.stats["prefill_tokens"], sess.stats["parks"],
                sess.stats["resumes"], sess.graphs.stats["captures"],
                sess.stats["decode_steps"])
    t_all = time.perf_counter()
    ctx = eager_steps() if mode == "eager" else contextlib.nullcontext()
    with ctx:
        while sess.pending or (manual_park and "resumed" not in park):
            before = state()
            c0 = cost[0]
            t0 = time.perf_counter()
            sess.step()
            dt = time.perf_counter() - t0 - (cost[0] - c0)
            after = state()
            ticks.append(dt)
            if before[:4] == after[:4] and after[4] == before[4] + 1 and \
                    len(ticks) > 1:
                plain.append(dt)
            if replays_at_park is None and sess.stats["parks"]:
                replays_at_park = sess.graphs.stats["replays"]
            if manual_park and len(ticks) == manual_park[0]:
                h = hs[1]
                idx = sess._slot_of(h)
                park["pages"] = sess._kv.gather(sess._kv.slot_ids(idx))
                t0 = time.perf_counter()
                sess.park(h)
                park["park_s"] = time.perf_counter() - t0
                rep = sess.kv_report()
                park["host_bytes"] = rep["host_compressed_bytes"]
                park["raw_bytes"] = sum(t.numel() for t in
                                        park["pages"].values())
            if manual_park and len(ticks) == manual_park[1]:
                h = hs[1]
                sess.resume(h)
                t0 = time.perf_counter()
                sess._admit_paged()
                park["restore_s"] = time.perf_counter() - t0
                idx = sess._slot_of(h)
                got = sess._kv.gather(sess._kv.slot_ids(idx))
                park["equal"] = all(torch.equal(got[k], park["pages"][k])
                                    for k in got)
                park["resumed"] = True
                del park["pages"]
    total = time.perf_counter() - t_all
    launches = registry.launch_counts()
    report = registry.dispatch_report()
    decode = sorted(plain)
    decode_ms = 1e3 * decode[len(decode) // 2]
    key = ("decode_paged", PAGED_SLOTS) if paged else ("decode",)
    replay_ms = None
    if mode == "graph" and key in sess.graphs._graphs:
        replay_ms = time_ms(lambda: sess.graphs.replay_only(key))
    res = {"mode": mode, "tokens": [list(h.tokens) for h in hs],
           "rows": [rows[h.id] for h in hs],
           "decode_ms_per_step_median": decode_ms,
           "decode_ms_per_step_mean": 1e3 * sum(decode) / len(decode),
           "decode_ticks_timed": len(decode), "ticks": len(ticks),
           "first_tick_ms": 1e3 * ticks[0], "total_s": total,
           "decode_replay_ms": replay_ms,
           "untraced_idle_share": (None if replay_ms is None
                                   else 1.0 - replay_ms / decode_ms),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "kv_report": sess.kv_report(), "graph_stats":
           dict(sess.graphs.stats), "graph_keys": sorted(
               map(str, sess.graphs._graphs)),
           "graphs_captured": len(sess.graphs._graphs),
           "replays_after_first_park": (
               None if replays_at_park is None else
               sess.graphs.stats["replays"] - replays_at_park),
           "launches": launches, "dispatch_report": report,
           "decode_steps": sess.stats["decode_steps"],
           "finite": all(np.isfinite(float(g)) for r in rows.values()
                         for _, g in r)}
    if manual_park:
        res["manual_park"] = park
    sess.close()
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _paged_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(23)
    system = rng.integers(0, cfg.vocab_size, PAGED_SYSTEM)
    return [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
            .astype(np.int32) for n in PAGED_OWN]


def phase_serve_paged(cfg, params, device):
    """llama3-8b at full width (``serve``'s bf16 tree, one q8 load) with an
    int8 cache on the grid ``calibrate_kv_cache_delta`` maps the first
    prompt's cache to: 8 requests of a shared 128-token system prompt and
    24-38 tokens of their own, 24 new tokens each, over 4 slots of 192
    positions, each run from graphs and (a) also eagerly (the eager runs
    of (b)-(d) were cut for time): (a) slot mode, (b) paged
    in pages of 16 without pressure or sharing, (c) paged with prefix
    sharing, (d) paged without sharing on a pool of 3 slots + the scratch
    page (auto-parks); then a manual park and resume of a request in flight
    (paged, graphs).  Checks: (b) gives (a)'s tokens and logits rows bit
    for bit; (c) has 7 prefix hits, 56 reused pages, 376 prefill tokens;
    (d) parks and restores every parked page; the manual restore equals the
    parked pages byte for byte; (a)'s graph and eager tokens and launches
    equal;
    no shape captured twice, decode replays after a park; launches equal
    225 per forward and 32 flash launches per whole-prompt prefill; the
    dispatch report empty but for (c)'s suffix prefills' ragged-kv_len
    records.  Partings of (c) and (d) from (a) are listed with their step
    and top-2 gap."""
    import numpy as np
    from repro_torch.serve.backends import get_backend
    from repro_torch.serve.quantized import calibrate_kv_cache_delta
    from repro_torch.serve.session import ServeConfig

    t0 = time.perf_counter()
    backend = get_backend("q8")
    tree = backend.load(cfg, params, device=device)
    prompts = _paged_prompts(cfg)
    delta = calibrate_kv_cache_delta(cfg, tree, prompts[0][None])
    qcfg = cfg.replace(q8_cache=True, kv_cache_delta=delta)
    log(f"[serve_paged] llama3-8b q8 loaded, kv_cache_delta calibrated on "
        f"a {prompts[0].size}-token prefill: {delta:.6g} "
        f"({time.perf_counter() - t0:.1f} s)")
    base = dict(slots=PAGED_SLOTS, max_len=PAGED_MAX_LEN)
    paged = dict(base, kv_page_size=PAGED_PAGE)
    configs_ = {
        "a_slots": ServeConfig(**base),
        "b_paged": ServeConfig(**paged, kv_prefix_sharing=False),
        "c_shared": ServeConfig(**paged),
        "d_tight": ServeConfig(**paged, kv_prefix_sharing=False,
                               kv_pool_pages=PAGED_TIGHT_POOL)}
    per_fwd = per_forward_launches(qcfg)["dequant_matmul"]
    ragged = ("flash_attention", "fallback",
              "ragged kv_len masking is not implemented in the kernel")
    out = {"kv_cache_delta": delta, "prompt_lens": [p.size for p in prompts]}
    for name, scfg in configs_.items():
        # (b)-(d) run from graphs only (a cut for time): (a)'s eager run
        # holds the graphs' tokens and launches to the eager step's
        modes = ("eager", "graph") if name == "a_slots" else ("graph",)
        runs = {m: _drive(qcfg, tree, backend, device, prompts, PAGED_NEW,
                          scfg, m) for m in modes}
        e, g = runs.get("eager"), runs["graph"]
        what = f"serve_paged {name}"
        if e is not None:
            # the eager tick's idle share against the same decode's graph
            # replay (the device work is the same kernels)
            e["untraced_idle_share"] = 1.0 - (
                g["decode_replay_ms"] / e["decode_ms_per_step_median"])
            check(e["tokens"] == g["tokens"], f"{what}: graph and eager "
                  "tokens differ")
            check(e["launches"] == g["launches"], f"{what}: launches differ "
                  f"between the modes: {e['launches']} {g['launches']}")
        check(all(r["finite"] for r in runs.values()),
              f"{what}: non-finite logits")
        rep = g["kv_report"]
        hits = rep.get("stats", {}).get("prefix_hits", 0)
        fwd = len(prompts) + g["decode_steps"]
        check(g["launches"]["dequant_matmul"] == per_fwd * fwd,
              f"{what}: {g['launches']['dequant_matmul']} dequant_matmul "
              f"launches, want {per_fwd} x {fwd} forwards")
        want_fa = flash_per_prefill(qcfg) * (len(prompts) - hits)
        check(g["launches"]["flash_attention"] == want_fa,
              f"{what}: {g['launches']['flash_attention']} flash launches, "
              f"want {want_fa} ({len(prompts) - hits} whole prefills)")
        for r in runs.values():
            keys = [_record_key(x) for x in r["dispatch_report"]]
            check(keys == [ragged] * (qcfg.num_layers * hits),
                  f"{what} {r['mode']}: dispatch report {set(keys)} x "
                  f"{len(keys)}, want {qcfg.num_layers * hits} ragged "
                  "kv_len records")
        check(g["graph_stats"]["captures"] == g["graphs_captured"],
              f"{what}: a shape was captured twice: {g['graph_stats']}")
        for r in runs.values():
            log(f"[serve_paged] {name} {r['mode']}: decode "
                f"{r['decode_ms_per_step_median']:.2f} ms/step median "
                f"({r['decode_ticks_timed']} ticks), replay "
                f"{_fmt(r['decode_replay_ms'])} ms, idle untraced "
                f"{_fmt(r['untraced_idle_share'])}, first tick "
                f"{r['first_tick_ms']:.1f} ms, run {r['total_s']:.2f} s, "
                f"peak {r['max_memory_allocated'] / 2**30:.2f} GiB, "
                f"graphs {r['graph_stats']}, launches {r['launches']}, "
                f"report {len(r['dispatch_report'])} records")
        log(f"[serve_paged] {name}: kv_report " + json.dumps(
            {k: v for k, v in rep.items() if k != "scheduler"}) +
            f" scheduler {rep['scheduler']}")
        out[name] = {**{k: v for k, v in g.items() if k != "rows"},
                     "rows": g["rows"]}
        if e is not None:
            e.pop("rows")
            out[name]["eager"] = e
    a, b = out["a_slots"], out["b_paged"]
    check(b["tokens"] == a["tokens"], "serve_paged: (b) paged tokens differ "
          "from (a) slot mode's: " + str(_partings(a["tokens"], b["tokens"],
                                                   a["rows"])))
    check([[h for h, _ in r] for r in b["rows"]] ==
          [[h for h, _ in r] for r in a["rows"]],
          "serve_paged: (b) logits rows differ from (a)'s bit for bit")
    st_c = out["c_shared"]["kv_report"]
    check((st_c["stats"]["prefix_hits"], st_c["stats"]["prefix_pages_reused"],
           st_c["scheduler"]["prefill_tokens"]) == (
               7, 7 * PAGED_SYSTEM // PAGED_PAGE,
               len(prompts[0]) + sum(p.size - PAGED_SYSTEM
                                     for p in prompts[1:])),
          f"serve_paged (c): {st_c['stats']} {st_c['scheduler']}")
    st_d = out["d_tight"]["kv_report"]
    sd = st_d["stats"]
    check(st_d["scheduler"]["parks"] >= 1 and
          st_d["scheduler"]["resumes"] == st_d["scheduler"]["parks"] and
          sd["pages_restored"] == sd["pages_evicted"] and
          sd["restores"] == st_d["scheduler"]["parks"],
          f"serve_paged (d): {st_d['scheduler']} {sd}")
    check(out["d_tight"]["replays_after_first_park"],
          f"serve_paged (d): no replay after a park: "
          f"{out['d_tight']['graph_stats']}")
    for name in ("c_shared", "d_tight"):
        out[name]["partings_from_a"] = _partings(
            a["tokens"], out[name]["tokens"], a["rows"])
        log(f"[serve_paged] {name}: partings from (a) "
            f"{out[name]['partings_from_a']}")
    m = _drive(qcfg, tree, backend, device, prompts[:PAGED_SLOTS],
               PAGED_NEW, configs_["b_paged"], "graph",
               manual_park=PAGED_MANUAL_PARK)
    mp = m["manual_park"]
    check(mp["equal"], "serve_paged: pages restored after the manual park "
          "differ from the parked ones")
    m["partings_from_a"] = _partings(a["tokens"][:PAGED_SLOTS], m["tokens"],
                                     a["rows"])
    log(f"[serve_paged] manual park of request 1 after tick "
        f"{PAGED_MANUAL_PARK[0]}, resume after {PAGED_MANUAL_PARK[1]}: "
        f"{mp['raw_bytes'] / 2**20:.1f} MiB of int8 pages to "
        f"{mp['host_bytes'] / 2**20:.2f} MiB on the host "
        f"(ratio {mp['host_bytes'] / mp['raw_bytes']:.3f}), park "
        f"{mp['park_s']:.3f} s, restore {mp['restore_s']:.3f} s, pages equal "
        f"byte for byte; partings from (a) {m['partings_from_a']}; graphs "
        f"{m['graph_stats']}")
    m.pop("rows")
    out["manual_park"] = m
    for name in configs_:
        out[name].pop("rows")
    del tree
    return out


def phase_serve_mla_paged(cfg, tree, device):
    """The MLA cut (``mla_cut``: 3 dense layers and one of 256 experts,
    nested {"dense", "main"} latent pools) served paged in pages of 16
    against slot mode from graphs, without pressure or sharing, over
    prompts of distinct lengths: launches of the path, MLA's d != dv
    records only, and the partings of the paged tokens from slot mode's
    with their step and top-2 gap (this model's bf16 logits have parted
    after near ties before)."""
    import numpy as np
    from repro_torch.serve.backends import get_backend
    from repro_torch.serve.session import ServeConfig

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in MLA_PAGED_LENS]
    max_len = max(MLA_PAGED_LENS) + MLA_PAGED_NEW
    backend = get_backend("q8")
    out = {}
    for name, extra in (("slots", {}),
                        ("paged", {"kv_page_size": PAGED_PAGE,
                                   "kv_prefix_sharing": False})):
        r = _drive(cfg, tree, backend, device, prompts, MLA_PAGED_NEW,
                   ServeConfig(slots=len(prompts), max_len=max_len, **extra),
                   "graph")
        fwd = len(prompts) + r["decode_steps"]
        what = f"serve_mla_paged {name}"
        for kern, n in per_forward_launches(cfg).items():
            check(r["launches"][kern] == n * fwd, f"{what}: "
                  f"{r['launches'][kern]} {kern} launches, want {n} x {fwd}")
        check(r["launches"]["flash_attention"] == 0,
              f"{what}: flash launched")
        check(report_ok(cfg, r["dispatch_report"]),
              f"{what}: dispatch report {r['dispatch_report'][:3]}")
        check(r["finite"], f"{what}: non-finite logits")
        log(f"[serve_mla_paged] {name}: decode "
            f"{r['decode_ms_per_step_median']:.2f} ms/step median, replay "
            f"{_fmt(r['decode_replay_ms'])} ms, idle untraced "
            f"{_fmt(r['untraced_idle_share'])}, peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB, launches "
            f"{r['launches']}, graphs {r['graph_stats']}, kv device bytes "
            f"{r['kv_report']['device_bytes']}")
        out[name] = r
    out["paged"]["partings_from_slots"] = _partings(
        out["slots"]["tokens"], out["paged"]["tokens"], out["slots"]["rows"])
    log(f"[serve_mla_paged] partings of paged from slot mode: "
        f"{out['paged']['partings_from_slots']}")
    for r in out.values():
        r.pop("rows")
    return out


def summarize(dm_rows, fa_rows, grouped_rows, serve, serve_moe, rd_rows,
              deploy, serve_moe_f32, sweep, swap, grouped_v3, serve_dense,
              serve_mla, embeds, serve_ssm, serve_hybrid, hybrid_f32,
              serve_paged, serve_mla_paged, zoo, train, train_dp,
              mesh_restore):
    """One entry per kernel and, for flash_attention and
    dequant_matmul_grouped, one per instance (``instance``).
    dequant_matmul: one full-width llama3-8b decode step's 225 calls at 4
    slots (bf16 x for projections, f32 x for the head), and its prefill
    forward (``prefill_*``: 224 calls at M=512 and the head at M=4);
    flash_attention: one full-width llama3-8b prefill call (B=4, S=128,
    bf16); dequant_matmul_grouped: one full-width deepseek-moe-16b decode
    step's 81 calls (M=32 rows per expert, bf16 x, the shared (N,) scale);
    their f32 instances: one deepseek-moe-16b f32 prefill call (B=4,
    S=128, H=G=16) and one grouped call at M=32, (K, N) = (2048, 1408),
    shared scale (``prefill_*``: at M=64), with launches from the f32 serve
    (serve_moe_f32);
    rd_quant: one 2-pass assignment of each of the 11 full-width shapes
    (layer 0 of each stacked leaf, embed, head; bf16), launches from the
    deploy encode.  The search loop's path (``rd_sweep``) launches
    rd_quant and the bf16 flash instance: those counts are
    ``sweep_launches`` of both entries.  The live weight swap's path
    (``delta_swap``) launches dequant_matmul and the bf16 flash instance:
    ``delta_swap_launches`` of both entries, and the zoo's (``zoo``, on
    the same 1-layer cut) ``zoo_launches``.  Launches of the other serving
    entries come from each model's q8 serve, its eager run (the graph
    run's are equal).  The serving kernels' ``ms`` and ``library_ms`` are
    CUDA-graph replays (``timing``), their eager loops' ``eager_ms``
    beside them; rd_quant's calls take milliseconds and are timed
    eagerly.  The other dense variants and MLA (PR 20): the D = 64 flash
    instances at musicgen-medium's prefill (B=4, S=128, H=G=24), launched
    by ``embeds_full`` (bf16 at 12 layers, f32 at 2), the grouped kernel
    at deepseek-v3-671b's 256 experts (one decode step's 3 calls at M=32,
    launched by ``serve_mla``), and the launches of each serving path of
    qwen3-8b, deepseek-v3-671b, musicgen-medium and qwen2-vl-7b beside
    the kernels they run.  The SSM and hybrid families: the D = 80
    flash instances at zamba2-2.7b's prefill (B=4, S=128, H=G=32), bf16
    launched by ``serve_hybrid`` (54 layers, 9 per prefill), f32 by
    ``serve_hybrid_f32`` (6 layers); dequant_matmul's launches of
    ``serve_ssm`` (the head only) and ``serve_hybrid``.  The paged
    serves: dequant_matmul's and flash_attention's launches of each run
    of ``serve_paged`` (llama3-8b, graph run; (a)'s eager run's are
    checked equal) and dequant_matmul's and the E = 256 grouped instance's of
    ``serve_mla_paged``.  The training phase's prefill step (``train``, 2
    layers) launches the bf16 flash instance: ``train_launches``; so do
    the data-parallel prefill step on the NCCL mesh (``train_dp``, 2
    layers: ``train_dp_launches``) and the session on the mesh-loaded bf16
    keyframe (``mesh_restore``, 1 layer: ``mesh_restore_launches``)."""
    def row(m, k, n, x):
        return next(r for r in dm_rows if (r["arch"], r["m"], r["k"], r["n"],
                                           r["x"]) ==
                    ("llama3-8b", m, k, n, x))
    step = [(row(4, k, n, "float32" if names == "head" else "bfloat16"),
             calls) for (k, n), calls, names in DM_SHAPES["llama3-8b"]]
    # one llama3-8b prefill forward: 224 projections at M=512 (bf16 x), the
    # head on the last positions only (M=4, f32 x)
    prefill = [(row(DM_PREFILL_M, k, n, "bfloat16"), calls)
               for (k, n), calls, names in DM_SHAPES["llama3-8b"]
               if names != "head"] + [r for r in step if r[1] == 1]
    dm = {"name": "dequant_matmul", "route": "cuda",
          "source": "src/repro_torch/kernels/dequant_matmul/csrc/"
                    "dequant_matmul.cu",
          "replaces": "src/repro/kernels/dequant_matmul/kernel.py:35",
          "launches": serve["q8"]["launches"]["dequant_matmul"],
          "max_abs_err": max(r["max_abs_err"] for r in dm_rows),
          "work": "one llama3-8b decode step: 225 calls at M=4",
          **{key: sum(r[key] * c for r, c in step)
             for key in ("ms", "eager_ms", "plain_ms", "bound_ms",
                         "library_ms")},
          "bound_by": "bytes", "timing": "cuda_graph",
          "prefill_work": "one llama3-8b prefill forward: 224 calls at "
                          "M=512 (bf16 x) and the head at M=4 (f32 x)",
          **{f"prefill_{key}": sum(r[key] * c for r, c in prefill)
             for key in ("ms", "bound_ms", "library_ms")}}
    def fa_entry(h, dtype, launches, work, d=128):
        r0 = next(r for r in fa_rows if (r["s"], r["h"], r["dtype"],
                                         r["d"]) == (128, h, dtype, d))
        return {"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in fa_rows
                                   if (r["dtype"], r["d"]) == (dtype, d)),
                "work": work, "instance": r0["instance"],
                "timing": "cuda_graph",
                **{key: r0[key] for key in ("ms", "eager_ms", "plain_ms",
                                            "bound_ms", "library_ms",
                                            "bound_by")}}
    fa = fa_entry(32, "bfloat16", serve["q8"]["launches"]["flash_attention"],
                  "one llama3-8b prefill call: B=4 S=128 H=32 G=8 D=128 bf16")
    fa["sweep_launches"] = sweep["launches"]["flash_attention"]
    fa["delta_swap_launches"] = swap["launches"]["flash_attention"]
    dm["delta_swap_launches"] = swap["launches"]["dequant_matmul"]
    fa["zoo_launches"] = zoo["launches"]["flash_attention"]
    fa["train_launches"] = train["launches"]["flash_attention"]
    fa["train_dp_launches"] = train_dp["launches"]["flash_attention"]
    fa["mesh_restore_launches"] = mesh_restore["launches"]["flash_attention"]
    dm["zoo_launches"] = zoo["launches"]["dequant_matmul"]
    fa32 = fa_entry(16, "float32",
                    serve_moe_f32["launches"]["flash_attention"],
                    "one deepseek-moe-16b f32 prefill call: B=4 S=128 H=16 "
                    "G=16 D=128 f32")
    gstep = [(next(r for r in grouped_rows if (r["m"], r["k"], r["n"],
                                               r["scale"], r["x"]) ==
                   (GROUPED_ROWS[0], k, n, "shared", "bfloat16")), calls)
             for (k, n), calls, _ in GROUPED_SHAPES]
    gm = {"name": "dequant_matmul_grouped", "route": "cuda",
          "source": "src/repro_torch/kernels/dequant_matmul/csrc/"
                    "dequant_matmul_grouped.cu",
          "replaces": "src/repro/kernels/dequant_matmul/kernel.py:70",
          "launches": serve_moe["q8"]["launches"]["dequant_matmul_grouped"],
          "max_abs_err": max(r["max_abs_err"] for r in grouped_rows
                             if r["x"] == "bfloat16"),
          "work": "one deepseek-moe-16b decode step: 81 calls, E=64, M=32 "
                  "per expert, bf16 x, shared (N,) scale",
          "instance": gstep[0][0]["instance"],
          **{key: sum(r[key] * c for r, c in gstep)
             for key in ("ms", "eager_ms", "plain_ms", "bound_ms",
                         "library_ms")},
          "bound_by": gstep[0][0]["bound_by"], "timing": "cuda_graph"}
    (k0, n0), _, _ = GROUPED_SHAPES[0]

    def g_row(m):
        return next(r for r in grouped_rows if (r["m"], r["k"], r["n"],
                                                r["scale"], r["x"]) ==
                    (m, k0, n0, "shared", "float32"))
    g32, g64 = g_row(GROUPED_ROWS[0]), g_row(GROUPED_ROWS[1])
    gm32 = {**{key: gm[key] for key in ("name", "route", "source",
                                        "replaces")},
            "launches": serve_moe_f32["launches"]["dequant_matmul_grouped"],
            "max_abs_err": max(r["max_abs_err"] for r in grouped_rows
                               if r["x"] == "float32"),
            "work": f"one call: E={GROUPED_E}, M={GROUPED_ROWS[0]} per "
                    f"expert, (K, N) = ({k0}, {n0}), f32 x, shared (N,) "
                    "scale",
            "instance": g32["instance"], "timing": "cuda_graph",
            **{key: g32[key] for key in ("ms", "eager_ms", "plain_ms",
                                         "bound_ms", "library_ms",
                                         "bound_by")},
            "prefill_work": f"the same at M={GROUPED_ROWS[1]} (a prefill's "
                            "capacity buffer)",
            **{f"prefill_{key}": g64[key] for key in ("instance", "ms",
                                                      "bound_ms",
                                                      "library_ms")}}
    t_b = sum(r["bytes_ms"] for r in rd_rows)
    t_f = sum(r["ops_ms"] for r in rd_rows)
    rd = {"name": "rd_quant", "route": "cuda",
          "source": "src/repro_torch/kernels/rd_quant/csrc/rd_quant.cu",
          "replaces": "src/repro/kernels/rd_quant/kernel.py:72",
          "launches": deploy["rd_quant_launches"],
          "max_abs_err": max(r["max_abs_err"] for r in rd_rows),
          "work": "one 2-pass assignment of each of 11 full-width shapes "
                  "(layer 0 of each stacked leaf, embed, head), bf16",
          **{key: sum(r[key] for r in rd_rows)
             for key in ("ms", "plain_ms", "bound_ms")},
          "bound_by": "bytes" if t_b >= t_f else "operations",
          "library_ms": None, "timing": "eager",
          "sweep_launches": sweep["launches"]["rd_quant"]}
    mg, qv = embeds["musicgen-medium"], embeds["qwen2-vl-7b"]
    dm["serve_dense_launches"] = serve_dense["q8"]["launches"][
        "dequant_matmul"]
    dm["serve_mla_launches"] = serve_mla["launches"]["dequant_matmul"]
    dm["embeds_full_launches"] = {a: embeds[a]["launches"]["dequant_matmul"]
                                  for a in embeds}
    fa["serve_dense_launches"] = serve_dense["q8"]["launches"][
        "flash_attention"]
    fa["embeds_full_launches"] = {"qwen2-vl-7b": qv["launches"][
        "flash_attention"]}
    fa64 = fa_entry(FLASH_D64_HEADS[0], "bfloat16",
                    mg["launches"]["flash_attention"],
                    "one musicgen-medium prefill call: B=4 S=128 H=G=24 "
                    "D=64 bf16", d=64)
    fa64_32 = fa_entry(FLASH_D64_HEADS[0], "float32",
                       mg["f32"]["launches"]["flash_attention"],
                       "one musicgen-medium f32 prefill call: B=4 S=128 "
                       "H=G=24 D=64 f32", d=64)
    vstep = [(next(r for r in grouped_v3 if (r["m"], r["k"], r["n"]) ==
                   (GROUPED_V3_ROWS[-1], k, n)), calls)
             for (k, n), calls, _ in GROUPED_V3_SHAPES]
    gv3 = {**{key: gm[key] for key in ("name", "route", "source",
                                       "replaces")},
           "launches": serve_mla["launches"]["dequant_matmul_grouped"],
           "max_abs_err": max(r["max_abs_err"] for r in grouped_v3),
           "work": f"one deepseek-v3-671b decode step's MoE layer: 3 calls, "
                   f"E={GROUPED_V3_E}, M={GROUPED_V3_ROWS[-1]} per expert "
                   "(4 slots; a 4 x 128 prefill's capacity is the same), "
                   "bf16 x, shared (N,) scale",
           "instance": "tc_bf16", "timing": "cuda_graph",
           "library_bank": "bfloat16",
           **{key: sum(r[key] * c for r, c in vstep)
              for key in ("ms", "eager_ms", "plain_ms", "bound_ms",
                          "library_ms")},
           "bound_by": vstep[0][0]["bound_by"]}
    fa80 = fa_entry(FLASH_D80_HEADS[0], "bfloat16",
                    serve_hybrid["q8"]["launches"]["flash_attention"],
                    "one zamba2-2.7b prefill call: B=4 S=128 H=G=32 D=80 "
                    "bf16", d=80)
    fa80_32 = fa_entry(FLASH_D80_HEADS[0], "float32",
                       hybrid_f32["launches"]["flash_attention"],
                       "one zamba2-2.7b f32 prefill call: B=4 S=128 H=G=32 "
                       "D=80 f32", d=80)
    dm["serve_ssm_launches"] = serve_ssm["q8"]["launches"]["dequant_matmul"]
    dm["serve_hybrid_launches"] = serve_hybrid["q8"]["launches"][
        "dequant_matmul"]
    runs = ("a_slots", "b_paged", "c_shared", "d_tight")
    for entry, kern in ((dm, "dequant_matmul"), (fa, "flash_attention")):
        entry["serve_paged_launches"] = {
            r: serve_paged[r]["launches"][kern] for r in runs}
    for entry, kern in ((dm, "dequant_matmul"),
                        (gv3, "dequant_matmul_grouped")):
        entry["serve_mla_paged_launches"] = {
            r: serve_mla_paged[r]["launches"][kern]
            for r in ("slots", "paged")}
    return [dm, fa, fa32, fa64, fa64_32, fa80, fa80_32, gm, gm32, gv3, rd]


def main() -> int:
    import importlib.util
    if importlib.util.find_spec("torch") is None:
        _fail("torch is not installed")
    name, card = phase_device()
    if not (SRC / "repro_torch").is_dir():
        _fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import shutil

    import torch
    device = torch.device("cuda")
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    TUNE_DIR.mkdir(parents=True)
    use_tuning_cache(EMPTY_TUNE_CACHE)
    t0 = time.perf_counter()
    results = {"device": name, "card": card}
    phase_s: dict = {}

    def run(key, fn, *args):
        t = time.perf_counter()
        results[key] = fn(*args)
        phase_s[key] = time.perf_counter() - t

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    run("build", phase_build)
    run("dequant_matmul", phase_kernels_dequant, device)
    run("flash_attention", phase_kernels_flash, device)
    run("dequant_matmul_grouped", phase_kernels_grouped, device)
    run("dequant_matmul_grouped_v3", phase_kernels_grouped_v3, device)
    run("parity", phase_parity, device)
    run("parity_codec", phase_parity_codec, device)
    run("parity_moe", phase_parity_moe, device)
    run("parity_moe_bf16", phase_parity_moe_bf16, device)
    run("parity_variants", phase_parity_variants, device)
    run("parity_ssm", phase_parity_ssm, device)
    run("parity_paged", phase_parity_paged, device)
    run("search_parity", phase_search_parity, device)
    cfg, params = init_full(device, "llama3-8b")
    policy = rd_policy_rules(covered_leaves(params))
    run("rd_quant", phase_kernels_rd, params, policy)
    run("deploy_rd", phase_deploy_rd, params, policy)
    run("serve", phase_serve, cfg, params, device)
    free()
    run("serve_paged", phase_serve_paged, cfg, params, device)
    del params
    free()
    run("deploy", phase_deploy_serve, device)
    free()
    run("delta_swap", phase_delta_swap, device)
    free()
    handover = results["delta_swap"].pop("handover")
    results["dist_backend"] = nccl_world()
    run("mesh_restore", phase_mesh_restore, device, handover)
    free()
    run("collectives", phase_collectives, device)
    free()
    run("zoo", phase_zoo, device, handover)
    free()
    # deepseek-moe-16b once every llama3-8b tensor is freed
    cfg, params = init_full(device, "deepseek-moe-16b",
                            num_layers=SERVE_MOE_LAYERS)
    run("serve_moe", phase_serve, cfg, params, device)
    del params
    free()
    run("container_moe", phase_container_moe, device)
    free()
    run("serve_moe_f32", phase_serve_moe_f32, device)
    free()
    # the other dense variants and MLA at their published widths
    cfg, params = init_full(device, "qwen3-8b", num_layers=SERVE_DENSE_LAYERS)
    run("serve_dense", phase_serve, cfg, params, device)
    del params
    free()
    # the SSM and hybrid families at their published widths, cut in depth
    for key, arch in (("serve_ssm", "mamba2-2.7b"),
                      ("serve_hybrid", "zamba2-2.7b")):
        cfg, params = init_full(device, arch,
                                num_layers=SSM_SERVE_LAYERS[arch])
        run(key, phase_serve, cfg, params, device)
        del params
        free()
    run("serve_hybrid_f32", phase_serve_hybrid_f32, device)
    free()
    mla_cfg, mla_tree = mla_cut(device)
    free()
    run("serve_mla", phase_serve_mla, mla_cfg, mla_tree, device)
    free()
    run("serve_mla_paged", phase_serve_mla_paged, mla_cfg, mla_tree, device)
    free()
    shapes = mla_decode_shapes(mla_cfg, mla_tree, device)
    run("tune", phase_tune, device, shapes, TUNED_CACHE)
    free()
    run("serve_mla_tuned", phase_serve_mla_tuned, mla_cfg, mla_tree, device,
        results["serve_mla"], results["tune"])
    del mla_tree
    free()
    run("pins", phase_pins, device)
    free()
    run("embeds_full", phase_embeds_full, device)
    free()
    run("fim", phase_fim, device)
    run("variational", phase_variational, device)
    free()
    run("train", phase_train, device)
    free()
    run("dryrun", phase_dryrun, device, results["train"])
    free()
    run("train_dp", phase_train_dp, device)
    free()
    run("rd_sweep", phase_rd_sweep, device)
    import torch.distributed as dist
    dist.destroy_process_group()
    for key in ("tokens", "logits"):      # serve_mla_tuned's reference
        results["serve_mla"].pop(key)
    results["phase_seconds"] = phase_s
    log("[done] seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()))
    kernels = summarize(results["dequant_matmul"],
                        results["flash_attention"],
                        results["dequant_matmul_grouped"], results["serve"],
                        results["serve_moe"], results["rd_quant"],
                        results["deploy"], results["serve_moe_f32"],
                        results["rd_sweep"], results["delta_swap"],
                        results["dequant_matmul_grouped_v3"],
                        results["serve_dense"], results["serve_mla"],
                        results["embeds_full"], results["serve_ssm"],
                        results["serve_hybrid"],
                        results["serve_hybrid_f32"],
                        results["serve_paged"], results["serve_mla_paged"],
                        results["zoo"], results["train"],
                        results["train_dp"], results["mesh_restore"])
    results["kernels"] = kernels
    results["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(results, indent=1, default=str))
    log(f"[done] all phases passed in {results['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
