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
7. deploy serve — full width cut to 2 layers: a deepcabac-rd container
             (every float leaf of rank >= 2, embed and head included)
             encoded from the card, served through
             ``ServeEngine.from_compressed`` on the q8 and container
             backends; tokens must equal a session on the in-memory tree
             with the same policy applied, launch counts must match the
             path, the dispatch report must be empty;
8. MoE serve — once the llama3-8b tensors are freed, deepseek-moe-16b at
             full width (28 layers) served as in 6, every routed-expert
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
             same hyperparameters and write identical blobs;
11. fim     — fisher_for on llama3-8b at full width, 2 layers: in bf16 on
             the card (finite, wq/wk/wv nonzero: gradients pass through
             attention, which under grad takes the scan, so no kernel
             launches), then in f32 on the card against the CPU;
12. variational — variational_fim at the same width in f32, 4 steps:
             sigma finite and > 0, vd_sparsify runs, ms/step, peak memory;
13. rd_sweep — rd_sweep on the 1-layer full-width llama3-8b (bf16) with
             the bench's fast grid: rd_quant and flash_attention launch
             the predicted counts, the report stays empty, the policy
             re-encodes to the sweep's bytes; every point and the split
             of the seconds (assignment, statistics, encode, decode,
             proxy);
14. delta_swap (after 7) — delta checkpoints and the live weight swap at
             llama3-8b's published widths, 2 layers, trained in f32 on the
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
15. parity_variants (after 4) — the smoke qwen3-8b, qwen1.5-4b,
             mistral-nemo-12b, qwen2-vl-7b, musicgen-medium and
             deepseek-v3-671b (f32, q8; qwen2-vl-7b also bf16) on the card
             and on the CPU: identical greedy tokens, close logits, equal
             q8 levels; reports hold only MLA's d != dv records;
16. serve_dense (after 9) — qwen3-8b at published widths and full depth
             (36 layers), served as in 6 (the q8 check of layer 0, then
             q8 and bf16, eager and graphs);
17. serve_mla — deepseek-v3-671b at published widths cut to 4 layers (3
             dense, 1 MoE of 256 experts top-8), built on q8 leaf by leaf
             and served as in 6; launches as predicted, no flash launch,
             only the d != dv (192 != 128) records; one full-width MLA
             block in f32, card against CPU;
18. embeds_full — musicgen-medium (48 layers, the D = 64 flash instance)
             and qwen2-vl-7b (28 layers, M-RoPE over a patch grid and
             text) at full depth on q8: ``prefill(embeds=...)`` of 4 x 128
             and 31 decode steps fed back through a stub frontend table;
             then each at 2 layers in f32, card tokens equal to the CPU's.

13 runs at 1 layer (RD_SWEEP_LAYERS), so that 15-18 fit the time limit.

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
EMBED_TABLE_ROWS = 4096
EMBED_F32_LAYERS = 2
EMBED_F32_NEW_TOKENS = 12
# flash attention's (H, G) and D at full width: llama3-8b, deepseek-moe-16b
# (D = 128), musicgen-medium (D = 64)
FLASH_HEADS = ((32, 8), (16, 16))
FLASH_D64_HEADS = (24, 24)
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
DEPLOY_LAYERS = 2            # depth of the full-width container served
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
VD_BYTES_PER_PARAM = 44
# rd_sweep: benchmarks/rd_sweep_bench.py's --fast grid, min_ndim=3 (the
# stacked layer matrices: embed and head stay raw)
RD_SWEEP_LAYERS = 1          # the sweep's depth (its launches of rd_quant
#                              go with the 7 stacked tensors, not the depth)
SWEEP = dict(delta_rels=(1e-3, 6e-3), lambdas=(0.0, 1e-5), prompts=3,
             decode_steps=6, fim_batches=1, min_ndim=3)
# search parity at smoke size: the sweep's logit KL card vs CPU (a sum over
# the vocabulary of f32 log-probability differences), the DC grids and the
# accuracy budget on minus the eval NLL.  On the seeded smoke weights each
# grid has points on both sides of the budget (a CPU run: DC-v2 keeps 0.01
# and 0.02 of the deltas and passes at lambda 0 only, DC-v1 passes at
# S = 32 only), so the choice is not a fallback.  DC-v1 runs lambda = 0
# alone: its F_i (the empirical FIM of random weights, 1e-6 and less) make
# any lambda > 0 zero most weights, which lowers a random model's NLL.
TOL_KL_ABS = 1e-6
DC_DELTAS = (0.005, 0.01, 0.02, 0.05)
DC_LAMBDAS = (0.0, 1e-4)
DC_S_GRID = (16.0, 32.0, 64.0)
DC_V1_LAMBDAS = (0.0,)
SEARCH_TOL = 0.005
# delta_swap: llama3-8b at full width, DEPLOY_LAYERS deep, trained in f32:
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
    cases = [(hg, 128) for hg in FLASH_HEADS] + [(FLASH_D64_HEADS, 64)]
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


def allowed_records(cfg) -> set:
    """The dispatch records a run of ``cfg`` may leave: MLA's attention has
    d != dv, so its prefills take the scan, recorded, as the reference's
    do (``repro/kernels/flash_attention/ops.py``); nothing else."""
    if cfg.attention != "mla":
        return set()
    d = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {("flash_attention", "fallback",
             f"d != dv ({d} != {cfg.v_head_dim})")}


def report_ok(cfg, report) -> bool:
    """Every record allowed, and the MLA records present: its prefills ran
    the scan."""
    allowed = allowed_records(cfg)
    got = {(r["op"], r["kind"], r["reason"]) for r in report}
    return got == allowed


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
            registry.clear_dispatch_report()
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
    kern = sum(e.self_device_time_total for e in prof.key_averages()
               if "rd_quant_pass" in e.key) / 1e3
    busy, top = _device_time(prof)
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
    """Full width cut to DEPLOY_LAYERS layers: deepcabac-rd container from
    the card, served from the blob on q8 and container, against sessions
    on the in-memory tree with the same policy applied."""
    import numpy as np
    import torch
    from repro_torch import compression, configs
    from repro_torch.core.codec import decode_record
    from repro_torch.core.container import ContainerReader
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.backends import get_backend

    cfg = configs.get("llama3-8b").replace(num_layers=DEPLOY_LAYERS)
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
    t0 = time.perf_counter()
    for hdr, payload in ContainerReader(blob):
        decode_record(hdr, payload, dequantize=False)
    dec_s = time.perf_counter() - t0
    log(f"[deploy] llama3-8b full width, {DEPLOY_LAYERS} layers: "
        f"{n_params / 1e9:.3f} G params, {n_coded / 1e9:.3f} G RD-coded "
        f"({len(leaves)} leaves, embed and head included); RD on the card "
        f"{rd_s:.2f} s ({launches} rd_quant launches); host CABAC encode "
        f"{enc_s:.1f} s ({n_coded / enc_s / 1e6:.1f} M values/s), decode "
        f"{dec_s:.1f} s ({n_coded / dec_s / 1e6:.1f} M values/s) on the card "
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
    out = {"layers": DEPLOY_LAYERS, "params": n_params, "rd_coded": n_coded,
           "leaves": len(leaves), "rd_quant_launches": launches,
           "rd_s": rd_s, "encode_s": enc_s, "decode_s": dec_s,
           "encode_values_per_s": n_coded / enc_s,
           "decode_values_per_s": n_coded / dec_s, "blob_bytes": len(blob),
           "bits_per_param": bpp,
           "policy_steps": {k: r["step"] for k, r in policy["rules"].items()}}
    for backend, tree_backend in (("q8", "q8"), ("container", "bf16")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine.from_compressed(cfg, blob, max_len=160,
                                          backend=backend, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        registry.clear_dispatch_report()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, new_tokens)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = registry.launch_counts()
        report = registry.dispatch_report()
        peak = torch.cuda.max_memory_allocated()
        fwd = 1 + eng._session(len(prompts)).stats["decode_steps"]
        ref = ServeEngine(cfg, tree_pol, max_len=160, backend=tree_backend,
                          device=device).generate(prompts, new_tokens)
        check(np.array_equal(toks, ref), f"deploy {backend}: greedy tokens "
              f"from the container differ from the policy-applied tree's")
        check(not report, f"deploy {backend}: dispatch report not empty: "
              f"{report}")
        check(counts["flash_attention"] == cfg.num_layers,
              f"deploy {backend}: {counts['flash_attention']} flash "
              f"launches, want {cfg.num_layers} (one prefill)")
        if backend == "q8":
            check(counts["dequant_matmul"] == per_fwd * fwd,
                  f"deploy q8: {counts['dequant_matmul']} dequant_matmul "
                  f"launches, want {per_fwd} x {fwd} passes")
        out[backend] = {"load_s": load_s, "generate_s": gen_s,
                        "forward_passes": fwd, "launches": counts,
                        "dispatch_report": report,
                        "max_memory_allocated": peak,
                        "tokens_equal_policy_tree": True,
                        "first_row_tail": toks[0, -8:].tolist()}
        log(f"[deploy] {backend}: load {load_s:.1f} s (decode + transfer), "
            f"4 x 128 + 32 greedy in {gen_s:.2f} s, tokens equal the "
            f"policy-applied tree's, launches {counts}, peak "
            f"{peak / 2**30:.2f} GiB")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
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


def phase_delta_swap(device):
    """Delta ("P-frame") checkpoints and the live weight swap at llama3-8b's
    published widths, cut to DEPLOY_LAYERS layers: the f32 training state on
    the card saved as a sharded keyframe over SWAP_MESH (shard math only)
    and two P-frames, each one AdamW step later, by ``CheckpointManager``
    (deepcabac-delta, min_quant_ndim=3: the stacked layer matrices are
    CABAC-coded, embed, head and norms stay raw); a graph-replaying q8
    session cold-started from the keyframe's manifest serves 4 x 128
    prompt tokens, and each P-frame is swapped in with the four requests in
    flight.  After each swap the resident leaves must equal, bit for bit,
    those of a q8 tree built from the host chain decode
    (``restore_levels``), every coded tensor must have changed levels, and
    the decode graph must not be captured again; a request admitted after
    the last swap must give that cold session's prefill logits bit for bit
    and its greedy tokens; the path's kernel launches must be
    ``per_forward_launches``' and the dispatch report empty."""
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
    cfg_t, params = _full_cut(device, param_dtype="float32",
                              compute_dtype="float32")
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
        cfg = configs.get("llama3-8b").replace(num_layers=DEPLOY_LAYERS)
        scfg = ServeConfig(slots=4, max_len=160)
        backend = get_backend("q8", track_levels=True)
        clock.wrap(backend, "_convert", "q8_convert")
        t0 = time.perf_counter()
        sess = ServeSession(cfg, str(root / f"step_{SWAP_STEPS[0]:08d}"),
                            backend=backend, serve_cfg=scfg, device=device)
        torch.cuda.synchronize()
        out["cold_start_s"] = time.perf_counter() - t0
        out["intra_decode_values_per_s"] = \
            n_coded / clock.secs["intra_decode"]
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
        handles = [sess.submit(p, SWAP_NEW_TOKENS) for p in prompts]
        clock.wrap(sess, "_admit", "admit")
        clock.wrap(sess.graphs, "_capture", "capture")
        gc.callbacks.append(gc_clock)
        registry.clear_dispatch_report()
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
            # the host chain decode of this step: the whole chain for the
            # first P-frame, then the next link on top of it
            t0 = time.perf_counter()
            ents = (delta.restore_levels(str(root), step) if k == 0 else
                    delta._apply_delta_file(
                        ents, str(root / f"step_{step:08d}"), None, step))
            chain_s = time.perf_counter() - t0
            cold_tree = get_backend("q8").load_entries(cfg, ents,
                                                       device=device)
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
        check(bool(torch.isfinite(late_logits).all()) and
              list(late_logits.shape) == [1, cfg.vocab_size],
              "delta_swap: late prefill logits not finite or misshaped")
        del cold, cold_tree, sess, ents
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
    finally:
        clock.restore()
        if gc_clock in gc.callbacks:
            gc.callbacks.remove(gc_clock)
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


def _serve_full(cfg, params, backend, device, prompts, new_tokens,
                mode="graph"):
    """Drive one full-width session, its steps replayed from CUDA graphs
    (``mode="graph"``, the session's default on the card) or run eagerly
    under ``eager_steps()`` (``"eager"``); return timings and launch
    counts, the greedy tokens (``tokens``) and one prefill forward's
    logits (``logits``, on the host), which the caller takes out.  Ticks
    ``PROF_STEPS[0]`` to ``PROF_STEPS[1] - 1`` are traced, after one tick
    that warms the tracer up; their own idle share is the headline
    (``device_idle_share``).  In graph mode the decode graph's replays are
    also timed by CUDA events (``decode_replay_ms``), which with the
    untraced ticks gives a share that no tracer touches
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
        trace["busy"], trace["top"] = _device_time(p)
        trace["split"] = {name: _kernel_ms(p, key) / n_prof
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
    registry.clear_dispatch_report()
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
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA],
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
        check(report_ok(cfg, r["dispatch_report"]), f"{cfg.name} "
              f"{backend} {mode}: dispatch report {r['dispatch_report']}, "
              f"want only {allowed_records(cfg)}")
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


def _device_time(prof):
    """Total device time (ms) in a profiler window and the eight largest
    kernels; (None, []) if the profiler saw no device time.  Only device
    events are summed: a CPU op's self device time repeats its kernels',
    and a user annotation (the schedule's ``ProfilerStep#n``) is drawn on
    the device's timeline over the kernels it spans."""
    rows = []
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA") and \
                evt.self_device_time_total > 0 and \
                not getattr(evt, "is_user_annotation", False) and \
                not evt.key.startswith("ProfilerStep"):
            rows.append((evt.key, evt.self_device_time_total / 1e3))
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows), rows[:8]


def _kernel_ms(prof, names) -> float:
    """Device time (ms) of the kernels whose name holds ``names`` (a
    string or a tuple of them) in a profiler window."""
    names = (names,) if isinstance(names, str) else names
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and
               any(n in e.key for n in names)) / 1e3


def per_forward_launches(cfg) -> dict:
    """Kernel launches of one q8 forward pass, counted from the model's
    structure: per dense layer the attention projections (GQA 4; MLA 7:
    w_dq, w_uq, w_dkv, w_kr, w_uk, w_uv, wo, 6 without a q LoRA) and 3 MLP;
    per MoE layer the attention's, the router and 3 shared-expert
    projections through dequant_matmul and 3 expert-bank products through
    dequant_matmul_grouped; the untied head."""
    n_layers = cfg.num_layers
    attn = 4 if cfg.attention != "mla" else 6 + bool(cfg.q_lora_rank)
    if cfg.family == "dense":
        return {"dequant_matmul": (attn + 3) * n_layers + 1,
                "dequant_matmul_grouped": 0}
    nd = cfg.first_dense_layers
    return {"dequant_matmul": (attn + 3) * nd + (attn + 4) * (n_layers - nd)
            + 1, "dequant_matmul_grouped": 3 * (n_layers - nd)}


def flash_per_prefill(cfg) -> int:
    """flash_attention launches of one prefill: one per layer, none for
    MLA (d != dv takes the scan)."""
    return 0 if cfg.attention == "mla" else cfg.num_layers


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
        check(not r["dispatch_report"],
              f"{what}: dispatch report not empty: {r['dispatch_report']}")
        check(r["launches"]["flash_attention"] == cfg.num_layers,
              f"{what}: {r['launches']['flash_attention']} flash launches, "
              f"want {cfg.num_layers} (one prefill)")
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
        registry.clear_dispatch_report()
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
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    from repro_torch.compression.tree import unflatten
    from repro_torch.models.transformer import prefill
    from repro_torch.serve.session import ServeConfig, ServeSession

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
    tree_cpu = unflatten({k: v.cpu() for k, v in flatten_tree(tree).items()})
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sess = ServeSession(cfg, tree_cpu, backend="q8", device=cpu,
                        serve_cfg=ServeConfig(slots=4,
                                              max_len=128 + new_tokens))
    hs = [sess.submit(p, max_new_tokens=new_tokens) for p in prompts]
    sess.run()
    tok_c = np.stack([h.result() for h in hs])
    lo_c, _ = prefill(sess.params, cfg, tokens=torch.from_numpy(prompts),
                      max_len=128 + new_tokens)
    lo_c = lo_c.float().numpy()
    cpu_s = time.perf_counter() - t0
    del sess, tree_cpu
    gc.collect()
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


def phase_serve_mla(device, cpu="cpu"):
    """deepseek-v3-671b at its published widths cut to SERVE_MLA_LAYERS
    layers (the 3 leading dense layers, d_ff 18432, and one MoE layer of
    256 experts top-8), bf16, built on q8 leaf by leaf and served as
    ``_serve_modes`` does (4 x 128 + 32 greedy, eagerly and from graphs):
    tokens and launches equal in both modes, dequant_matmul and
    dequant_matmul_grouped launched as ``per_forward_launches`` predicts,
    no flash launch, and only the d != dv (192 != 128) records.  Then one
    full-width MLA block in f32 on q8 (prefill of 2 x 64, a ragged decode
    step) on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch import configs

    cfg = configs.get("deepseek-v3-671b").replace(
        num_layers=SERVE_MLA_LAYERS)
    tree = init_q8_leafwise(cfg, device)
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    r = _serve_modes(cfg, tree, "q8", device, prompts, 32)
    del r["tokens"], r["logits"]
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
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    r["layers"] = cfg.num_layers
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


def phase_embeds_full(device, cpu="cpu"):
    """The embeddings models at their published widths and full depth,
    bf16 on q8: musicgen-medium (48 layers, layernorm, gelu, head dim 64:
    the D = 64 flash instance) and qwen2-vl-7b (28 layers, M-RoPE with a
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
        cfg = configs.get(arch)
        tree = init_q8_leafwise(cfg, device)
        emb, p3, table = embed_inputs(cfg, 4, 128, 8, device)
        torch.cuda.reset_peak_memory_stats()
        registry.clear_dispatch_report()
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
    registry.clear_dispatch_report()
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
    to DEPLOY_LAYERS layers: in its bf16 on the card (every leaf finite,
    wq/wk/wv nonzero, no kernel launched, empty report), then in f32 on the
    card against the same f32 weights on the CPU, per leaf within TOL_F32
    of max|F|."""
    import torch
    from repro_torch.compression import flatten_tree
    from repro_torch.compression.tree import unflatten

    cfg, params = _full_cut(device)
    torch.cuda.reset_peak_memory_stats()
    _, bf16_s, launches = _fisher_leaves(cfg, params, "bf16")
    bf16_peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32, params = _full_cut(device, param_dtype="float32",
                              compute_dtype="float32")
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
    registry.clear_dispatch_report()
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
    return RDSearchConfig(**SWEEP)


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
    registry.clear_dispatch_report()
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


def summarize(dm_rows, fa_rows, grouped_rows, serve, serve_moe, rd_rows,
              deploy, serve_moe_f32, sweep, swap, grouped_v3, serve_dense,
              serve_mla, embeds):
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
    ``delta_swap_launches`` of both entries.  Launches of the other serving
    entries come from each model's q8 serve, its eager run (the graph
    run's are equal).  The serving kernels' ``ms`` and ``library_ms`` are
    CUDA-graph replays (``timing``), their eager loops' ``eager_ms``
    beside them; rd_quant's calls take milliseconds and are timed
    eagerly.  The other dense variants and MLA (PR 20): the D = 64 flash
    instances at musicgen-medium's prefill (B=4, S=128, H=G=24), launched
    by ``embeds_full`` (bf16 at 48 layers, f32 at 2), the grouped kernel
    at deepseek-v3-671b's 256 experts (one decode step's 3 calls at M=32,
    launched by ``serve_mla``), and the launches of each serving path of
    qwen3-8b, deepseek-v3-671b, musicgen-medium and qwen2-vl-7b beside
    the kernels they run."""
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
    return [dm, fa, fa32, fa64, fa64_32, gm, gm32, gv3, rd]


def main() -> int:
    import importlib.util
    if importlib.util.find_spec("torch") is None:
        _fail("torch is not installed")
    name, card = phase_device()
    if not (SRC / "repro_torch").is_dir():
        _fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    device = torch.device("cuda")
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
    run("search_parity", phase_search_parity, device)
    cfg, params = init_full(device, "llama3-8b")
    policy = rd_policy_rules(covered_leaves(params))
    run("rd_quant", phase_kernels_rd, params, policy)
    run("deploy_rd", phase_deploy_rd, params, policy)
    run("serve", phase_serve, cfg, params, device)
    del params
    free()
    run("deploy", phase_deploy_serve, device)
    free()
    run("delta_swap", phase_delta_swap, device)
    free()
    # deepseek-moe-16b once every llama3-8b tensor is freed
    cfg, params = init_full(device, "deepseek-moe-16b")
    run("serve_moe", phase_serve, cfg, params, device)
    del params
    free()
    run("container_moe", phase_container_moe, device)
    free()
    run("serve_moe_f32", phase_serve_moe_f32, device)
    free()
    # the other dense variants and MLA at their published widths
    cfg, params = init_full(device, "qwen3-8b")
    run("serve_dense", phase_serve, cfg, params, device)
    del params
    free()
    run("serve_mla", phase_serve_mla, device)
    free()
    run("embeds_full", phase_embeds_full, device)
    free()
    run("fim", phase_fim, device)
    run("variational", phase_variational, device)
    run("rd_sweep", phase_rd_sweep, device)
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
                        results["embeds_full"])
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
