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
             paths' shapes (llama3-8b and deepseek-moe-16b), with stated
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
5. deploy RD — eq. (11) level assignment of the whole full-width tree
             (11 leaves) through the kernel, 44 launches, device time
             against its bound and the rate model's bits per parameter;
6. serve   — llama3-8b at full width (32 layers, seeded random init) on
             the q8 backend, then the bf16 one: 4 requests of 128 prompt
             tokens and 32 new tokens, greedy; launch counters and the
             dispatch report prove the path ran through the kernels, and
             the card's q8 quantization of layer 0, the embedding and the
             head equals the CPU's bit for bit;
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
             tokens and launch counts.

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
DM_ROWS = (1, 4, 512)        # decode rows at 1 and 4 slots; prefill B*S
# deepseek-moe-16b's expert banks: E experts, (K, N) with calls per forward
# pass, and rows per expert: the capacity buffer of a 4-slot decode step
# (4 x cap 8) and of a 4 x 128-token prefill (4 x cap 16)
GROUPED_E = 64
GROUPED_SHAPES = [((2048, 1408), 54, "w_gate,w_up"), ((1408, 2048), 27,
                                                      "w_down")]
GROUPED_ROWS = (32, 64)
# flash attention's (H, G) at full width: llama3-8b, deepseek-moe-16b
FLASH_HEADS = ((32, 8), (16, 16))
TOL_F32 = 1e-4               # relative to max|plain|: f32 sums in other order
TOL_FLASH_BF16 = 2e-2        # bf16 output and p rounded to bf16 before PV
# bf16 smoke deepseek-moe-16b, card against CPU, relative to max|logit|:
# the reading is 3.4e-7 (NVIDIA H100 80GB HBM3, 700 W), so a kernel fault
# that moves the logits by 1e-4 or more fails
TOL_MOE_BF16_LOGITS = 1e-4
PROF_STEPS = (4, 8)          # decode ticks traced by torch.profiler
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
    compute the function: the bf16 peak bounds it.  A f32 x has 24
    significant bits: its products are counted at the f32 rate, which
    assumes no split.  Split exactly into three bf16 pieces (8 bits each,
    each piece times a level exact in f32), the same function would run on
    the tensor cores at BF16_FLOPS / 3, about 5x the f32 rate, and would
    then be bound by bytes; no kernel of the port does that yet."""
    return BF16_FLOPS if x_bytes == 2 else F32_FLOPS


def _dm_bound(m, k, n, x_bytes):
    nbytes = m * k * x_bytes + k * n + 4 * n + 4 * m * n
    flops = 2.0 * m * k * n
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / _matmul_peak(x_bytes)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_dequant(device):
    """dequant_matmul vs its plain version at every main-path shape."""
    import torch
    from repro_torch.kernels.dequant_matmul.ops import dequant_matmul_cuda
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for arch, (k, n), calls, names in [(a, *shape) for a, shapes in
                                       DM_SHAPES.items() for shape in shapes]:
        # rotate weight copies so each call reads its weights from HBM,
        # as a decode step does (the L2 holds 50 MB)
        copies = max(1, math.ceil(120e6 / (k * n)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=device,
                            dtype=torch.int8) for _ in range(copies)]
        sc = torch.rand(n, generator=gen, device=device) * 0.01 + 1e-4
        w_deq = ws[0].float() * sc        # library yardstick's operand
        for m in DM_ROWS:
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
                rows.append({"arch": arch, "m": m, "k": k, "n": n,
                             "x": str(xdt)[6:],
                             "calls_per_forward": calls, "weights": names,
                             "max_abs_err": abs_e, "max_rel_err": rel_e,
                             "ms": ms, "eager_ms": eager, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bound,
                             "bound_by": by})
                log(f"[kernels] dequant_matmul m={m:4d} k={k:5d} n={n:6d} "
                    f"x={str(xdt)[6:]:8s} err {rel_e:.2e}  kernel {ms:.4f} ms"
                    f" (eager {eager:.4f})  plain {plain:.4f}  library "
                    f"{lib:.4f}  bound {bound:.4f} ({by})")
        del ws, w_deq
    return rows


def _flash_bound(b, sq, skv, h, g, d, elt):
    nbytes = (2 * b * sq * h * d + 2 * b * skv * g * d) * elt
    pairs = sum(min(skv, i + 1 + (skv - sq)) for i in range(sq))
    flops = 4.0 * d * b * h * pairs
    peak = BF16_FLOPS if elt == 2 else F32_FLOPS
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_flash(device):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import _flash_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    b, d = 4, 128
    rows = []
    for (h, g), s in [(hg, s) for hg in FLASH_HEADS for s in (128, 100)]:
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
                                      else "f32_simt"),
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
    expert shapes: bf16 x (the main path, the tensor-core instance) in both
    scale forms at decode and prefill rows, and f32 x (the f32 tile) at
    decode rows with the shared scale."""
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
            cases = [(m, torch.bfloat16) for m in GROUPED_ROWS]
            if form == "shared":
                cases.append((GROUPED_ROWS[0], torch.float32))
            for m, xdt in cases:
                x = torch.randn((e, m, k), generator=gen, device=device
                                ).to(xdt)
                inst = "tc_bf16" if xdt == torch.bfloat16 else "f32_tile"
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


def _serve_full(cfg, params, backend, device, prompts, new_tokens):
    """Drive one full-width session; return timings and launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models.transformer import prefill
    from repro_torch.serve.session import ServeConfig, ServeSession
    from torch.profiler import ProfilerActivity, profile

    b, s = prompts.shape
    sess = ServeSession(cfg, params, backend=backend, device=device,
                        serve_cfg=ServeConfig(slots=b,
                                              max_len=s + new_tokens))
    hs = [sess.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.clear_dispatch_report()
    registry.reset_launch_counts()
    step_s = []
    prof, prof_wall = None, 0.0
    t_all = time.perf_counter()
    while sess.pending:
        i = len(step_s)
        if i == PROF_STEPS[0]:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        t0 = time.perf_counter()
        sess.step()                   # host copy of the logits syncs
        step_s.append(time.perf_counter() - t0)
        if i == PROF_STEPS[1] - 1:
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
    total = time.perf_counter() - t_all
    launches = registry.launch_counts()
    report = registry.dispatch_report()
    peak = torch.cuda.max_memory_allocated()
    tokens = np.stack([h.result() for h in hs])
    logits, _ = prefill(sess.params, cfg,
                        tokens=torch.from_numpy(prompts).to(device),
                        max_len=s + new_tokens)
    finite = bool(torch.isfinite(logits).all().item())
    plain_steps = [t for j, t in enumerate(step_s)
                   if j > 0 and not PROF_STEPS[0] <= j < PROF_STEPS[1]]
    decode = sorted(plain_steps)
    decode_ms = 1e3 * decode[len(decode) // 2]
    busy, top = _device_time(prof)
    n_prof = PROF_STEPS[1] - PROF_STEPS[0]
    res = {"backend": backend, "launches": launches,
           "dispatch_report": report, "decode_steps":
           sess.stats["decode_steps"], "first_step_ms": 1e3 * step_s[0],
           "prefill_ms": 1e3 * step_s[0] - decode_ms,
           "decode_ms_per_step_median": decode_ms,
           "decode_ms_per_step_mean": 1e3 * sum(decode) / len(decode),
           "profiled_steps": list(PROF_STEPS),
           "profiled_wall_ms_per_step": 1e3 * prof_wall / n_prof,
           "device_busy_ms_per_step": (None if busy is None
                                       else busy / n_prof),
           "device_idle_share": (None if busy is None
                                 else 1.0 - busy / (1e3 * prof_wall)),
           "top_device_ms_per_step": {k: v / n_prof for k, v in top},
           "total_s_with_trace": total,
           "decode_tokens_per_s": b / (decode_ms / 1e3),
           "max_memory_allocated": peak, "logits_finite": finite,
           "logits_shape": list(logits.shape),
           "first_row_tail": tokens[0, -8:].tolist()}
    del sess, logits
    return res


def _device_time(prof):
    """Total device time (ms) in a profiler window and the five largest
    kernels; (None, []) if the profiler saw no device time.  Only device
    events are summed: a CPU op's self device time repeats its kernels'."""
    rows = []
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA") and \
                evt.self_device_time_total > 0:
            rows.append((evt.key, evt.self_device_time_total / 1e3))
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows), rows[:5]


def per_forward_launches(cfg) -> dict:
    """Kernel launches of one q8 forward pass, counted from the model's
    structure: 7 projections per dense layer (4 attention, 3 MLP); per MoE
    layer 4 attention, the router and 3 shared-expert projections through
    dequant_matmul and 3 expert-bank products through
    dequant_matmul_grouped; the untied head."""
    n_layers = cfg.num_layers
    if cfg.family == "dense":
        return {"dequant_matmul": 7 * n_layers + 1,
                "dequant_matmul_grouped": 0}
    nd = cfg.first_dense_layers
    return {"dequant_matmul": 7 * nd + 8 * (n_layers - nd) + 1,
            "dequant_matmul_grouped": 3 * (n_layers - nd)}


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
        r = _serve_full(cfg, params, backend, device, prompts, new_tokens)
        gc.collect()
        torch.cuda.empty_cache()
        fwd = 1 + r["decode_steps"]
        log(f"[serve] {cfg.name} {backend}: prefill {r['prefill_ms']:.1f} ms "
            f"(first "
            f"tick {r['first_step_ms']:.1f} ms), decode "
            f"{r['decode_ms_per_step_median']:.2f} ms/step median "
            f"({r['decode_tokens_per_s']:.1f} tok/s at 4 slots), peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB, device busy "
            f"{r['device_busy_ms_per_step']} ms and idle "
            f"{r['device_idle_share']} of the traced ticks, launches "
            f"{r['launches']}, report {len(r['dispatch_report'])} records")
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


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def summarize(dm_rows, fa_rows, grouped_rows, serve, serve_moe, rd_rows,
              deploy):
    """One entry per kernel.  dequant_matmul: one full-width llama3-8b
    decode step's 225 calls at 4 slots (bf16 x for projections, f32 x for
    the head); flash_attention: one full-width llama3-8b prefill call (B=4,
    S=128, bf16); dequant_matmul_grouped: one full-width deepseek-moe-16b
    decode step's 81 calls (M=32 rows per expert, bf16 x, the shared (N,)
    scale); rd_quant: one 2-pass assignment of each of the 11 full-width
    shapes (layer 0 of each stacked leaf, embed, head; bf16), launches from
    the deploy encode.  Launches of the serving kernels come from each
    model's q8 serve.  The serving kernels' ``ms`` and ``library_ms`` are
    CUDA-graph replays (``timing``), their eager loops' ``eager_ms``
    beside them; rd_quant's calls take milliseconds and are timed eagerly."""
    def row(m, k, n, x):
        return next(r for r in dm_rows if (r["arch"], r["m"], r["k"], r["n"],
                                           r["x"]) ==
                    ("llama3-8b", m, k, n, x))
    step = [(row(4, k, n, "float32" if names == "head" else "bfloat16"),
             calls) for (k, n), calls, names in DM_SHAPES["llama3-8b"]]
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
          "bound_by": "bytes", "timing": "cuda_graph"}
    fa0 = next(r for r in fa_rows if (r["s"], r["h"], r["dtype"]) ==
               (128, 32, "bfloat16"))
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
          "launches": serve["q8"]["launches"]["flash_attention"],
          "max_abs_err": max(r["max_abs_err"] for r in fa_rows),
          "work": "one llama3-8b prefill call: B=4 S=128 H=32 G=8 D=128 bf16",
          "instance": fa0["instance"], "timing": "cuda_graph",
          **{key: fa0[key] for key in ("ms", "eager_ms", "plain_ms",
                                       "bound_ms", "library_ms",
                                       "bound_by")}}
    gstep = [(next(r for r in grouped_rows if (r["m"], r["k"], r["n"],
                                               r["scale"], r["x"]) ==
                   (GROUPED_ROWS[0], k, n, "shared", "bfloat16")), calls)
             for (k, n), calls, _ in GROUPED_SHAPES]
    gm = {"name": "dequant_matmul_grouped", "route": "cuda",
          "source": "src/repro_torch/kernels/dequant_matmul/csrc/"
                    "dequant_matmul_grouped.cu",
          "replaces": "src/repro/kernels/dequant_matmul/kernel.py:70",
          "launches": serve_moe["q8"]["launches"]["dequant_matmul_grouped"],
          "max_abs_err": max(r["max_abs_err"] for r in grouped_rows),
          "work": "one deepseek-moe-16b decode step: 81 calls, E=64, M=32 "
                  "per expert, bf16 x, shared (N,) scale",
          "instance": gstep[0][0]["instance"],
          **{key: sum(r[key] * c for r, c in gstep)
             for key in ("ms", "eager_ms", "plain_ms", "bound_ms",
                         "library_ms")},
          "bound_by": gstep[0][0]["bound_by"], "timing": "cuda_graph"}
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
          "library_ms": None, "timing": "eager"}
    return [dm, fa, gm, rd]


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
    results["build"] = phase_build()
    results["dequant_matmul"] = phase_kernels_dequant(device)
    results["flash_attention"] = phase_kernels_flash(device)
    results["dequant_matmul_grouped"] = phase_kernels_grouped(device)
    results["parity"] = phase_parity(device)
    results["parity_codec"] = phase_parity_codec(device)
    results["parity_moe"] = phase_parity_moe(device)
    results["parity_moe_bf16"] = phase_parity_moe_bf16(device)
    cfg, params = init_full(device, "llama3-8b")
    policy = rd_policy_rules(covered_leaves(params))
    results["rd_quant"] = phase_kernels_rd(params, policy)
    results["deploy_rd"] = phase_deploy_rd(params, policy)
    results["serve"] = phase_serve(cfg, params, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    results["deploy"] = phase_deploy_serve(device)
    # deepseek-moe-16b once every llama3-8b tensor is freed
    cfg, params = init_full(device, "deepseek-moe-16b")
    results["serve_moe"] = phase_serve(cfg, params, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    results["container_moe"] = phase_container_moe(device)
    kernels = summarize(results["dequant_matmul"],
                        results["flash_attention"],
                        results["dequant_matmul_grouped"], results["serve"],
                        results["serve_moe"], results["rd_quant"],
                        results["deploy"])
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
