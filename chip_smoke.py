#!/usr/bin/env python3
"""Proof on one NVIDIA card that the PyTorch/CUDA port builds, is right and
serves.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each fails the run on its own; nothing is caught and ignored):

1. device  — a CUDA card is required; prints its name and power limit;
2. build   — builds every hand-written kernel from the checkout's sources
             (one nvcc per source, started together);
3. kernels — each kernel against its plain PyTorch version at the main
             path's shapes, with stated tolerances, timed beside its plain
             version, a one-call PyTorch yardstick and its bound;
4. parity  — the llama3-8b smoke model (f32, q8) served on the card and on
             the CPU from the same converted weights: greedy tokens must be
             identical and prefill logits close; q8 levels and scales made
             on the card must equal the CPU's bit for bit;
5. serve   — llama3-8b at full width (32 layers, seeded random init) on
             the q8 backend, then the bf16 one: 4 requests of 128 prompt
             tokens and 32 new tokens, greedy; launch counters and the
             dispatch report prove the path ran through the kernels, and
             the card's q8 quantization of layer 0, the embedding and the
             head equals the CPU's bit for bit.

The line before the last is the card's name and power limit; one line
before it is the ``{"kernels": [...]}`` summary; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  It imports nothing of JAX.
"""

from __future__ import annotations

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

# llama3-8b full width: (K, N) of the q8 projections and the head, with
# the number of calls per forward pass
DM_SHAPES = [((4096, 4096), 64, "wq,wo"), ((4096, 1024), 64, "wk,wv"),
             ((4096, 14336), 64, "w_gate,w_up"), ((14336, 4096), 32, "w_down"),
             ((4096, 128256), 1, "head")]
DM_ROWS = (1, 4, 512)        # decode rows at 1 and 4 slots; prefill B*S
TOL_F32 = 1e-4               # relative to max|plain|: f32 sums in other order
TOL_FLASH_BF16 = 2e-2        # bf16 output and p rounded to bf16 before PV
PROF_STEPS = (4, 8)          # decode ticks traced by torch.profiler


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
    return {"seconds": total, "per_source": secs}


def _dm_bound(m, k, n, x_bytes):
    nbytes = m * k * x_bytes + k * n + 4 * n + 4 * m * n
    flops = 2.0 * m * k * n
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels_dequant(device):
    """dequant_matmul vs its plain version at every main-path shape."""
    import torch
    from repro_torch.kernels.dequant_matmul.ops import dequant_matmul_cuda
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for (k, n), calls, names in DM_SHAPES:
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
                ms = time_ms(lambda: dequant_matmul_cuda(
                    x, ws[next(it) % copies], sc))
                plain = time_ms(lambda: dequant_matmul_ref(x, ws[0], sc))
                xf = x.float()
                lib = time_ms(lambda: torch.matmul(xf, w_deq))
                bound, by = _dm_bound(m, k, n, x.element_size())
                rows.append({"m": m, "k": k, "n": n, "x": str(xdt)[6:],
                             "calls_per_forward": calls, "weights": names,
                             "max_abs_err": abs_e, "max_rel_err": rel_e,
                             "ms": ms, "plain_ms": plain, "library_ms": lib,
                             "bound_ms": bound, "bound_by": by})
                log(f"[kernels] dequant_matmul m={m:4d} k={k:5d} n={n:6d} "
                    f"x={str(xdt)[6:]:8s} err {rel_e:.2e}  kernel {ms:.4f} ms"
                    f"  plain {plain:.4f}  library {lib:.4f}  bound "
                    f"{bound:.4f} ({by})")
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
    b, h, g, d = 4, 32, 8, 128
    rows = []
    for s in (128, 100):
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
            ms = time_ms(lambda: _flash_cuda(q, k, v))
            plain_ms = time_ms(plain)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            bound, by = _flash_bound(b, s, s, h, g, d, q.element_size())
            rows.append({"b": b, "s": s, "h": h, "g": g, "d": d,
                         "dtype": str(dt)[6:], "max_abs_err": abs_e,
                         "max_rel_err": rel_e, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib, "bound_ms": bound,
                         "bound_by": by})
            log(f"[kernels] flash_attention B={b} S={s} H={h} G={g} D={d} "
                f"{str(dt)[6:]:8s} err {rel_e:.2e}  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f}  library {lib:.4f}  bound "
                f"{bound:.5f} ({by})")
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


def phase_serve(device):
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models.transformer import init_params

    cfg = configs.get("llama3-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] llama3-8b full width: {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    # the q8 backend quantizes this tree on the card: hold layer 0 of every
    # stacked leaf, the embedding and the head against the CPU, bit for bit
    from repro_torch.compression import flatten_tree
    t0 = time.perf_counter()
    sample = {k: (v[:1] if k.startswith("layers/") else v)
              for k, v in flatten_tree(params).items()}
    mism = q8_mismatches(sample, device)
    check(mism == 0, f"full width: {mism} q8 entries quantized on the card "
          "differ from the CPU's")
    log(f"[serve] full width q8 of layer 0, embed and head: card equals CPU "
        f"bit for bit ({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    new_tokens = 32
    per_fwd = 7 * cfg.num_layers + 1
    out = {"q8_mismatch_card_vs_cpu": mism}
    for backend in ("q8", "bf16"):
        r = _serve_full(cfg, params, backend, device, prompts, new_tokens)
        gc.collect()
        torch.cuda.empty_cache()
        fwd = 1 + r["decode_steps"]
        log(f"[serve] {backend}: prefill {r['prefill_ms']:.1f} ms (first "
            f"tick {r['first_step_ms']:.1f} ms), decode "
            f"{r['decode_ms_per_step_median']:.2f} ms/step median "
            f"({r['decode_tokens_per_s']:.1f} tok/s at 4 slots), peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB, device idle "
            f"{r['device_idle_share']} of the traced ticks, launches "
            f"{r['launches']}, report {len(r['dispatch_report'])} records")
        check(r["logits_finite"], f"{backend}: non-finite logits")
        check(r["logits_shape"] == [4, cfg.vocab_size],
              f"{backend}: logits shape {r['logits_shape']}")
        check(not r["dispatch_report"],
              f"{backend}: dispatch report not empty: {r['dispatch_report']}")
        check(r["launches"]["flash_attention"] == cfg.num_layers,
              f"{backend}: {r['launches']['flash_attention']} flash launches,"
              f" want {cfg.num_layers} (one prefill)")
        if backend == "q8":
            check(r["launches"]["dequant_matmul"] == per_fwd * fwd,
                  f"q8: {r['launches']['dequant_matmul']} dequant_matmul "
                  f"launches, want {per_fwd} x {fwd} passes")
        out[backend] = r
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def summarize(dm_rows, fa_rows, serve):
    """One entry per kernel.  dequant_matmul: one full-width decode step's
    225 calls at 4 slots (bf16 x for projections, f32 x for the head);
    flash_attention: one full-width prefill call (B=4, S=128, bf16)."""
    def row(m, k, n, x):
        return next(r for r in dm_rows if (r["m"], r["k"], r["n"], r["x"])
                    == (m, k, n, x))
    step = [(row(4, k, n, "float32" if names == "head" else "bfloat16"),
             calls) for (k, n), calls, names in DM_SHAPES]
    dm = {"name": "dequant_matmul", "route": "cuda",
          "source": "src/repro_torch/kernels/dequant_matmul/csrc/"
                    "dequant_matmul.cu",
          "replaces": "src/repro/kernels/dequant_matmul/kernel.py:35",
          "launches": serve["q8"]["launches"]["dequant_matmul"],
          "max_abs_err": max(r["max_abs_err"] for r in dm_rows),
          "work": "one decode step: 225 calls at M=4",
          **{key: sum(r[key] * c for r, c in step)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
          "bound_by": "bytes"}
    fa0 = next(r for r in fa_rows if r["s"] == 128 and r["dtype"] ==
               "bfloat16")
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
          "launches": serve["q8"]["launches"]["flash_attention"],
          "max_abs_err": max(r["max_abs_err"] for r in fa_rows),
          "work": "one prefill call: B=4 S=128 H=32 G=8 D=128 bf16",
          **{key: fa0[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "library_ms", "bound_by")}}
    return [dm, fa]


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
    results["parity"] = phase_parity(device)
    results["serve"] = phase_serve(device)
    kernels = summarize(results["dequant_matmul"],
                        results["flash_attention"], results["serve"])
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
