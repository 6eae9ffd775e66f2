#!/usr/bin/env python3
"""Time the serving kernels of one or more checkouts on one card by both
yardsticks, CUDA-graph replays and eager loops, so that two commits are
compared by one method in one run:

    python3 kernel_yardsticks.py PARENT . . PARENT

Each argument is the root of a checkout (it holds ``src/repro_torch``).
Each is measured in a process of its own, in the order given, with the
timing helpers, shapes and tolerances of the ``chip_smoke.py`` beside this
script, so the commits differ only in their kernels.  Rows, bf16 unless
named:

- flash_attention at the full-width prefill shapes (B=4, D=128, S 128 and
  100, (H, G) (32, 8) and (16, 16)), bf16 and f32, with
  ``scaled_dot_product_attention`` on the same operands (f32 with TF32
  off, as ``chip_smoke.phase_device`` sets it);
- dequant_matmul_grouped at deepseek-moe-16b's expert banks (E=64, M 32
  and 64): a bf16 x with the shared (N,) scale, a f32 x with the shared
  and the per-expert (E, N) scale, with ``torch.bmm`` on the dequantized
  f32 bank;
- dequant_matmul at one decode step (M=4) of each model, the head with a
  f32 x, summed over the step's calls;
- dequant_matmul at one prefill forward (M=512) of each model, every
  projection (bf16 x) and the MoE router (f32 x), summed over the
  forward's calls (the head runs on the last positions only, M=4, and is
  in the decode rows), each row beside ``torch.matmul`` on the
  dequantized f32 weight (the same function), ``torch.matmul`` of the
  bf16 x on the weight dequantized to bf16 (a speed reference for cuBLAS
  at that shape, not the same function) and, for a bf16 x, the grouped
  kernel's tensor-core instance called with one expert (E=1);
- deepseek-moe-16b's MoE block (``models.moe.moe_block``: router,
  routing, the grouped expert products, shared experts) at full width,
  one layer of q8 banks, a bf16 x of a decode step's rows (G=4, S=1) and
  a prefill's (G=4, S=128), called as the serving step calls it (without
  the aux loss where the block can skip it): device time and device
  kernels per call, from the profiler over MOE_CALLS calls.

Every kernel call is first held against its plain version.  One JSON line
per checkout is printed; all of them go to
``chiprun_out/kernel_yardsticks.json``.  Needs a card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
MOE_CALLS = 20


def _measure(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    name, card = cs.phase_device()
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    import repro_torch
    cs.check(Path(repro_torch.__file__).resolve().is_relative_to(root),
             f"repro_torch came from {repro_torch.__file__}, not {root}")
    from repro_torch.kernels import _build
    from repro_torch.kernels.dequant_matmul.ops import (
        dequant_matmul_cuda, dequant_matmul_grouped_cuda)
    from repro_torch.kernels.dequant_matmul.ref import (
        dequant_matmul_grouped_ref, dequant_matmul_ref)
    from repro_torch.kernels.flash_attention.ops import _flash_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def both(fn):
        return {"graph_ms": cs.time_ms_graph(fn), "eager_ms": cs.time_ms(fn)}

    flash = []
    b, d = 4, 128
    for (h, g), s, dt in [(hg, s, dt) for hg in cs.FLASH_HEADS
                          for s in (128, 100)
                          for dt in (torch.bfloat16, torch.float32)]:
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev
                               ).to(dt) for n in (h, g, g))
        rep = h // g
        want = flash_attention_ref(
            q.permute(0, 2, 1, 3).reshape(b * h, s, d),
            *(t.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(
                b * h, s, d) for t in (k, v))).reshape(
            b, h, s, d).permute(0, 2, 1, 3)
        _, rel = cs.rel_err(_flash_cuda(q, k, v), want)
        tol = cs.TOL_FLASH_BF16 if dt == torch.bfloat16 else cs.TOL_F32
        cs.check(rel <= tol, f"flash S={s} H={h} {dt}: rel {rel}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flash.append({"s": s, "h": h, "g": g, "dtype": str(dt)[6:],
                      "rel_err": rel,
                      "kernel": both(lambda: _flash_cuda(q, k, v)),
                      "sdpa": both(lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True, enable_gqa=True))})

    grouped = []
    e = cs.GROUPED_E
    for (k, n), _, _ in cs.GROUPED_SHAPES:
        wq = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        for form, sshape in (("shared", (n,)), ("per_expert", (e, n))):
            sc = torch.rand(sshape, generator=gen, device=dev) * 0.01 + 1e-4
            w_deq = wq.float() * (sc if sc.dim() == 1 else sc[:, None, :])
            cases = [(m, torch.float32) for m in cs.GROUPED_ROWS]
            if form == "shared":
                cases = [(m, torch.bfloat16) for m in cs.GROUPED_ROWS] + cases
            for m, xdt in cases:
                x = torch.randn((e, m, k), generator=gen, device=dev).to(xdt)
                _, rel = cs.rel_err(dequant_matmul_grouped_cuda(x, wq, sc),
                                    dequant_matmul_grouped_ref(x, wq, sc))
                cs.check(rel <= cs.TOL_F32,
                         f"grouped m={m} k={k} {form} {xdt}: rel {rel}")
                xf = x.float()
                grouped.append({"m": m, "k": k, "n": n, "x": str(xdt)[6:],
                                "scale": form, "rel_err": rel,
                                "kernel": both(
                                    lambda: dequant_matmul_grouped_cuda(
                                        x, wq, sc)),
                                "bmm": both(lambda: torch.bmm(xf, w_deq))})
            del w_deq
        del wq

    dm, steps = [], {}
    for arch, shapes in cs.DM_SHAPES.items():
        step = {"graph_ms": 0.0, "eager_ms": 0.0}
        for (k, n), calls, names in shapes:
            copies = max(1, math.ceil(120e6 / (k * n)))
            ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(copies)]
            sc = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-4
            xdt = torch.float32 if names == "head" else torch.bfloat16
            x = torch.randn((4, k), generator=gen, device=dev).to(xdt)
            _, rel = cs.rel_err(dequant_matmul_cuda(x, ws[0], sc),
                                dequant_matmul_ref(x, ws[0], sc))
            cs.check(rel <= cs.TOL_F32, f"dm {arch} k={k} n={n}: rel {rel}")
            it = iter(range(1 << 30))
            t = both(lambda: dequant_matmul_cuda(x, ws[next(it) % copies],
                                                 sc))
            dm.append({"arch": arch, "m": 4, "k": k, "n": n,
                       "x": str(xdt)[6:], "calls": calls, "rel_err": rel,
                       "kernel": t})
            for key in step:
                step[key] += t[key] * calls
            del ws
        steps[arch] = step

    def graph(fn):
        return {"graph_ms": cs.time_ms_graph(fn)}

    prefill, forwards = [], {}
    m = cs.DM_PREFILL_M
    for arch, shapes in cs.DM_SHAPES.items():
        fwd = {"kernel": 0.0, "matmul": 0.0, "matmul_bf16": 0.0}
        for (k, n), calls, names in shapes:
            if names == "head":
                continue
            copies = max(1, math.ceil(120e6 / (k * n)))
            ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(copies)]
            sc = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-4
            xdt = torch.float32 if names == "router" else torch.bfloat16
            x = torch.randn((m, k), generator=gen, device=dev).to(xdt)
            _, rel = cs.rel_err(dequant_matmul_cuda(x, ws[0], sc),
                                dequant_matmul_ref(x, ws[0], sc))
            cs.check(rel <= cs.TOL_F32, f"dm {arch} m={m} k={k} n={n}: "
                     f"rel {rel}")
            it = iter(range(1 << 30))
            w_deq = ws[0].float() * sc
            xf, xb, wb = x.float(), x.bfloat16(), w_deq.bfloat16()
            row = {"arch": arch, "m": m, "k": k, "n": n, "x": str(xdt)[6:],
                   "calls": calls, "rel_err": rel,
                   "kernel": both(lambda: dequant_matmul_cuda(
                       x, ws[next(it) % copies], sc)),
                   "matmul": graph(lambda: torch.matmul(xf, w_deq)),
                   "matmul_bf16": graph(lambda: torch.matmul(xb, wb)),
                   "grouped_e1": None}
            if xdt == torch.bfloat16:
                x3, sc3 = x[None], sc
                jt = iter(range(1 << 30))
                _, rel3 = cs.rel_err(
                    dequant_matmul_grouped_cuda(x3, ws[0][None], sc3)[0],
                    dequant_matmul_ref(x, ws[0], sc))
                cs.check(rel3 <= cs.TOL_F32, f"grouped E=1 k={k} n={n}")
                row["grouped_e1"] = graph(lambda: dequant_matmul_grouped_cuda(
                    x3, ws[next(jt) % copies][None], sc3))
            prefill.append(row)
            fwd["kernel"] += row["kernel"]["graph_ms"] * calls
            fwd["matmul"] += row["matmul"]["graph_ms"] * calls
            fwd["matmul_bf16"] += row["matmul_bf16"]["graph_ms"] * calls
            del ws, w_deq, wb
        forwards[arch] = fwd
    moe = _moe_block_rows(cs, torch, dev, gen)
    return {"root": str(root), "card": card, "device": name,
            "torch": torch.__version__, "moe_block": moe,
            "flash_attention": flash,
            "dequant_matmul_grouped": grouped, "dequant_matmul": dm,
            "dequant_matmul_decode_step": steps,
            "dequant_matmul_prefill": prefill,
            "dequant_matmul_prefill_forward": forwards}


def _moe_block_rows(cs, torch, dev, gen) -> list:
    import inspect

    from repro_torch import configs
    from repro_torch.models import moe
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get("deepseek-moe-16b")
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    fs = cfg.num_shared_experts * f

    def q8(*shape):
        return {"q8": torch.randint(-127, 128, shape, generator=gen,
                                    device=dev, dtype=torch.int8),
                "q8s": torch.rand(shape[-1], generator=gen, device=dev)
                * 0.01 + 1e-4}
    p = {"router": q8(d, e), "w_gate": q8(e, d, f), "w_up": q8(e, d, f),
         "w_down": q8(e, f, d), "sh_gate": q8(d, fs), "sh_up": q8(d, fs),
         "sh_down": q8(fs, d)}
    kw = ({"with_aux": False} if "with_aux" in
          inspect.signature(moe.moe_block).parameters else {})
    rows = []
    for s in (1, 128):
        x = torch.randn((4, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        for _ in range(3):
            moe.moe_block(x, p, cfg, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(MOE_CALLS):
                moe.moe_block(x, p, cfg, **kw)
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy, top = cs._device_time(events)
        kernels = sum(evt.count for evt in events
                      if str(evt.device_type).endswith("CUDA") and
                      evt.self_device_time_total > 0)
        rows.append({"g": 4, "s": s, "x": "bfloat16", "aux": not kw,
                     "device_ms_per_call": busy / MOE_CALLS,
                     "device_ops_per_call": kernels / MOE_CALLS,
                     "grouped_ms_per_call": cs._kernel_ms(
                         events, "dm_grouped") / MOE_CALLS,
                     "top_ms_per_call": {k: v / MOE_CALLS for k, v in top}})
    del p
    return rows


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(_measure(Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for arg in argv:
        root = Path(arg).resolve()
        if not (root / "src" / "repro_torch").is_dir():
            print(f"{root} holds no src/repro_torch", file=sys.stderr)
            return 2
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--one", str(root)], capture_output=True,
                              text=True, timeout=900)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            sys.stdout.write(proc.stdout)
            print(f"{root}: exit {proc.returncode}", file=sys.stderr)
            return 1
        last = proc.stdout.strip().splitlines()[-1]
        runs.append(json.loads(last))
        print(last, flush=True)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_yardsticks.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
