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
  100, (H, G) (32, 8) and (16, 16)), with ``scaled_dot_product_attention``;
- dequant_matmul_grouped at deepseek-moe-16b's expert banks (E=64, M 32
  and 64, the shared (N,) scale), with ``torch.bmm`` on the dequantized
  f32 bank;
- dequant_matmul at one decode step (M=4) of each model, the head with a
  f32 x, summed over the step's calls.

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
    for (h, g), s in [(hg, s) for hg in cs.FLASH_HEADS for s in (128, 100)]:
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for n in (h, g, g))
        rep = h // g
        want = flash_attention_ref(
            q.permute(0, 2, 1, 3).reshape(b * h, s, d),
            *(t.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(
                b * h, s, d) for t in (k, v))).reshape(
            b, h, s, d).permute(0, 2, 1, 3)
        _, rel = cs.rel_err(_flash_cuda(q, k, v), want)
        cs.check(rel <= cs.TOL_FLASH_BF16, f"flash S={s} H={h}: rel {rel}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flash.append({"s": s, "h": h, "g": g, "rel_err": rel,
                      "kernel": both(lambda: _flash_cuda(q, k, v)),
                      "sdpa": both(lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True, enable_gqa=True))})

    grouped = []
    e = cs.GROUPED_E
    for (k, n), _, _ in cs.GROUPED_SHAPES:
        wq = torch.randint(-127, 128, (e, k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        sc = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-4
        w_deq = wq.float() * sc
        for m in cs.GROUPED_ROWS:
            x = torch.randn((e, m, k), generator=gen, device=dev
                            ).to(torch.bfloat16)
            _, rel = cs.rel_err(dequant_matmul_grouped_cuda(x, wq, sc),
                                dequant_matmul_grouped_ref(x, wq, sc))
            cs.check(rel <= cs.TOL_F32, f"grouped m={m} k={k}: rel {rel}")
            xf = x.float()
            grouped.append({"m": m, "k": k, "n": n, "rel_err": rel,
                            "kernel": both(lambda: dequant_matmul_grouped_cuda(
                                x, wq, sc)),
                            "bmm": both(lambda: torch.bmm(xf, w_deq))})
        del wq, w_deq

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
    return {"root": str(root), "card": card, "device": name,
            "torch": torch.__version__, "flash_attention": flash,
            "dequant_matmul_grouped": grouped, "dequant_matmul": dm,
            "dequant_matmul_decode_step": steps}


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
