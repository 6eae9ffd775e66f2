#!/usr/bin/env python3
"""Time the q8 load and the full-width serves of one or more checkouts on
one card, so that two commits are compared by one method in one run:

    python3 serve_yardsticks.py PARENT . . PARENT

Each argument is the root of a checkout (it holds ``src/repro_torch``).
Each is measured in a process of its own, in the order given, with the
harness of the ``chip_smoke.py`` beside this script (``init_full``,
``phase_serve``), so the commits differ only in their package.  Per
checkout:

- the q8 load of deepseek-moe-16b at full width: ``quantize_tree_q8`` of
  its bf16 tree on the card (the q8 backend's load step; 27 MoE layers of
  three 64-expert banks), wall seconds to a synchronize, LOAD_REPEATS
  times;
- ``phase_serve`` of deepseek-moe-16b, then of llama3-8b (q8 and bf16,
  each eagerly and from graphs, every check of ``chip_smoke.py``): the
  phase's seconds, and per backend and mode the prefill forward ms, the
  decode ms/step median and the device busy ms per traced tick.

One JSON line per checkout is printed; all of them go to
``chiprun_out/serve_yardsticks.json``, the checkouts' logs to
``chiprun_out/serve_yardsticks.log``.  Needs a card.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
LOAD_REPEATS = 3


def _serve_numbers(res: dict) -> dict:
    out = {}
    for backend in ("q8", "bf16"):
        r = res[backend]
        for mode, m in (("graph", r), ("eager", r["eager"])):
            out[f"{backend}/{mode}"] = {
                "prefill_forward_ms": m["prefill_forward_ms"],
                "decode_ms_per_step_median": m["decode_ms_per_step_median"],
                "device_busy_ms_per_step": m["device_busy_ms_per_step"]}
    return out


def _measure(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    name, card = cs.phase_device()
    sys.path.insert(0, str(root / "src"))
    import torch
    import repro_torch
    cs.check(Path(repro_torch.__file__).resolve().is_relative_to(root),
             f"repro_torch came from {repro_torch.__file__}, not {root}")
    from repro_torch.compression import quantize_tree_q8
    from repro_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda")
    out = {"root": str(root), "device": name, "card": card}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg, params = cs.init_full(dev, "deepseek-moe-16b")
    loads = []
    for _ in range(LOAD_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q8 = quantize_tree_q8(params)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        del q8
        free()
    out["deepseek-moe-16b/q8_load_s"] = loads
    for arch in ("deepseek-moe-16b", "llama3-8b"):
        if arch != cfg.name:
            del params
            free()
            cfg, params = cs.init_full(dev, arch)
        t0 = time.perf_counter()
        res = cs.phase_serve(cfg, params, dev)
        out[f"{arch}/phase_serve_s"] = time.perf_counter() - t0
        out[arch] = _serve_numbers(res)
        free()
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(_measure(Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    logs = []
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
        logs.append(f"== {root}\n{proc.stdout}")
        (out / "serve_yardsticks.log").write_text("".join(logs))
        if proc.returncode != 0:
            sys.stdout.write(proc.stdout)
            print(f"{root}: exit {proc.returncode}", file=sys.stderr)
            return 1
        last = proc.stdout.strip().splitlines()[-1]
        runs.append(json.loads(last))
        print(last, flush=True)
    (out / "serve_yardsticks.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
