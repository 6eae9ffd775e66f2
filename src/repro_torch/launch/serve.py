"""Serving entry point of the port: continuous batching over a weight
backend, optionally from a DeepCABAC container.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --ckpt model.dcbc --backend container --batch 4 \\
        --prompt-len 128 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-moe-16b --backend q8 --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-8b --backend q8 --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mamba2-2.7b --backend q8 --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch zamba2-2.7b --backend bf16 --prompt-len 128

``--arch`` takes every id of the reference's (``configs.ARCH_IDS``, the
SSM mamba2-2.7b and the hybrid zamba2-2.7b included;
deepseek-v3-671b's 671 G parameters do not fit one card, so it serves
with ``--smoke`` there); a model that takes embeddings (musicgen-medium,
qwen2-vl-7b) exits with a message: it runs through ``prefill`` /
``decode_step`` with ``embeds=``, not a session. ``--backend``: ``bf16``
(full-precision weights), ``q8`` (int8 matmul weights), ``container``
(stream the DCBC blob; serve-q8 records stay int8). Without ``--ckpt``
the bf16/q8 backends take seeded random init, and the container backend
packs a serve-q8 container in process first, so the streaming load still
runs. Runs on the card unless ``--device cpu``; on the card the session
replays CUDA graphs of its steps.  ``--kernel-impl OP=IMPL`` (repeatable)
pins an op's impl in the model's ``KernelPolicy`` (e.g.
``dequant_matmul=ref`` runs the plain version on the card, and counts no
launch of the kernel), ``--strict-kernels`` makes a pinned impl that
cannot run raise ``KernelDispatchError``, and ``--no-tuning-cache``
ignores the persistent tuning cache (``kernels.tune``).
Prints the generated tokens, the decode ms/step (host clock per tick
after the first two, which hold the prefills and the decode graph's
capture), the launch count of every
kernel (``dequant_matmul_grouped`` included: a MoE model's expert banks
on q8) and every ``dispatch_report()`` record (a fallback or loop
dequant)."""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from .. import configs, kernels
from ..models.transformer import init_params
from ..serve.backends import available_backends
from ..serve.session import ServeConfig, ServeSession, require_token_input


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="DeepCABAC container (.dcbc); random init if unset")
    ap.add_argument("--backend", choices=available_backends(),
                    default="bf16", help="weight backend (see serve/backends)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="KV slots (0 = one per request)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-impl", action="append", default=[],
                    metavar="OP=IMPL",
                    help="pin a kernel impl (repeatable), e.g. "
                         "flash_attention=scan dequant_matmul=ref")
    ap.add_argument("--strict-kernels", action="store_true",
                    help="a pinned impl that cannot run raises instead of "
                         "falling back (see kernels.dispatch_report)")
    ap.add_argument("--no-tuning-cache", action="store_true",
                    help="ignore the persistent kernel tuning cache")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    pol = cfg.kernels
    for pin in args.kernel_impl:
        op, _, impl = pin.partition("=")
        if op not in kernels.available_ops():
            ap.error(f"--kernel-impl: unknown op {op!r}; "
                     f"available: {kernels.available_ops()}")
        if impl not in kernels.spec(op).impls:
            ap.error(f"--kernel-impl: unknown impl {impl!r} for {op}; "
                     f"available: {sorted(kernels.spec(op).impls)}")
        pol = pol.override(op, impl)
    pol = dataclasses.replace(pol, strict=args.strict_kernels,
                              use_tuning_cache=not args.no_tuning_cache)
    cfg = cfg.replace(kernels=pol)
    try:
        require_token_input(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.ckpt:
        with open(args.ckpt, "rb") as f:
            weights = f.read()
    elif args.backend == "container":
        from .. import compression
        params = init_params(cfg, 0, device=args.device)
        weights = compression.get("serve-q8").compress(params).blob
        del params
        print(f"packed serve-q8 container in process: "
              f"{len(weights) / 2**20:.1f} MiB")
    else:
        weights = init_params(cfg, 0, device=args.device)
    scfg = ServeConfig(slots=args.slots or args.batch,
                       max_len=args.prompt_len + args.steps)
    session = ServeSession(cfg, weights, backend=args.backend,
                           serve_cfg=scfg, device=args.device)
    del weights                     # the session holds its own tree
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    handles = [session.submit(p, max_new_tokens=args.steps,
                              temperature=args.temperature)
               for p in prompts]
    session.step()                  # admits (prefills) and decodes once
    session.step()                  # on the card: captures the decode graph
    t0, n0 = time.perf_counter(), session.stats["decode_steps"]
    session.run()                   # each tick copies its logits: synced
    ticks = session.stats["decode_steps"] - n0
    decode_ms = 1e3 * (time.perf_counter() - t0) / max(ticks, 1)
    out = np.stack([h.result() for h in handles])
    print(f"backend={args.backend} device={args.device} slots={scfg.slots}: "
          f"generated {out.shape} tokens; first row tail: "
          f"{out[0, -min(16, out.shape[1]):].tolist()}")
    print(f"decode {decode_ms:.2f} ms/step over {ticks} steps "
          f"({'graphs' if session.graphs.stats['replays'] else 'eager'})")
    print(f"kernel launches: {kernels.launch_counts()}")
    for rec in kernels.dispatch_report():
        print(f"kernel {rec['kind']}: {rec['op']}: "
              f"{rec['requested'] or 'default'} -> {rec['impl']} "
              f"({rec['reason']})")
    return out


if __name__ == "__main__":
    main()
