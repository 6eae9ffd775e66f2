"""Training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``--smoke`` selects the reduced config; without it the full assigned
configuration trains, which must fit one card.  The loop checkpoints
(DeepCABAC-compressed, written on a worker thread), resumes after
restarts, error-feedback-compresses the gradient stream when
``--compress-grads`` is set, and reports straggler steps.  Runs on the
card unless ``--device cpu``.  The port trains on one device:
``--production-mesh`` (16 x 16, or 2 x 16 x 16 with ``--multi-pod``)
raises "not yet ported" until the distribution slice.
"""

from __future__ import annotations

import argparse

from .. import configs
from ..checkpoint.manager import CheckpointConfig
from ..distributed.compress import CompressionConfig
from ..optim.adamw import AdamWConfig
from ..train.loop import LoopConfig, train_loop
from .mesh import make_local_mesh, make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    else:
        mesh = make_local_mesh(data=1, model=1)
    loop = LoopConfig(total_steps=args.steps, batch=args.batch,
                      seq=args.seq, ckpt_every=args.ckpt_every)
    ckpt = (CheckpointConfig(args.ckpt_dir, params_mode="cabac",
                             async_save=True)
            if args.ckpt_dir else None)
    res = train_loop(cfg, mesh, loop,
                     opt_cfg=AdamWConfig(lr=args.lr),
                     comp_cfg=CompressionConfig(enabled=args.compress_grads),
                     ckpt_cfg=ckpt, device=args.device)
    print(f"steps={res.final_step} first_loss={res.losses[0]:.4f} "
          f"last_loss={res.losses[-1]:.4f} "
          f"stragglers={len(res.straggler_steps)}")


if __name__ == "__main__":
    main()
