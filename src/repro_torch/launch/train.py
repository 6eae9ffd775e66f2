"""Training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.launch.train --smoke --device cpu

``--smoke`` selects the reduced config; without it the full assigned
configuration trains, which must fit one card.  The loop checkpoints
(DeepCABAC-compressed, written on a worker thread), resumes after
restarts, error-feedback-compresses the gradient stream when
``--compress-grads`` is set, and reports straggler steps.  Runs on the
card unless ``--device cpu``.

Under ``torchrun`` (or with ``RANK`` and ``WORLD_SIZE`` set) every rank
trains: the process group is initialised (NCCL on ``cuda``, each rank on
card ``LOCAL_RANK``; gloo with ``--device cpu``) and the mesh is
``data = world size``, as the reference uses every device; the train
state is sharded over ``data`` (FSDP, the reference's ``"fsdp": "data"``
rule).  Without them the run is a world of one on a mesh-free step.
``--production-mesh`` (16 x 16, or 2 x 16 x 16 with ``--multi-pod``)
needs a world of 256 (512) ranks: its model axis of 16 runs the dense
GQA family tensor-parallel; any other family raises
``NotImplementedError`` before the world is touched.  Only rank 0
prints.
"""

from __future__ import annotations

import argparse
import os

from .. import configs
from ..checkpoint.manager import CheckpointConfig
from ..distributed.compress import CompressionConfig
from ..distributed.tensor_parallel import check_supported
from ..optim.adamw import AdamWConfig
from ..train.loop import LoopConfig, train_loop
from .mesh import device_mesh, make_local_mesh, make_production_mesh


def _init_world(device: str):
    """The process group of a ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` from the
    environment), or None outside one."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    import torch
    import torch.distributed as dist
    if device.startswith("cuda"):
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return dist


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
    spec = None
    if args.production_mesh:
        spec = make_production_mesh(multi_pod=args.multi_pod)
        check_supported(cfg, spec.shape["model"])
    dist = _init_world(args.device)
    if spec is not None and dist is None:
        raise ValueError(f"--production-mesh: the mesh {spec.shape} needs "
                         f"a torchrun world of {spec.size} ranks")
    if dist is not None and spec is None:
        spec = make_local_mesh(data=dist.get_world_size())
    mesh = device_mesh(spec, args.device) if dist else None
    loop = LoopConfig(total_steps=args.steps, batch=args.batch,
                      seq=args.seq, ckpt_every=args.ckpt_every)
    ckpt = (CheckpointConfig(args.ckpt_dir, params_mode="cabac",
                             async_save=True)
            if args.ckpt_dir else None)
    rank = dist.get_rank() if dist else 0
    try:
        res = train_loop(cfg, mesh, loop,
                         opt_cfg=AdamWConfig(lr=args.lr),
                         comp_cfg=CompressionConfig(
                             enabled=args.compress_grads),
                         ckpt_cfg=ckpt, device=args.device)
    finally:
        if dist:
            dist.destroy_process_group()
    if rank == 0:
        print(f"steps={res.final_step} first_loss={res.losses[0]:.4f} "
              f"last_loss={res.losses[-1]:.4f} "
              f"stragglers={len(res.straggler_steps)}")


if __name__ == "__main__":
    main()
