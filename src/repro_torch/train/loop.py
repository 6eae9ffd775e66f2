"""Fault-tolerant training loop (the port's copy of ``repro.train.loop``):
checkpoint/restart, preemption handling, straggler accounting, async
compressed checkpointing.

The loop owns no data-pipeline state (batches are pure functions of the
step), checkpoints are atomic, SIGTERM ends the loop after the current
step with a final synchronous save, and per-step wall times feed a
straggler monitor that flags steps slower than ``straggler_factor`` x the
median of the last 64 steps.  Times are read through this module's
``time``.  Where the last periodic save already wrote the final step,
the final save only waits for it (the reference writes the same state a
second time).

On a ``torch.distributed`` ``DeviceMesh`` every rank builds the same
batch and the step takes its rows, and the state is sharded by the
reference's rules (``distributed.fsdp``: each rank holds its box of
every leaf).  A save gathers the state leaf by leaf to the mesh's first
rank, which alone writes it through the same writer (sharded over the
mesh's shape when the config is sharded), so the step directory is the
one a single process writes from the whole state; every rank restores
its boxes of the whole state (``CheckpointManager.restore`` with the
layout as its ``mesh``).
A barrier ends a run once the last save is on disk, and a stop flag is
all-reduced once a step, so a SIGTERM on any rank stops all of them after
the same step.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np

from ..checkpoint.manager import CheckpointConfig, CheckpointManager
from ..checkpoint.sharded import MeshSpec
from ..data.pipeline import make_batch
from ..distributed.compress import CompressionConfig
from ..distributed.sharding import DEFAULT_RULES
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig
from .steps import init_train_state, make_train_step, train_layout


@dataclass
class LoopConfig:
    total_steps: int = 200
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    resume: bool = True


@dataclass
class LoopResult:
    losses: list[float] = field(default_factory=list)
    step_times: list[float] = field(default_factory=list)
    straggler_steps: list[int] = field(default_factory=list)
    final_step: int = 0


def train_loop(cfg: ModelConfig, mesh, loop: LoopConfig,
               opt_cfg: AdamWConfig | None = None,
               comp_cfg: CompressionConfig | None = None,
               ckpt_cfg: CheckpointConfig | None = None, *,
               device="cuda") -> LoopResult:
    """Train from ``init_train_state`` (or, with ``loop.resume``, from the
    latest checkpoint in ``ckpt_cfg.directory``) up to
    ``loop.total_steps`` on ``device`` (the card unless ``"cpu"`` is
    asked for), sharded over ``mesh`` when it is a ``DeviceMesh``."""
    opt_cfg = opt_cfg or AdamWConfig()
    # one layout for the state, the step and the restore
    layout = train_layout(cfg, opt_cfg, comp_cfg, mesh, DEFAULT_RULES,
                          "train_loop")
    group = layout.group if layout is not None else None
    writes = group is None or group.first
    save_mesh = MeshSpec.from_any(mesh) if layout is not None else None
    state = init_train_state(cfg, opt_cfg, comp_cfg, seed=loop.seed,
                             device=device, mesh=layout)
    mgr = CheckpointManager(ckpt_cfg) if ckpt_cfg else None

    def save(step):
        # every rank gathers; the first writes the whole state
        whole = state if layout is None else \
            layout.gather_state(state, keep=writes)
        if writes:
            mgr.save(whole, step, mesh=save_mesh)

    start_step = 0
    if mgr and loop.resume and mgr.latest_step() is not None:
        state, meta = mgr.restore(state, device=device, mesh=layout)
        start_step = int(meta["step"])

    step_fn, make_jitted = make_train_step(
        cfg, layout or mesh, opt_cfg, comp_cfg,
        total_steps=loop.total_steps)
    probe = make_batch(cfg, 0, batch=loop.batch, seq=loop.seq,
                       seed=loop.seed)
    fn = make_jitted(state, probe)

    stop = {"flag": False}

    def on_term(signum, frame):
        stop["flag"] = True
    prev_handler = signal.signal(signal.SIGTERM, on_term)

    result = LoopResult()
    times: list[float] = []
    saved = None
    try:
        for step in range(start_step, loop.total_steps):
            batch = make_batch(cfg, step, batch=loop.batch, seq=loop.seq,
                               seed=loop.seed)
            t0 = time.monotonic()
            state, metrics = fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            times.append(dt)
            result.losses.append(loss)
            result.step_times.append(dt)
            if len(times) > 8:
                med = float(np.median(times[-64:]))
                if dt > loop.straggler_factor * med:
                    result.straggler_steps.append(step)
            if mgr and (step + 1) % loop.ckpt_every == 0:
                save(step + 1)
                saved = step + 1
            stopping = group.any(stop["flag"]) if group else stop["flag"]
            if stopping:
                break
        result.final_step = int(state["step"])
        if mgr:
            if saved != result.final_step:
                save(result.final_step)
            mgr.wait()
        if group is not None:
            group.barrier()
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    return result
