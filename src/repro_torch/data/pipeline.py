"""Deterministic synthetic token pipeline (the port's copy of
``repro.data.pipeline``: plain numpy, so a batch equals the reference's
for the same (seed, step)).

Batch contents are a pure function of (seed, step).  The stream is a
noisy affine-recurrence language
    t_{k+1} = (a * t_k + b) mod V   with prob (1 - noise), else uniform
so a model can learn it.  :func:`to_device` turns a token batch into the
tensors the port's model takes; the ``embeds`` and ``pos3d`` inputs of
the stub-frontend and m-rope architectures wait with those models.
"""

from __future__ import annotations

import numpy as np
import torch


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(cfg, step: int, *, batch: int, seq: int, seed: int = 1234,
               noise: float = 0.1) -> dict:
    """Batch dict matching the arch's input signature (tokens or embeds)."""
    rng = _rng_for(seed, step)
    v = cfg.vocab_size
    a, b = 31, 17
    start = rng.integers(0, v, size=(batch, 1))
    toks = np.empty((batch, seq + 1), dtype=np.int64)
    toks[:, :1] = start
    for t in range(seq):
        nxt = (a * toks[:, t] + b) % v
        flip = rng.random(batch) < noise
        nxt = np.where(flip, rng.integers(0, v, batch), nxt)
        toks[:, t + 1] = nxt
    out: dict = {"labels": toks[:, 1:].astype(np.int32)}
    if cfg.embed_input:
        out["tokens"] = toks[:, :-1].astype(np.int32)
    else:
        # stub frontend: deterministic per-token embedding (fixed projection)
        emb_rng = _rng_for(seed, -1)
        table = emb_rng.standard_normal((v, cfg.d_model)).astype(np.float32)
        out["embeds"] = table[toks[:, :-1]]
    if cfg.m_rope:
        pos = np.broadcast_to(np.arange(seq)[None, None], (3, batch, seq))
        out["pos3d"] = pos.astype(np.int32)
    return out


def make_eval_batches(cfg, n: int, *, batch: int, seq: int,
                      seed: int = 9999) -> list[dict]:
    return [make_batch(cfg, 10_000_000 + i, batch=batch, seq=seq, seed=seed)
            for i in range(n)]


def to_device(batch: dict, device) -> dict:
    """A token batch as int64 tensors on ``device`` (tokens, labels)."""
    extra = sorted(set(batch) - {"tokens", "labels"})
    if extra:
        raise NotImplementedError(
            f"batch inputs {extra}: not yet ported (token inputs only)")
    return {k: torch.from_numpy(np.asarray(v)).to(device, torch.int64)
            for k, v in batch.items()}
