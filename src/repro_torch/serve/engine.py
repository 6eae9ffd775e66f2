"""Batch-call wrapper over :class:`ServeSession` (port of
``repro.serve.engine``): ``generate(prompts, steps)`` over same-length
prompts; ``from_compressed`` serves a DCBC container blob."""

from __future__ import annotations

import numpy as np

from ..models.config import ModelConfig
from ..kernels.registry import resolve_device
from .backends import resolve_backend
from .session import ServeConfig, ServeSession


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 backend: str = "bf16", device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = resolve_backend(backend).load(cfg, params,
                                                    device=self.device)
        self.max_len = max_len
        self._sessions: dict[int, ServeSession] = {}

    @classmethod
    def from_compressed(cls, cfg: ModelConfig, blob: bytes,
                        max_len: int = 512, backend="container",
                        device="cuda") -> "ServeEngine":
        """Load from a DCBC container through a streaming blob backend
        (``container``: serve-q8 records stay int8; ``q8`` / ``bf16``:
        entropy-coded records dequantize to the param dtype)."""
        return cls(cfg, blob, max_len=max_len, backend=backend,
                   device=device)

    def _session(self, slots: int) -> ServeSession:
        # one session per batch size; the tree is already loaded, and
        # "bf16" passes it through
        if slots not in self._sessions:
            self._sessions[slots] = ServeSession(
                self.cfg, self.params, backend="bf16",
                serve_cfg=ServeConfig(slots=slots, max_len=self.max_len),
                device=self.device)
        return self._sessions[slots]

    def generate(self, prompts: np.ndarray, steps: int,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """prompts (B, S) int32 -> (B, S + steps) including generated ids."""
        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        if s + steps > self.max_len:
            raise ValueError("prompt + steps exceeds the cache length")
        session = self._session(b)
        handles = [session.submit(prompts[i], max_new_tokens=steps,
                                  temperature=temperature, seed=(seed, i))
                   for i in range(b)]
        session.run()
        gen = np.stack([h.result() for h in handles])
        return np.concatenate([prompts, gen], axis=1)
