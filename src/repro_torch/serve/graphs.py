"""The compiled serving step: CUDA graphs of prefill and decode, the port's
counterpart of the reference's ``jax.jit`` (``repro.serve.session``
compiles one function per step shape; here :class:`StepGraphs` keeps one
graph per shape).

A step is ``fn(*inputs)`` over device tensors.  It returns nothing: it
writes its results into tensors the caller allocated outside the graphs
(the session's KV caches and its logits buffer).  For each shape ``key``:

* the first use runs ``fn`` eagerly, and that is the step's real run: it
  also warms what a kernel sets up once (built libraries, shared-memory
  attributes, the SM count) and the allocator;
* the second use captures ``fn`` into a graph, reading its inputs from
  static device buffers, then replays it.  Capture runs nothing, so no
  step is lost or run twice;
* every later use copies the host inputs into the static buffers (from
  pinned arrays) and replays.

A graph bakes in the addresses of everything it touches: the parameters,
caches and output buffers must be written in place and never
reallocated, or the graph recaptured.  A graph keeps nothing alive of its
own but its small input buffers: every tensor a step allocates is dead
when its capture ends, so the graphs share one memory pool that is as
large as the largest step's temporaries, however many shapes are
captured.  Since no tensor outlives a replay, graphs may replay in any
order.  Each replay credits the kernel launches its capture counted
(``kernels.registry``), and events of the dispatch report are recorded
while capturing, since every replay takes the captured route.  On the
card a capture or replay that fails raises: nothing falls back to the
eager step.  On the CPU there are no graphs; steps run eagerly, as the
reference's CPU jit has no device graph.  :func:`eager_steps` runs the
eager step on the card, as ``jax.disable_jit()`` does for the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import registry

_EAGER = contextvars.ContextVar("repro_torch_eager_steps", default=False)


@contextlib.contextmanager
def eager_steps():
    """Inside the block, serving steps on the card run eagerly, op by op
    from Python, and capture nothing (the counterpart of
    ``jax.disable_jit()``): for comparisons and debugging.  Graphs
    captured before stay and replay again after the block."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


class CudaGraphs:
    """Capture and replay on the card, every graph in one memory pool."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()

    def capture(self, fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            fn()
        return graph

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


@dataclass
class _Graph:
    graph: object
    inputs: tuple          # static device buffers the graph reads
    staging: tuple         # host arrays they are filled from
    launches: dict         # kernel -> launches of one replay
    loaded: object = None  # CUDA event: the last copy of the inputs done


class StepGraphs:
    """One captured graph per step shape on ``device`` (see the module
    docstring).  ``backend`` captures and replays (:class:`CudaGraphs` on
    the card; none on the CPU, where every step runs eagerly)."""

    def __init__(self, device: torch.device, backend=None):
        self.device = torch.device(device)
        if backend is None and self.device.type == "cuda":
            backend = CudaGraphs()
        self.backend = backend
        self._graphs: dict = {}
        self._seen: set = set()
        self.stats = {"eager": 0, "captures": 0, "replays": 0}

    def run(self, key, fn, host_inputs: tuple) -> None:
        """One step of shape ``key``: ``fn`` over ``host_inputs`` (numpy
        arrays) on the device.  What it writes, the caller reads before
        the next step writes there again."""
        if self.backend is None or _EAGER.get():
            fn(*(self._to_device(a) for a in host_inputs))
            return
        g = self._graphs.get(key)
        if g is None:
            if key not in self._seen:
                self._seen.add(key)
                self.stats["eager"] += 1
                fn(*(self._to_device(a) for a in host_inputs))
                return
            g = self._capture(fn, host_inputs)
            self._graphs[key] = g
        else:
            self._load(g, host_inputs)
        self.backend.replay(g.graph)
        registry.credit_launches(g.launches)
        self.stats["replays"] += 1

    def reset(self) -> None:
        """Drop every captured graph (a tensor they read was replaced):
        each shape captures again on its next use."""
        self._graphs.clear()

    def replay_only(self, key) -> None:
        """Replay ``key``'s graph on the inputs it last had, counting no
        launches: for timing the device work of a step."""
        self.backend.replay(self._graphs[key].graph)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _capture(self, fn, host_inputs) -> _Graph:
        pin = self.device.type == "cuda"
        staging = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                    pin_memory=pin) for a in host_inputs)
        g = _Graph(None, tuple(torch.empty_like(h, device=self.device)
                               for h in staging), staging, {})
        self._load(g, host_inputs)
        with registry.captured_launches() as g.launches:
            g.graph = self.backend.capture(lambda: fn(*g.inputs))
        self.stats["captures"] += 1
        return g

    def _load(self, g: _Graph, host_inputs) -> None:
        if g.loaded is not None:          # the last copy read the staging
            g.loaded.synchronize()
        for h, a, t in zip(g.staging, host_inputs, g.inputs):
            h.numpy()[...] = a
            t.copy_(h, non_blocking=True)
        if self.device.type == "cuda":
            g.loaded = torch.cuda.Event()
            g.loaded.record()
