"""Tensor parallelism over a mesh's ``model`` axis for the dense GQA family
(Megatron's layout; the port's own, as the reference lets XLA's SPMD
partitioner insert these collectives from the ``tp``, ``heads`` and
``vocab`` rules of ``repro.distributed.sharding``).

Each rank of the ``model`` group holds a contiguous range of the query
heads (``num_heads / t``) with the key/value heads they read, a range of
the MLP's hidden units and a range of the vocabulary
(:meth:`TensorParallel.ranges`).  A block's input is replicated over the
group; :meth:`TensorParallel.enter` (identity forward, all-reduce
backward) precedes the column-parallel products (``wq``, ``wk``, ``wv``
and their biases, ``w_gate``, ``w_up``, the head) and
:meth:`TensorParallel.leave` (all-reduce forward, identity backward)
follows the row-parallel ones (``wo``, ``w_down``).  The embedding looks
up the rank's rows and zeros the rest before :meth:`leave`, and the loss
is a vocab-parallel cross-entropy: the max and the sum of exponentials
all-reduced over the group, the label's logit taken by the rank that owns
it, so the ``(B, S, V)`` logits are never gathered.

Where there are fewer key/value heads than ranks (``t % G == 0``), each
rank reads the one head its query heads share: the rule's split of the
flat ``G * Dh`` columns cuts a head, so the step gathers those leaves
over ``model`` and slices the head (``distributed.fsdp``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import mesh_axis_names

# the leaves a tensor-parallel block splits, by the suffix of their flat
# name: (dim, what the dim indexes); every other leaf is replicated over
# the model axis
_SPLIT = (
    ("attn/wq", -1, "heads"), ("attn/bq", -1, "heads"),
    ("attn/wk", -1, "kv_heads"), ("attn/bk", -1, "kv_heads"),
    ("attn/wv", -1, "kv_heads"), ("attn/bv", -1, "kv_heads"),
    ("attn/wo", -2, "heads"),
    ("mlp/w_gate", -1, "ff"), ("mlp/w_up", -1, "ff"),
    ("mlp/w_down", -2, "ff"),
    ("embed", 0, "vocab"), ("head", -1, "vocab"),
)
# the replicated leaves a block reads between enter and leave, on this
# rank's heads only: each rank's gradient of them is a partial sum
_PARTIAL = ("attn/q_norm", "attn/k_norm")


def model_size(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 without one or without a
    ``DeviceMesh``)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return 1
    return int(mesh.size(names.index("model")))


def check_supported(cfg, t: int) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` runs tensor-parallel on
    a model axis of ``t``: the dense family with GQA attention, its query
    heads split evenly, and its key/value heads either split evenly or
    each shared by whole ranks."""
    if t <= 1:
        return
    if cfg.family != "dense" or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over a model axis of {t} is "
            f"not yet ported for the {cfg.family} family with "
            f"{cfg.attention} attention (the port splits the dense GQA "
            "family only)")
    h, g = cfg.num_heads, cfg.num_kv_heads
    if h % t or (g % t and t % g):
        raise NotImplementedError(
            f"{cfg.name}: {h} query / {g} key-value heads over a model axis "
            f"of {t}: tensor parallelism with uneven head splits is not yet "
            "ported")


class TensorParallel:
    """The ``model`` axis of a ``DeviceMesh`` as the tensor-parallel group
    of ``cfg`` (:func:`check_supported` first): ``size`` ranks, this one
    number ``rank``."""

    def __init__(self, mesh, cfg):
        names = mesh_axis_names(mesh)
        self.size = int(mesh.size(names.index("model")))
        check_supported(cfg, self.size)
        self.rank = int(mesh.get_local_rank("model"))
        self.group = mesh.get_group("model")
        self.cfg = cfg

    # -- layout --------------------------------------------------------
    def ranges(self, rank: int | None = None) -> dict:
        """``[start, stop)`` of each split dim's units on ``rank`` (this
        one by default), in elements of the dim: query-head and
        key/value-head columns, hidden units, vocabulary rows."""
        r = self.rank if rank is None else rank
        t, cfg = self.size, self.cfg
        h, g, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        hl = h // t
        if g % t == 0:
            kv = (r * (g // t), (r + 1) * (g // t))
        else:                                   # t % g == 0: shared heads
            kv = (r // (t // g), r // (t // g) + 1)

        def even(n):
            return (n * r // t, n * (r + 1) // t)
        return {"heads": (r * hl * dh, (r + 1) * hl * dh),
                "kv_heads": (kv[0] * dh, kv[1] * dh),
                "ff": even(cfg.d_ff), "vocab": even(cfg.vocab_size)}

    def split(self, name: str, ndim: int):
        """``(dim, what)`` of the dim a leaf named ``name`` (a flat
        parameter name) is split on, or None for a replicated leaf."""
        for suffix, dim, what in _SPLIT:
            if name == suffix or name.endswith("/" + suffix):
                return dim % ndim, what
        return None

    def partial(self, name: str) -> bool:
        """Whether replicated leaf ``name`` is read on this rank's heads
        only, so its gradient is summed over the group."""
        return any(name == suffix or name.endswith("/" + suffix)
                   for suffix in _PARTIAL)

    def local_config(self, cfg):
        """``cfg`` with this rank's head counts."""
        h, g = cfg.num_heads, cfg.num_kv_heads
        return cfg.replace(num_heads=h // self.size,
                           num_kv_heads=max(g // self.size, 1))

    @property
    def vocab(self) -> tuple:
        return self.ranges()["vocab"]

    # -- the operators at a block's edges -------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, gradient all-reduced over the group: before
        a column-parallel product."""
        return _CopyToModel.apply(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """Partial results summed over the group, identity backward:
        after a row-parallel product."""
        return _ReduceFromModel.apply(x, self.group)

    def embed(self, lookup, table, tokens, dtype) -> torch.Tensor:
        """The rows of ``tokens`` from this rank's vocabulary rows
        ``table`` (``lookup(table, idx, dtype)`` gathers them): tokens
        another rank owns give zero rows, and the sum over the group
        holds every row."""
        v0, v1 = self.vocab
        own = (tokens >= v0) & (tokens < v1)
        rows = lookup(table, torch.where(own, tokens - v0, 0), dtype)
        return self.leave(rows * own[..., None].to(rows.dtype))

    def cross_entropy(self, logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """Per-position NLL ``(B, S)`` in f32 from this rank's vocabulary
        columns of the logits ``(B, S, V / t)``."""
        return _VocabParallelNLL.apply(logits.to(torch.float32), labels,
                                       self.vocab[0], self.group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _VocabParallelNLL(torch.autograd.Function):
    """``logsumexp(z) - z[label]`` over the vocabulary split across the
    group; the gradient of the local logits is ``softmax - onehot`` on
    the rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, v0, group):
        m = torch.amax(logits, dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        se = torch.sum(e, dim=-1)
        dist.all_reduce(se, group=group)
        local = labels - v0
        own = (local >= 0) & (local < logits.shape[-1])
        idx = torch.where(own, local, 0)[..., None]
        z = torch.gather(logits, -1, idx)[..., 0] * own.to(logits.dtype)
        dist.all_reduce(z, group=group)
        ctx.save_for_backward(e / se[..., None], idx, own)
        return torch.log(se) + m - z

    @staticmethod
    def backward(ctx, grad):
        p, idx, own = ctx.saved_tensors
        g = p.scatter_add(-1, idx, -own[..., None].to(p.dtype))
        return g * grad[..., None], None, None, None
