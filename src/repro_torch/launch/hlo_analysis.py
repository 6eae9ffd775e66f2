"""Per-device FLOP, byte, collective and memory account of one step (the
port's counterpart of ``repro.launch.hlo_analysis``).

The reference re-derives FLOPs and HBM bytes from the post-SPMD HLO text
of a compiled step (``trip_aware_cost``).  The port has no HLO: its steps
run eagerly, op by op.  So this module reads a trace of the aten ops the
port actually runs: :class:`OpAccount` is a ``TorchDispatchMode`` that
sees every op of the step, on fake tensors under ``FakeTensorMode`` (the
dry run, ``launch.dryrun``, where nothing is allocated or computed) or on
real ones (the same account of a real step, which the tests hold the dry
run to).  Only ops with a tensor on the account's device type count.

* FLOPs: dot-like ops only, as the reference counts ``dot``: ``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, the SDPA ops and the convolution ops,
  by ``torch.utils.flop_counter``'s formulas (2 x result elements x the
  contracted size for a product).  Elementwise work lives in the bytes.
* bytes: operand bytes plus result bytes of every op, except that
  - metadata and view ops (``view``, ``_unsafe_view``, ``t``,
    ``transpose``, ``expand``, ``detach``, ``alias``, ``as_strided`` and
    every other op whose result aliases its input) count nothing, like
    the reference's ``_SKIP_BYTES_OPS``;
  - an in-place write into a slice (``copy_`` into a view,
    ``index_put_``, ``slice_scatter`` and the other ``*_scatter`` ops)
    counts twice the written slice, as ``dynamic-update-slice`` does
    there; a ``copy_`` into a whole tensor reads its source and writes
    its destination;
  - data movement (``cat``, ``stack``, ``index_select``, ``gather``,
    ``index``, ``embedding``, ``clone`` and a contiguous copy, padding,
    ``repeat``) counts twice its result, as ``_RESULT_ONLY_OPS`` does;
  - a fill (``zeros``, ``full``, ``arange``, ``fill_``, ...) writes its
    result once; ``empty`` moves nothing.
  Dtype conversions (``_to_copy``) **are** counted, operand and result:
  eager PyTorch runs each as a kernel of its own that reads and writes
  memory, where the TPU fuses a convert into its consumer (the
  reference's ``_ALIAS_OPS``).  ``bytes_bf16`` equals ``bytes``: the
  reference's adjustment undoes the CPU backend's legalization of bf16
  to f32 in the lowered module, and a fake tensor keeps its real dtype.
* ranges: eager execution runs each op once per step, so there is no
  loop-trip multiplicity to recover; ``per_comp`` is keyed by the
  outermost ``torch.profiler.record_function`` range an op ran in
  (``train_step/ef``, ``train_step/adamw``, the FSDP gathers
  ``fsdp/gather`` and their gradients' reductions ``fsdp/reduce``), and
  ``forward_backward`` for every op outside one.
* collectives: each ``c10d`` op (or functional collective) is one event:
  its kind under the reference's names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute`` for a
  receive; ``broadcast``, ``reduce``, ``gather``, ``scatter`` under names
  of their own), the bytes of its result by the reference's conventions
  (an all-gather's gathered array, a reduce-scatter's shard, an
  all-reduce's tensor, which is its operand too) and its group's size.
  ``launch.dryrun.collective_bytes`` sums them.
* memory: every storage an op creates on the device, from its creation
  until the storage is freed (a weakref finalizer), plus the storages the
  caller :meth:`OpAccount.hold` s (the step's arguments); ``peak`` is the
  high-water mark of the live bytes, and :meth:`OpAccount.peak_by_op`
  splits it by the op that made each storage.  A storage counts its bytes
  unrounded (the CUDA allocator rounds each block up to 512 bytes).
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops that touch no memory: metadata, host constants, profiler ranges
_SKIP_OPS = {"_unsafe_view", "lift_fresh", "lift_fresh_copy",
             "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_same_size", "resolve_conj",
             "resolve_neg"}
# writes into a slice of an existing buffer: op -> the position of the
# written values among its arguments
_SLICE_WRITE_OPS = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
                    "slice_scatter": 1, "select_scatter": 1,
                    "diagonal_scatter": 1, "as_strided_scatter": 1}
_RESULT_ONLY_OPS = {"cat", "stack", "index_select", "gather", "index",
                    "_unsafe_index", "embedding", "clone", "contiguous",
                    "constant_pad_nd", "pad", "repeat", "repeat_interleave",
                    "flip", "roll", "narrow_copy", "slice_copy",
                    "select_copy", "expand_copy", "permute_copy",
                    "transpose_copy", "view_copy", "unfold_copy"}
_FILL_OPS = {"zeros", "ones", "full", "zeros_like", "ones_like",
             "full_like", "new_zeros", "new_ones", "new_full",
             "scalar_tensor", "arange", "fill_", "zero_", "fill"}
_EMPTY_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "empty_permuted"}

# c10d ops: the kind of collective (the reference's names where it has
# one); the first argument holds the result tensors
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather",
    "scatter_": "scatter",
}
# functional collectives: the result is what the op returns
_FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}

DEFAULT_RANGE = "forward_backward"


def _dot_formulas() -> dict:
    from torch.utils.flop_counter import flop_registry
    return {k: f for k, f in flop_registry.items()
            if isinstance(k, torch._ops.OpOverloadPacket)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (lists, tuples and
    dicts walked), appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _group_size(func, args, kwargs) -> int | None:
    """The size of the process group a collective runs over."""
    pg_type = torch._C._distributed_c10d.ProcessGroup
    for a in (*args, *kwargs.values()):
        if isinstance(a, pg_type):
            return a.size()
        if isinstance(a, torch.ScriptObject):
            try:
                return pg_type.unbox(a).size()
            except RuntimeError:
                continue
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = kwargs.get("group_name", args[-1] if args else None)
        if isinstance(name, str):
            return _resolve_process_group(name).size()
    return None


def _classify(func, dots: dict) -> tuple:
    """(how the op is counted, its name, its FLOP formula or None, and
    for a slice write the index of its values argument, for a collective
    its kind)."""
    name = func.__name__.split(".")[0]
    ns = func.namespace
    aux = None
    if ns == "profiler":
        how = "enter" if name.startswith("_record_function_enter") else \
            "exit" if name.startswith("_record_function_exit") else "prim"
    elif ns == "prim":
        how = "prim"
    elif ns in ("c10d", "_c10d_functional"):
        how = "collective"
        aux = (_C10D_KINDS if ns == "c10d" else _FUNCTIONAL_KINDS).get(name)
    elif func.is_view or name in _SKIP_OPS:
        how = "free"
    elif name in _EMPTY_OPS:
        how = "empty"
    elif name in _FILL_OPS:
        how = "fill"
    elif name == "copy_":
        how = "copy"
    elif name in _SLICE_WRITE_OPS:
        how, aux = "slice_write", _SLICE_WRITE_OPS[name]
    elif name in _RESULT_ONLY_OPS:
        how = "result_only"
    else:
        how = "normal"
    return how, f"{ns}.{name}", dots.get(func.overloadpacket), aux


class OpAccount(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and live device memory of the
    ops run under it (see the module's docstring), on ``device``'s type.
    Enter it around one step; read :meth:`cost`, :attr:`events` and
    :meth:`memory` after."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.flops = 0
        self.bytes = 0
        self.per_range: dict = defaultdict(lambda: {
            "flops": 0, "bytes": 0, "ops": 0, "collective_bytes": 0})
        self.events: list[dict] = []
        self.op_counts: dict = defaultdict(int)
        self._ranges: list[str] = []
        self._dots = _dot_formulas()
        self._info: dict = {}
        self._live: dict[int, tuple] = {}      # id -> (bytes, creator)
        self._held: set[int] = set()
        self._live_by: dict = defaultdict(int)  # creator -> live bytes
        self.live = 0
        self.peak = 0
        self.peak_by: dict = {}

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor, who: str,
               nbytes: int | None = None) -> int:
        """Count ``t``'s storage as live from now until it is freed (once
        per storage), made by ``who``; returns the storage's id."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return key
        n = st.nbytes() if nbytes is None else nbytes
        weakref.finalize(st, self._free, key)
        self._live[key] = (n, who)
        self._live_by[who] += n
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by = dict(self._live_by)
        return key

    def _free(self, key: int) -> None:
        n, who = self._live.pop(key, (0, None))
        self.live -= n
        if who is not None:
            self._live_by[who] -= n
        self._held.discard(key)

    def hold(self, tensors, share: float = 1.0) -> int:
        """Count the storages of ``tensors`` (a tree) as live, each at
        ``share`` of its bytes (a batch of which the step reads this
        rank's rows only); returns the bytes added."""
        before = self.live
        for t in _flat(tensors, []):
            if t.device.type != self.device_type:
                continue
            n = t.untyped_storage().nbytes()
            self._held.add(self._track(t, "argument", int(n * share)))
        return self.live - before

    def held_ids(self) -> set:
        """The ids of the storages :meth:`hold` counted (and still live)."""
        return set(self._held)

    def storage_bytes(self, tensors) -> dict:
        """Storage id -> bytes, as counted live, of the distinct storages
        of ``tensors`` (a tree) on the account's device."""
        out = {}
        for t in _flat(tensors, []):
            if t.device.type == self.device_type:
                st = t.untyped_storage()
                out[id(st)] = self._live.get(id(st), (st.nbytes(),))[0]
        return out

    # -- the ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _classify(func, self._dots)
        how, name, dot, aux = info
        out = func(*args, **kwargs)
        if how == "prim":
            return out
        if how == "enter":
            self._ranges.append(args[0])
            return out
        if how == "exit":
            if self._ranges:
                self._ranges.pop()
            return out
        ins = _flat(kwargs, _flat(args, []))
        outs = _flat(out, [])
        dt = self.device_type
        if not any(t.device.type == dt for t in ins) and \
                not any(t.device.type == dt for t in outs):
            return out
        rng = self._ranges[0] if self._ranges else DEFAULT_RANGE
        acc = self.per_range[rng]
        acc["ops"] += 1
        self.op_counts[name] += 1
        if how == "free":
            return out
        for t in outs:
            if t.device.type == dt:
                self._track(t, name)
        if how == "collective" and aux is not None:
            self._collective(func, aux, args, kwargs, out, acc, rng)
        flops = int(dot(*args, **kwargs, out_val=out)) if dot else 0
        nbytes = self._bytes(how, aux, ins, outs, args)
        self.flops += flops
        self.bytes += nbytes
        acc["flops"] += flops
        acc["bytes"] += nbytes
        return out

    @staticmethod
    def _bytes(how, aux, ins, outs, args) -> int:
        if how == "empty":
            return 0
        if how == "fill":
            return sum(_nbytes(t) for t in outs)
        if how == "copy":
            dst, src = args[0], args[1]
            if dst._is_view() or _nbytes(dst) < \
                    dst.untyped_storage().nbytes():
                return 2 * _nbytes(dst)
            return _nbytes(dst) + (_nbytes(src) if isinstance(
                src, torch.Tensor) else 0)
        if how == "slice_write":
            return 2 * sum(_nbytes(t) for t in _flat(args[aux:aux + 1], []))
        if how == "result_only":
            return 2 * sum(_nbytes(t) for t in outs)
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def _collective(self, func, kind, args, kwargs, out, acc, rng) -> None:
        # c10d ops take their result tensors first; a functional
        # collective returns them
        res = _flat(args[:1] if func.namespace == "c10d" else out, [])
        nbytes = sum(_nbytes(t) for t in res)
        self.events.append({"kind": kind, "bytes": nbytes,
                            "group_size": _group_size(func, args, kwargs),
                            "range": rng,
                            "dtypes": sorted({str(t.dtype).split(".")[-1]
                                              for t in res})})
        acc["collective_bytes"] += nbytes

    # -- results -----------------------------------------------------------
    def cost(self) -> dict:
        """The counterpart of the reference's ``trip_aware_cost``:
        ``flops``, ``bytes``, ``bytes_bf16`` (equal to ``bytes``) and
        ``per_comp``, by range."""
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_bf16": self.bytes,
                "per_comp": {k: dict(v) for k, v in self.per_range.items()}}

    def peak_by_op(self, top: int = 12) -> dict:
        """The live bytes at the peak by the op that made each storage
        (``argument`` for the held ones), the ``top`` largest."""
        items = sorted(((k, v) for k, v in self.peak_by.items() if v),
                       key=lambda kv: -kv[1])
        return dict(items[:top])
