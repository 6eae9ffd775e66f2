"""Public wrappers of the fused dequantize-matmul.

``dequant_matmul(x (..., K), w_q (K, N) int8, scale (N,) f32) -> (..., N)
f32``: leading dims of ``x`` flatten to the kernel's M and come back on
the way out.  ``dequant_matmul_grouped(x (E, M, K), w_q (E, K, N) int8,
scale (E, N) | (N,) f32) -> (E, M, N) f32``: one product per expert.  A
CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the hand-written kernel (``csrc/dequant_matmul.cu``,
``csrc/dequant_matmul_grouped.cu``) or raises — there is no fallback.
``dequant_matmul`` runs its weight-streaming decode instance up to M = 8
and its tensor-core instance above (or where a decode block's x would not
fit), for either x type; :func:`schedule` picks the instance, the tile
and how far K splits, unless the caller gives the launch's two knobs, kc
and bm (the registry does: the tuning cache's or a policy's tiles).  The
grouped kernel runs on the tensor cores for either x type (a f32 x split
into three bf16 pieces in the kernel); its tiles are compile-time
template instances, so it has no knob to tune.

Both ops register an ``OpSpec`` (impls ``cuda``: the kernel, on the card
only; ``ref``: the plain version on any device).  ``dequant_matmul``'s
tile space is {"kc", "bm"}: bm <= DECODE_MAX_M picks the decode instance
(launched with bm = M), 32 or 128 the tensor-core tile; kc gives one
candidate per K split count of each instance.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..registry import (Impl, OpSpec, count_launch, refuse_traced,
                        register_op)
from ..tune import pow2_bucket
from .ref import dequant_matmul_grouped_ref, dequant_matmul_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_GROUPED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
_FNS: dict = {}

# dequant_matmul's grid (csrc/dequant_matmul.cu).  A block covers TILE
# output columns.  The decode instance (M <= DECODE_MAX_M) runs K in rounds
# of DECODE_ROWS rows, staging at most DECODE_X_BYTES of f32 x; the
# tensor-core one in steps of TC_BK rows over TILE or SMALL_BM rows.  K
# splits into at most MAX_SPLITS chunks (one thread-block cluster).
DECODE_MAX_M = 8
TILE = 128
DECODE_ROWS = 32
DECODE_MIN_STEPS = 4          # a decode block's load rounds, at least
DECODE_X_BYTES = 64 * 1024
TC_BK = 64
TC_MAX_STEPS = 128            # K steps of a TILE-row block, at most
SMALL_BM = 32
SMALL_N = 64
MAX_SPLITS = 8
MAX_GRID_ROWS = 65535
H100_SMS = 132                # planning for the card from CPU tensors
_SMS: dict = {}               # device index -> SM count


def schedule(m: int, k: int, n: int, sms: int) -> tuple[int, int, int, int]:
    """(kc, splits, tiles, bm): K rows per block, the number of K chunks,
    of output tiles, and the instance of one ``dequant_matmul`` launch on a
    card of ``sms`` SMs: bm = M for the decode instance, else the
    tensor-core tile's rows.

    Decode, at M <= DECODE_MAX_M where a block's share of x fits
    DECODE_X_BYTES: K is split until the blocks fill one wave, as many as
    SMs (a second, partial wave measured slower: it only adds its tail),
    but a block keeps at least DECODE_MIN_STEPS load rounds.  Tensor cores:
    the SMALL_BM-row tile for few rows, for N <= SMALL_N (the MoE router)
    and where TILE-row tiles would fill less than a quarter of a wave; K
    is split until the small tiles fill a wave, and in two for the large
    ones (measured faster than one or four chunks at every main-path
    shape), more where a block would run over TC_MAX_STEPS steps."""
    rounds = -(-k // DECODE_ROWS)
    if m <= DECODE_MAX_M and \
            4 * m * -(-rounds // MAX_SPLITS) * DECODE_ROWS <= DECODE_X_BYTES:
        tiles = -(-n // TILE)
        s = max(1, min(-(-sms // tiles), -(-rounds // DECODE_MIN_STEPS),
                       MAX_SPLITS))
        per = min(-(-rounds // s), DECODE_X_BYTES // (4 * m) // DECODE_ROWS)
        return per * DECODE_ROWS, -(-rounds // per), tiles, m
    steps = -(-k // TC_BK)
    big = -(-n // TILE) * -(-m // TILE)
    small = m <= SMALL_BM or n <= SMALL_N or 4 * big <= sms
    bm = SMALL_BM if small else TILE
    tiles = -(-n // TILE) * -(-m // bm)
    if bm == SMALL_BM:
        s = -(-sms // tiles)
    else:
        s = max(2, -(-steps // TC_MAX_STEPS))
    s = min(s, steps, MAX_SPLITS)
    per = -(-steps // s)
    return per * TC_BK, -(-steps // per), tiles, bm


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _launcher(name: str = "dequant_matmul", argtypes=_ARGTYPES):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_operands(op: str, x, w_q, scale) -> None:
    """What both kernels take: f32|bf16 x, int8 contiguous levels and f32
    contiguous scales on x's card, dimensions within int32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op}: x dtype {x.dtype} not in (float32, "
                        "bfloat16)")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{op}: w_q must be int8 and scale float32")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{op}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if max(x.shape + w_q.shape) >= 2 ** 31:
        raise ValueError(f"{op}: a dimension exceeds int32")


def dequant_matmul_cuda(x2: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor, *, kc: int | None = None,
                        bm: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on 2-D operands; checks what it takes.
    ``kc`` / ``bm`` are the launch's knobs (default :func:`schedule`'s);
    bm <= DECODE_MAX_M runs the decode instance.  Knobs the launch does
    not take raise."""
    refuse_traced("dequant_matmul", x2, w_q, scale)
    m, k = x2.shape
    if w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"dequant_matmul: w_q {tuple(w_q.shape)} does not "
                         f"match x (m={m}, k={k})")
    n = w_q.shape[1]
    if scale.shape != (n,):
        raise ValueError(f"dequant_matmul: scale {tuple(scale.shape)} != "
                         f"({n},)")
    _check_operands("dequant_matmul", x2, w_q, scale)
    x2 = x2.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    if kc is None or bm is None:
        kc, _, _, bm = schedule(m, k, n, _sms(x2.device))
    elif bm <= DECODE_MAX_M:
        bm = m
    err = _launcher()(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                      w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                      m, k, n, kc, bm, stream)
    _build.check(err, "dequant_matmul")
    count_launch("dequant_matmul")
    return out


def dequant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor, *, kc: int | None = None,
                   bm: int | None = None) -> torch.Tensor:
    """Serving matmul against DeepCABAC-quantized weights.

    x (..., K) f32|bf16, w_q (K, N) int8 levels, scale (N,) per-channel
    Delta -> (..., N) f32.  ``kc`` / ``bm``: the kernel's launch knobs
    (see :func:`dequant_matmul_cuda`); the plain version has none."""
    refuse_traced("dequant_matmul", x, w_q, scale)
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    m = math.prod(lead)
    n = w_q.shape[1]
    x2 = x.reshape(m, k)
    if x.is_cuda:
        out = dequant_matmul_cuda(x2, w_q, scale, kc=kc, bm=bm)
    else:
        out = dequant_matmul_ref(x2, w_q, scale)
    return out.reshape(*lead, n)


def dequant_matmul_grouped_cuda(x: torch.Tensor, w_q: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """Launch the grouped CUDA kernel; checks what it takes.  A (N,) scale
    goes to the kernel as an expert stride of 0 (no (E, N) copy)."""
    refuse_traced("dequant_matmul_grouped", x, w_q, scale)
    if x.dim() != 3 or w_q.dim() != 3 or w_q.shape[0] != x.shape[0] or \
            w_q.shape[1] != x.shape[2]:
        raise ValueError(f"dequant_matmul_grouped: x {tuple(x.shape)} and "
                         f"w_q {tuple(w_q.shape)} are not (E, M, K) and "
                         "(E, K, N)")
    e, m, k = x.shape
    n = w_q.shape[2]
    if scale.shape == (n,):
        stride = 0
    elif scale.shape == (e, n):
        stride = n
    else:
        raise ValueError(f"dequant_matmul_grouped: scale "
                         f"{tuple(scale.shape)} is neither ({e}, {n}) nor "
                         f"({n},)")
    _check_operands("dequant_matmul_grouped", x, w_q, scale)
    if e > 65535:
        raise ValueError(f"dequant_matmul_grouped: {e} experts exceed the "
                         "grid's 65535")
    x = x.contiguous()
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher("dequant_matmul_grouped", _GROUPED_ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w_q.data_ptr(),
        scale.data_ptr(), stride, out.data_ptr(), e, m, k, n, stream)
    _build.check(err, "dequant_matmul_grouped")
    count_launch("dequant_matmul_grouped")
    return out


def dequant_matmul_grouped(x: torch.Tensor, w_q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Grouped-expert serving matmul, one independent product per expert.

    x (E, M, K) f32|bf16, w_q (E, K, N) int8 levels, scale (E, N) f32 or
    (N,) (one per-channel Delta shared by the layer's experts) -> (E, M, N)
    f32."""
    refuse_traced("dequant_matmul_grouped", x, w_q, scale)
    if x.is_cuda:
        return dequant_matmul_grouped_cuda(x, w_q, scale)
    return dequant_matmul_grouped_ref(x, w_q, scale)


# ---------------------------------------------------------------------------
# Registry specs
# ---------------------------------------------------------------------------

def _shape_info(x, w_q, scale) -> dict:
    """m, k, n and the SM count :func:`schedule` plans for: x's card's, or
    H100_SMS for a CPU x (planning for ``"cuda"`` without a card)."""
    m = math.prod(x.shape[:-1])
    return {"m": m, "k": x.shape[-1], "n": w_q.shape[1],
            "sms": _sms(x.device) if x.is_cuda else H100_SMS}


def _bucket(s: dict) -> str:
    # rows are data-dependent (decode m = live batch) -> pow2 bucket;
    # k/n are model dims -> exact
    return f"m{pow2_bucket(s['m'])}_k{s['k']}_n{s['n']}"


def default_tiles(s: dict) -> dict:
    kc, _, _, bm = schedule(max(s["m"], 1), max(s["k"], 1), s["n"],
                            s["sms"])
    return {"kc": kc, "bm": bm}


def kc_candidates(s: dict) -> list[int]:
    """One kc per K split count (1 to MAX_SPLITS) of each instance: K in
    rounds of DECODE_ROWS rows (decode) and in steps of TC_BK (tensor
    cores)."""
    out = set()
    for unit in (DECODE_ROWS, TC_BK):
        units = max(-(-s["k"] // unit), 1)
        out.update(-(-units // sp) * unit for sp in range(1, MAX_SPLITS + 1))
    return sorted(out)


def tile_ok(s: dict, t: dict) -> bool:
    """What the launch takes (``csrc/dequant_matmul.cu``,
    ``dequant_matmul_launch``): at most MAX_SPLITS K chunks; the decode
    instance (bm <= DECODE_MAX_M) at M <= DECODE_MAX_M, kc a multiple of
    DECODE_ROWS, M kc f32 x values within DECODE_X_BYTES; the tensor-core
    one with bm in (SMALL_BM, TILE), kc a multiple of TC_BK, at most
    MAX_GRID_ROWS row tiles."""
    m, kc, bm = s["m"], t["kc"], t["bm"]
    if kc <= 0 or -(-s["k"] // kc) > MAX_SPLITS:
        return False
    if bm <= DECODE_MAX_M:
        return (m <= DECODE_MAX_M and kc % DECODE_ROWS == 0
                and 4 * m * kc <= DECODE_X_BYTES)
    return (bm in (SMALL_BM, TILE) and kc % TC_BK == 0
            and -(-m // bm) <= MAX_GRID_ROWS)


def _example_inputs(shape, device="cpu"):
    """(m, k, n) or (m, k, n, x dtype name): seeded operands on
    ``device``."""
    m, k, n = shape[:3]
    xdt = getattr(torch, shape[3]) if len(shape) > 3 else torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(m * 31 + k * 7 + n)
    x = torch.randn((m, k), generator=gen, device=device).to(xdt)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                       dtype=torch.int8)
    sc = torch.rand(n, generator=gen, device=device) * 0.01 + 1e-4
    return (x, wq, sc), {}


def _run_ref(x, w_q, scale):
    lead = tuple(x.shape[:-1])
    out = dequant_matmul_ref(x.reshape(-1, x.shape[-1]), w_q, scale)
    return out.reshape(*lead, w_q.shape[1])


@register_op
def _dequant_matmul_spec() -> OpSpec:
    return OpSpec(
        name="dequant_matmul",
        impls={
            "cuda": Impl("cuda", dequant_matmul, platforms=("cuda",)),
            "ref": Impl("ref", _run_ref, uses_tiles=False),
        },
        defaults={"cuda": "cuda", "*": "ref"},
        fallbacks=("ref",),
        tile_space={"kc": kc_candidates, "bm": (DECODE_MAX_M, SMALL_BM,
                                                TILE)},
        default_tiles=default_tiles,
        tile_ok=tile_ok,
        shape_info=_shape_info,
        bucket=_bucket,
        example_inputs=_example_inputs,
        oracle=dequant_matmul_ref,
        tune_impls={"cuda": "cuda"},
    )


def _grouped_shape_info(x, w_q, scale) -> dict:
    return {"e": x.shape[0], "m": x.shape[1], "k": x.shape[2],
            "n": w_q.shape[2]}


def _grouped_bucket(s: dict) -> str:
    return f"e{s['e']}_m{pow2_bucket(s['m'])}_k{s['k']}_n{s['n']}"


@register_op
def _dequant_matmul_grouped_spec() -> OpSpec:
    return OpSpec(
        name="dequant_matmul_grouped",
        impls={
            "cuda": Impl("cuda", dequant_matmul_grouped, platforms=("cuda",),
                         uses_tiles=False),
            "ref": Impl("ref", dequant_matmul_grouped_ref, uses_tiles=False),
        },
        defaults={"cuda": "cuda", "*": "ref"},
        fallbacks=("ref",),
        shape_info=_grouped_shape_info,
        bucket=_grouped_bucket,
        oracle=dequant_matmul_grouped_ref,
    )
