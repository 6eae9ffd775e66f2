"""GQA-aware attention over (B, S, H, D) and the flash kernel's wrapper.

The registered op ``flash_attention`` is the attention the model calls
(``kernels.get("flash_attention")(q, k, v, qpos, ..., policy=...)``), with
the reference registry's routing (``repro.kernels.flash_attention.ops``)
over three impls: ``cuda`` (the kernel), ``scan`` (the online-softmax
scan; decode through the naive path) and ``ref`` (the naive path):

* decode (Sq == 1) is *routed* to :func:`~.scan.naive_attend`, by design,
  and records nothing;
* a call that autograd differentiates (grad enabled and any of q, k, v
  requiring grad) is routed to :func:`~.scan.online_softmax_scan` on every
  platform, by design, and records nothing: the kernel has no backward,
  and the reference's Pallas kernel has none either (its training path
  differentiates the scan, its CPU default).  :func:`_flash_cuda` raises
  if such a call reaches it, so a gradient is never dropped quietly;
* on the card, the hand-written kernel runs unless a shape breaks its
  contract — ragged ``kv_len``, ``d != dv``, or a ``qpos`` that is not the
  right-aligned arange its causal mask hard-codes — and then
  :func:`~.scan.online_softmax_scan` runs and the fallback is recorded in
  ``dispatch_report()`` (a ``cuda`` pin raises there under a strict
  policy).  A head dim the kernel was not built for raises;
* on the CPU the scan is the platform default, as in the reference.

The kernel masks its own ragged edges, so the TPU kernel's "a power-of-two
tile divides S" constraints are gone; the function computed is unchanged.

:func:`flash_attention` is the kernel's wrapper: a CUDA tensor launches
``csrc/flash_attention.cu`` (or raises), a CPU tensor takes the plain
version in ``ref.py``.  Both types run on the tensor cores: bf16 as it
is, f32 by the 3xTF32 split.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..registry import Impl, OpSpec, count_launch, register_op
from ..tune import pow2_bucket
from .ref import flash_attention_ref
from .scan import naive_attend, online_softmax_scan

# smoke models; musicgen-medium; zamba2-2.7b; llama3-8b and the other GQA
# models
KERNEL_HEAD_DIMS = (32, 64, 80, 128)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]
_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _aligned(t):
    """Both instances copy 16-byte rows with cp.async: a view that starts
    off a 16-byte boundary is copied to a fresh allocation."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _wants_grad(q, k, v) -> bool:
    """True when autograd would differentiate through this call.  The
    kernel has no backward (nor has the reference's), so such a call must
    not reach it."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))


def _flash_cuda(q, k, v):
    if _wants_grad(q, k, v):
        raise RuntimeError(
            "flash_attention: the kernel has no backward, and an input "
            "requires grad; attention() routes such a call to the scan")
    b, sq, h, d = q.shape
    skv, g = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("flash_attention: q, k, v must share a dtype in "
                        f"(float32, bfloat16); got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if v.shape[-1] != d or k.shape[-1] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if g < 1 or h % g:
        raise ValueError(f"flash_attention: {g} KV heads do not divide "
                         f"{h} heads")
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), int(q.dtype == torch.bfloat16),
                      b, sq, skv, h, g, d, 1.0 / (d ** 0.5), stream)
    _build.check(err, "flash_attention")
    count_launch("flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention, q (B, Sq, H, D); k, v (B, Skv, G, D) with G | H
    -> (B, Sq, H, D) in q's dtype.  Query i sees keys j <= i + Skv - Sq."""
    if q.is_cuda:
        return _flash_cuda(q, k, v)
    b, sq, h, d = q.shape
    skv, g = k.shape[1], k.shape[2]
    rep = h // g
    qf = q.permute(0, 2, 1, 3).reshape(b * h, sq, d)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(
        b * h, skv, d)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(
        b * h, skv, v.shape[-1])
    out = flash_attention_ref(qf, kf, vf, causal=True)
    return out.reshape(b, h, sq, -1).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# Registry spec.  Op signature (the model-level contract):
#     (q (B,Sq,H,D), k (B,Skv,G,D), v (B,Skv,G,DV), qpos (B,Sq),
#      *, kv_len=None, kv_block=1024, qpos_canonical=None)
# ---------------------------------------------------------------------------

def _qpos_canonical(qpos, sq: int, skv: int) -> bool:
    """The kernel hard-codes qpos == arange(sq) + (skv - sq).  Comparing
    on the host syncs with the card, so a step under CUDA-graph capture
    must say what its qpos is (``qpos_canonical``): it raises here."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "flash_attention: qpos must be checked on the host, which a "
            "CUDA-graph capture cannot do; pass qpos_canonical")
    want = torch.arange(sq, device=qpos.device) + (skv - sq)
    return bool(torch.equal(qpos, want[None, :].expand_as(qpos)))


def _shape_info(q, k, v, qpos=None, *, kv_len=None, kv_block=1024,
                qpos_canonical=None) -> dict:
    """The call's shapes.  ``qpos_canonical`` is the caller's word (a
    caller that built qpos from an arange says so, sparing a
    device-to-host comparison per layer), else True without a qpos, else
    compared here only where it decides the route: a prefill call the
    kernel could take otherwise.  Anywhere else it stays None (unknown)."""
    b, sq, h, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    grad = _wants_grad(q, k, v)
    if qpos_canonical is None:
        if qpos is None:
            qpos_canonical = True
        elif sq > 1 and kv_len is None and d == dv and not grad:
            qpos_canonical = _qpos_canonical(qpos, sq, skv)
    return {"b": b, "sq": sq, "skv": skv, "h": h, "g": k.shape[2], "d": d,
            "dv": dv, "ragged": kv_len is not None, "grad": grad,
            "qpos_canonical": qpos_canonical}


def _bucket(s: dict) -> str:
    return (f"bh{pow2_bucket(s['b'] * s['h'])}_sq{pow2_bucket(s['sq'])}"
            f"_skv{pow2_bucket(s['skv'])}_d{s['d']}")


def _kernel_constraint(s: dict) -> str | None:
    """What the kernel cannot take.  A head dim it was not built for is no
    constraint: the kernel raises on it."""
    if s["sq"] <= 1:
        return "decode (Sq == 1): one query row per head underfills a tile"
    if s["grad"]:
        return "an input requires grad and the kernel has no backward"
    if s["ragged"]:
        return "ragged kv_len masking is not implemented in the kernel"
    if s["d"] != s["dv"]:
        return f"d != dv ({s['d']} != {s['dv']})"
    if s["qpos_canonical"] is False:
        return ("qpos is not the canonical right-aligned arange the "
                "kernel's causal mask hard-codes")
    return None


def _route(s: dict, platform: str) -> str | None:
    """Designed routes, recorded nowhere: decode takes the naive path
    inside the scan impl, and a call autograd differentiates takes the
    scan on every platform (the kernel has no backward, nor has the
    reference's)."""
    return "scan" if s["sq"] <= 1 or s["grad"] else None


def _as_q5(q, k):
    b, sq, h, d = q.shape
    g = k.shape[2]
    return q.reshape(b, sq, g, h // g, d)


def _run_cuda(q, k, v, qpos, *, kv_len=None, kv_block=1024,
              qpos_canonical=None):
    del qpos, kv_len, kv_block, qpos_canonical
    return flash_attention(q, k, v)


def _run_scan(q, k, v, qpos, *, kv_len=None, kv_block=1024,
              qpos_canonical=None):
    b, sq, h, _ = q.shape
    q5 = _as_q5(q, k)
    if sq > 1:
        out = online_softmax_scan(q5, k, v, qpos, kv_block, kv_len)
    else:                          # decode: one query row, scan degenerates
        out = naive_attend(q5, k, v, qpos, kv_len)
    return out.reshape(b, sq, h, v.shape[-1])


def _run_ref(q, k, v, qpos, *, kv_len=None, kv_block=1024,
             qpos_canonical=None):
    b, sq, h, _ = q.shape
    out = naive_attend(_as_q5(q, k), k, v, qpos, kv_len)
    return out.reshape(b, sq, h, v.shape[-1])


@register_op
def _flash_attention_spec() -> OpSpec:
    return OpSpec(
        name="flash_attention",
        impls={
            "cuda": Impl("cuda", _run_cuda, platforms=("cuda",),
                         constraint=_kernel_constraint, uses_tiles=False),
            "scan": Impl("scan", _run_scan, uses_tiles=False),
            "ref": Impl("ref", _run_ref, uses_tiles=False),
        },
        defaults={"cuda": "cuda", "*": "scan"},
        route=_route,
        fallbacks=("scan", "ref"),
        shape_info=_shape_info,
        bucket=_bucket,
        oracle=flash_attention_ref,
    )
