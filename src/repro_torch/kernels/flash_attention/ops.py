"""GQA-aware attention over (B, S, H, D) and the flash kernel's wrapper.

:func:`attention` is the op the model calls, with the reference registry's
routing (``repro.kernels.flash_attention.ops``):

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
  ``dispatch_report()``.  A head dim the kernel was not built for raises;
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
from ..registry import count_launch, platform_of, record_event
from .ref import flash_attention_ref
from .scan import naive_attend, online_softmax_scan

# smoke models; musicgen-medium; llama3-8b and the other GQA models
KERNEL_HEAD_DIMS = (32, 64, 128)

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
# Op-level routing (the model-level contract):
#     (q (B,Sq,H,D), k (B,Skv,G,D), v (B,Skv,G,DV), qpos (B,Sq),
#      *, kv_len=None, kv_block=1024)
# ---------------------------------------------------------------------------

def _qpos_canonical(qpos, sq: int, skv: int) -> bool:
    """The kernel hard-codes qpos == arange(sq) + (skv - sq).  Comparing
    on the host syncs with the card, so a step under CUDA-graph capture
    must say what its qpos is (``qpos_canonical``): it raises here."""
    if qpos is None:
        return True
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "flash_attention: qpos must be checked on the host, which a "
            "CUDA-graph capture cannot do; pass qpos_canonical")
    want = torch.arange(sq, device=qpos.device) + (skv - sq)
    return bool(torch.equal(qpos, want[None, :].expand_as(qpos)))


def _kernel_constraint(q, k, v, qpos, kv_len, qpos_canonical) -> str | None:
    sq, skv, d, dv = q.shape[1], k.shape[1], q.shape[-1], v.shape[-1]
    if kv_len is not None:
        return "ragged kv_len masking is not implemented in the kernel"
    if d != dv:
        return f"d != dv ({d} != {dv})"
    if qpos_canonical is None:
        qpos_canonical = _qpos_canonical(qpos, sq, skv)
    if not qpos_canonical:
        return ("qpos is not the canonical right-aligned arange the "
                "kernel's causal mask hard-codes")
    return None


def _as_q5(q, k):
    b, sq, h, d = q.shape
    g = k.shape[2]
    return q.reshape(b, sq, g, h // g, d)


def _run_scan(q, k, v, qpos, kv_len, kv_block):
    b, sq, h, _ = q.shape
    q5 = _as_q5(q, k)
    if sq > 1:
        out = online_softmax_scan(q5, k, v, qpos, kv_block, kv_len)
    else:                          # decode: one query row, scan degenerates
        out = naive_attend(q5, k, v, qpos, kv_len)
    return out.reshape(b, sq, h, v.shape[-1])


def attention(q, k, v, qpos, *, kv_len=None, kv_block: int = 1024,
              qpos_canonical: bool | None = None):
    """Route one attention call (see the module docstring).
    ``qpos_canonical`` lets a caller that built ``qpos`` from an arange
    say so, sparing a device-to-host comparison per layer."""
    platform = platform_of(q)
    if q.shape[1] <= 1 or platform == "cpu" or _wants_grad(q, k, v):
        return _run_scan(q, k, v, qpos, kv_len, kv_block)
    reason = _kernel_constraint(q, k, v, qpos, kv_len, qpos_canonical)
    if reason is not None:
        record_event(op="flash_attention", platform=platform, impl="scan",
                     reason=reason, kind="fallback")
        return _run_scan(q, k, v, qpos, kv_len, kv_block)
    return flash_attention(q, k, v)
