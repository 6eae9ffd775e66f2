"""Why the port's dequantize-matmul and attention kernels may use the
tensor cores, and the bounds ``chip_smoke.py`` holds the kernels to.  CPU
only.

The reference computes out = x @ (q * s) with f32 sums.  The kernels'
tensor-core instances compute out = s * (x @ q): bf16 x bf16 products
summed in f32 on the tensor cores, the per-column scale once in the
epilogue.  That is the same function when every product x * q is exact in
f32, which holds for a bf16 x (8 significant bits) and an int8 level (at
most 8): (b) checks it for all 256 levels.  A f32 x is split exactly into
three bf16 pieces first, hi + mid + lo == x (bf16x3; checked on 10^6
values), so each piece times a level is exact too.  (a) holds the kernels'
orders, as plain PyTorch functions, against the JAX package's ops at
llama3-8b's and deepseek-moe-16b's widths to 1e-5 of max|ref| (f32 sums in
another order).  (c) checks that the bounds count operations at the bf16
tensor-core rate for a bf16 x and at a third of it for a f32 x (three
MMAs per product), so most of them are bytes.  (d) f32 attention: the
kernel's f32 instance splits every operand of both products into two
TF32 values (3xTF32); its emulation in PyTorch holds against the JAX
package's flash_attention (naive reference and Pallas interpret) at
llama3-8b's and deepseek-moe-16b's head shapes to 1e-5, and the bound
counts f32 attention at that split's rate, BF16_FLOPS / 6.

Run as a script, it prints how far each order is from the exact f64 result
(E=8, M=32, K=2048, N=1408), the measurement the kernel's source note cites.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.dequant_matmul.ops import \
    dequant_matmul as jdm  # noqa: E402
from repro.kernels.dequant_matmul.ops import \
    dequant_matmul_grouped as jdmg  # noqa: E402
from repro.kernels.flash_attention.ops import \
    _run_ref as jflash_ref  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jflash  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.dequant_matmul.ref import (  # noqa: E402
    bf16x3_split, dequant_matmul_grouped_ref,
    dequant_matmul_grouped_scale_after, dequant_matmul_ref,
    dequant_matmul_scale_after)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_3xtf32, tf32_split)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5
# deepseek-moe-16b's expert banks: w_gate / w_up and w_down
EXPERT_KN = [(2048, 1408), (1408, 2048)]
# llama3-8b's projections: wk / wv and wq / wo
DENSE_KN = [(4096, 1024), (4096, 4096)]


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _inputs(e, m, k, n, scale_form, seed, xdt="bfloat16"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    if xdt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    wq = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
    sc = (rng.random((e, n) if scale_form == "per_expert" else (n,))
          * 0.01 + 1e-4).astype(np.float32)
    return x, wq, sc


@pytest.mark.parametrize("scale_form", ["shared", "per_expert"])
@pytest.mark.parametrize("m", [32, 64])
@pytest.mark.parametrize("k,n", EXPERT_KN)
def test_scale_after_order_matches_jax_at_expert_widths(k, n, m, scale_form):
    """(a) E cut to 4 for time; M = 32 (a 4-slot decode step's capacity
    buffer) and 64 (a 4 x 128-token prefill's); a bf16 x as it is and a
    f32 x as its three bf16 pieces (the kernel's two instances)."""
    e = 4
    for xdt in ("bfloat16", "float32"):
        x, wq, sc = _inputs(e, m, k, n, scale_form, k + n + m, xdt)
        got = dequant_matmul_grouped_scale_after(_t(x), _t(wq),
                                                 _t(sc)).numpy()
        assert got.dtype == np.float32 and got.shape == (e, m, n)
        for kw in ({"use_ref": True}, {"interpret": True}):
            want = np.asarray(jdmg(jnp.asarray(x), jnp.asarray(wq),
                                   jnp.asarray(sc), **kw), np.float32)
            scale = float(np.max(np.abs(want)))
            assert scale > 0
            assert float(np.max(np.abs(got - want))) <= RTOL * scale, \
                (xdt, kw)


def test_bf16x3_split_is_exact_over_a_wide_exponent_range():
    """hi + mid + lo == x for 10^6 f32 values with exponents -110..126 and
    random signs and significands, and each piece is a bf16 whose
    products with every level are exact."""
    rng = np.random.default_rng(3)
    n = 1_000_000
    sig = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    exp = rng.integers(-110 + 127, 127 + 127, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    x = (sign | (exp << 23) | sig).view(np.float32)
    assert np.isfinite(x).all()
    assert float(np.log2(np.abs(x)).min()) < -100
    assert float(np.log2(np.abs(x)).max()) > 120
    hi, mid, lo = bf16x3_split(_t(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.double() + mid.double() + lo.double()).numpy()
    np.testing.assert_array_equal(back, x.astype(np.float64))
    # and in the kernel's f32 order, hi + mid + lo rounds to nothing
    np.testing.assert_array_equal(
        ((hi.float() + mid.float()) + lo.float()).numpy(), x)


def _dense_inputs(m, k, n, xdt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if xdt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sc = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    return x, wq, sc


@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,n", DENSE_KN)
def test_scale_after_orders_match_jax_at_llama3_widths(k, n, xdt):
    """(a) M = 16 (a continuous batch past the decode instance): s * (x @ q)
    for a bf16 x and s * (lo @ q + mid @ q + hi @ q) for a f32 x against
    the JAX package's dequant_matmul (its plain reference), and the port's
    plain version (the reference's order) against both."""
    m = 16
    x, wq, sc = _dense_inputs(m, k, n, xdt, k + n)
    got = dequant_matmul_scale_after(_t(x), _t(wq), _t(sc)).numpy()
    plain = dequant_matmul_ref(_t(x), _t(wq), _t(sc)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    want = np.asarray(jdm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sc),
                          use_ref=True), np.float32)
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    assert float(np.max(np.abs(got - want))) <= RTOL * scale
    assert float(np.max(np.abs(plain - want))) <= RTOL * scale


def test_scale_after_order_matches_jax_pallas_interpret():
    """(a) the same against the JAX package's Pallas kernel in interpret
    mode, at a width it runs quickly on the CPU (both x types)."""
    for xdt in ("bfloat16", "float32"):
        x, wq, sc = _dense_inputs(16, 512, 256, xdt, 7)
        got = dequant_matmul_scale_after(_t(x), _t(wq), _t(sc)).numpy()
        want = np.asarray(jdm(jnp.asarray(x), jnp.asarray(wq),
                              jnp.asarray(sc), interpret=True), np.float32)
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(got - want))) <= RTOL * scale, xdt


def _bf16_spread():
    """Every finite bf16 whose magnitude is below 2^120 (so that x * 128
    stays finite in f32), subnormals and zeros included."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    vals = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    keep = np.isfinite(vals) & (np.abs(vals) < 2.0 ** 120)
    return bits[keep].view(ml_dtypes.bfloat16)


def test_every_bf16_times_int8_product_is_exact_in_f32():
    """(b) all 256 levels against every bf16 in range, in f64."""
    x = _bf16_spread()
    assert x.size > 60000
    xt = _t(x).float()                      # (X,) exact bf16 -> f32
    x64 = np.asarray(x, np.float64)
    levels = np.arange(-128, 128, dtype=np.int64)
    for lo in range(0, 256, 32):
        q = levels[lo:lo + 32]
        got = (xt[None, :] * torch.from_numpy(q.astype(np.float32))[:, None]
               ).numpy().astype(np.float64)
        want = x64[None, :] * q.astype(np.float64)[:, None]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [32, 64])
def test_scale_after_order_equals_plain_version_closely(m):
    """The port's own plain version (the reference's order) and the
    kernel's order agree to 1e-5 of max|ref| on a bf16 x."""
    x, wq, sc = _inputs(3, m, 300, 130, "per_expert", m)
    a = dequant_matmul_grouped_scale_after(_t(x), _t(wq), _t(sc))
    b = dequant_matmul_grouped_ref(_t(x), _t(wq), _t(sc))
    assert float((a - b).abs().max()) <= RTOL * float(b.abs().max())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)             # imports no torch at the top
    return cs


def test_grouped_bound_is_bytes_for_bf16_x_and_operations_for_f32_x():
    """(c) E=64, (K, N) = (2048, 1408), shared (N,) scale.  A f32 x counts
    at BF16_FLOPS / 3 (the bf16x3 split's three MMAs), which makes the
    decode rows (M = 32) bytes as well; operations bound it from M = 128
    rows per expert."""
    cs = _chip_smoke()
    e, m, k, n = 64, 32, 2048, 1408
    nbytes = e * m * k * 2 + e * k * n + 4 * n + 4 * e * m * n
    ms, by = cs._grouped_bound(e, m, k, n, 2, n)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)
    assert ms == pytest.approx(0.0610, abs=5e-5)
    ms, by = cs._grouped_bound(e, m, k, n, 4, n)
    assert by == "bytes"
    nbytes32 = e * m * k * 4 + e * k * n + 4 * n + 4 * e * m * n
    assert ms == pytest.approx(nbytes32 / cs.HBM_BYTES_PER_S * 1e3)
    assert ms == pytest.approx(0.0635, abs=5e-5)
    ms, by = cs._grouped_bound(e, 128, k, n, 4, n)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * e * 128 * k * n * 3 / cs.BF16_FLOPS
                               * 1e3)
    # prefill rows (M = 64): still bytes for bf16 x
    assert cs._grouped_bound(e, 64, k, n, 2, n)[1] == "bytes"


def test_dm_bound_counts_bf16_x_at_the_tensor_core_rate():
    cs = _chip_smoke()
    ms, by = cs._dm_bound(512, 4096, 4096, 2)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * 512 * 4096 * 4096 / cs.BF16_FLOPS
                               * 1e3)
    assert ms == pytest.approx(0.0174, abs=5e-5)
    # f32 x: the bf16x3 split runs three MMAs per product, BF16_FLOPS / 3
    # (it was the f32 rate, 0.2564 ms, when no kernel split a f32 x)
    ms, by = cs._dm_bound(512, 4096, 4096, 4)
    assert by == "operations"
    assert ms == pytest.approx(3 * 2.0 * 512 * 4096 * 4096 / cs.BF16_FLOPS
                               * 1e3)
    assert ms == pytest.approx(0.0521, abs=5e-5)
    # the router at prefill (f32 x, 2048 x 64)
    assert cs._dm_bound(512, 2048, 64, 4)[1] == "bytes"
    # decode (M = 4): the weight bytes, whatever x's type
    assert cs._dm_bound(4, 4096, 14336, 2)[1] == "bytes"
    assert cs._dm_bound(4, 4096, 14336, 4)[1] == "bytes"


def test_flash_bound_counts_f32_at_the_split_rate():
    """(d) f32 attention at 3xTF32's BF16_FLOPS / 6: bytes bound both
    full-width prefill shapes (it was the f32 rate, 0.00808 ms of
    operations at (32, 8), when no kernel put f32 on the tensor cores)."""
    cs = _chip_smoke()
    b, s, d = 4, 128, 128
    for (h, g), want_ms in (((32, 8), 0.00626), ((16, 16), 0.00501)):
        ms, by = cs._flash_bound(b, s, s, h, g, d, 4)
        nbytes = (2 * b * s * h * d + 2 * b * s * g * d) * 4
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)
        assert ms == pytest.approx(want_ms, abs=1e-5)
    assert cs._flash_peak(4) == pytest.approx(cs.BF16_FLOPS / 6)
    assert cs._flash_peak(2) == cs.BF16_FLOPS
    # operations bind f32 attention once a row sees enough keys: S = 4096
    ms, by = cs._flash_bound(1, 4096, 4096, 32, 8, d, 4)
    assert by == "operations"
    flops = 4.0 * d * 32 * 4096 * 4097 // 2
    assert ms == pytest.approx(flops / (cs.BF16_FLOPS / 6) * 1e3)


def test_tf32_split_is_within_2_to_the_minus_22():
    """(d) big and small are TF32 values (low 13 significand bits zero),
    x - big is exact, and big + small is within 2^-22 |x| of x, for 10^6
    f32 values over a wide exponent range."""
    rng = np.random.default_rng(4)
    n = 1_000_000
    sig = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    exp = rng.integers(-100 + 127, 100 + 127, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    x = (sign | (exp << 23) | sig).view(np.float32)
    big, small = tf32_split(_t(x))
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(
        (_t(x) - big).double().numpy(), x64 - big.double().numpy())
    err = np.abs(big.double().numpy() + small.double().numpy() - x64)
    assert float(np.max(err / np.abs(x64))) <= 2.0 ** -22


@pytest.mark.parametrize("s", [100, 128])
@pytest.mark.parametrize("h,g", [(16, 16), (32, 8)])
def test_3xtf32_attention_matches_jax_at_full_width_heads(h, g, s):
    """(d) D = 128, B = 1: the 3xTF32 emulation against the JAX package's
    naive reference (``_run_ref``, what its tests run on the CPU) and, at
    S = 128 (a power-of-two tile divides it), its Pallas kernel in
    interpret mode, to 1e-5 of max|ref|."""
    b, d = 1, 128
    rng = np.random.default_rng(h * 1000 + g * 10 + s)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    rep = h // g
    qt = _t(q).permute(0, 2, 1, 3).reshape(b * h, s, d)
    kt, vt = (_t(a).permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
              .reshape(b * h, s, d) for a in (k, v))
    got = flash_attention_3xtf32(qt, kt, vt).reshape(b, h, s, d).permute(
        0, 2, 1, 3).numpy()
    qpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    wants = {"ref": jflash_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), qpos)}
    if s == 128:
        wants["interpret"] = jflash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True, bq=64,
                                    bk=64)
    for name, want in wants.items():
        want = np.asarray(want, np.float32)
        scale = float(np.max(np.abs(want)))
        assert scale > 0
        assert float(np.max(np.abs(got - want))) <= RTOL * scale, name


def test_chip_smoke_imports_without_a_card():
    cs = _chip_smoke()
    assert cs.BF16_FLOPS > cs.F32_FLOPS
    assert not hasattr(cs, "torch")


def _report(e=8, m=32, k=2048, n=1408, seed=0):
    """Distances, relative to max|exact|, of the reference's order and the
    kernel's from the exact f64 result, and between the two."""
    x, wq, sc = _inputs(e, m, k, n, "shared", seed)
    xt, qt, st = _t(x), _t(wq), _t(sc)
    ref = dequant_matmul_grouped_ref(xt, qt, st).double()
    tc = dequant_matmul_grouped_scale_after(xt, qt, st).double()
    exact = (xt.double() @ qt.double()) * st.double()[None, None, :]
    top = float(exact.abs().max())
    return {"tc_vs_ref": float((tc - ref).abs().max()) / top,
            "ref_vs_exact": float((ref - exact).abs().max()) / top,
            "tc_vs_exact": float((tc - exact).abs().max()) / top}


if __name__ == "__main__":
    for key, val in _report().items():
        print(f"{key}: {val:.3g} of max|exact|")
