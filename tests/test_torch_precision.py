"""Why the bf16-x instance of the grouped kernel may use the tensor cores,
and the bounds ``chip_smoke.py`` holds the kernels to.  CPU only.

The reference computes out = x @ (q * s) with f32 sums.  The kernel's
bf16-x instance computes out = s * (x @ q): bf16 x bf16 products summed in
f32 on the tensor cores, the per-column scale once in the epilogue.  That
is the same function when every product x * q is exact in f32, which holds
for a bf16 x (8 significant bits) and an int8 level (at most 8): (b) checks
it for all 256 levels.  (a) holds the kernel's order, as a plain PyTorch
function, against the JAX package's grouped op at deepseek-moe-16b's
per-expert widths to 1e-5 of max|ref| (f32 sums in another order).  (c)
checks that the bounds count operations at the bf16 tensor-core rate for a
bf16 x, so they are bytes, and at the f32 rate for a f32 x.

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
    dequant_matmul_grouped as jdmg  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.dequant_matmul.ref import (  # noqa: E402
    dequant_matmul_grouped_ref, dequant_matmul_grouped_scale_after)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5
# deepseek-moe-16b's expert banks: w_gate / w_up and w_down
EXPERT_KN = [(2048, 1408), (1408, 2048)]


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _inputs(e, m, k, n, scale_form, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, m, k)).astype(np.float32).astype(
        ml_dtypes.bfloat16)
    wq = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
    sc = (rng.random((e, n) if scale_form == "per_expert" else (n,))
          * 0.01 + 1e-4).astype(np.float32)
    return x, wq, sc


@pytest.mark.parametrize("scale_form", ["shared", "per_expert"])
@pytest.mark.parametrize("m", [32, 64])
@pytest.mark.parametrize("k,n", EXPERT_KN)
def test_scale_after_order_matches_jax_at_expert_widths(k, n, m, scale_form):
    """(a) E cut to 4 for time; M = 32 (a 4-slot decode step's capacity
    buffer) and 64 (a 4 x 128-token prefill's)."""
    e = 4
    x, wq, sc = _inputs(e, m, k, n, scale_form, k + n + m)
    got = dequant_matmul_grouped_scale_after(_t(x), _t(wq), _t(sc)).numpy()
    assert got.dtype == np.float32 and got.shape == (e, m, n)
    for kw in ({"use_ref": True}, {"interpret": True}):
        want = np.asarray(jdmg(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(sc), **kw), np.float32)
        scale = float(np.max(np.abs(want)))
        assert scale > 0
        assert float(np.max(np.abs(got - want))) <= RTOL * scale, kw


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
    """(c) E=64, M=32, (K, N) = (2048, 1408), shared (N,) scale."""
    cs = _chip_smoke()
    e, m, k, n = 64, 32, 2048, 1408
    nbytes = e * m * k * 2 + e * k * n + 4 * n + 4 * e * m * n
    ms, by = cs._grouped_bound(e, m, k, n, 2, n)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)
    assert ms == pytest.approx(0.0610, abs=5e-5)
    ms, by = cs._grouped_bound(e, m, k, n, 4, n)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * e * m * k * n / cs.F32_FLOPS * 1e3)
    assert ms == pytest.approx(0.1763, abs=5e-5)
    # prefill rows (M = 64): still bytes for bf16 x
    assert cs._grouped_bound(e, 64, k, n, 2, n)[1] == "bytes"


def test_dm_bound_counts_bf16_x_at_the_tensor_core_rate():
    cs = _chip_smoke()
    ms, by = cs._dm_bound(512, 4096, 4096, 2)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * 512 * 4096 * 4096 / cs.BF16_FLOPS
                               * 1e3)
    assert ms == pytest.approx(0.0174, abs=5e-5)
    ms, by = cs._dm_bound(512, 4096, 4096, 4)
    assert by == "operations"
    assert ms == pytest.approx(0.2564, abs=5e-5)
    # decode (M = 4): the weight bytes, whatever x's type
    assert cs._dm_bound(4, 4096, 14336, 2)[1] == "bytes"
    assert cs._dm_bound(4, 4096, 14336, 4)[1] == "bytes"


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
