"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (``rd_quant``: equal levels, no tolerance).

Every test carries the ``cuda`` marker and skips without a card (decided
inside the test body, so every worker collects the same tests).  On the
card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file
imports no JAX, so it runs where only PyTorch is installed.  Tolerances
are relative to the largest magnitude of the plain result: 1e-4 where both
sides compute in f32 (sums in another order; for the grouped kernel's bf16-x
instance too, whose bf16 x int8 products are exact in f32 and whose scale
multiplies after the sum), 2e-2 for bf16 attention (the kernel rounds p to
bf16 before the PV product, as the TPU kernel did), 1e-3
for a smoke model's logits on the card against the CPU (f32 through every
layer, as in ``chip_smoke.py``'s parity phases).
"""

import contextlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.dequant_matmul import (dequant_matmul,  # noqa: E402
                                                dequant_matmul_grouped)
from repro_torch.kernels.dequant_matmul import ops as dmops  # noqa: E402
from repro_torch.kernels.dequant_matmul.ref import (  # noqa: E402
    dequant_matmul_grouped_ref, dequant_matmul_grouped_scale_after,
    dequant_matmul_ref, dequant_matmul_scale_after)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL_FLASH_BF16 = 2e-2

pytestmark = pytest.mark.cuda


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("m,k,n", [(1, 300, 130), (3, 300, 130),
                                   (8, 1030, 257), (9, 300, 130),
                                   (130, 100, 70), (512, 4096, 4096),
                                   (512, 4096, 128256)])
def test_dequant_matmul_kernel_matches_plain(m, k, n):
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand(n, generator=g, device="cuda") * 0.01 + 1e-4
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.randn((m, k), generator=g, device="cuda").to(xdt)
        before = kernels.launch_counts()["dequant_matmul"]
        got = dequant_matmul(x, wq, sc)
        want = dequant_matmul_ref(x, wq, sc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["dequant_matmul"] == before + 1
        assert want.abs().max() > 0
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= 1e-4


def _dm_operands(m, k, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand(n, generator=g, device="cuda") * 0.01 + 1e-4
    x = torch.randn((m, k), generator=g, device="cuda")
    return x, wq, sc


@pytest.mark.parametrize("k,n", [(512, 256), (1030, 257)])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 31, 64,
                               100, 512])
def test_dequant_matmul_instances_match_plain(m, k, n):
    """M <= 8: the decode instance; above: the tensor-core one; each with
    K split over blocks (these shapes fill no wave unsplit), aligned
    (512, 256: 16-byte copies) and ragged (1030, 257: element-wise)."""
    _needs_card()
    x, wq, sc = _dm_operands(m, k, n, m * 31 + k + n)
    for xdt in (torch.float32, torch.bfloat16):
        xt = x.to(xdt)
        before = kernels.launch_counts()["dequant_matmul"]
        got = dequant_matmul(xt, wq, sc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["dequant_matmul"] == before + 1
        assert got.dtype == torch.float32 and got.shape == (m, n)
        assert torch.isfinite(got).all()
        assert _rel(got, dequant_matmul_ref(xt, wq, sc)) <= 1e-4
        assert _rel(got, dequant_matmul_scale_after(xt, wq, sc)) <= 1e-4


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_dequant_matmul_takes_x_off_a_16_byte_boundary(m, xdt):
    """Aligned K and N, but x starts one element off a 16-byte boundary:
    the tensor-core instance takes its element-wise loader."""
    _needs_card()
    dt = getattr(torch, xdt)
    _, wq, sc = _dm_operands(m, 256, 256, 5)
    buf = torch.randn(m * 256 + 1, device="cuda").to(dt)
    x = buf[1:].view(m, 256)
    assert x.data_ptr() % 16 != 0
    got = dequant_matmul(x, wq, sc)
    assert _rel(got, dequant_matmul_ref(x, wq, sc)) <= 1e-4


@pytest.mark.parametrize("m,k,n,xdt", [
    (4, 4096, 1024, "bfloat16"), (4, 4096, 1024, "float32"),
    (4, 2048, 102400, "float32"), (512, 4096, 1024, "bfloat16"),
    (512, 2048, 64, "float32"), (17, 1030, 257, "bfloat16"),
    (8, 16416, 256, "float32")])
def test_dequant_matmul_is_deterministic_and_graph_capturable(m, k, n, xdt):
    """Two calls give identical bits (a cluster sums the split-K partials
    in a fixed order), and a call captured in a CUDA graph and replayed
    gives the eager call's bits.  The last case has too long a K for the
    decode instance's x staging and takes the tensor cores at M = 8."""
    _needs_card()
    x, wq, sc = _dm_operands(m, k, n, m + k + n)
    x = x.to(getattr(torch, xdt))
    a = dequant_matmul(x, wq, sc)
    b = dequant_matmul(x, wq, sc)
    assert torch.equal(a, b)
    assert _rel(a, dequant_matmul_ref(x, wq, sc)) <= 1e-4
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dequant_matmul(x, wq, sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = dequant_matmul(x, wq, sc)
    for _ in range(2):
        c.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(c, a)


def test_dequant_matmul_instances_raise_and_never_take_the_plain_version(
        monkeypatch):
    """Without its library the wrapper raises for both instances; it never
    reaches the plain version, and counts no launch."""
    _needs_card()
    from repro_torch.kernels import _build

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    def missing(name):
        raise RuntimeError(f"nvcc not found: {name} cannot be built")
    monkeypatch.setattr(dmops, "dequant_matmul_ref", plain)
    monkeypatch.setattr(dmops, "_FNS", {})
    monkeypatch.setattr(_build, "load", missing)
    before = kernels.launch_counts()["dequant_matmul"]
    for m in (4, 64):
        for xdt in (torch.float32, torch.bfloat16):
            x, wq, sc = _dm_operands(m, 128, 128, m)
            with pytest.raises(RuntimeError, match="nvcc"):
                dmops.dequant_matmul(x.to(xdt), wq, sc)
    assert kernels.launch_counts()["dequant_matmul"] == before


def test_dequant_matmul_rejects_what_the_kernel_does_not_take():
    _needs_card()
    x = torch.randn(2, 64, device="cuda")
    wq = torch.zeros(64, 32, dtype=torch.int8, device="cuda")
    sc = torch.ones(32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        dequant_matmul(x, wq.t().contiguous().t(), sc)
    with pytest.raises(TypeError):
        dequant_matmul(x, wq.float(), sc)
    with pytest.raises(ValueError):
        dequant_matmul(x, wq.cpu(), sc)


@pytest.mark.parametrize("scale_form", ["shared", "per_expert"])
@pytest.mark.parametrize("e,m,k,n", [(4, 8, 160, 96), (3, 5, 70, 33),
                                     (2, 130, 300, 257), (4, 17, 256, 160),
                                     (64, 32, 2048, 1408),
                                     (64, 64, 1408, 2048), (2, 33, 132, 48),
                                     (3, 64, 1030, 130),
                                     (256, 32, 7168, 256),
                                     (256, 32, 2048, 896)])
def test_dequant_matmul_grouped_kernel_matches_plain(e, m, k, n, scale_form):
    """Both x types on the tensor cores (a f32 x by the bf16x3 split, on
    mma.sync up to 32 rows and on wgmma above): 16-byte copies at aligned
    shapes (K a multiple of 8 for a bf16 x, of 4 for a f32 x: (2, 33, 132,
    48) takes them for f32 only), element-wise loads at (3, 5, 70, 33),
    (2, 130, 300, 257) and (3, 64, 1030, 130); the 32-row M tile, which
    also takes M <= 16, the 64-row one, and several M tiles (M = 130);
    deepseek-v3-671b's 256 experts at its bank's K (7168 and 2048) and a
    reduced N (the plain version on the CPU would take 15 GB of f32 at
    the full N)."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(e + m + k + n)
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((n,) if scale_form == "shared" else (e, n), generator=g,
                    device="cuda") * 0.01 + 1e-4
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.randn((e, m, k), generator=g, device="cuda").to(xdt)
        before = kernels.launch_counts()["dequant_matmul_grouped"]
        got = dequant_matmul_grouped(x, wq, sc)
        want = dequant_matmul_grouped_ref(x, wq, sc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["dequant_matmul_grouped"] == \
            before + 1
        assert got.dtype == torch.float32 and got.shape == (e, m, n)
        assert want.abs().max() > 0
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= 1e-4
        # and the kernel's own order
        assert _rel(got, dequant_matmul_grouped_scale_after(x, wq, sc)) \
            <= 1e-4
        # the plain version on the CPU agrees as well
        assert _rel(got, dequant_matmul_grouped_ref(x.cpu(), wq.cpu(),
                                                    sc.cpu())) <= 1e-4


def test_dequant_matmul_grouped_rejects_and_never_takes_the_plain_version(
        monkeypatch):
    _needs_card()

    def plain(*args):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(dmops, "dequant_matmul_grouped_ref", plain)
    x = torch.randn(2, 4, 64, device="cuda")
    wq = torch.zeros(2, 64, 32, dtype=torch.int8, device="cuda")
    sc = torch.ones(32, device="cuda")
    before = kernels.launch_counts()["dequant_matmul_grouped"]
    with pytest.raises(TypeError, match="dtype"):
        dmops.dequant_matmul_grouped(x.half(), wq, sc)
    with pytest.raises(TypeError, match="int8"):
        dmops.dequant_matmul_grouped(x, wq.float(), sc)
    with pytest.raises(ValueError, match="scale"):
        dmops.dequant_matmul_grouped(x, wq, torch.ones(3, 32, device="cuda"))
    with pytest.raises(ValueError, match="cpu"):
        dmops.dequant_matmul_grouped(x, wq.cpu(), sc)
    with pytest.raises(ValueError, match="contiguous"):
        dmops.dequant_matmul_grouped(x, wq.transpose(1, 2).contiguous()
                                     .transpose(1, 2), sc)
    with pytest.raises(ValueError, match="E, M, K"):
        dmops.dequant_matmul_grouped(x[0], wq, sc)
    assert kernels.launch_counts()["dequant_matmul_grouped"] == before
    dmops.dequant_matmul_grouped(x, wq, sc)
    assert kernels.launch_counts()["dequant_matmul_grouped"] == before + 1


def test_grouped_tc_instance_takes_operands_off_a_16_byte_boundary():
    """Aligned shapes, but x starts 2 bytes off a 16-byte boundary: the
    tensor-core instance takes its element-wise loader."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(11)
    e, m, k, n = 2, 16, 128, 128
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((e, n), generator=g, device="cuda") * 0.01 + 1e-4
    buf = torch.randn(e * m * k + 1, generator=g, device="cuda").to(
        torch.bfloat16)
    x = buf[1:].view(e, m, k)
    assert x.data_ptr() % 16 != 0
    before = kernels.launch_counts()["dequant_matmul_grouped"]
    got = dequant_matmul_grouped(x, wq, sc)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dequant_matmul_grouped"] == before + 1
    assert _rel(got, dequant_matmul_grouped_ref(x, wq, sc)) <= 1e-4


@pytest.mark.parametrize("scale_form", ["shared", "per_expert"])
def test_grouped_f32_instance_takes_operands_off_a_16_byte_boundary(
        scale_form):
    """Aligned shapes, but a f32 x starts 4 bytes off a 16-byte boundary:
    the f32 instance (wgmma at M = 40) takes its element-wise loader."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(12)
    e, m, k, n = 3, 40, 256, 144
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((n,) if scale_form == "shared" else (e, n), generator=g,
                    device="cuda") * 0.01 + 1e-4
    buf = torch.randn(e * m * k + 1, generator=g, device="cuda")
    x = buf[1:].view(e, m, k)
    assert x.data_ptr() % 16 != 0
    before = kernels.launch_counts()["dequant_matmul_grouped"]
    got = dequant_matmul_grouped(x, wq, sc)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dequant_matmul_grouped"] == before + 1
    assert _rel(got, dequant_matmul_grouped_ref(x, wq, sc)) <= 1e-4


@pytest.mark.parametrize("h,g", [(32, 8), (16, 16), (4, 1), (24, 24),
                                 (28, 4)])
@pytest.mark.parametrize("s", [1, 100, 128, 257])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_tc_instance_matches_plain(d, s, h, g):
    """The bf16 (tensor-core) instance at every head dim it is built for,
    ragged S and every main-path group size (musicgen-medium's (24, 24),
    qwen2-vl-7b's rep-7 (28, 4))."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(s * 7 + d + h + g)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((2, s, h, d), (2, s, g, d),
                                      (2, s, g, d)))
    before = kernels.launch_counts()["flash_attention"]
    got = fops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    want = fops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert _rel(got, want) <= TOL_FLASH_BF16


@pytest.mark.parametrize("h,g", [(32, 8), (16, 16), (4, 1), (24, 24),
                                 (28, 4)])
@pytest.mark.parametrize("s", [1, 100, 128, 257])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_f32_instance_matches_plain(d, s, h, g):
    """The f32 (3xTF32 tensor-core) instance at every head dim it is built
    for, ragged S and every main-path group size, to 1e-4 of
    max|plain|."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(s * 5 + d + h + g)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((2, s, h, d), (2, s, g, d), (2, s, g, d)))
    before = kernels.launch_counts()["flash_attention"]
    got = fops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    want = fops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert _rel(got, want) <= 1e-4


def test_flash_f32_instance_takes_a_view_off_a_16_byte_boundary():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = 2 * 37 * 8 * 128
    buf = torch.randn(3 * n + 1, generator=gen, device="cuda")
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(2, 37, 8, 128)
               for i in range(3))
    assert q.data_ptr() % 16 != 0
    got = fops.flash_attention(q, k, v)
    want = fops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert _rel(got, want) <= 1e-4


def _graph_bits(fn):
    """fn()'s result from a CUDA-graph replay (after a warm-up on a side
    stream, as capture needs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = fn()
    c.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return c.clone()


@pytest.mark.parametrize("case", ["flash-16-16", "flash-32-8", "flash-d32",
                                  "grouped-m32", "grouped-m64",
                                  "grouped-ragged"])
def test_f32_instances_are_deterministic_and_graph_capturable(case):
    """The f32 instances of flash_attention and dequant_matmul_grouped: two
    calls give identical bits, and a graph replay gives the eager call's."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(len(case))
    if case.startswith("flash"):
        b, s, h, gg, d = {"flash-16-16": (4, 128, 16, 16, 128),
                          "flash-32-8": (4, 100, 32, 8, 128),
                          "flash-d32": (2, 45, 4, 2, 32)}[case]
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for shape in ((b, s, h, d), (b, s, gg, d), (b, s, gg, d)))

        def fn():
            return fops.flash_attention(q, k, v)
    else:
        e, m, k_, n = {"grouped-m32": (64, 32, 2048, 1408),
                       "grouped-m64": (64, 64, 1408, 2048),
                       "grouped-ragged": (3, 37, 1030, 130)}[case]
        wq = torch.randint(-127, 128, (e, k_, n), generator=g,
                           device="cuda", dtype=torch.int8)
        sc = torch.rand((e, n), generator=g, device="cuda") * 0.01 + 1e-4
        x = torch.randn((e, m, k_), generator=g, device="cuda")

        def fn():
            return dequant_matmul_grouped(x, wq, sc)
    a, b_ = fn(), fn()
    assert a.dtype == torch.float32
    assert torch.equal(a, b_)
    assert torch.equal(_graph_bits(fn), a)


def test_f32_instances_raise_and_never_take_the_plain_version(monkeypatch):
    """Without their libraries the f32 instances raise: a CUDA tensor never
    reaches the plain version, and no launch is counted."""
    _needs_card()
    from repro_torch.kernels import _build

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    def missing(name):
        raise RuntimeError(f"nvcc not found: {name} cannot be built")
    monkeypatch.setattr(dmops, "dequant_matmul_grouped_ref", plain)
    monkeypatch.setattr(fops, "flash_attention_ref", plain)
    monkeypatch.setattr(dmops, "_FNS", {})
    monkeypatch.setattr(fops, "_FN", None)
    monkeypatch.setattr(_build, "load", missing)
    before = kernels.launch_counts()
    x = torch.randn(2, 32, 256, device="cuda")
    wq = torch.zeros(2, 256, 128, dtype=torch.int8, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        dmops.dequant_matmul_grouped(x, wq, torch.ones(128, device="cuda"))
    q = torch.randn((1, 16, 4, 128), device="cuda")
    kv = torch.randn((1, 16, 2, 128), device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        fops.flash_attention(q, kv, kv)
    assert kernels.launch_counts() == before


def test_tc_instances_raise_and_never_take_the_plain_version(monkeypatch):
    _needs_card()

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(dmops, "dequant_matmul_grouped_ref", plain)
    monkeypatch.setattr(fops, "flash_attention_ref", plain)
    x = torch.randn(2, 5, 70, device="cuda").to(torch.bfloat16)
    wq = torch.zeros(2, 70, 33, dtype=torch.int8, device="cuda")
    sc = torch.ones(33, device="cuda")
    before = kernels.launch_counts()
    with pytest.raises(TypeError, match="int8"):
        dmops.dequant_matmul_grouped(x, wq.float(), sc)
    with pytest.raises(ValueError, match="scale"):
        dmops.dequant_matmul_grouped(x, wq, torch.ones(3, 33, device="cuda"))
    with pytest.raises(ValueError, match="cpu"):
        dmops.dequant_matmul_grouped(x, wq.cpu(), sc)
    q = torch.zeros((1, 8, 4, 128), device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fops.flash_attention(q[..., :96].contiguous(),
                             kv[..., :96].contiguous(),
                             kv[..., :96].contiguous())
    with pytest.raises(TypeError, match="dtype"):
        fops.flash_attention(q, kv.float(), kv)
    with pytest.raises(ValueError, match="divide"):
        fops.flash_attention(q, kv[:, :, :1].expand(1, 8, 3, 128)
                             .contiguous(), kv[:, :, :1].expand(
                                 1, 8, 3, 128).contiguous())
    with pytest.raises(ValueError, match="cpu"):
        fops.flash_attention(q, kv.cpu(), kv)
    assert kernels.launch_counts() == before
    dmops.dequant_matmul_grouped(x, wq, sc)
    fops.flash_attention(q, kv, kv)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["dequant_matmul_grouped"] == \
        before["dequant_matmul_grouped"] + 1
    assert after["flash_attention"] == before["flash_attention"] + 1


def test_moe_prefill_routes_through_the_grouped_kernel():
    """Smoke deepseek-moe-16b on q8: every routed-expert product launches
    the grouped kernel, the router, shared experts, attention, dense layer
    and head the dense one, and the tokens equal the CPU's."""
    _needs_card()
    from repro_torch import configs
    from repro_torch.compression.tree import flatten_tree, unflatten
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.quantized import quantize_tree_q8
    cfg = configs.get("deepseek-moe-16b", smoke=True)
    p_cpu = quantize_tree_q8(init_params(cfg, 0, device="cpu"))
    p = unflatten({k: v.cuda() for k, v in flatten_tree(p_cpu).items()})
    toks = torch.randint(0, cfg.vocab_size, (3, 9),
                         generator=torch.Generator().manual_seed(0))
    kernels.reset_launch_counts()
    kernels.clear_dispatch_report()
    lo, caches = prefill(p, cfg, tokens=toks.cuda(), max_len=12)
    nd, nm = cfg.first_dense_layers, cfg.num_layers - cfg.first_dense_layers
    assert kernels.launch_counts() == {
        "dequant_matmul": 7 * nd + 8 * nm + 1,
        "dequant_matmul_grouped": 3 * nm,
        "flash_attention": cfg.num_layers, "rd_quant": 0}
    assert sorted(caches) == ["dense", "main"]
    assert kernels.dispatch_report() == []
    want, _ = prefill(p_cpu, cfg, tokens=toks, max_len=12)
    assert _rel(lo, want) <= 1e-3
    assert torch.equal(lo.argmax(-1).cpu(), want.argmax(-1))


@pytest.mark.parametrize("s,d,h,g", [(128, 128, 32, 8), (100, 128, 32, 8),
                                     (128, 128, 16, 16),
                                     (7, 32, 4, 2), (33, 32, 8, 8),
                                     (128, 80, 32, 32), (100, 80, 32, 32),
                                     (37, 80, 8, 2)])
def test_flash_kernel_matches_plain(s, d, h, g):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((2, s, h, d), (2, s, g, d), (2, s, g, d)))
        before = kernels.launch_counts()["flash_attention"]
        got = fops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["flash_attention"] == before + 1
        want = fops.flash_attention(q.cpu(), k.cpu(), v.cpu())
        assert got.dtype == dt and got.shape == q.shape
        assert _rel(got, want) <= tol


def test_flash_kernel_raises_on_a_head_dim_it_was_not_built_for():
    """96 (no model's, not built): the wrapper raises, the router does
    not fall back."""
    _needs_card()
    q = torch.zeros((1, 8, 2, 96), device="cuda")
    kv = torch.zeros((1, 8, 1, 96), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fops.flash_attention(q, kv, kv)
    qpos = torch.arange(8, device="cuda")[None]
    with pytest.raises(ValueError, match="head dim"):
        kernels.get("flash_attention")(q, kv, kv, qpos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_quantization_on_card_equals_cpu_bit_for_bit(dtype):
    """Levels and scales do not depend on where the tree is quantized (a
    scalar divide, which CUDA turns into a product with the reciprocal,
    moves scales by an ulp and flips levels on a rounding edge)."""
    _needs_card()
    from repro_torch.compression import flatten_tree, quantize_tree_q8
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    raw = {"layers": {"w": torch.randn((3, 1024, 513), generator=g).to(dt)},
           "head": torch.randn((1000, 2051), generator=g).to(dt)}
    want = flatten_tree(quantize_tree_q8(raw))
    got = flatten_tree(quantize_tree_q8(
        {"layers": {"w": raw["layers"]["w"].cuda()},
         "head": raw["head"].cuda()}))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert torch.equal(got[name].cpu(), want[name]), name


def test_kv_cache_quantization_on_card_equals_cpu():
    _needs_card()
    from repro_torch.serve.quantized import quantize_cache_value
    x = torch.randn((4, 64, 8, 32), generator=torch.Generator().manual_seed(2))
    for delta in (1.0 / 16.0, 0.0371):
        assert torch.equal(quantize_cache_value(x.cuda(), delta).cpu(),
                           quantize_cache_value(x, delta))


@pytest.mark.parametrize("dtype,sq,skv,d", [
    ("float32", 20, 45, 32), ("bfloat16", 20, 45, 32),
    ("bfloat16", 1, 9, 128), ("bfloat16", 64, 200, 128),
    ("bfloat16", 100, 257, 32), ("float32", 1, 9, 128),
    ("float32", 64, 200, 128), ("float32", 100, 257, 32)])
def test_flash_kernel_skv_longer_than_sq(dtype, sq, skv, d):
    _needs_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((2, sq, 4, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((2, skv, 2, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((2, skv, 2, d), generator=gen, device="cuda").to(dt)
    got = fops.flash_attention(q, k, v)
    want = fops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert _rel(got, want) <= (1e-4 if dt == torch.float32
                               else TOL_FLASH_BF16)


def test_flash_tc_instance_takes_a_view_off_a_16_byte_boundary():
    """The wrapper copies a bf16 operand whose rows do not start on a
    16-byte boundary (the kernel stages rows with 16-byte copies)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 2 * 33 * 4 * 128
    buf = torch.randn(3 * n + 1, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(2, 33, 4, 128)
               for i in range(3))
    assert q.data_ptr() % 16 != 0
    got = fops.flash_attention(q, k, v)
    want = fops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert _rel(got, want) <= TOL_FLASH_BF16


def test_prefill_routes_to_the_kernel_and_decode_does_not():
    _needs_card()
    from repro_torch import configs
    from repro_torch.models.transformer import decode_step, init_params, \
        prefill
    from repro_torch.serve.quantized import quantize_tree_q8
    cfg = configs.get("llama3-8b", smoke=True)
    p = quantize_tree_q8(init_params(cfg, 0, device="cuda"))
    toks = torch.randint(0, cfg.vocab_size, (3, 9), device="cuda")
    kernels.reset_launch_counts()
    kernels.clear_dispatch_report()
    lo, caches = prefill(p, cfg, tokens=toks, max_len=12)
    assert kernels.launch_counts() == {
        "dequant_matmul": 7 * cfg.num_layers + 1,
        "dequant_matmul_grouped": 0,
        "flash_attention": cfg.num_layers, "rd_quant": 0}
    decode_step(p, cfg, caches, torch.full((3,), 9, device="cuda"),
                tokens=lo.argmax(-1))
    assert kernels.launch_counts()["flash_attention"] == cfg.num_layers
    assert kernels.dispatch_report() == []


def test_chip_smoke_parity_phase_on_card():
    _needs_card()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", cs)
    spec.loader.exec_module(cs)
    res = cs.phase_parity(torch.device("cuda"))
    assert res["tokens_identical"]
    np.testing.assert_array_less(res["logits_rel_diff"], 1e-3)


def _rd_inputs(n, dt, seed, window=4, fisher=False):
    from repro_torch.compression.rd_search import nearest_level_f64
    from repro_torch.core.rate_model import estimate_bin_probs_torch
    from repro_torch.kernels.rd_quant.coeffs import pack_coeffs
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn(n, generator=g, device="cuda") * 0.05).to(dt)
    w[torch.rand(n, generator=g, device="cuda") < 0.3] = 0
    step = 0.008
    nn, amax = nearest_level_f64(w, step)
    sc, mg = pack_coeffs(estimate_bin_probs_torch(nn))
    f = (torch.rand(n, generator=g, device="cuda") * 3 if fisher else None)
    return w, f, sc, mg, dict(step=step, lam=2e-4, window=window,
                              max_level=amax + window + 1, num_gr=10,
                              passes=2)


@pytest.mark.parametrize("n,dtype,window,fisher", [
    (1, "float32", 4, False), (1023, "float32", 1, True),
    (70001, "bfloat16", 8, False), (4096 * 1024 + 3, "bfloat16", 4, True),
    (4096 * 14336, "bfloat16", 4, False)])
def test_rd_quant_kernel_equals_plain(n, dtype, window, fisher):
    _needs_card()
    from repro_torch.kernels.rd_quant.ops import rd_quant_cuda
    from repro_torch.kernels.rd_quant.ref import rd_quant_ref
    w, f, sc, mg, kw = _rd_inputs(n, getattr(torch, dtype), n, window,
                                  fisher)
    before = kernels.launch_counts()["rd_quant"]
    got = rd_quant_cuda(w, f, sc, mg, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rd_quant"] == before + kw["passes"]
    want = rd_quant_ref(w, f, sc, mg, **kw)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, want)
    if n < 1 << 20:       # and the plain version on the CPU agrees
        assert torch.equal(got.cpu(), rd_quant_ref(
            w.cpu(), None if f is None else f.cpu(), sc, mg, **kw))


def test_rd_quant_kernel_rejects_what_it_does_not_take():
    """No fallback: a CUDA tensor the kernel cannot take raises."""
    _needs_card()
    from repro_torch.kernels.rd_quant.ops import rd_quant_cuda
    w, f, sc, mg, kw = _rd_inputs(1000, torch.float32, 1)
    before = kernels.launch_counts()["rd_quant"]
    with pytest.raises(TypeError, match="dtype"):
        rd_quant_cuda(w.half(), None, sc, mg, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rd_quant_cuda(w.reshape(10, 100).t(), None, sc, mg, **kw)
    with pytest.raises(ValueError, match="2\\^24"):
        rd_quant_cuda(w, None, sc, mg, **dict(kw, max_level=1 << 24))
    with pytest.raises(ValueError, match="fisher"):
        rd_quant_cuda(w, torch.ones(1000), sc, mg, **kw)
    assert kernels.launch_counts()["rd_quant"] == before


@pytest.mark.parametrize("n,dtype", [(70001, "bfloat16"),
                                     (4096 * 1024 + 3, "float32")])
def test_rd_quant_levels_do_not_depend_on_blocks_per_sm(n, dtype):
    """The grid cap is the kernel's tunable knob: every value the tuner
    tries gives the plain version's levels exactly."""
    _needs_card()
    from repro_torch.kernels.rd_quant.ops import rd_quant_cuda
    from repro_torch.kernels.rd_quant.ref import rd_quant_ref
    w, f, sc, mg, kw = _rd_inputs(n, getattr(torch, dtype), n, 4, False)
    want = rd_quant_ref(w, f, sc, mg, **kw)
    for b in kernels.spec("rd_quant").tile_space["blocks_per_sm"] + (1,):
        assert torch.equal(rd_quant_cuda(w, f, sc, mg, blocks_per_sm=b,
                                         **kw), want), b
    with pytest.raises(RuntimeError, match="launch failed"):
        rd_quant_cuda(w, f, sc, mg, blocks_per_sm=0, **kw)


@pytest.mark.parametrize("shape", [(4, 7168, 64, "bfloat16"),
                                   (3, 1030, 257, "float32"),
                                   (40, 512, 384, "bfloat16")])
def test_dequant_matmul_autotune_on_the_card(shape, tmp_path,
                                              monkeypatch):
    """A small sweep: every candidate (decode and tensor-core tiles, each
    K split count) is within 1e-4 of the plain version, the winner is
    persisted and a plan of the op reads it back."""
    _needs_card()
    from repro_torch.kernels import tune
    from repro_torch.kernels.dequant_matmul import ops
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    seen = []

    def verify(shp, tiles, out):
        (x, wq, sc), _ = ops._example_inputs(shp, "cuda")
        assert _rel(out, dequant_matmul_ref(x, wq, sc)) <= 1e-4, tiles
        seen.append(tiles)

    res = tune.autotune("dequant_matmul", [shape], repeats=2,
                        verify=verify)
    (r,) = res.values()
    m, k, n = shape[:3]
    s = {"m": m, "k": k, "n": n, "sms": ops._sms(torch.device("cuda"))}
    assert r["configs"] == len(seen) >= 2
    assert r["default_tiles"] == ops.default_tiles(s)
    assert r["tiles"] in seen and all(ops.tile_ok(s, t) for t in seen)
    assert r["time_us"] <= r["default_time_us"]
    assert any(t["bm"] <= ops.DECODE_MAX_M for t in seen) == (m <= 8)
    assert (tmp_path / "tune.json").exists()
    x, wq, sc = ops._example_inputs(shape, "cuda")[0]
    plan = kernels.get("dequant_matmul").plan(x, wq, sc)
    assert plan.cache_hit and dict(plan.tiles) == r["tiles"]
    # the winner through the public wrapper, and a knob the launch does
    # not take raises (no fallback)
    got = dequant_matmul(x, wq, sc, **r["tiles"])
    assert _rel(got, dequant_matmul_ref(x, wq, sc)) <= 1e-4
    with pytest.raises(RuntimeError, match="launch failed"):
        dequant_matmul(x, wq, sc, kc=32 if m > 8 else 48, bm=128)


def test_container_round_trip_on_card():
    """Smoke tree: the deepcabac-rd container encoded from the card (the
    kernel) equals the CPU's (the plain version) byte for byte, and serves
    on the card the CPU's greedy tokens."""
    _needs_card()
    from repro_torch import compression, configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine
    cfg = configs.get("llama3-8b", smoke=True)
    tree = init_params(cfg, 3, device="cpu")
    leaves = {k: v for k, v in compression.flatten_tree(tree).items()
              if v.dim() >= 2}
    policy = {"format": "repro-tensor-policy", "version": 1, "rules": {
        k: {"step": compression.relative_step(v, 0.006), "lam": 1e-5}
        for k, v in leaves.items()}}
    codec = compression.get("deepcabac-rd", policy_table=policy)
    kernels.reset_launch_counts()
    blob = codec.compress({k: v.cuda() for k, v in
                           compression.flatten_tree(tree).items()}).blob
    assert kernels.launch_counts()["rd_quant"] == 4 * len(leaves)
    cpu_blob = compression.get("deepcabac-rd", policy_table=policy,
                               assign="kernel").compress(tree).blob
    assert blob == cpu_blob
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 7))
    got = ServeEngine.from_compressed(cfg, blob, max_len=16,
                                      device="cuda").generate(prompts, 5)
    want = ServeEngine.from_compressed(cfg, blob, max_len=16,
                                       device="cpu").generate(prompts, 5)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the compiled serving step: CUDA graphs of prefill and decode
# ---------------------------------------------------------------------------

def _serve_modes(arch, dtype, requests=7):
    """The smoke model on q8 served twice on the card, under
    ``eager_steps()`` and with graphs: 7 requests over 3 slots, greedy and
    sampled, of lengths that admit 3, 2 and 1 rows, padded (dense, bucket
    8) and plain, evicted at different lengths so slots refill.  Returns
    {mode: (tokens, launch counts, dispatch report, graph stats)}."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.quantized import quantize_tree_q8
    from repro_torch.serve.session import (ServeConfig, ServeSession,
                                           eager_steps)
    cfg = configs.get(arch, smoke=True).replace(param_dtype=dtype,
                                                compute_dtype=dtype)
    params = quantize_tree_q8(init_params(cfg, 0, device="cuda"))
    dense = cfg.family == "dense"
    scfg = ServeConfig(slots=3, max_len=24,
                       prefill_buckets=(8,) if dense else ())
    rng = np.random.default_rng(4)
    lens = (5, 5, 8, 5, 8, 5, 5) if dense else (5,) * 7
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens[:requests]]
    new = (3, 6, 4, 5, 2, 6, 4)
    temps = (0.0, 0.8, 0.0, 0.0, 0.8, 0.0, 0.0)
    out = {}
    for mode in ("eager", "graph"):
        sess = ServeSession(cfg, params, backend="q8", device="cuda",
                            serve_cfg=scfg)
        kernels.reset_launch_counts()
        kernels.clear_dispatch_report()
        hs = [sess.submit(p, max_new_tokens=n, temperature=t, seed=i)
              for i, (p, n, t) in enumerate(zip(prompts, new, temps))]
        if mode == "eager":
            with eager_steps():
                sess.run()
        else:
            sess.run()
        out[mode] = ([h.tokens for h in hs], kernels.launch_counts(),
                     kernels.dispatch_report(), dict(sess.graphs.stats))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b",
                                  "qwen3-8b", "deepseek-v3-671b"])
def test_graph_session_equals_the_eager_session(arch, dtype):
    """Bit for bit: a replay runs the eager step's kernels on the same
    inputs, so every logit and every token is the same; launch counts too
    (each replay credits its capture's), and the report stays empty but
    for MLA's prefills, whose d != dv takes the scan (recorded, as the
    reference records it)."""
    _needs_card()
    out = _serve_modes(arch, dtype)
    eager, graph = out["eager"], out["graph"]
    assert graph[0] == eager[0]
    assert graph[1] == eager[1]
    assert graph[1]["dequant_matmul"] > 0
    if arch == "deepseek-v3-671b":
        assert graph[1]["flash_attention"] == 0
        for rec in eager[2] + graph[2]:
            assert (rec["op"], rec["kind"], rec["reason"]) == (
                "flash_attention", "fallback", "d != dv (48 != 32)")
        assert eager[2] and graph[2]
    else:
        assert graph[1]["flash_attention"] > 0
        assert eager[2] == graph[2] == []
    if arch.startswith("deepseek"):
        assert graph[1]["dequant_matmul_grouped"] > 0
    assert eager[3] == {"eager": 0, "captures": 0, "replays": 0}
    assert graph[3]["captures"] >= 2 and graph[3]["replays"] >= 10


def test_a_failed_capture_raises_and_never_runs_eagerly(monkeypatch):
    """A decode step that cannot be captured fails its tick, and the next
    one: the session does not carry on with the eager step."""
    _needs_card()
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import session as smod
    cfg = configs.get("llama3-8b", smoke=True)
    sess = smod.ServeSession(cfg, init_params(cfg, 0, device="cuda"),
                             backend="q8", device="cuda",
                             serve_cfg=smod.ServeConfig(slots=2, max_len=16))
    real = smod.decode_step

    def decode_step(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("this step cannot be captured")
        return real(*args, **kw)

    monkeypatch.setattr(smod, "decode_step", decode_step)
    sess.submit(np.arange(5, dtype=np.int32), max_new_tokens=8)
    sess.step()                            # prefill and decode, eager
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cannot be captured"):
            sess.step()
    assert sess.graphs.stats == {"eager": 2, "captures": 0, "replays": 0}


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b"])
def test_graphs_of_many_prompt_lengths_keep_memory_bounded(arch):
    """Every prompt length is a prefill shape with a graph of its own, and
    a graph keeps no output: the prefill writes into the slot caches and
    the logits buffer.  After 12 more lengths, each served twice (eagerly,
    then captured and replayed), the memory in use has grown by less than
    one row's KV cache (the graphs' input buffers only; a graph that kept
    its prefill's caches would add one per length), and the peak is still
    the first, longest length's."""
    _needs_card()
    from repro_torch import configs
    from repro_torch.compression.tree import flatten_tree
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serve.session import ServeConfig, ServeSession
    cfg = configs.get(arch, smoke=True)
    max_len = 512
    sess = ServeSession(cfg, init_params(cfg, 0, device="cuda"),
                        backend="q8", device="cuda",
                        serve_cfg=ServeConfig(slots=1, max_len=max_len))
    row_cache = sum(t.numel() * t.element_size() for t in flatten_tree(
        init_cache(cfg, 1, max_len, device="cpu")).values())
    rng = np.random.default_rng(0)

    def serve(n):
        for _ in range(2):             # evicted at admission: prefill only
            sess.submit(rng.integers(0, cfg.vocab_size, (n,)),
                        max_new_tokens=1)
            sess.step()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serve(64)
    peak_first = torch.cuda.max_memory_allocated()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for n in range(40, 52):
        serve(n)
    assert sess.graphs.stats == {"eager": 13, "captures": 13, "replays": 13}
    assert torch.cuda.memory_allocated() - base < row_cache
    assert torch.cuda.max_memory_allocated() - peak_first < row_cache


# ---------------------------------------------------------------------------
# autograd: the kernel has no backward, so a gradient never meets it
# ---------------------------------------------------------------------------

def test_flash_kernel_raises_on_inputs_that_require_grad():
    _needs_card()
    q = torch.randn(1, 16, 4, 32, device="cuda", requires_grad=True)
    k = torch.randn(1, 16, 2, 32, device="cuda")
    v = torch.randn(1, 16, 2, 32, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        fops._flash_cuda(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        fops.flash_attention(q, k, v)
    with torch.no_grad():                    # nothing to differentiate
        fops._flash_cuda(q, k, v)


def test_attention_under_grad_takes_the_scan_and_matches_the_cpu():
    """A call that autograd differentiates routes to the scan on the card
    (no launch, nothing recorded) and its gradients equal the CPU's; the
    same call without grad still launches the kernel."""
    _needs_card()
    g = torch.Generator().manual_seed(8)
    qc, kc, vc = (torch.randn(shape, generator=g) for shape in (
        (2, 24, 4, 32), (2, 24, 2, 32), (2, 24, 2, 32)))
    qpos = torch.arange(24)[None].expand(2, 24)
    grads = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (t.to(dev).requires_grad_(True) for t in (qc, kc, vc))
        kernels.reset_launch_counts()
        kernels.clear_dispatch_report()
        out = kernels.get("flash_attention")(q, k, v, qpos.to(dev),
                                             kv_block=16)
        (out * out).sum().backward()
        assert kernels.launch_counts()["flash_attention"] == 0
        assert kernels.dispatch_report() == []
        grads[dev] = [t.grad.cpu() for t in (q, k, v)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel(got, want) <= 1e-4
    kernels.reset_launch_counts()
    q, k, v = (t.detach().cuda() for t in (qc, kc, vc))
    kernels.get("flash_attention")(q, k, v, qpos.cuda(),
                                   qpos_canonical=True)
    assert kernels.launch_counts()["flash_attention"] == 1


def test_fisher_for_on_the_card_matches_the_cpu():
    """The empirical FIM of the smoke models (f32) on the card against the
    CPU, per leaf within 1e-4 of max|F|: gradients reach wq, wk and wv,
    and no kernel is launched (the model's float weights take torch
    products; attention under grad takes the scan)."""
    _needs_card()
    from repro_torch import configs
    from repro_torch.compression.rd_search import fisher_for
    from repro_torch.compression.tree import flatten_tree, unflatten
    from repro_torch.models.transformer import init_params
    for arch in ("llama3-8b", "deepseek-moe-16b"):
        cfg = configs.get(arch, smoke=True)
        cpu = init_params(cfg, 0, device="cpu")
        card = unflatten({k: v.cuda() for k, v in flatten_tree(cpu).items()})
        kernels.reset_launch_counts()
        kernels.clear_dispatch_report()
        f_card = flatten_tree(fisher_for(cfg, card, batches=2))
        assert sum(kernels.launch_counts().values()) == 0
        assert kernels.dispatch_report() == []
        f_cpu = flatten_tree(fisher_for(cfg, cpu, batches=2))
        for name, want in f_cpu.items():
            assert f_card[name].is_cuda
            assert _rel(f_card[name], want) <= 1e-4, (arch, name)
        for name in ("wq", "wk", "wv"):
            assert float(f_card[f"layers/attn/{name}"].abs().max()) > 0


def test_rd_sweep_on_the_card_reproduces_its_policy_bytes():
    """rd_sweep on the card (smoke llama3-8b, bf16: the bf16 flash
    instance at every proxy prefill, rd_quant for every lambda > 0
    assignment): the policy re-applied through the registry gives the
    swept container's bytes, and the launches are the predicted ones."""
    _needs_card()
    from repro_torch import compression, configs
    from repro_torch.compression.rd_search import RDSearchConfig, rd_sweep
    from repro_torch.models.transformer import init_params
    cfg = configs.get("llama3-8b", smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    params = init_params(cfg, 0, device="cuda")
    search = RDSearchConfig(delta_rels=(1e-3, 6e-3), lambdas=(0.0, 1e-5),
                            prompts=2, prompt_len=8, decode_steps=4,
                            fim_batches=1, min_ndim=3)
    kernels.reset_launch_counts()
    kernels.clear_dispatch_report()
    res = rd_sweep(cfg, params, search)
    counts = kernels.launch_counts()
    assert kernels.dispatch_report() == []
    blob = compression.get("deepcabac-rd", policy_table=res.policy,
                           min_ndim=3).compress(params).blob
    assert len(blob) == res.policy_bytes
    n_cov = 7                  # wq, wk, wv, wo, w_gate, w_up, w_down
    measures = len(res.points) + 1 + (res.refined_tensors > 0
                                      or res.reverted)
    assert counts["flash_attention"] == 2 * cfg.num_layers * (1 + measures)
    per = 4                    # (1 + 1 refinement) x 2 passes
    lam_pos = sum(lam > 0 for lam in search.lambdas) * len(
        search.delta_rels)
    winner = per * n_cov * (res.winner.lam > 0)
    want = (per * n_cov * lam_pos
            + winner * (1 + len(search.refine_factors))
            + winner * ((res.refined_tensors > 0 or res.reverted) + 1))
    assert counts["rd_quant"] == want


def _swap_chain(root):
    """A keyframe and two P-frames of the llama3-8b smoke model (seeded
    init, two multiplicative drifts), written by the port's manager."""
    from repro_torch import compression, configs
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.models.transformer import init_params
    cfg = configs.get("llama3-8b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    mgr = CheckpointManager(CheckpointConfig(
        str(root), codec="deepcabac-delta", delta_every=4, keep=10))
    rng = np.random.default_rng(0)
    for step in (1, 2, 3):
        if step > 1:
            for v in compression.flatten_tree(params).values():
                v.mul_(torch.from_numpy(
                    1 + 1e-3 * rng.standard_normal(tuple(v.shape))).float())
        mgr.save({"params": params, "step": np.int32(step)}, step)
    dirs = [str(root / f"step_{s:08d}") for s in (1, 2, 3)]
    with open(f"{dirs[0]}/params.dcbc", "rb") as f:
        return cfg, f.read(), dirs


def test_swap_under_graph_replay_equals_eager_and_cpu(tmp_path):
    """Two P-frames swapped into a q8 session with two requests in flight:
    from graphs (no capture after a swap) the leaves and tokens equal the
    eager session's bit for bit, and the tokens equal the CPU's."""
    _needs_card()
    from repro_torch import compression
    from repro_torch.serve.backends import get_backend
    from repro_torch.serve.session import (ServeConfig, ServeSession,
                                           eager_steps)
    cfg, kf_blob, dirs = _swap_chain(tmp_path)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6))
    out = {}
    for mode, device in (("graph", "cuda"), ("eager", "cuda"),
                         ("cpu", "cpu")):
        sess = ServeSession(cfg, kf_blob,
                            backend=get_backend("q8", track_levels=True),
                            serve_cfg=ServeConfig(slots=2, max_len=32),
                            device=device)
        hs = [sess.submit(p.astype(np.int32), max_new_tokens=12)
              for p in prompts]
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            for _ in range(3):
                sess.step()
            caps = sess.graphs.stats["captures"]
            sess.swap_weights(dirs[1])
            for _ in range(3):
                sess.step()
            sess.swap_weights(dirs[2])
            sess.run()
        assert sess.graphs.stats["captures"] == caps
        out[mode] = ([h.tokens for h in hs],
                     {k: v.cpu() for k, v in
                      compression.flatten_tree(sess.params).items()},
                     dict(sess.graphs.stats))
    graph, eager, cpu = out["graph"], out["eager"], out["cpu"]
    assert graph[2]["captures"] == 1 and graph[2]["replays"] >= 10
    assert graph[0] == eager[0] == cpu[0]
    for k, v in eager[1].items():
        assert torch.equal(graph[1][k], v), k
        if k.endswith(("/q8", "/q8s")):
            assert torch.equal(cpu[1][k], v), k


# ---------------------------------------------------------------------------
# the other dense variants and MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_block_on_the_card_matches_the_cpu(dtype):
    """deepseek-v3-671b's smoke MLA block (q8 projections, int8 latent
    cache): prefill, then a ragged decode step, on the card and on the
    CPU from the same tensors.  Both take the scan at prefill (d != dv)
    and the naive path at decode; the projections go through
    dequant_matmul on the card.  f32 to 1e-4 of max|cpu|; bf16 to
    TOL_FLASH_BF16 (bf16 activations rounded in other places)."""
    _needs_card()
    from repro_torch import configs
    from repro_torch.compression.tree import flatten_tree, unflatten
    from repro_torch.models.attention import mla_attention
    from repro_torch.models.transformer import _layer_slice, init_params
    from repro_torch.serve.quantized import quantize_tree_q8
    dt = getattr(torch, dtype)
    cfg = configs.get("deepseek-v3-671b", smoke=True).replace(
        q8_cache=True, param_dtype=dtype, compute_dtype=dtype)
    p_cpu = _layer_slice(quantize_tree_q8(init_params(cfg, 0, device="cpu"))
                         ["layers"]["attn"], 0)
    p_gpu = unflatten({k: v.cuda() for k, v in
                       flatten_tree(p_cpu).items()})
    g = torch.Generator().manual_seed(3)
    b, s, max_len = 3, 9, 16
    x = torch.randn((b, s, cfg.d_model), generator=g).to(dt)
    x1 = torch.randn((b, 1, cfg.d_model), generator=g).to(dt)
    cp = torch.tensor([9, 4, 7])
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = {"ckv": torch.zeros((b, max_len, cfg.kv_lora_rank),
                                    dtype=torch.int8, device=dev),
                 "kr": torch.zeros((b, max_len, cfg.qk_rope_head_dim),
                                   dtype=torch.int8, device=dev)}
        pos = torch.arange(s, device=dev).expand(b, s)
        kernels.reset_launch_counts()
        y, cache = mla_attention(x.to(dev), p, cfg, pos, cache=cache,
                                 qpos_canonical=True)
        y1, cache = mla_attention(x1.to(dev), p, cfg,
                                  cp.to(dev)[:, None], cache=cache,
                                  cache_pos=cp.to(dev))
        out[dev] = (y.cpu(), y1.cpu(), {k: v.cpu() for k, v in
                                        cache.items()},
                    kernels.launch_counts())
    tol = 1e-4 if dtype == "float32" else TOL_FLASH_BF16
    for i in (0, 1):
        assert torch.isfinite(out["cuda"][i].float()).all()
        assert _rel(out["cuda"][i], out["cpu"][i]) <= tol
    for name in ("ckv", "kr"):               # int8 levels: at most one step
        d = (out["cuda"][2][name].int() - out["cpu"][2][name].int()).abs()
        assert int(d.max()) <= 1
    # 7 projections a call, w_dq .. wo; attention never reaches the kernel
    assert out["cuda"][3]["dequant_matmul"] == 14
    assert out["cuda"][3]["flash_attention"] == 0


@pytest.mark.parametrize("sq,skv", [(128, 128), (50, 113), (16, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_d80_instances_with_ragged_and_offset_queries(dtype, sq, skv):
    """The D = 80 instances (zamba2-2.7b's head dim: 5 k16 steps, 10 n8
    blocks of the output) where queries sit at the end of a longer key
    range and neither length is a multiple of a tile."""
    _needs_card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(sq * skv)
    q = torch.randn((2, sq, 8, 80), generator=g, device="cuda").to(dt)
    k = torch.randn((2, skv, 4, 80), generator=g, device="cuda").to(dt)
    v = torch.randn((2, skv, 4, 80), generator=g, device="cuda").to(dt)
    got = fops.flash_attention(q, k, v)
    want = fops.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert got.dtype == dt and got.shape == q.shape
    tol = 1e-4 if dtype == "float32" else TOL_FLASH_BF16
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_smoke_model_on_card_matches_cpu(arch, dtype):
    """The SSM and hybrid smoke models on q8: prefill (the chunked scan),
    then decode steps through the recurrence, on the card and on the CPU
    from the same tensors, both fed the CPU's greedy tokens; the head (and
    the hybrid's shared block) through dequant_matmul, the hybrid's prefill
    attention through the flash kernel.  Logits within 1e-3 of max|cpu| in
    f32 and 2e-2 in bf16 (rounded at other places); the f32 argmax equal
    (in bf16 a near tie may part)."""
    _needs_card()
    from repro_torch import configs
    from repro_torch.compression.tree import flatten_tree, unflatten
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)
    from repro_torch.serve.quantized import quantize_tree_q8
    cfg = configs.get(arch, smoke=True).replace(param_dtype=dtype,
                                                compute_dtype=dtype)
    p_cpu = quantize_tree_q8(init_params(cfg, 0, device="cpu"))
    p = unflatten({k: v.cuda() for k, v in flatten_tree(p_cpu).items()})
    toks = torch.randint(0, cfg.vocab_size, (3, 21),
                         generator=torch.Generator().manual_seed(1))
    out, fed = {}, []
    for dev, params in (("cpu", p_cpu), ("cuda", p)):
        kernels.reset_launch_counts()
        lo, caches = prefill(params, cfg, tokens=toks.to(dev), max_len=26)
        los = [lo]
        for i in range(4):
            if dev == "cpu":
                fed.append(lo.argmax(-1))
            lo, caches = decode_step(params, cfg, caches, 21 + i,
                                     tokens=fed[i].to(dev))
            los.append(lo)
        out[dev] = ([x.float().cpu() for x in los], kernels.launch_counts())
    groups = (cfg.num_layers // cfg.shared_attn_every
              if cfg.family == "hybrid" else 0)
    assert out["cuda"][1]["dequant_matmul"] == 5 * (7 * groups + 1)
    assert out["cuda"][1]["flash_attention"] == groups
    for got, want in zip(*(out[d][0] for d in ("cuda", "cpu"))):
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= (1e-3 if dtype == "float32" else 2e-2)
        if dtype == "float32":
            assert torch.equal(got.argmax(-1), want.argmax(-1))
