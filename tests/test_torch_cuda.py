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
    dequant_matmul_ref)
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
                                     (64, 64, 1408, 2048)])
def test_dequant_matmul_grouped_kernel_matches_plain(e, m, k, n, scale_form):
    """f32 x: the f32 tile; bf16 x: the tensor-core instance (16-byte
    copies at aligned shapes, element-wise loads at (3, 5, 70, 33) and
    (2, 130, 300, 257); the 32-row M tile, which also takes M <= 16,
    and the 64-row one)."""
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
        if xdt == torch.bfloat16:           # and the kernel's own order
            assert _rel(got, dequant_matmul_grouped_scale_after(
                x, wq, sc)) <= 1e-4
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


@pytest.mark.parametrize("h,g", [(32, 8), (16, 16), (4, 1)])
@pytest.mark.parametrize("s", [1, 100, 128, 257])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_tc_instance_matches_plain(d, s, h, g):
    """The bf16 (tensor-core) instance at both head dims, ragged S and
    every main-path group size."""
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
        fops.flash_attention(q[..., :64].contiguous(),
                             kv[..., :64].contiguous(),
                             kv[..., :64].contiguous())
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
                                     (7, 32, 4, 2), (33, 32, 8, 8)])
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
    _needs_card()
    q = torch.zeros((1, 8, 2, 64), device="cuda")
    kv = torch.zeros((1, 8, 1, 64), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fops.flash_attention(q, kv, kv)
    qpos = torch.arange(8, device="cuda")[None]
    with pytest.raises(ValueError, match="head dim"):
        fops.attention(q, kv, kv, qpos)


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
    ("bfloat16", 100, 257, 32)])
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
