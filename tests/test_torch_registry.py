"""The port's kernel registry, ``KernelPolicy`` and autotuner against the
reference's (``repro.kernels``), on the CPU.

Planning is checked for both platforms without a card: a policy pinned to
``"cuda"`` plans what a card would run (``dequant_matmul``'s tiles for
132 SMs).  The whole slice runs the llama3-8b and deepseek-moe-16b smoke
models (f32, raw and q8) through ``kernels.get`` under the default policy
and with each op pinned to ``ref``, against the reference under its
default policy: prefill logits within 2e-5 of max|logit| (the tolerance of
``test_torch_model.py`` and ``test_torch_moe.py``) and greedy tokens
identical.  The autotuner's mechanics run on a toy op registered here:
the real ops' tunable impls run on the card only
(``tests/test_torch_cuda.py``)."""

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import kernels as jkernels  # noqa: E402
from repro.compression.quantizers import quantize_tree_q8 as jq8  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.kernels import tune as jtune  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 tensor_from_numpy)
from repro_torch.kernels import KernelPolicy, registry, tune  # noqa: E402
from repro_torch.kernels.dequant_matmul import ops as dmops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

RTOL = 2e-5
CARD = KernelPolicy(platform="cuda")
HOST = KernelPolicy(platform="cpu")


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rtol * scale


@pytest.fixture(autouse=True)
def _fresh_cache(tmp_path, monkeypatch):
    """Every test reads and writes a cache file of its own."""
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    tune.invalidate_cache()
    yield
    tune.invalidate_cache()


def _dm_inputs(m=4, k=256, n=256, seed=0, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if lead is not None:
        x = x.reshape(*lead, k)
    wq = rng.integers(-127, 127, (k, n)).astype(np.int8)
    sc = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    return x, wq, sc


def _grouped_inputs(e=3, m=5, k=32, n=24, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, m, k)).astype(np.float32),
            rng.integers(-127, 127, (e, k, n)).astype(np.int8),
            (rng.random((e, n)) * 0.01 + 1e-4).astype(np.float32))


def _flash_inputs(b=1, sq=16, skv=16, h=4, g=2, d=32, dv=None, seed=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, g, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, g, dv or d)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(sq) + (skv - sq), (b, sq)).astype(
        np.int32)
    return q, k, v, qpos


def _rd_inputs(n=3000, seed=3):
    from repro_torch.core.quant import nearest_level
    from repro_torch.core.rate_model import estimate_bin_probs
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(n) * 0.05).astype(np.float32)
    w[rng.random(n) < 0.5] = 0
    return w, estimate_bin_probs(nearest_level(w, 0.008))


def _embed_inputs(seed=4):
    rng = np.random.default_rng(seed)
    leaf = {"q8": rng.integers(-127, 127, (64, 16)).astype(np.int8),
            "q8s": (rng.random(16) * 0.02 + 1e-4).astype(np.float32)}
    return leaf, rng.integers(0, 64, (2, 5)).astype(np.int32)


def _port_args(op):
    """Small CPU arguments of each op, in the op's signature."""
    if op == "dequant_matmul":
        return tuple(map(_t, _dm_inputs())), {}
    if op == "dequant_matmul_grouped":
        return tuple(map(_t, _grouped_inputs())), {}
    if op == "flash_attention":
        return tuple(map(_t, _flash_inputs())), {}
    if op == "rd_quant":
        w, probs = _rd_inputs()
        return (_t(w), None, probs), {"step": 0.008, "lam": 2e-4}
    leaf, toks = _embed_inputs()
    return ({k: _t(v) for k, v in leaf.items()}, _t(toks),
            torch.float32), {}


# ---------------------------------------------------------------------------
# ops and planning
# ---------------------------------------------------------------------------

def test_available_ops_equal_the_reference():
    assert kernels.available_ops() == jkernels.available_ops()


@pytest.mark.parametrize("op", sorted(jkernels.available_ops()))
def test_plan_defaults_by_platform(op):
    """A card runs each hand-written kernel; the CPU its plain version (the
    scan for attention).  The embedding's gather is no kernel: both
    platforms gather.  An op's first tensor picks the platform under
    "auto"."""
    args, kw = _port_args(op)
    bound = kernels.get(op)
    want_card = "gather" if op == "embed_lookup_q8" else "cuda"
    want_host = {"embed_lookup_q8": "gather",
                 "flash_attention": "scan"}.get(op, "ref")
    card = bound.plan(*args, policy=CARD, **kw)
    host = bound.plan(*args, policy=HOST, **kw)
    auto = bound.plan(*args, **kw)
    assert (card.platform, card.impl, card.fallback_reason) == (
        "cuda", want_card, None)
    assert (host.platform, host.impl, host.fallback_reason) == (
        "cpu", want_host, None)
    assert auto == host


def test_designed_routes_record_nothing():
    """Decode and a call under grad take the scan by design on the card:
    no fallback, no record; the same call is the kernel's otherwise."""
    fa = kernels.get("flash_attention")
    q, k, v, qpos = map(_t, _flash_inputs())
    kernels.clear_dispatch_report()
    assert fa.plan(q, k, v, qpos, policy=CARD).impl == "cuda"
    dec = fa.plan(q[:, -1:], k, v, qpos[:, -1:], policy=CARD)
    qg = q.clone().requires_grad_(True)
    grad = fa.plan(qg, k, v, qpos, policy=CARD)
    for p in (dec, grad):
        assert (p.impl, p.fallback_reason, p.requested) == ("scan", None,
                                                            None)
    out = fa(qg, k, v, qpos)
    out.sum().backward()
    fa(q[:, -1:], k, v, qpos[:, -1:], kv_len=_t(np.array([9], np.int32)))
    assert kernels.dispatch_report() == []
    # the reference routes decode the same way
    jq, jk, jv, jp = map(jnp.asarray, _flash_inputs())
    jdec = jkernels.get("flash_attention").plan(
        jq[:, -1:], jk, jv, jp[:, -1:],
        policy=jkernels.KernelPolicy(platform="tpu"))
    assert (jdec.impl, jdec.fallback_reason) == ("scan", None)


def test_plans_are_memoized_and_follow_the_cache():
    """One plan per (op, platform, policy, shapes, cache generation): a
    second call reuses it, a new cache entry makes a new one."""
    op = kernels.get("dequant_matmul")
    x, wq, sc = map(_t, _dm_inputs(m=4))
    first = op.plan(x, wq, sc, policy=CARD)
    assert op.plan(x, wq, sc, policy=CARD) is first
    bucket = dmops._bucket(dmops._shape_info(x, wq, sc))
    tune.get_cache().store("dequant_matmul", "cuda", bucket,
                           {"kc": 128, "bm": 8}, 1.0)
    hit = op.plan(x, wq, sc, policy=CARD)
    assert hit is not first and hit.cache_hit
    assert dict(hit.tiles) == {"kc": 128, "bm": 8}


# ---------------------------------------------------------------------------
# buckets and policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9, 640, 1000, 1 << 20,
                               (1 << 20) + 1])
def test_pow2_bucket_equals_the_reference(n):
    assert tune.pow2_bucket(n) == jtune.pow2_bucket(n)


BUCKET_CASES = {
    "dequant_matmul": [dict(m=1), dict(m=3), dict(m=4, k=96, n=40),
                       dict(m=12, lead=(3, 4)), dict(m=20, k=64, n=8)],
    "dequant_matmul_grouped": [dict(), dict(e=2, m=9, k=16, n=8)],
    "flash_attention": [dict(), dict(b=3, sq=5, skv=11, h=6, g=3, d=16),
                        dict(sq=1, skv=7)],
    "rd_quant": [dict(n=1), dict(n=3000), dict(n=4096)],
}


@pytest.mark.parametrize("op,case", [(op, c) for op, cs in
                                     BUCKET_CASES.items() for c in cs])
def test_bucket_strings_equal_the_reference(op, case):
    make = {"dequant_matmul": _dm_inputs, "rd_quant": None,
            "dequant_matmul_grouped": _grouped_inputs,
            "flash_attention": _flash_inputs}[op]
    if op == "rd_quant":
        w, probs = _rd_inputs(**case)
        targs, jargs = (_t(w), None, probs), (jnp.asarray(w), None, probs)
    else:
        arrs = make(**case)
        targs, jargs = tuple(map(_t, arrs)), tuple(map(jnp.asarray, arrs))
    t, j = kernels.spec(op), jkernels.spec(op)
    assert t.bucket(t.shape_info(*targs)) == j.bucket(j.shape_info(*jargs))


def test_policy_semantics_equal_the_reference():
    assert dataclasses.asdict(KernelPolicy()) == dataclasses.asdict(
        jkernels.KernelPolicy())
    assert dataclasses.asdict(kernels.DEFAULT_POLICY) == dataclasses.asdict(
        jkernels.DEFAULT_POLICY)
    assert [f.name for f in dataclasses.fields(KernelPolicy)] == [
        f.name for f in dataclasses.fields(jkernels.KernelPolicy)]
    for pol in (KernelPolicy(), jkernels.KernelPolicy()):
        p = pol.override("dequant_matmul", "ref")
        assert p.override("dequant_matmul", "ref") == p        # idempotent
        p2 = p.override("dequant_matmul", "x").override("rd_quant", "ref")
        assert p2.overrides == (("dequant_matmul", "x"), ("rd_quant",
                                                          "ref"))
        assert p2.impl_for("dequant_matmul") == "x"
        assert p2.impl_for("flash_attention") is None
        t = p2.with_tiles("dequant_matmul", kc=64, bm=32)
        assert t.tiles_for("dequant_matmul") == {"bm": 32, "kc": 64}
        assert t.with_tiles("dequant_matmul", bm=128).tile_overrides == (
            ("dequant_matmul", (("bm", 128),)),)
        assert t.tiles_for("rd_quant") == {}
        hash(t)
    tp = KernelPolicy().override("a", "b").with_tiles("a", kc=1)
    jp = jkernels.KernelPolicy().override("a", "b").with_tiles("a", kc=1)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def test_unknown_impl_raises():
    args, _ = _port_args("dequant_matmul")
    with pytest.raises(KeyError, match="unknown impl"):
        kernels.get("dequant_matmul").plan(*args, policy=KernelPolicy()
                                           .override("dequant_matmul",
                                                     "nope"))
    with pytest.raises(KeyError, match="unknown kernel op"):
        kernels.get("nope")


@pytest.mark.parametrize("op", ["dequant_matmul", "dequant_matmul_grouped",
                                "flash_attention", "rd_quant"])
def test_pinned_cuda_on_a_cpu_tensor_falls_back_visibly(op):
    """The pin cannot run on the CPU: the fallback is recorded with the
    reference's schema and runs the plain version; under a strict policy
    it raises instead."""
    args, kw = _port_args(op)
    bound = kernels.get(op)
    pol = KernelPolicy().override(op, "cuda")
    want = bound(*args, policy=KernelPolicy().override(
        op, "scan" if op == "flash_attention" else "ref"), **kw)
    kernels.clear_dispatch_report()
    got = bound(*args, policy=pol, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (rec,) = kernels.dispatch_report()
    assert rec == {"op": op, "platform": "cpu", "requested": "cuda",
                   "impl": "scan" if op == "flash_attention" else "ref",
                   "reason": "impl 'cuda' unavailable on platform 'cpu'",
                   "kind": "fallback"}
    with pytest.raises(kernels.KernelDispatchError, match="strict"):
        bound(*args, policy=dataclasses.replace(pol, strict=True), **kw)


def test_strict_flash_pin_refuses_a_ragged_kv_len_on_the_card_plan():
    fa = kernels.get("flash_attention")
    q, k, v, qpos = map(_t, _flash_inputs())
    kv_len = _t(np.array([16], np.int32))
    pin = dataclasses.replace(CARD, strict=True).override(
        "flash_attention", "cuda")
    plan = fa.plan(q, k, v, qpos, kv_len=kv_len, policy=pin)
    assert plan.impl == "scan" and "ragged" in plan.fallback_reason
    with pytest.raises(kernels.KernelDispatchError, match="ragged"):
        fa(q, k, v, qpos, kv_len=kv_len, policy=pin)


# ---------------------------------------------------------------------------
# tiles and the tuning cache
# ---------------------------------------------------------------------------

def _schedule_cases():
    """Every (M, K, N) that ``tests/test_torch_schedule.py`` checks
    ``ops.schedule`` at, read from that file."""
    spec = importlib.util.spec_from_file_location(
        "torch_schedule_cases", Path(__file__).with_name(
            "test_torch_schedule.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


SCHEDULE_SHAPES = _schedule_cases()


@pytest.mark.parametrize("m,k,n", SCHEDULE_SHAPES)
def test_dequant_matmul_default_tiles_are_the_schedule(m, k, n):
    """Planned for the card (132 SMs: the H100's count, taken for CPU
    tensors), the default tiles are ``ops.schedule``'s, and the launch
    takes them."""
    s = {"m": m, "k": k, "n": n, "sms": dmops.H100_SMS}
    kc, _, _, bm = dmops.schedule(m, k, n, dmops.H100_SMS)
    assert dmops.default_tiles(s) == {"kc": kc, "bm": bm}
    assert dmops.tile_ok(s, {"kc": kc, "bm": bm})
    cands = tune.tile_candidates(kernels.spec("dequant_matmul"), s)
    assert cands and all(dmops.tile_ok(s, t) for t in cands)
    # at most one decode and two tensor-core tiles per split count
    assert len(cands) <= 3 * 2 * dmops.MAX_SPLITS


def test_dequant_matmul_plan_takes_the_schedule_for_a_cpu_tensor():
    x, wq, sc = map(_t, _dm_inputs(m=6, lead=(2, 3), k=512, n=384))
    plan = kernels.get("dequant_matmul").plan(x, wq, sc, policy=CARD)
    kc, _, _, bm = dmops.schedule(6, 512, 384, dmops.H100_SMS)
    assert dict(plan.tiles) == {"kc": kc, "bm": bm}


def test_tile_ok_is_the_launch_contract():
    s = {"m": 4, "k": 7168, "n": 64, "sms": 132}
    assert dmops.tile_ok(s, {"kc": 896, "bm": 8})          # 8 chunks
    assert not dmops.tile_ok(s, {"kc": 864, "bm": 8})      # 9 chunks
    assert not dmops.tile_ok(s, {"kc": 912, "bm": 8})      # not 32-aligned
    assert dmops.tile_ok(s, {"kc": 960, "bm": 32})         # tensor cores
    assert not dmops.tile_ok(s, {"kc": 928, "bm": 32})     # not 64-aligned
    assert not dmops.tile_ok(s, {"kc": 1024, "bm": 64})    # no such tile
    big = {"m": 8, "k": 18432, "n": 64, "sms": 132}
    assert not dmops.tile_ok(big, {"kc": 2304, "bm": 8})   # x > 64 KB
    assert not dmops.tile_ok({**s, "m": 9}, {"kc": 896, "bm": 8})
    rows = {"m": 65536 * 32, "k": 64, "n": 64, "sms": 132}
    assert not dmops.tile_ok(rows, {"kc": 64, "bm": 32})   # grid rows


def test_tuning_cache_hit_vs_default_tiles():
    """As the reference's test of the same name: a cold plan takes the
    default tiles, an autotune-written entry serves its pow2 bucket, the
    policy can ignore the cache, and tile pins beat it."""
    op = kernels.get("dequant_matmul")
    x, wq, sc = map(_t, _dm_inputs(m=4))
    cold = op.plan(x, wq, sc, policy=CARD)
    assert not cold.cache_hit
    assert dict(cold.tiles) == dmops.default_tiles(
        dmops._shape_info(x, wq, sc))
    bucket = dmops._bucket(dmops._shape_info(x, wq, sc))
    assert bucket == "m4_k256_n256"
    tiles = {"bm": 32, "kc": 128}
    tune.get_cache().store("dequant_matmul", "cuda", bucket, tiles, 3.5,
                           shape=[4, 256, 256])
    tune.get_cache().save()
    tune.invalidate_cache()                     # reload from the file
    warm = op.plan(x, wq, sc, policy=CARD)
    assert warm.cache_hit and dict(warm.tiles) == tiles
    assert op.plan(*map(_t, _dm_inputs(m=3)), policy=CARD).cache_hit
    assert not op.plan(*map(_t, _dm_inputs(m=5)), policy=CARD).cache_hit
    off = dataclasses.replace(CARD, use_tuning_cache=False)
    assert not op.plan(x, wq, sc, policy=off).cache_hit
    pinned = CARD.with_tiles("dequant_matmul", kc=64, bm=128)
    assert dict(op.plan(x, wq, sc, policy=pinned).tiles) == {"kc": 64,
                                                             "bm": 128}
    # the host plan has no tiles: the plain version takes none
    assert op.plan(x, wq, sc, policy=HOST).tiles == ()


def test_a_cached_tile_the_rows_cannot_take_is_clamped_and_recorded():
    """A decode tile cached for bucket m16 cannot run at M = 12 (above the
    decode instance's 8 rows): the default runs, recorded as a tile
    clamp."""
    op = kernels.get("dequant_matmul")
    x, wq, sc = map(_t, _dm_inputs(m=12))
    s = dmops._shape_info(x, wq, sc)
    tune.get_cache().store("dequant_matmul", "cuda", dmops._bucket(s),
                           {"kc": 256, "bm": 8}, 1.0)
    plan = op.plan(x, wq, sc, policy=CARD)
    assert plan.cache_hit and dict(plan.tiles) == dmops.default_tiles(s)
    kernels.clear_dispatch_report()
    out = op(x, wq, sc, policy=CARD)            # a CPU tensor: plain
    assert out.shape == (12, 256)
    (rec,) = kernels.dispatch_report()
    assert rec["kind"] == "tile_clamp" and rec["impl"] == "cuda"


def test_rd_quant_tiles_and_levels_do_not_depend_on_them():
    args, kw = _port_args("rd_quant")
    plan = kernels.get("rd_quant").plan(*args, policy=CARD, **kw)
    assert dict(plan.tiles) == {"blocks_per_sm": 16}
    spec = kernels.spec("rd_quant")
    assert tune.tile_candidates(spec, {"n": 3000}) == [
        {"blocks_per_sm": b} for b in (4, 8, 16, 32, 64)]
    want = kernels.get("rd_quant")(*args, **kw)
    for b in (4, 64):
        got = kernels.rd_quant(*args, blocks_per_sm=b, **kw)
        assert torch.equal(got, want)


def test_autotune_refuses_without_a_tunable_impl_or_tile_space():
    with pytest.raises(ValueError, match="no tunable impl"):
        tune.autotune("dequant_matmul", [(4, 64, 64)], policy=HOST)
    with pytest.raises(ValueError, match="no tunable impl"):
        tune.autotune("rd_quant", [(1000,)], policy=HOST)
    for op in ("dequant_matmul_grouped", "flash_attention",
               "embed_lookup_q8"):
        with pytest.raises(ValueError, match="no tunable tile space"):
            tune.autotune(op, [(1, 2, 3)], policy=CARD)


# ---------------------------------------------------------------------------
# autotune mechanics on a toy op
# ---------------------------------------------------------------------------

@pytest.fixture
def toy_ops():
    """Two ops registered for one test: ``toy_scale`` (a host impl whose
    tile t = 2 is fastest) and ``toy_raise`` (a ``cuda`` impl that raises
    and a ``ref`` impl that must never run in its place)."""
    calls = {"ref": 0}

    def scale(x, *, t):
        time.sleep(0.004 * abs(t - 2))
        return x * t

    def boom(x, *, t=1):
        raise RuntimeError("kernel launch failed")

    def ref(x):
        calls["ref"] += 1
        return x

    def inputs(shape, device="cpu"):
        return (torch.ones(shape, device=device),), {}

    registry.register_op(lambda: registry.OpSpec(
        name="toy_scale",
        impls={"toy": registry.Impl("toy", scale, platforms=("cpu",))},
        defaults={"*": "toy"}, tile_space={"t": (1, 2, 4)},
        default_tiles=lambda s: {"t": 1},
        tile_ok=lambda s, t: t["t"] <= s["n"],
        shape_info=lambda x: {"n": x.numel()},
        bucket=lambda s: f"n{tune.pow2_bucket(s['n'])}",
        example_inputs=inputs, tune_impls={"cpu": "toy"}))
    registry.register_op(lambda: registry.OpSpec(
        name="toy_raise",
        impls={"cuda": registry.Impl("cuda", boom),
               "ref": registry.Impl("ref", ref, uses_tiles=False)},
        defaults={"*": "cuda"}, fallbacks=("ref",),
        shape_info=lambda x: {"n": x.numel()}))
    yield calls
    for name in ("toy_scale", "toy_raise"):
        registry._OPS.pop(name)
    registry._PLANS.clear()


def test_autotune_persists_winners_and_skips_cached_entries(toy_ops,
                                                            tmp_path):
    seen = []
    res = tune.autotune("toy_scale", [(4,), (1,)], policy=HOST,
                        repeats=1, warmup=0,
                        verify=lambda shape, tiles, out: seen.append(
                            (shape, tiles["t"], float(out[0]))))
    assert res["n4"]["tiles"] == {"t": 2} and res["n4"]["configs"] == 3
    assert res["n4"]["default_tiles"] == {"t": 1}
    assert res["n4"]["default_time_us"] >= res["n4"]["time_us"]
    assert res["n1"]["tiles"] == {"t": 1} and res["n1"]["configs"] == 1
    assert (((4,), 4, 4.0)) in seen and (((1,), 2, 2.0)) not in seen
    on_disk = json.loads((tmp_path / "tune.json").read_text())
    assert on_disk["version"] == 1
    assert on_disk["entries"]["toy_scale/cpu/n4"]["tiles"] == {"t": 2}
    assert on_disk["entries"]["toy_scale/cpu/n4"]["shape"] == [4]
    # the dispatch of a toy call reads the winner
    plan = kernels.get("toy_scale").plan(torch.ones(3))
    assert plan.cache_hit and dict(plan.tiles) == {"t": 2}
    # cached buckets are skipped unless forced (3 is in bucket n4)
    again = tune.autotune("toy_scale", [(3,)], policy=HOST, repeats=1,
                          warmup=0)
    assert again == {"n4": {"tiles": {"t": 2}, "cached": True}}
    forced = tune.autotune("toy_scale", [(4,)], policy=HOST, repeats=1,
                           warmup=0, force=True)
    assert forced["n4"]["configs"] == 3


def test_an_impl_that_raises_is_never_replaced(toy_ops):
    """No hidden fallback: the registry re-raises an impl's exception (a
    kernel that fails to build or launch), and the plain version does not
    run in its place, under every policy."""
    op = kernels.get("toy_raise")
    for pol in (None, KernelPolicy(strict=True),
                KernelPolicy().override("toy_raise", "cuda")):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            op(torch.ones(3), policy=pol)
    assert toy_ops["ref"] == 0
    assert op(torch.ones(3), policy=KernelPolicy().override(
        "toy_raise", "ref")).shape == (3,)


def test_cache_files_round_trip_between_the_packages(tmp_path):
    ours = tune.TuningCache(tmp_path / "port.json")
    ours.store("dequant_matmul", "cuda", "m4_k7168_n64",
               {"kc": 896, "bm": 4}, 10.9, shape=[4, 7168, 64])
    ours.save()
    theirs = jtune.TuningCache(tmp_path / "port.json")
    assert theirs.entries == ours.entries
    assert theirs.lookup("dequant_matmul", "cuda", "m4_k7168_n64") == {
        "kc": 896, "bm": 4}
    theirs.store("rd_quant", "tpu", "n4096", {"block_m": 64}, 5.0,
                 shape=[4000])
    theirs.save()
    back = tune.TuningCache(tmp_path / "port.json")
    assert back.entries == theirs.entries
    assert back.lookup("rd_quant", "tpu", "n4096") == {"block_m": 64}
    assert (tmp_path / "port.json").read_text() == json.dumps(
        {"version": 1, "entries": back.entries}, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def _policies():
    pols = {"default": KernelPolicy()}
    for op in jkernels.available_ops():
        pols[f"{op}=ref"] = KernelPolicy().override(op, "ref")
    pols["all=ref"] = KernelPolicy(overrides=tuple(
        (op, "ref") for op in kernels.available_ops()))
    return pols


def _greedy(prefill, decode, steps=3):
    logits, caches = prefill()
    toks = [np.asarray(logits).argmax(-1)]
    for i in range(steps):
        logits, caches = decode(caches, i, toks[-1])
        toks.append(np.asarray(logits).argmax(-1))
    return np.stack(toks, 1)


@pytest.fixture(scope="module", params=["llama3-8b", "deepseek-moe-16b"])
def slice_model(request):
    arch = request.param
    cfg = jconfigs.get(arch, smoke=True)
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    trees = {"raw": jparams, "q8": jq8(jparams)}
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 6))
    want = {}
    for tree, p in trees.items():
        jlo, _ = jtf.prefill(p, cfg, tokens=jnp.asarray(toks, jnp.int32),
                             max_len=10)

        def jdec(c, i, t, p=p):
            lo, c = jtf.decode_step(p, cfg, c, 6 + i,
                                    tokens=jnp.asarray(t, jnp.int32))
            return lo, c
        want[tree] = (np.asarray(jlo), _greedy(
            lambda p=p: jtf.prefill(p, cfg, tokens=jnp.asarray(
                toks, jnp.int32), max_len=10), jdec))
    return {"arch": arch, "toks": toks, "want": want,
            "t": {tree: params_from_numpy(jflatten(p), "cpu")
                  for tree, p in trees.items()}}


@pytest.mark.parametrize("tree", ["raw", "q8"])
@pytest.mark.parametrize("pol", list(_policies()))
def test_the_slice_under_every_policy_matches_the_reference(slice_model,
                                                            tree, pol):
    tcfg = configs.get(slice_model["arch"], smoke=True).replace(
        kernels=_policies()[pol])
    p, toks = slice_model["t"][tree], slice_model["toks"]
    want_logits, want_tokens = slice_model["want"][tree]
    kernels.clear_dispatch_report()

    def prefill():
        return ttf.prefill(p, tcfg, tokens=_t(toks), max_len=10)

    def dec(c, i, t):
        return ttf.decode_step(p, tcfg, c, 6 + i, tokens=_t(t))
    lo, _ = prefill()
    _close(lo.numpy(), want_logits)
    np.testing.assert_array_equal(_greedy(prefill, dec), want_tokens)
    assert [r for r in kernels.dispatch_report()
            if r["kind"] == "fallback"] == []


@pytest.mark.parametrize("tree", ["raw", "q8"])
def test_tied_embeddings_match_the_reference(tree):
    """A tied head: the embedding's transpose projects the logits.  Raw,
    it is a plain product; on q8 it is dequantized in the loop (its
    per-vocab-row scales would sit on the contraction dim) and recorded
    once, as the reference records it."""
    cfg = jconfigs.get("llama3-8b", smoke=True).replace(tie_embeddings=True)
    tcfg = configs.get("llama3-8b", smoke=True).replace(tie_embeddings=True)
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(1))
    assert "head" not in jparams
    if tree == "q8":
        jparams = jq8(jparams)
    tp = params_from_numpy(jflatten(jparams), "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 7))
    jtf._reported_loop_dequant.clear()
    ttf._reported_loop_dequant.clear()
    jkernels.clear_dispatch_report()
    kernels.clear_dispatch_report()
    jlo, jc = jtf.prefill(jparams, cfg, tokens=jnp.asarray(toks, jnp.int32),
                          max_len=10)
    tlo, tc = ttf.prefill(tp, tcfg, tokens=_t(toks), max_len=10)
    _close(tlo.numpy(), jlo)
    nxt = np.asarray(jlo).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tlo.argmax(-1).numpy(), nxt)
    jlo, _ = jtf.decode_step(jparams, cfg, jc, 7, tokens=jnp.asarray(nxt))
    tlo, _ = ttf.decode_step(tp, tcfg, tc, 7, tokens=_t(nxt))
    _close(tlo.numpy(), jlo)
    got = [r for r in kernels.dispatch_report()
           if r["kind"] == "loop_dequant"]
    want = [r for r in jkernels.dispatch_report()
            if r["kind"] == "loop_dequant"]
    assert got == want
    assert len(got) == (tree == "q8")
    if got:
        assert got[0]["reason"].startswith("embed.T (tied head)")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launcher_error(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as e:
        main()
    return e.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("pin,msg", [
    ("nope=ref", "--kernel-impl: unknown op 'nope'"),
    ("dequant_matmul=nope", "--kernel-impl: unknown impl 'nope' for "
                            "dequant_matmul"),
    ("flash_attention", "--kernel-impl: unknown impl '' for "
                        "flash_attention")])
def test_launcher_rejects_pins_as_the_reference_does(pin, msg, monkeypatch,
                                                     capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["--smoke", "--kernel-impl", pin]
    t_code, t_err = _launcher_error(tserve.main, [*argv, "--device", "cpu"],
                                    monkeypatch, capsys)
    j_code, j_err = _launcher_error(jserve.main, argv, monkeypatch, capsys)
    assert t_code == j_code == 2
    assert msg in t_err and msg in j_err
    if pin == "nope=ref":
        assert t_err.split(";")[0] == j_err.split(";")[0]


def test_launcher_pins_reach_the_policy(monkeypatch, capsys):
    """The three flags parse into the model's policy; a pin the CPU cannot
    run falls back visibly, and raises under --strict-kernels."""
    from repro_torch.launch import serve as tserve
    seen = []
    real = tserve.ServeSession

    def spy(cfg, *a, **k):
        seen.append(cfg.kernels)
        return real(cfg, *a, **k)
    monkeypatch.setattr(tserve, "ServeSession", spy)
    base = ["--smoke", "--backend", "q8", "--device", "cpu", "--steps", "2",
            "--prompt-len", "4", "--batch", "2"]
    out = tserve.main([*base, "--kernel-impl", "dequant_matmul=ref",
                       "--kernel-impl", "flash_attention=ref",
                       "--no-tuning-cache"])
    assert out.shape == (2, 2)
    assert seen[-1] == KernelPolicy(use_tuning_cache=False, overrides=(
        ("dequant_matmul", "ref"), ("flash_attention", "ref")))
    text = capsys.readouterr().out
    assert "'dequant_matmul': 0" in text and "fallback" not in text
    tserve.main([*base, "--kernel-impl", "dequant_matmul=cuda"])
    assert "kernel fallback: dequant_matmul: cuda -> ref" in \
        capsys.readouterr().out
    with pytest.raises(kernels.KernelDispatchError, match="strict"):
        tserve.main([*base, "--kernel-impl", "dequant_matmul=cuda",
                     "--strict-kernels"])
