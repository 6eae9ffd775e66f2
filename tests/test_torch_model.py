"""The port's numerics and dense model against the JAX reference.

The same numpy inputs — JAX parameters flattened to numpy and carried
across with ``repro_torch.convert`` — go through both packages on the
CPU.  q8 levels and scales must be bit-identical.  Logits and caches of
the llama3-8b smoke model (f32) agree to 2e-5 relative to their largest
magnitude: both sides sum the same f32 products in a different order
through two layers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compression.quantizers import quantize_leaf as jquantize_leaf  # noqa: E402
from repro.compression.quantizers import quantize_tree_q8 as jq8  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.compression import (flatten_tree, quantize_leaf,  # noqa: E402
                                     quantize_tree_q8)
from repro_torch.convert import (params_from_numpy, tensor_from_numpy,  # noqa: E402
                                 tensor_to_numpy)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

RTOL = 2e-5


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rtol * scale


@pytest.fixture(scope="module")
def smoke():
    cfg = jconfigs.get("llama3-8b", smoke=True)
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    jq = jq8(jparams)
    tcfg = configs.get("llama3-8b", smoke=True)
    return {"cfg": cfg, "tcfg": tcfg, "raw": jparams, "q8": jq,
            "t_raw": params_from_numpy(jflatten(jparams), "cpu"),
            "t_q8": params_from_numpy(jflatten(jq), "cpu")}


# ---------------------------------------------------------------------------
# configs, conversion, quantization
# ---------------------------------------------------------------------------

def test_config_matches_reference_field_for_field():
    import dataclasses
    assert "llama3-8b" in configs.names()
    for arch in configs.names():                 # every registered id
        for smoke_ in (False, True):
            want = dataclasses.asdict(jconfigs.get(arch, smoke=smoke_))
            want.pop("kernels")
            got = dataclasses.asdict(configs.get(arch, smoke=smoke_))
            assert got == want, arch
    with pytest.raises(NotImplementedError, match="not yet ported"):
        configs.get("mamba2-2.7b")
    with pytest.raises(KeyError):
        configs.get("no-such-model")


def test_convert_round_trips_bfloat16():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(tensor_to_numpy(t).view(np.uint16),
                                  a.view(np.uint16))
    tree = params_from_numpy({"a/b": a, "a/c/q8": np.ones(3, np.int8)}, "cpu")
    assert tree["a"]["b"].dtype == torch.bfloat16
    assert tree["a"]["c"]["q8"].dtype == torch.int8


def test_q8_tree_bit_exact(smoke):
    want = jflatten(smoke["q8"])
    got = {k: tensor_to_numpy(v)
           for k, v in flatten_tree(quantize_tree_q8(smoke["t_raw"])).items()}
    assert sorted(got) == sorted(want)
    assert "layers/attn/wq/q8s" in got and got["layers/attn/wq/q8s"].shape \
        == (2, 128)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("shape", [(3, 40, 24), (50, 24), (2, 3, 5, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_leaf_bit_exact(shape, dtype):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    # exact half-level ties: round half to even on both sides
    w.reshape(-1)[:4] = [0.5, 1.5, -2.5, 127.0]
    w = w.astype(getattr(ml_dtypes, dtype) if dtype == "bfloat16"
                 else dtype)
    want = jquantize_leaf(jnp.asarray(w))
    got = quantize_leaf(tensor_from_numpy(w, "cpu"))
    for key in ("q8", "q8s"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = np.broadcast_to(np.arange(5) + 3, (2, 5)).astype(np.int32)
    _close(tlayers.rms_norm(_t(x), _t(scale), 1e-5).numpy(),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    _close(tlayers.apply_rope(_t(x), _t(pos), 500000.0).numpy(),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    for act in ("silu", "gelu"):
        _close(tlayers.activation(_t(x), act).numpy(),
               jlayers.activation(jnp.asarray(x), act))
    h = rng.standard_normal((2, 3, 16)).astype(np.float32)
    mlp = {n: rng.standard_normal(s).astype(np.float32) * 0.2 for n, s in
           (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    jq = {n: jquantize_leaf(jnp.asarray(w)) for n, w in mlp.items()}
    tq = {n: {k: _t(np.asarray(v)) for k, v in q.items()}
          for n, q in jq.items()}
    _close(tlayers.swiglu_mlp(_t(h), tq, "silu").numpy(),
           jlayers.swiglu_mlp(jnp.asarray(h), jq, "silu"))
    _close(tlayers.swiglu_mlp(_t(h), {n: _t(w) for n, w in mlp.items()},
                              "silu").numpy(),
           jlayers.swiglu_mlp(jnp.asarray(h),
                              {n: jnp.asarray(w) for n, w in mlp.items()},
                              "silu"))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_cache_update_matches_reference(int8, ragged):
    rng = np.random.default_rng(2)
    dt = np.int8 if int8 else np.float32
    cache = np.zeros((3, 10, 2, 4), dt)
    s = 1 if ragged else 4
    vals = rng.standard_normal((3, s, 2, 4)).astype(np.float32) * 3
    pos = np.array([0, 5, 9], np.int32) if ragged else 2
    want = jattn._cache_update(jnp.asarray(cache), jnp.asarray(vals),
                               jnp.asarray(pos), 1 / 16)
    tc = _t(cache)
    got = tattn._cache_update(tc, _t(vals), _t(pos) if ragged else pos,
                              1 / 16)
    assert got is tc                          # updated in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the dense model: forward, prefill, ragged decode
# ---------------------------------------------------------------------------

def _caches_close(tc, jc):
    for name in ("k", "v"):
        _close(tc[name].numpy(), jc[name])


@pytest.mark.parametrize("tree", ["raw", "q8"])
def test_prefill_logits_and_caches(smoke, tree):
    cfg, tcfg = smoke["cfg"], smoke["tcfg"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    jlo, jc = jtf.prefill(smoke[tree], cfg, tokens=jnp.asarray(toks,
                                                               jnp.int32),
                          max_len=12)
    tlo, tc = ttf.prefill(smoke["t_" + tree], tcfg, tokens=_t(toks),
                          max_len=12)
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)
    full, _, _ = ttf.forward(smoke["t_" + tree], tcfg, tokens=_t(toks))
    jfull, _, _ = jtf.forward(smoke[tree], cfg,
                              tokens=jnp.asarray(toks, jnp.int32))
    _close(full.numpy(), jfull)
    li = np.array([3, 6], np.int32)
    tlast, _, _ = ttf.forward(smoke["t_" + tree], tcfg, tokens=_t(toks),
                              last_index=_t(li))
    jlast, _, _ = jtf.forward(smoke[tree], cfg,
                              tokens=jnp.asarray(toks, jnp.int32),
                              last_index=jnp.asarray(li))
    _close(tlast.numpy(), jlast)


@pytest.mark.parametrize("bsz", [1, 3, 5])
def test_ragged_decode_matches_reference(smoke, bsz):
    cfg, tcfg = smoke["cfg"], smoke["tcfg"]
    toks = np.random.default_rng(4 + bsz).integers(0, cfg.vocab_size,
                                                   (bsz, 6))
    jlo, jc = jtf.prefill(smoke["q8"], cfg,
                          tokens=jnp.asarray(toks, jnp.int32), max_len=12)
    tlo, tc = ttf.prefill(smoke["t_q8"], tcfg, tokens=_t(toks), max_len=12)
    # ragged per-row offsets: rows restart at 6, 5, 4
    pos = (6 - np.arange(bsz) % 3).astype(np.int32)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlo, -1)).astype(np.int32)
        np.testing.assert_array_equal(tlo.argmax(-1).numpy(), nxt)
        jlo, jc = jtf.decode_step(smoke["q8"], cfg, jc, jnp.asarray(pos),
                                  tokens=jnp.asarray(nxt))
        tlo, tc = ttf.decode_step(smoke["t_q8"], tcfg, tc, _t(pos),
                                  tokens=_t(nxt))
        _close(tlo.numpy(), jlo)
        pos = pos + 1
    _caches_close(tc, jc)


def test_fused_params_and_loop_dequant_report():
    rng = np.random.default_rng(6)
    lp = {"attn": {"wq": quantize_leaf(_t(rng.standard_normal((8, 4)).astype(
        np.float32)))},
        "odd": quantize_leaf(_t(rng.standard_normal((8, 4)).astype(
            np.float32)))}
    ttf._reported_loop_dequant.clear()
    kernels.clear_dispatch_report()
    for _ in range(2):
        out = ttf._fused_layer_params(lp, torch.float32, "cpu")
    assert out["attn"]["wq"] is lp["attn"]["wq"]          # stays int8
    assert out["odd"].dtype == torch.float32              # dequantized
    recs = kernels.dispatch_report()
    assert [r["kind"] for r in recs] == ["loop_dequant"]  # reported once
    assert recs[0]["reason"].startswith("odd:")


def test_unported_paths_raise(smoke):
    with pytest.raises(NotImplementedError):
        ttf.init_params(smoke["tcfg"].replace(family="ssm"), 0,
                        device="cpu")
    with pytest.raises(NotImplementedError):
        tattn.gqa_attention(None, None, smoke["tcfg"], None,
                            cache_pages=object())
    p = ttf.init_params(smoke["tcfg"], 0, device="cpu")
    assert flatten_tree(p).keys() == jflatten(smoke["raw"]).keys()
    for name, leaf in flatten_tree(p).items():
        assert tuple(leaf.shape) == jflatten(smoke["raw"])[name].shape
        assert leaf.dtype == torch.float32
