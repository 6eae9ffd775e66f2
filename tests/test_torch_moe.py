"""deepseek-moe-16b's path through the port against the JAX package, on the
CPU: the grouped dequantize-matmul, q8 of the 4-D expert banks,
``moe_block``, the model, the serving session and the containers.

Inputs are made with numpy from a seed (parameters: the reference's init
carried across with ``repro_torch.convert``) and go through both packages.
Tolerances, relative to the largest magnitude of the reference's result:
1e-5 for the grouped product (the same f32 products summed in another
order); 2e-5 for ``moe_block``'s output and the smoke model's logits and
caches (f32, summed in another order through three layers).  The aux
load-balance loss agrees to 1e-6 absolute (a mean of f32 probabilities
summed in another order).  Integers agree exactly: q8 levels and scales,
routing decisions, tokens and container bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax import lax  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.compression.quantizers import quantize_leaf as jquantize_leaf  # noqa: E402
from repro.compression.quantizers import quantize_tree_q8 as jq8  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.kernels.dequant_matmul.ops import \
    dequant_matmul_grouped as jdmg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import ServeSession as JSession  # noqa: E402
from repro_torch import compression, configs, kernels  # noqa: E402
from repro_torch.compression import (flatten_tree, quantize_leaf,  # noqa: E402
                                     quantize_tree_q8)
from repro_torch.convert import (params_from_numpy, tensor_from_numpy,  # noqa: E402
                                 tensor_to_numpy)
from repro_torch.kernels.dequant_matmul import dequant_matmul_grouped  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.transformer import param_specs  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, ServeSession  # noqa: E402

ARCH = "deepseek-moe-16b"
RTOL_GROUPED = 1e-5
RTOL = 2e-5
AUX_ATOL = 1e-6


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
    cfg = jconfigs.get(ARCH, smoke=True)
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    jq = jq8(jparams)
    return {"cfg": cfg, "tcfg": configs.get(ARCH, smoke=True),
            "raw": jparams, "q8": jq, "flat": jflatten(jparams),
            "t_raw": params_from_numpy(jflatten(jparams), "cpu"),
            "t_q8": params_from_numpy(jflatten(jq), "cpu")}


def test_config_matches_reference_field_for_field():
    import dataclasses
    for smoke_ in (False, True):
        want = dataclasses.asdict(jconfigs.get(ARCH, smoke=smoke_))
        got = dataclasses.asdict(configs.get(ARCH, smoke=smoke_))
        # the KernelPolicy field for field (asdict recurses into it)
        assert got["kernels"] == want["kernels"]
        assert got == want
    assert ARCH in configs.names()


# ---------------------------------------------------------------------------
# the grouped dequantize-matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale_form", ["per_expert", "shared"])
@pytest.mark.parametrize("e,m,k,n", [(4, 8, 160, 96), (3, 5, 70, 33)])
def test_grouped_plain_matches_jax(e, m, k, n, scale_form, xdt):
    rng = np.random.default_rng(e * 131 + m * 31 + k * 7 + n)
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    if xdt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    wq = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
    sc = (rng.random((e, n) if scale_form == "per_expert" else (n,))
          * 0.01 + 1e-4).astype(np.float32)
    before = kernels.launch_counts()["dequant_matmul_grouped"]
    got = dequant_matmul_grouped(_t(x), _t(wq), _t(sc))
    assert kernels.launch_counts()["dequant_matmul_grouped"] == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, m, n)
    for kw in ({"interpret": True}, {"use_ref": True}):
        want = jdmg(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sc), **kw)
        _close(got.numpy(), want, RTOL_GROUPED)


# ---------------------------------------------------------------------------
# q8 of the 4-D expert banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_4d_leaf_bit_exact(dtype):
    """Within a layer the scale reduces over E and K: one (N,) scale per
    layer that all its experts share."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((3, 4, 40, 24)).astype(np.float32)
    w.reshape(-1)[:4] = [0.5, 1.5, -2.5, 127.0]     # half-level ties
    w = w.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    want = jquantize_leaf(jnp.asarray(w))
    got = quantize_leaf(tensor_from_numpy(w, "cpu"))
    assert tuple(got["q8s"].shape) == (3, 24)
    for key in ("q8", "q8s"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_tree_bit_exact_on_the_moe_smoke_tree(smoke, dtype):
    jraw = jax.tree_util.tree_map(lambda a: a.astype(dtype), smoke["raw"])
    want = jflatten(jq8(jraw))
    got = {k: tensor_to_numpy(v) for k, v in flatten_tree(quantize_tree_q8(
        params_from_numpy(jflatten(jraw), "cpu"))).items()}
    assert sorted(got) == sorted(want)
    for name in ("w_gate", "w_up", "w_down"):
        assert got[f"layers/moe/{name}/q8"].ndim == 4
        assert got[f"layers/moe/{name}/q8s"].shape == (
            2, got[f"layers/moe/{name}/q8"].shape[-1])
    assert "dense_layers/mlp/w_down/q8" in got
    assert "layers/moe/router/q8" in got
    for name in want:
        w = np.asarray(want[name])
        if w.dtype == ml_dtypes.bfloat16:       # the port hands out bits
            w = w.view(np.uint16)
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


# ---------------------------------------------------------------------------
# routing and moe_block
# ---------------------------------------------------------------------------

def test_top_k_puts_the_lower_index_first_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.0, 0.5, 0.25, 0.0, 0.25]], np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(_t(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _moe_case(smoke, case, tree):
    """(reference cfg, port cfg, layer-0 moe params of both, x (G, S, d))."""
    cfg, tcfg = smoke["cfg"], smoke["tcfg"]
    s = 8 if case == "tie" else 16     # 2 x 8 ties fit experts 0 and 1
    raw = jax.tree_util.tree_map(lambda a: a[0], smoke["raw"]["layers"]["moe"])
    if case == "drops":            # 8 experts x cap 8 slots < 2 x 40 picks
        cfg = cfg.replace(capacity_factor=0.25)
        tcfg = tcfg.replace(capacity_factor=0.25)
        s = 40
    if case == "tie":              # every router logit is exactly 0
        raw = dict(raw, router=jnp.zeros_like(raw["router"]))
    jp = {k: jquantize_leaf(v) for k, v in raw.items()} if tree == "q8" \
        else raw
    tp = {k: ({kk: _t(np.asarray(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else _t(np.asarray(v)))
          for k, v in jp.items()}
    x = np.random.default_rng(s).standard_normal(
        (3, s, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, jp, tp, x


@pytest.mark.parametrize("tree", ["raw", "q8"])
@pytest.mark.parametrize("case", ["smoke", "drops", "tie"])
def test_moe_block_matches_reference(smoke, case, tree):
    cfg, tcfg, jp, tp, x = _moe_case(smoke, case, tree)
    want, want_aux = jmoe.moe_block(jnp.asarray(x), jp, cfg)
    got, got_aux = tmoe.moe_block(_t(x), tp, tcfg)
    _close(got.numpy(), want)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_ATOL
    # the routing the block took, counted from its own top-k
    if tree == "q8":
        logits = tmoe.q8_einsum(_t(x), tp["router"])
    else:
        logits = _t(x) @ tp["router"]
    _, topi = tmoe.top_k(torch.softmax(logits, -1), tcfg.top_k)
    per_row = torch.nn.functional.one_hot(topi, tcfg.num_experts).sum((1, 2))
    cap = tmoe.moe_capacity(x.shape[1], tcfg)
    dropped = int((per_row - cap).clamp_min(0).sum())
    assert (dropped > 0) == (case == "drops")
    if case == "tie":              # lower expert indices win, as in lax.top_k
        assert torch.equal(topi, torch.arange(tcfg.top_k).expand_as(topi))


# ---------------------------------------------------------------------------
# the model: forward, prefill, ragged decode
# ---------------------------------------------------------------------------

def _caches_close(tc, jc):
    assert sorted(tc) == sorted(jc) == ["dense", "main"]
    for part in ("dense", "main"):
        for name in ("k", "v"):
            _close(tc[part][name].numpy(), jc[part][name])


@pytest.mark.parametrize("tree", ["raw", "q8"])
def test_forward_prefill_and_decode_match_reference(smoke, tree):
    cfg, tcfg = smoke["cfg"], smoke["tcfg"]
    jp, tp = smoke[tree], smoke["t_" + tree]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 7))
    jl, _, jaux = jtf.forward(jp, cfg, tokens=jnp.asarray(toks, jnp.int32))
    tl, _, taux = ttf.forward(tp, tcfg, tokens=_t(toks))
    _close(tl.numpy(), jl)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL and float(taux) > 0
    jlo, jc = jtf.prefill(jp, cfg, tokens=jnp.asarray(toks, jnp.int32),
                          max_len=12)
    tlo, tc = ttf.prefill(tp, tcfg, tokens=_t(toks), max_len=12)
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)
    pos = np.array([7, 6, 5], np.int32)            # ragged per-row offsets
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlo, -1)).astype(np.int32)
        np.testing.assert_array_equal(tlo.argmax(-1).numpy(), nxt)
        jlo, jc = jtf.decode_step(jp, cfg, jc, jnp.asarray(pos),
                                  tokens=jnp.asarray(nxt))
        tlo, tc = ttf.decode_step(tp, tcfg, tc, _t(pos), tokens=_t(nxt))
        _close(tlo.numpy(), jlo)
        pos = pos + 1
    _caches_close(tc, jc)


def test_layout_and_template_carry_per_leaf_dtypes(smoke):
    """The router stays f32 in a bf16 model: in the init, in the template
    a container load checks against, and through the bf16 and q8 blob
    loads (the reference's eval_shape template does the same)."""
    tcfg = smoke["tcfg"].replace(param_dtype="bfloat16",
                                 compute_dtype="bfloat16")
    specs = param_specs(tcfg)
    tree = ttf.init_params(tcfg, 0, device="cpu")
    flat = flatten_tree(tree)
    assert {k: (tuple(v.shape), v.dtype) for k, v in flat.items()} == {
        k: (tuple(s), d) for k, (s, d) in specs.items()}
    assert specs["layers/moe/router"][1] == torch.float32
    assert specs["layers/moe/w_gate"][1] == torch.bfloat16
    jflat = jflatten(jtf.init_params(jconfigs.get(ARCH, smoke=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16"),
        jax.random.PRNGKey(0)))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jflat.items()} == {
        k: (tuple(s), str(d)[6:]) for k, (s, d) in specs.items()}
    raw_blob = compression.get("raw").compress(tree).blob
    loaded = flatten_tree(ServeEngine.from_compressed(
        tcfg, raw_blob, backend="bf16", device="cpu").params)
    assert loaded["layers/moe/router"].dtype == torch.float32
    assert torch.equal(loaded["layers/moe/router"], flat["layers/moe/router"])
    q8_blob = compression.get("serve-q8").compress(tree).blob
    for backend in ("container", "q8"):
        got = flatten_tree(ServeEngine.from_compressed(
            tcfg, q8_blob, backend=backend, device="cpu").params)
        want = flatten_tree(quantize_tree_q8(tree))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert got["layers/moe/w_down/q8"].dtype == torch.int8
        assert tuple(got["layers/moe/w_down/q8s"].shape) == (
            2, tcfg.d_model)


# ---------------------------------------------------------------------------
# serving and containers
# ---------------------------------------------------------------------------

def _prompts(n, lengths, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (lengths[i % len(lengths)],)).astype(
        np.int32) for i in range(n)]


@pytest.mark.parametrize("backend", ["q8", "bf16"])
def test_session_tokens_match_reference(smoke, backend):
    """5 requests of mixed lengths over 3 slots, greedy and sampled:
    queueing, batched admission into the nested MoE caches, ragged decode
    with free slots."""
    prompts = _prompts(5, (5, 5, 7, 3), smoke["cfg"].vocab_size, seed=1)
    temps = [0.0, 0.8, 0.0, 0.8, 0.0]
    out = []
    for sess in (JSession(smoke["cfg"], smoke["raw"], backend=backend,
                          serve_cfg=JConfig(slots=3, max_len=16)),
                 ServeSession(smoke["tcfg"], params_from_numpy(
                     smoke["flat"], "cpu"), backend=backend, device="cpu",
                     serve_cfg=ServeConfig(slots=3, max_len=16))):
        hs = [sess.submit(p, max_new_tokens=6, temperature=t)
              for p, t in zip(prompts, temps)]
        sess.run()
        out.append([(h.tokens, h.finish_reason) for h in hs])
    assert out[0] == out[1]


def _rd_policy(tree) -> dict:
    rules = {k: {"step": compression.relative_step(v, 0.006), "lam": 1e-5,
                 "kind": "rd-grid"}
             for k, v in flatten_tree(tree).items()
             if v.dim() >= 2 and v.is_floating_point()}
    return {"format": "repro-tensor-policy", "version": 1, "rules": rules}


@pytest.mark.parametrize("codec", ["serve-q8", "deepcabac-rd"])
def test_containers_byte_identical_and_served_alike(smoke, codec):
    kw = {}
    if codec == "deepcabac-rd":
        kw = {"policy_table": _rd_policy(smoke["t_raw"]), "assign": "host"}
    want = jcompression.get(codec, **kw).compress(smoke["raw"]).blob
    got = compression.get(codec, **kw).compress(smoke["t_raw"]).blob
    assert got == want
    prompts = np.stack(_prompts(3, (6,), smoke["cfg"].vocab_size, seed=4))
    jtok = JEngine.from_compressed(smoke["cfg"], want, max_len=16,
                                   backend="container").generate(prompts, 5)
    kernels.clear_dispatch_report()
    eng = ServeEngine.from_compressed(smoke["tcfg"], got, max_len=16,
                                      backend="container", device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 5), jtok)
    w_gate = eng.params["layers"]["moe"]["w_gate"]
    assert isinstance(w_gate, dict) == (codec == "serve-q8")
    assert kernels.dispatch_report() == []


def test_launcher_serves_the_moe_smoke_model(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCH, "--smoke", "--backend", "q8",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "6",
                      "--steps", "3"])
    assert out.shape == (2, 3)
    text = capsys.readouterr().out
    assert "backend=q8 device=cpu" in text
    assert "dequant_matmul_grouped" in text


def test_chip_smoke_moe_parity_phase_at_smoke_size_on_cpu():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.phase_parity_moe("cpu")
    assert res["tokens_identical"] and res["logits_rel_diff"] == 0.0
    assert res["q8_mismatch_card_vs_cpu"] == {"float32": 0, "bfloat16": 0}
    assert res["drops"]["dropped_per_row_at_least"] > 0
