"""The other dense variants and MLA through the port against the JAX
package, on the CPU: qwen3-8b (qk-norm), qwen1.5-4b (QKV bias),
mistral-nemo-12b, qwen2-vl-7b (M-RoPE, embeddings in), musicgen-medium
(layernorm, gelu, embeddings in) and deepseek-v3-671b (MLA, MoE).

Every model is the smoke config.  The reference's parameters are carried
across with ``repro_torch.convert`` after their vectors (norm scales and
biases, QKV biases, the q/k/kv norms) are redrawn from a numpy seed, so
that those code paths are not the identity.  Inputs are made with numpy.
Tolerances, relative to the largest magnitude of the reference's result:
2e-5 for logits, caches and block outputs in f32 (the same f32 products
summed in another order, as ``tests/test_torch_model.py``); 2^-6 for a
block in bf16 (the packages round the bf16 products and the gelu at other
places, each a step of 2^-8 of a value); M-RoPE 1e-6 (the same f32 ops on
the same angles).  Loss and gradients as ``tests/test_torch_fim.py``:
loss rel 1e-5, each leaf within 1e-4 of its max|g|.  Integers agree
exactly: q8 levels and scales, int8 caches, greedy tokens.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compression.quantizers import quantize_tree_q8 as jq8  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeSession as JSession  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.compression import flatten_tree, quantize_tree_q8  # noqa: E402
from repro_torch.compression.tree import unflatten  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.serve.quantized import dequant_leaf  # noqa: E402

VARIANTS = ("qwen3-8b", "qwen1.5-4b", "mistral-nemo-12b", "qwen2-vl-7b",
            "musicgen-medium", "deepseek-v3-671b")
RTOL = 2e-5
RTOL_BF16_BLOCK = 2.0 ** -6
ROPE_ATOL = 1e-6
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
B, S, MAX_LEN, GREEDY = 2, 7, 16, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _is_vector(name: str, arr) -> bool:
    """A norm scale or bias, or a QKV bias: a vector per layer."""
    last = name.rsplit("/", 1)[-1]
    stacked = name.split("/", 1)[0] in ("layers", "dense_layers")
    return arr.ndim == (2 if stacked else 1) and (
        "norm" in name or last in ("bq", "bk", "bv"))


def _jax_params(cfg, seed=0) -> dict:
    """The reference's init with every vector redrawn: scales around 1,
    biases around 0 (flat, numpy)."""
    rng = np.random.default_rng(seed + 100)
    flat = {k: np.asarray(v) for k, v in
            jflatten(jtf.init_params(cfg, jax.random.PRNGKey(seed))).items()}
    for name, arr in flat.items():
        if _is_vector(name, arr):
            base = 0.0 if name.endswith(("bias", "bq", "bk", "bv")) else 1.0
            flat[name] = (base + 0.2 * rng.standard_normal(arr.shape)
                          ).astype(arr.dtype)
    return flat


def _jtree(flat: dict) -> dict:
    return unflatten({k: jnp.asarray(v) for k, v in flat.items()})


_MODELS: dict = {}


def _model(arch):
    """(jax cfg, port cfg, jax trees {raw, q8}, port trees {raw, q8})."""
    if arch not in _MODELS:
        cfg = jconfigs.get(arch, smoke=True)
        flat = _jax_params(cfg)
        jraw = _jtree(flat)
        jq = jq8(jraw)
        _MODELS[arch] = (cfg, configs.get(arch, smoke=True),
                         {"raw": jraw, "q8": jq},
                         {"raw": params_from_numpy(flat, "cpu"),
                          "q8": params_from_numpy(jflatten(jq), "cpu")})
    return _MODELS[arch]


def _pos3d(b, grid, n_text, start=0):
    """(3, b, grid[0] * grid[1] + n_text) M-RoPE streams: an image patch
    grid (t = 0, h = row, w = column) followed by text positions that
    continue from the grid's largest position + 1 in all three streams;
    row i of the batch is shifted by ``start + i``."""
    gh, gw = grid
    hh, ww = np.divmod(np.arange(gh * gw), gw)
    t0 = max(gh, gw)
    text = t0 + np.arange(n_text)
    streams = np.stack([np.concatenate([np.zeros(gh * gw, int), text]),
                        np.concatenate([hh, text]),
                        np.concatenate([ww, text])])          # (3, S)
    rows = [streams + start + i for i in range(b)]
    return np.stack(rows, axis=1).astype(np.int32)             # (3, b, S)


def _inputs(cfg, seed=0):
    """Prompt inputs of both packages and the stub frontend's table (the
    embedding of a generated token, for an embeddings model)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}, None
    out = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)}
    if cfg.m_rope:
        out["pos3d"] = _pos3d(B, (2, 2), S - 4)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    return out, table


def _step_inputs(cfg, tok, table, pos):
    """Decode inputs for the generated tokens ``tok`` (B,) at ``pos``."""
    if cfg.embed_input:
        return {"tokens": tok.astype(np.int32)}
    out = {"embeds": table[tok][:, None, :]}
    if cfg.m_rope:
        # text after the prompt: the prompt's last stream position + 1 + k
        out["pos3d"] = np.broadcast_to(
            (_pos3d(B, (2, 2), S - 4)[:, :, -1:] + 1 + pos - S),
            (3, B, 1)).astype(np.int32)
    return out


def _caches_close(tc, jc):
    want = {k: np.asarray(v) for k, v in jflatten(jc).items()}
    got = {k: tensor_to_numpy(v) for k, v in flatten_tree(tc).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if want[k].dtype == np.int8:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            _close(got[k], want[k])


# ---------------------------------------------------------------------------
# configs and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", VARIANTS)
def test_config_and_layout_match_reference(arch):
    for smoke in (False, True):
        want = dataclasses.asdict(jconfigs.get(arch, smoke=smoke))
        want.pop("kernels")
        assert dataclasses.asdict(configs.get(arch, smoke=smoke)) == want
    assert arch in configs.names()
    # full width: names, shapes and dtypes without allocating
    jcfg = jconfigs.get(arch)
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in flatten_tree(shapes).items()}
    got = {k: (tuple(shape), str(dt).replace("torch.", ""))
           for k, (shape, dt) in ttf.param_specs(configs.get(arch)).items()}
    assert got == want
    # smoke: init_params itself
    cfg, tcfg, _, _ = _model(arch)
    p = flatten_tree(ttf.init_params(tcfg, 0, device="cpu"))
    ref = jflatten(jtf.init_params(cfg, jax.random.PRNGKey(0)))
    assert p.keys() == ref.keys()
    for k, v in p.items():
        assert tuple(v.shape) == ref[k].shape, k
        assert tensor_to_numpy(v).dtype == np.asarray(ref[k]).dtype, k
    assert ("embed" in p) == tcfg.embed_input


def test_registry_keeps_the_ssm_archs_unported():
    assert configs.names() == [a for a in jconfigs.names()
                               if a not in ("mamba2-2.7b", "zamba2-2.7b")]
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            configs.get(arch)


@pytest.mark.parametrize("arch", VARIANTS)
def test_q8_tree_bit_identical(arch):
    _, _, jt, tt = _model(arch)
    want = {k: np.asarray(v) for k, v in jflatten(jt["q8"]).items()}
    got = {k: tensor_to_numpy(v) for k, v in
           flatten_tree(quantize_tree_q8(tt["raw"])).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("run", [1, 3])
def test_quantize_leaf_in_runs_of_experts_is_bit_exact(run, dtype,
                                                       monkeypatch):
    """A stacked bank layer larger than ``Q8_CHUNK_VALUES`` is quantized in
    runs of ``run`` experts (3 of 8 leaves a shorter last run): its levels
    and scales are still the reference's."""
    from repro.compression.quantizers import quantize_leaf as jquantize_leaf
    from repro_torch.compression import quantizers
    rng = np.random.default_rng(11)
    w = rng.standard_normal((2, 8, 24, 16)).astype(np.float32)
    w[1, 5, 3, :] *= 40.0                      # the max in a later run
    monkeypatch.setattr(quantizers, "Q8_CHUNK_VALUES", run * 24 * 16)
    want = jquantize_leaf(jnp.asarray(w).astype(jnp.dtype(dtype)))
    got = quantizers.quantize_leaf(_t(w).to(getattr(torch, dtype)))
    for key in ("q8", "q8s"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# layers: M-RoPE, layernorm + gelu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,sections", [(128, (16, 24, 24)), (32, (4, 6, 6))])
def test_m_rope_with_distinct_streams(d, sections):
    rng = np.random.default_rng(7)
    pos3d = _pos3d(2, (3, 4), 5, start=3)            # (3, 2, 17)
    assert len({tuple(s.ravel()) for s in pos3d}) == 3
    x = rng.standard_normal((2, pos3d.shape[-1], 3, d)).astype(np.float32)
    want = np.asarray(jlayers.apply_m_rope(jnp.asarray(x),
                                           jnp.asarray(pos3d), 1e6,
                                           sections))
    got = tlayers.apply_m_rope(_t(x), _t(pos3d), 1e6, sections).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROPE_ATOL)
    # a wrong section map moves the result
    bad = tlayers.apply_m_rope(_t(x), _t(pos3d[[1, 0, 2]]), 1e6,
                               sections).numpy()
    assert float(np.max(np.abs(bad - want))) > 1e-2
    # the broadcast default is plain RoPE
    p1 = np.broadcast_to(pos3d[0][None], pos3d.shape)
    np.testing.assert_allclose(
        tlayers.apply_m_rope(_t(x), _t(np.ascontiguousarray(p1)), 1e6,
                             sections).numpy(),
        tlayers.apply_rope(_t(x), _t(pos3d[0]), 1e6).numpy(),
        rtol=0, atol=ROPE_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_gelu_block(dtype):
    cfg, tcfg, jt, tt = _model("musicgen-medium")
    cfg = cfg.replace(compute_dtype=dtype)
    tcfg = tcfg.replace(compute_dtype=dtype)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    # layer 0, its parameters in the compute dtype (as the configs have
    # them: param_dtype == compute_dtype)
    jlp = jax.tree.map(lambda a: a[0].astype(jdt), jt["raw"]["layers"])
    tlp = params_from_numpy({k: np.asarray(v) for k, v in
                             jflatten(jlp).items()}, "cpu")
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jx = jnp.asarray(x).astype(jdt)
    want, _, _ = jtf._dense_block(jx, jlp, cfg, jnp.asarray(pos), None,
                                  None, None)
    tx = _t(x).to(tdt)
    got, _ = ttf._dense_block(tx, tlp, tcfg, _t(pos), None, None, None,
                              True)
    assert got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           RTOL if dtype == "float32" else RTOL_BF16_BLOCK)
    # the norm alone, chosen by cfg.norm; a layernorm's {scale, bias} under
    # a config that says rmsnorm fails instead of running the other norm
    _close(tlayers.norm(_t(x), tlp["attn_norm"], tcfg).numpy(),
           jtf._norm(jnp.asarray(x), jlp["attn_norm"], cfg))
    with pytest.raises(AttributeError):
        tlayers.norm(_t(x), tlp["attn_norm"], tcfg.replace(norm="rmsnorm"))


# ---------------------------------------------------------------------------
# the models: prefill, decode, greedy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["raw", "q8"])
@pytest.mark.parametrize("arch", VARIANTS)
def test_prefill_decode_and_greedy_match_reference(arch, tree):
    cfg, tcfg, jt, tt = _model(arch)
    jp, tp = jt[tree], tt[tree]
    inp, table = _inputs(cfg)
    jlo, jc = jtf.prefill(jp, cfg, max_len=MAX_LEN,
                          **{k: jnp.asarray(v) for k, v in inp.items()})
    tlo, tc = ttf.prefill(tp, tcfg, max_len=MAX_LEN,
                          **{k: _t(v) for k, v in inp.items()})
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)
    jdec = jax.jit(lambda p, c, pos, kw: jtf.decode_step(p, cfg, c, pos,
                                                         **kw))
    toks_j, toks_t = [], []
    for step in range(GREEDY):
        nj = np.asarray(jnp.argmax(jlo, -1))
        nt = tlo.argmax(-1).numpy()
        toks_j.append(nj)
        toks_t.append(nt)
        if step == GREEDY - 1:
            break
        kw = _step_inputs(cfg, nj, table, S + step)
        jlo, jc = jdec(jp, jc, jnp.int32(S + step),
                       {k: jnp.asarray(v) for k, v in kw.items()})
        tlo, tc = ttf.decode_step(tp, tcfg, tc, S + step,
                                  **{k: _t(v) for k, v in
                                     _step_inputs(cfg, nt, table,
                                                  S + step).items()})
        if step == 0:                     # one decode step, before argmax
            _close(tlo.numpy(), jlo)      # could diverge the two runs
            _caches_close(tc, jc)
    np.testing.assert_array_equal(np.stack(toks_t), np.stack(toks_j))


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "deepseek-v3-671b"])
def test_ragged_decode_matches_reference(arch):
    """Per-row decode offsets (the session's continuous batching), with
    the M-RoPE streams or the MLA latent cache."""
    cfg, tcfg, jt, tt = _model(arch)
    inp, table = _inputs(cfg, seed=3)
    jlo, jc = jtf.prefill(jt["q8"], cfg, max_len=MAX_LEN,
                          **{k: jnp.asarray(v) for k, v in inp.items()})
    tlo, tc = ttf.prefill(tt["q8"], tcfg, max_len=MAX_LEN,
                          **{k: _t(v) for k, v in inp.items()})
    pos = np.array([S, S - 2], np.int32)
    nxt = np.asarray(jnp.argmax(jlo, -1))
    kw = _step_inputs(cfg, nxt, table, S)
    jlo, jc = jtf.decode_step(jt["q8"], cfg, jc, jnp.asarray(pos),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    tlo, tc = ttf.decode_step(tt["q8"], tcfg, tc, _t(pos),
                              **{k: _t(v) for k, v in kw.items()})
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["raw", "q8"])
@pytest.mark.parametrize("q8_cache", [False, True])
def test_mla_attention_and_latent_cache(q8_cache, tree):
    cfg, tcfg, jt, tt = _model("deepseek-v3-671b")
    cfg = cfg.replace(q8_cache=q8_cache)
    tcfg = tcfg.replace(q8_cache=q8_cache)
    jp = jax.tree.map(lambda a: a[0], jt[tree]["layers"]["attn"])
    tp = ttf._layer_slice(tt[tree]["layers"]["attn"], 0)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jdt, tdt = ((jnp.int8, torch.int8) if q8_cache else
                (jnp.float32, torch.float32))
    shapes = {"ckv": (B, MAX_LEN, cfg.kv_lora_rank),
              "kr": (B, MAX_LEN, cfg.qk_rope_head_dim)}
    jcache = {k: jnp.zeros(v, jdt) for k, v in shapes.items()}
    tcache = {k: torch.zeros(v, dtype=tdt) for k, v in shapes.items()}
    want, jc = jattn.mla_attention(jnp.asarray(x), jp, cfg,
                                   jnp.asarray(pos), cache=jcache)
    got, tc = tattn.mla_attention(_t(x), tp, tcfg, _t(pos), cache=tcache)
    assert tc is tcache and tc["ckv"].dtype == tdt
    _close(got.numpy(), want)
    _caches_close(tc, jc)
    # decode: all rows at one offset, then ragged per-row offsets
    for cache_pos in (S, np.array([S + 1, S - 3], np.int32)):
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        cp = np.broadcast_to(np.asarray(cache_pos), (B,))
        p1 = cp[:, None].astype(np.int32)
        want, jc = jattn.mla_attention(jnp.asarray(x1), jp, cfg,
                                       jnp.asarray(p1), cache=jc,
                                       cache_pos=jnp.asarray(cache_pos))
        got, tc = tattn.mla_attention(
            _t(x1), tp, tcfg, _t(p1), cache=tc,
            cache_pos=(_t(cache_pos) if isinstance(cache_pos, np.ndarray)
                       else cache_pos))
        _close(got.numpy(), want)
        _caches_close(tc, jc)


def test_mla_int8_serving_prefill_and_decode():
    """The reference's ``test_int8_serving_mla`` through both packages:
    q8 weights and the int8 latent cache, nested {dense, main}."""
    cfg, tcfg, jt, tt = _model("deepseek-v3-671b")
    cfg = cfg.replace(q8_cache=True, capacity_factor=8.0)
    tcfg = tcfg.replace(q8_cache=True, capacity_factor=8.0)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jlo, jc = jtf.prefill(jt["q8"], cfg, tokens=jnp.asarray(toks),
                          max_len=S + 4)
    tlo, tc = ttf.prefill(tt["q8"], tcfg, tokens=_t(toks), max_len=S + 4)
    assert tc["main"]["ckv"].dtype == torch.int8
    assert tc["dense"]["kr"].shape == (1, B, S + 4, cfg.qk_rope_head_dim)
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)
    jlo, jc = jtf.decode_step(jt["q8"], cfg, jc, S,
                              tokens=jnp.asarray(toks[:, 0]))
    tlo, tc = ttf.decode_step(tt["q8"], tcfg, tc, S, tokens=_t(toks[:, 0]))
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)


def test_mla_fused_q8_equals_dequantized_dense():
    """As ``tests/test_compressed_resident.py::test_forward_equivalence``
    for deepseek-v3: the q8 forward (every MLA projection through
    dequant_matmul) equals the forward on the dequantized tree, and the
    report holds no dequant_matmul fallback and no loop dequant."""
    _, tcfg, _, tt = _model("deepseek-v3-671b")
    qp = tt["q8"]
    dp = unflatten({k: dequant_leaf(v, torch.float32) for k, v in
                    _q8_leaves(qp).items()})
    toks = _t(np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 8)))
    ttf._reported_loop_dequant.clear()
    kernels.clear_dispatch_report()
    lo_q, _, _ = ttf.forward(qp, tcfg, tokens=toks)
    lo_r, _, _ = ttf.forward(dp, tcfg, tokens=toks)
    np.testing.assert_allclose(lo_q.numpy(), lo_r.numpy(), atol=2e-5,
                               rtol=2e-5)
    assert torch.equal(lo_q.argmax(-1), lo_r.argmax(-1))
    recs = kernels.dispatch_report()
    assert [r for r in recs if r["op"].startswith("dequant_matmul")] == []
    assert [r for r in recs if r["kind"] == "loop_dequant"] == []
    for name in ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv"):
        assert name in ttf._FUSED_ELIGIBLE
        assert "q8" in qp["layers"]["attn"][name]


def _q8_leaves(tree, prefix=""):
    """Flat map whose values are q8 leaves as dicts or plain tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "q8" not in v:
            out.update(_q8_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(n, lengths, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (lengths[i % len(lengths)],)).astype(
        np.int32) for i in range(n)]


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v3-671b"])
def test_session_tokens_match_reference(arch):
    """5 requests of mixed lengths over 3 slots on q8, greedy and sampled:
    batched admission into the slot caches (the MLA latents included),
    ragged decode, slots reused as requests finish."""
    cfg, tcfg, jt, tt = _model(arch)
    prompts = _prompts(5, (5, 5, 7, 3), cfg.vocab_size, seed=1)
    temps = [0.0, 0.8, 0.0, 0.8, 0.0]
    out = []
    for sess in (JSession(cfg, jt["raw"], backend="q8",
                          serve_cfg=JConfig(slots=3, max_len=16)),
                 ServeSession(tcfg, tt["raw"], backend="q8", device="cpu",
                              serve_cfg=ServeConfig(slots=3, max_len=16))):
        hs = [sess.submit(p, max_new_tokens=6, temperature=t)
              for p, t in zip(prompts, temps)]
        sess.run()
        out.append([(h.tokens, h.finish_reason) for h in hs])
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_embeddings_models_are_refused_by_the_session(arch, capsys):
    _, tcfg, _, tt = _model(arch)
    with pytest.raises(ValueError, match="embeds="):
        ServeSession(tcfg, tt["raw"], backend="q8", device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="prefill / decode_step"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_launcher_serves_the_mla_smoke_model(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "deepseek-v3-671b", "--smoke", "--backend",
                      "q8", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--steps", "3"])
    assert out.shape == (2, 3)
    assert "dequant_matmul_grouped" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# train_loss with embeds and pos3d
# ---------------------------------------------------------------------------

def test_train_loss_with_embeds_and_pos3d_matches_jax_grad():
    from repro_torch.data import pipeline
    cfg, tcfg, jt, tt = _model("qwen2-vl-7b")
    rng = np.random.default_rng(5)
    jb = {"embeds": rng.standard_normal((2, 12, cfg.d_model)).astype(
              np.float32),
          "labels": rng.integers(0, cfg.vocab_size, (2, 12)).astype(
              np.int32),
          "pos3d": _pos3d(2, (3, 3), 3)}               # a patch grid + text
    tb = pipeline.to_device(jb, "cpu")
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.train_loss(p, b, cfg)))(jt["raw"], jb)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flatten_tree(tt["raw"]).items()}
    loss = ttf.train_loss(unflatten(leaves), tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = {k: np.asarray(v, np.float64) for k, v in jflatten(jg).items()}
    assert sorted(leaves) == sorted(want)
    for k, w in want.items():
        g = leaves[k].grad.double().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, k
    for name in ("wq", "wk", "bq", "bk"):          # through M-RoPE
        assert float(leaves[f"layers/attn/{name}"].grad.abs().max()) > 0


def test_chip_smoke_variants_parity_phase_at_smoke_size_on_cpu():
    """``chip_smoke.py``'s parity_variants phase with the CPU standing in
    for the card: every smoke variant, its q8 levels, tokens and logits."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.phase_parity_variants("cpu")
    assert sorted(res) == sorted([f"{a}/float32" for a in VARIANTS]
                                 + ["qwen2-vl-7b/bfloat16"])
    for r in res.values():
        assert r["tokens_differ"] == 0 and r["logits_rel_diff"] == 0.0
        assert r["q8_mismatch_card_vs_cpu"] == 0
