"""The SSM and hybrid families through the port against the JAX package,
on the CPU: mamba2-2.7b (Mamba2 mixers, attention-free) and zamba2-2.7b
(the mixers with one shared attention block every ``shared_attn_every``
layers).

Every model is the smoke config.  The reference's parameters are carried
across with ``repro_torch.convert`` after ``a_log``, ``dt_bias``,
``d_skip``, the conv biases and the norm scales are redrawn from a numpy
seed, so that A != -1 and no path is the identity.  Inputs are made with
numpy.  Tolerances, relative to the largest magnitude of the reference's
result, as ``tests/test_torch_variants.py``: 2e-5 in f32 (the same f32
products summed in another order); 2^-6 for a block in bf16 (the packages
round bf16 products at other places, each a step of 2^-8 of a value).
Loss rel 1e-5, gradients within 1e-4 of each leaf's max|g|.  Integers are
exact: q8 levels and scales, greedy tokens, container bytes, the
loop-dequant record set.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import kernels as jkernels  # noqa: E402
from repro.compression.quantizers import quantize_tree_q8 as jq8  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import ServeSession as JSession  # noqa: E402
from repro_torch import compression, configs, kernels  # noqa: E402
from repro_torch.compression import flatten_tree, quantize_tree_q8  # noqa: E402
from repro_torch.compression.tree import unflatten  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, ServeSession  # noqa: E402

ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
RTOL = 2e-5
RTOL_BF16_BLOCK = 2.0 ** -6
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
B, S, MAX_LEN, GREEDY = 2, 23, 40, 8
# the mixer tensors the reference dequantizes in its loop under q8
LOOP_DEQUANT = {"w_z", "w_x", "w_b", "w_c", "w_dt", "conv_x_w", "conv_b_w",
                "conv_c_w", "out_proj"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


_REDRAW = {  # leaf name -> (base, spread) of the redrawn values
    "a_log": (0.0, 0.5), "dt_bias": (-2.0, 0.5), "d_skip": (1.0, 0.2),
    "conv_x_b": (0.0, 0.2), "conv_b_b": (0.0, 0.2), "conv_c_b": (0.0, 0.2)}


def _redrawn(flat: dict, seed: int = 0) -> dict:
    """The reference's init with a_log, dt_bias, d_skip, the conv biases
    and every norm scale redrawn (flat, numpy)."""
    rng = np.random.default_rng(seed + 100)
    out = dict(flat)
    for name, arr in flat.items():
        last = name.rsplit("/", 1)[-1]
        if last in _REDRAW or "norm" in last:
            base, spread = _REDRAW.get(last, (1.0, 0.2))
            out[name] = (base + spread * rng.standard_normal(arr.shape)
                         ).astype(arr.dtype)
    return out


def _jtree(flat: dict) -> dict:
    return unflatten({k: jnp.asarray(v) for k, v in flat.items()})


_MODELS: dict = {}


def _model(arch, dtype="float32"):
    """(jax cfg, port cfg, jax trees {raw, q8}, port trees {raw, q8})."""
    key = (arch, dtype)
    if key not in _MODELS:
        cfg = jconfigs.get(arch, smoke=True).replace(param_dtype=dtype,
                                                     compute_dtype=dtype)
        tcfg = configs.get(arch, smoke=True).replace(param_dtype=dtype,
                                                     compute_dtype=dtype)
        flat = _redrawn({k: np.asarray(v) for k, v in jflatten(
            jtf.init_params(cfg, jax.random.PRNGKey(0))).items()})
        jraw = _jtree(flat)
        jq = jq8(jraw)
        _MODELS[key] = (cfg, tcfg, {"raw": jraw, "q8": jq},
                        {"raw": params_from_numpy(flat, "cpu"),
                         "q8": params_from_numpy(
                             {k: np.asarray(v)
                              for k, v in jflatten(jq).items()}, "cpu")})
    return _MODELS[key]


def _caches_close(tc, jc, rtol=RTOL):
    want = {k: np.asarray(v) for k, v in jflatten(jc).items()}
    got = {k: tensor_to_numpy(v) for k, v in flatten_tree(tc).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if want[k].dtype == np.int8:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            _close(got[k], want[k], rtol)


# ---------------------------------------------------------------------------
# configs and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_layout_match_reference(arch):
    assert configs.names() == jconfigs.names()
    for smoke in (False, True):
        assert dataclasses.asdict(configs.get(arch, smoke=smoke)) == \
            dataclasses.asdict(jconfigs.get(arch, smoke=smoke))
    # full width: names, shapes and dtypes without allocating
    jcfg = jconfigs.get(arch)
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in flatten_tree(shapes).items()}
    got = {k: (tuple(shape), str(dt).replace("torch.", ""))
           for k, (shape, dt) in ttf.param_specs(configs.get(arch)).items()}
    assert got == want
    for leaf in ("a_log", "dt_bias"):          # f32 in a bf16 model
        assert got[f"layers/mixer/{leaf}"][1] == "float32"
    assert got["layers/mixer/w_x"][1] == "bfloat16"
    assert ("shared/attn/wq" in got) == (arch == "zamba2-2.7b")
    # smoke: init_params itself, and its init values where they are fixed
    cfg, tcfg, _, _ = _model(arch)
    p = flatten_tree(ttf.init_params(tcfg, 0, device="cpu"))
    ref = {k: np.asarray(v) for k, v in
           jflatten(jtf.init_params(cfg, jax.random.PRNGKey(0))).items()}
    assert p.keys() == ref.keys()
    for k, v in p.items():
        assert tuple(v.shape) == ref[k].shape, k
        assert tensor_to_numpy(v).dtype == ref[k].dtype, k
        if k.rsplit("/", 1)[-1] in _REDRAW or k.endswith("norm"):
            np.testing.assert_array_equal(tensor_to_numpy(v), ref[k],
                                          err_msg=k)
    w = p["layers/mixer/conv_x_w"]                 # std W^-0.5
    assert abs(float(w.std()) - cfg.ssm_conv ** -0.5) < 0.05


@pytest.mark.parametrize("q8_cache", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, q8_cache):
    """Conv tails in the compute dtype and the state in f32, under
    ``q8_cache`` too; the hybrid's attention cache per group."""
    cfg, tcfg, _, _ = _model(arch)
    want = jflatten(jtf.init_cache(cfg.replace(q8_cache=q8_cache), 3, 11))
    got = flatten_tree(ttf.init_cache(tcfg.replace(q8_cache=q8_cache), 3,
                                      11, device="cpu"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert tensor_to_numpy(got[k]).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("arch", ARCHS)
def test_q8_tree_bit_identical(arch):
    _, _, jt, tt = _model(arch)
    want = {k: np.asarray(v) for k, v in jflatten(jt["q8"]).items()}
    got = {k: tensor_to_numpy(v) for k, v in
           flatten_tree(quantize_tree_q8(tt["raw"])).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the conv kernels are quantized per tap (their last dim), the f32
    # vectors stay as they are
    assert "layers/mixer/conv_x_w/q8" in got
    assert got["layers/mixer/a_log"].dtype == np.float32


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------

def test_segsum_matches_reference():
    a = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(
        np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = tssm._segsum(_t(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def _ssd_inputs(rng, s, h=4, p=8, g=2, n=6):
    x = rng.standard_normal((2, s, h, p)).astype(np.float32)
    a = -np.abs(rng.standard_normal((2, s, h))).astype(np.float32) * 0.3
    bm = rng.standard_normal((2, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((2, s, g, n)).astype(np.float32)
    return x, a, bm, cm


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunks", [1, 3])
def test_ssd_chunked_matches_reference(chunks, with_state):
    rng = np.random.default_rng(chunks + 10 * with_state)
    chunk = 8
    x, a, bm, cm = _ssd_inputs(rng, chunks * chunk)
    st = (rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
          if with_state else None)
    jy, jst = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(a),
                               jnp.asarray(bm), jnp.asarray(cm), chunk,
                               None if st is None else jnp.asarray(st))
    ty, tst = tssm.ssd_chunked(_t(x), _t(a), _t(bm), _t(cm), chunk,
                               None if st is None else _t(st))
    assert tst.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(tst.numpy(), jst)


@pytest.mark.parametrize("s", [1, 2, 9])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(with_tail, s):
    """S = 1 and 2 are shorter than the tail (W - 1 = 3): the new tail
    keeps part of the old one."""
    rng = np.random.default_rng(s)
    u = rng.standard_normal((2, s, 5)).astype(np.float32)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    bias = rng.standard_normal((5,)).astype(np.float32)
    tail = (rng.standard_normal((2, 3, 5)).astype(np.float32)
            if with_tail else None)
    jo, jt_ = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                jnp.asarray(bias),
                                None if tail is None else jnp.asarray(tail))
    to, tt_ = tssm._causal_conv(_t(u), _t(w), _t(bias),
                                None if tail is None else _t(tail))
    _close(to.numpy(), jo)
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt_))


def _mixer_case(arch, dtype, seed=3):
    cfg, tcfg, jt, tt = _model(arch, dtype)
    jp = jax.tree.map(lambda a: a[0], jt["raw"]["layers"]["mixer"])
    tp = ttf._layer_slice(tt["raw"]["layers"]["mixer"], 0)
    return cfg, tcfg, jp, tp, np.random.default_rng(seed)


@pytest.mark.parametrize("s", [1, 5, 16, 23])
def test_mamba2_mixer_prefill_and_decode_match_reference(s):
    """Prefill from a zero cache (S = 1 takes the decode branch; 5 and 23
    are front-padded to the 16-token chunk), then two decode steps: the
    output, the final state and the three tails, written into the cache
    the caller passed."""
    cfg, tcfg, jp, tp, rng = _mixer_case("mamba2-2.7b", "float32")
    cache_t = ttf._layer_slice(ttf.init_cache(tcfg, B, 1, device="cpu"), 0)
    cache_j = jax.tree.map(lambda a: a[0], jtf.init_cache(cfg, B, 1))
    for step, length in enumerate((s, 1, 1)):
        x = rng.standard_normal((B, length, cfg.d_model)).astype(np.float32)
        want, cache_j = jssm.mamba2_mixer(jnp.asarray(x), jp, cfg,
                                          cache=cache_j)
        state = cache_t["state"]
        got, out_c = tssm.mamba2_mixer(_t(x), tp, tcfg, cache=cache_t)
        assert out_c is cache_t and out_c["state"] is state   # in place
        _close(got.numpy(), want)
        _caches_close(out_c, cache_j)
    # no cache: the chunked scan alone (train_loss's path)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    want, _ = jssm.mamba2_mixer(jnp.asarray(x), jp, cfg)
    got, none = tssm.mamba2_mixer(_t(x), tp, tcfg)
    assert none is None
    _close(got.numpy(), want)


def test_mamba2_mixer_in_bf16_matches_reference():
    """A bf16 mixer: f32 dt, scan and state, the y and the conv in bf16."""
    cfg, tcfg, jp, tp, rng = _mixer_case("mamba2-2.7b", "bfloat16")
    assert tp["a_log"].dtype == torch.float32
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    cache_j = jax.tree.map(lambda a: a[0], jtf.init_cache(cfg, B, 1))
    cache_t = ttf._layer_slice(ttf.init_cache(tcfg, B, 1, device="cpu"), 0)
    want, cache_j = jssm.mamba2_mixer(jnp.asarray(x).astype(jnp.bfloat16),
                                      jp, cfg, cache=cache_j)
    got, cache_t = tssm.mamba2_mixer(_t(x).to(torch.bfloat16), tp, tcfg,
                                     cache=cache_t)
    assert got.dtype == torch.bfloat16
    assert cache_t["state"].dtype == torch.float32
    assert cache_t["conv"]["x"].dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           RTOL_BF16_BLOCK)
    _close(cache_t["state"].numpy(), cache_j["state"], RTOL_BF16_BLOCK)


# ---------------------------------------------------------------------------
# the models: prefill, decode, greedy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["raw", "q8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_greedy_match_reference(arch, tree):
    cfg, tcfg, jt, tt = _model(arch)
    jp, tp = jt[tree], tt[tree]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    jlo, jc = jtf.prefill(jp, cfg, tokens=jnp.asarray(toks, jnp.int32),
                          max_len=MAX_LEN)
    tlo, tc = ttf.prefill(tp, tcfg, tokens=_t(toks), max_len=MAX_LEN)
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)
    jdec = jax.jit(lambda p, c, pos, t: jtf.decode_step(p, cfg, c, pos,
                                                        tokens=t))
    toks_j, toks_t = [], []
    for step in range(GREEDY):
        nj = np.asarray(jnp.argmax(jlo, -1))
        nt = tlo.argmax(-1).numpy()
        toks_j.append(nj)
        toks_t.append(nt)
        if step == GREEDY - 1:
            break
        jlo, jc = jdec(jp, jc, jnp.int32(S + step), jnp.asarray(nj))
        tlo, tc = ttf.decode_step(tp, tcfg, tc, S + step, tokens=_t(nt))
        if step == 0:
            _close(tlo.numpy(), jlo)
            _caches_close(tc, jc)
    np.testing.assert_array_equal(np.stack(toks_t), np.stack(toks_j))


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_decode_matches_reference(arch):
    """Per-row decode offsets (the session's continuous batching): the
    hybrid's attention writes each row at its own position."""
    cfg, tcfg, jt, tt = _model(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    jlo, jc = jtf.prefill(jt["q8"], cfg, tokens=jnp.asarray(toks, jnp.int32),
                          max_len=MAX_LEN)
    tlo, tc = ttf.prefill(tt["q8"], tcfg, tokens=_t(toks), max_len=MAX_LEN)
    pos = np.array([S, S - 4], np.int32)
    nxt = np.asarray(jnp.argmax(jlo, -1)).astype(np.int32)
    jlo, jc = jtf.decode_step(jt["q8"], cfg, jc, jnp.asarray(pos),
                              tokens=jnp.asarray(nxt))
    tlo, tc = ttf.decode_step(tt["q8"], tcfg, tc, _t(pos), tokens=_t(nxt))
    _close(tlo.numpy(), jlo)
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_q8_loop_dequant_records_match_reference(arch):
    """Under q8 the mixer tensors have no fused consumer: both packages
    dequantize them in the loop and record the same names, once each; the
    hybrid's shared block (2-D q8 leaves) goes to dequant_matmul."""
    cfg, tcfg, jt, tt = _model(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 6))

    def names(report):
        return {r["reason"].split(":", 1)[0] for r in report
                if r["kind"] == "loop_dequant"}
    jtf._reported_loop_dequant.clear()
    jkernels.clear_dispatch_report()
    jtf.forward(jt["q8"], cfg, tokens=jnp.asarray(toks, jnp.int32))
    want = names(jkernels.dispatch_report())
    ttf._reported_loop_dequant.clear()
    kernels.clear_dispatch_report()
    kernels.reset_launch_counts()
    for _ in range(2):
        ttf.forward(tt["q8"], tcfg, tokens=_t(toks))
    report = kernels.dispatch_report()
    assert want == LOOP_DEQUANT
    assert names(report) == want
    assert len(report) == len(want)                 # once per tensor
    assert {r["op"] for r in report} == {"dequant_matmul"}
    if arch == "zamba2-2.7b":                       # unstacked, 2-D levels
        assert tt["q8"]["shared"]["attn"]["wq"]["q8"].dim() == 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["q8", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_session_tokens_match_reference(arch, backend):
    """6 requests over 3 slots, mixed lengths with a 1-token prompt,
    greedy and sampled: batched admission places each prefill's state and
    tails (and the hybrid's attention rows) into the slots."""
    cfg, tcfg, jt, tt = _model(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 5, 1, 7, 3, 1)]
    temps = [0.0, 0.8, 0.0, 0.0, 0.8, 0.0]
    out = []
    for sess in (JSession(cfg, jt["raw"], backend=backend,
                          serve_cfg=JConfig(slots=3, max_len=16)),
                 ServeSession(tcfg, tt["raw"], backend=backend, device="cpu",
                              serve_cfg=ServeConfig(slots=3, max_len=16))):
        hs = [sess.submit(p, max_new_tokens=6, temperature=t)
              for p, t in zip(prompts, temps)]
        sess.run()
        out.append([(h.tokens, h.finish_reason) for h in hs])
    assert out[0] == out[1]


def test_prefill_buckets_stay_refused():
    _, tcfg, _, tt = _model("mamba2-2.7b")
    with pytest.raises(ValueError, match="dense-family"):
        ServeSession(tcfg, tt["raw"], device="cpu",
                     serve_cfg=ServeConfig(prefill_buckets=(8,)))


def test_serve_q8_container_is_byte_identical_and_loads_in_both():
    """The mamba2 smoke model's serve-q8 container: the same bytes from
    either package, and both packages' engines serve it (a_log and dt_bias
    stay f32 records) with the same tokens."""
    cfg, tcfg, jt, tt = _model("mamba2-2.7b")
    jblob = jcompression.get("serve-q8").compress(jt["raw"]).blob
    tblob = compression.get("serve-q8").compress(tt["raw"]).blob
    assert bytes(tblob) == bytes(jblob)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = JEngine.from_compressed(cfg, jblob, max_len=16).generate(
        prompts, 5)
    eng = ServeEngine.from_compressed(tcfg, tblob, max_len=16, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 5), want)
    mixer = eng.params["layers"]["mixer"]
    assert mixer["a_log"].dtype == torch.float32
    assert isinstance(mixer["w_x"], dict)           # int8 resident


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_smoke_model(arch, capsys):
    from repro_torch.launch import serve
    ttf._reported_loop_dequant.clear()
    kernels.clear_dispatch_report()
    out = serve.main(["--arch", arch, "--smoke", "--backend", "q8",
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      "6", "--steps", "3"])
    assert out.shape == (2, 3)
    text = capsys.readouterr().out
    assert "backend=q8 device=cpu" in text
    assert "kernel loop_dequant: dequant_matmul" in text


# ---------------------------------------------------------------------------
# train_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_jax_grad(arch):
    cfg, tcfg, jt, tt = _model(arch)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 20)).astype(
                 np.int32)}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.train_loss(p, b, cfg)))(jt["raw"], batch)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flatten_tree(tt["raw"]).items()}
    loss = ttf.train_loss(unflatten(leaves),
                          {k: _t(v).long() for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = {k: np.asarray(v, np.float64) for k, v in jflatten(jg).items()}
    assert sorted(leaves) == sorted(want)
    for k, w in want.items():
        g = leaves[k].grad.double().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, k
    for name in ("a_log", "dt_bias", "conv_x_w", "w_b"):   # through the scan
        assert float(leaves[f"layers/mixer/{name}"].grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# chip_smoke's phase on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_ssm_parity_phase_at_smoke_size_on_cpu():
    """``chip_smoke.py``'s parity_ssm phase with the CPU standing in for
    the card: both smoke models in f32 on q8 and in bf16."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.LOOP_DEQUANT) == LOOP_DEQUANT    # the reference's set
    res = mod.phase_parity_ssm("cpu")
    assert sorted(res) == sorted(f"{a}/{d}" for a in ARCHS
                                 for d in ("float32", "bfloat16"))
    for r in res.values():
        assert r["tokens_differ"] == 0 and r["logits_rel_diff"] == 0.0
        assert r["q8_mismatch_card_vs_cpu"] == 0
        assert r["graph_tokens_differ"] == 0
        assert set(r["report"]) == LOOP_DEQUANT
