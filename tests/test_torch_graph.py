"""The compiled serving step on the CPU: what a CUDA graph needs of the
step, the MoE routing it captures, and the graph runner's bookkeeping.

* Capture-safety: ``prefill`` (plain and padded) and ``decode_step`` of
  the dense, MoE, SSM and hybrid smoke models (the SSM decode writes its
  state and conv tails in place) run under a dispatch mode that raises on
  every op that reads a device value on the host, sizes its output on the
  host or makes a tensor from host data (on the card, a copy from pageable
  memory): a CUDA graph can capture none of them.
* Routing against ``repro.models.moe``: the expert ids, capacity
  positions, keep masks and capacity buffer that the reference's own
  ``moe_block`` computes (read out of it by replacing its expert products)
  equal the port's exactly, with forced ties and forced drops, in f32 and
  bf16.  Inputs are small integers on an exact grid, so the router logits
  are exact in both packages and ties are real ties.  The block's output
  agrees to 2e-5 of max|out| in f32 (``tests/test_torch_moe.py``'s
  tolerance) and to 2^-5 in bf16: the packages round the bf16 expert
  products and SwiGLU at other places (JAX rounds sigmoid and product to
  bf16 apart, PyTorch the SiLU once), each a step of 2^-8 of a value,
  summed through the down product (1.2e-2 at most on these cases); the
  aux loss to 1e-6.  The combined weights of the coded output agree to
  2^-7 absolute in bf16 (weights <= 1, rounded to bf16 after the
  packages' softmaxes, which may differ by an ulp).
* The runner (``serve.graphs.StepGraphs``) with a stub graph backend: the
  first use of a shape is eager, the second captures once, every replay
  credits the captured launches, a step's results land in the caller's
  tensors and are read before the next step (a graph keeps no outputs),
  and ``eager_steps()`` captures nothing.  A session on the stub gives the
  eager session's tokens; its own steps, which place a prefill's caches
  into the slots, run under the dispatch mode above.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.compression import quantize_tree_q8  # noqa: E402
from repro_torch.compression.tree import flatten_tree, unflatten  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.serve.graphs import StepGraphs, eager_steps  # noqa: E402

ARCHS = ("llama3-8b", "deepseek-moe-16b")
RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -5}
WEIGHT_ATOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
AUX_ATOL = 1e-6


# ---------------------------------------------------------------------------
# capture-safety
# ---------------------------------------------------------------------------

_FORBIDDEN = {"_local_scalar_dense", "item", "equal", "is_nonzero",
              "nonzero", "_assert_async", "bincount", "masked_select",
              "lift_fresh"}


class NoHostSync(TorchDispatchMode):
    """Raise on every op a CUDA graph cannot capture: a device value read
    on the host, an output sized on the host, a tensor made from host
    data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _FORBIDDEN or name.lstrip("_").startswith("unique"):
            raise AssertionError(f"host-syncing op in a step: {func}")
        return func(*args, **(kwargs or {}))


def _smoke(arch, tree, **overrides):
    cfg = configs.get(arch, smoke=True).replace(**overrides)
    params = ttf.init_params(cfg, 0, device="cpu")
    return cfg, (quantize_tree_q8(params) if tree == "q8" else params)


@pytest.mark.parametrize("step", ["prefill", "prefill_padded", "decode"])
@pytest.mark.parametrize("tree", ["raw", "q8"])
@pytest.mark.parametrize("arch", ARCHS + ("deepseek-moe-16b-drops",
                                          "mamba2-2.7b", "zamba2-2.7b"))
def test_steps_run_with_no_host_sync(arch, tree, step):
    overrides = {}
    if arch.endswith("-drops"):            # 2 x 24 picks over 8 x cap 8
        arch, overrides = arch[:-6], {"capacity_factor": 0.25}
    cfg, params = _smoke(arch, tree, **overrides)
    rng = np.random.default_rng(1)
    b, s, max_len = 3, 24, 32
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    last = torch.tensor([23, 9, 0])
    pos = torch.tensor([24, 10, 1], dtype=torch.int32)
    tok1 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b,)))
    logits, caches = ttf.prefill(params, cfg, tokens=toks, max_len=max_len)
    with NoHostSync():
        if step == "prefill":
            out, _ = ttf.prefill(params, cfg, tokens=toks, max_len=max_len)
        elif step == "prefill_padded":
            out, _ = ttf.prefill(params, cfg, tokens=toks, max_len=max_len,
                                 last_index=last)
        else:
            out, _ = ttf.decode_step(params, cfg, caches, pos, tokens=tok1)
    assert out.shape == (b, cfg.vocab_size)
    assert torch.isfinite(out).all()
    if step == "prefill":
        assert torch.equal(out, logits)


@pytest.mark.parametrize("step", ["prefill", "prefill_padded", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen2-vl-7b",
                                  "musicgen-medium"])
def test_mla_and_m_rope_steps_run_with_no_host_sync(arch, step):
    """The MLA latent cache (q8, int8 cache), M-RoPE with its (3, B, S)
    streams and layernorm: prefill and ragged decode capture-safe."""
    cfg, params = _smoke(arch, "q8", q8_cache=True)
    rng = np.random.default_rng(2)
    b, s, max_len = 3, 24, 32
    if cfg.embed_input:
        inp = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                       (b, s)))}
        inp1 = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                        (b,)))}
    else:
        inp = {"embeds": torch.randn(b, s, cfg.d_model)}
        inp1 = {"embeds": torch.randn(b, 1, cfg.d_model)}
        if cfg.m_rope:
            grid = torch.arange(s) // 4                    # distinct streams
            inp["pos3d"] = torch.stack([torch.zeros(s, dtype=torch.long),
                                        grid, torch.arange(s) % 4]
                                       )[:, None].expand(3, b, s)
            inp1["pos3d"] = torch.full((3, b, 1), s)
    last = torch.tensor([23, 9, 0])
    pos = torch.tensor([24, 10, 1], dtype=torch.int32)
    logits, caches = ttf.prefill(params, cfg, max_len=max_len, **inp)
    with NoHostSync():
        if step == "prefill":
            out, _ = ttf.prefill(params, cfg, max_len=max_len, **inp)
        elif step == "prefill_padded":
            out, _ = ttf.prefill(params, cfg, max_len=max_len,
                                 last_index=last, **inp)
        else:
            out, _ = ttf.decode_step(params, cfg, caches, pos, **inp1)
    assert out.shape == (b, cfg.vocab_size)
    assert torch.isfinite(out).all()
    if step == "prefill":
        assert torch.equal(out, logits)


def test_the_mode_catches_a_host_sync():
    with pytest.raises(AssertionError, match="host-syncing"):
        with NoHostSync():
            torch.nn.functional.one_hot(torch.zeros(3, dtype=torch.long), 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_session_steps_run_with_no_host_sync(arch):
    """The session's own steps, as a graph captures them: a prefill of 2
    rows placed into slots 2 and 0 through its slot-index input (plain,
    then padded), then a decode over the 3 slots; each writes the
    session's logits buffer and caches, and equals the model's steps."""
    cfg, params = _smoke(arch, "q8")
    sess = ServeSession(cfg, params, backend="q8", device="cpu",
                        serve_cfg=ServeConfig(slots=3, max_len=16))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    last = torch.tensor([5, 3], dtype=torch.int32)
    idx = torch.tensor([2, 0])
    tok3 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3,)))
    pos3 = torch.tensor([6, 0, 4], dtype=torch.int32)
    want, caches = ttf.prefill(sess.params, cfg, tokens=toks, max_len=16)
    with NoHostSync():
        sess._prefill(idx, toks)
    assert torch.equal(sess.logits[:2], want)
    for name, full in flatten_tree(sess._caches).items():
        part = flatten_tree(caches)[name]
        assert torch.equal(full[:, 2], part[:, 0])
        assert torch.equal(full[:, 0], part[:, 1])
    want, _ = ttf.prefill(sess.params, cfg, tokens=toks, max_len=16,
                          last_index=last)
    with NoHostSync():
        sess._prefill(idx, toks, last)
    assert torch.equal(sess.logits[:2], want)
    expect = {k: v.clone() for k, v in flatten_tree(sess._caches).items()}
    want, _ = ttf.decode_step(sess.params, cfg,
                              unflatten(expect), pos3, tokens=tok3)
    with NoHostSync():
        sess._decode(tok3, pos3)
    assert torch.equal(sess.logits, want)


def test_host_offset_takes_host_values_and_row_tensors_only():
    from repro_torch.models.attention import host_offset
    assert host_offset(7) == 7 and host_offset(np.int32(7)) == 7
    assert host_offset(torch.tensor(7)) == 7
    assert host_offset(torch.tensor([7, 3])) is None
    with pytest.raises(ValueError, match="cache_pos"):
        host_offset(torch.zeros((2, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# routing against the reference
# ---------------------------------------------------------------------------

def _routing_case(case, dtype):
    """The MoE smoke config without shared experts, and x (G, S, d) and a
    dense router whose logits are exact: x in {-2..2}, router entries in
    {-1, 0, 1} / 4, at most 128 products per logit.  ``tie``: experts 1
    and 5 copy experts 0 and 3, so each pair ties exactly; ``drops``: the
    same, and every token's feature 0 puts experts 0 and 1 first, 16
    tokens for 8 capacity rows."""
    cfg = jconfigs.get("deepseek-moe-16b", smoke=True).replace(
        num_shared_experts=0)
    tcfg = configs.get("deepseek-moe-16b", smoke=True).replace(
        num_shared_experts=0)
    g, s, d, e = 3, 16, cfg.d_model, cfg.num_experts
    rng = np.random.default_rng({"smoke": 0, "tie": 1, "drops": 2}[case])
    x = rng.integers(-2, 3, (g, s, d)).astype(np.float32)
    router = (rng.integers(-1, 2, (d, e)) / 4).astype(np.float32)
    if case in ("tie", "drops"):
        router[:, 1], router[:, 5] = router[:, 0], router[:, 3]
    if case == "drops":
        x[..., 0] = 2
        router[0, :2] = 8.0
    w = {name: (rng.standard_normal((e, d_in, d_out)) * d_in ** -0.5
                ).astype(np.float32)
         for name, d_in, d_out in (("w_gate", d, cfg.moe_d_ff),
                                   ("w_up", d, cfg.moe_d_ff),
                                   ("w_down", cfg.moe_d_ff, d))}
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        w = {k: v.astype(ml_dtypes.bfloat16) for k, v in w.items()}
    return cfg, tcfg, x, {"router": router, **w}


def _codes(buf_shape, d, dtype):
    """Stand-in for the expert products' result: capacity row c of expert
    e holds the unit vector e*C + c, so the combined output of a token
    shows which rows it read and with which weight."""
    g, e, c, _ = buf_shape
    return np.broadcast_to(np.eye(e * c, d, dtype=np.float32).reshape(
        1, e, c, d), (g, e, c, d)).astype(dtype)


def _read_codes(out, topi, c):
    """(pos, keep) of every choice from a coded output: a kept choice of
    expert e has its weight at e*C + pos, a dropped one shows nothing."""
    g, s, k = topi.shape
    pos = np.full((g, s, k), -1)
    for gi, si, j in np.ndindex(g, s, k):
        e = topi[gi, si, j]
        hit = np.flatnonzero(out[gi, si, e * c:(e + 1) * c])
        assert len(hit) <= 1
        if len(hit):
            pos[gi, si, j] = hit[0]
    return pos, pos >= 0


def _reference_routing(monkeypatch, cfg, x, p):
    """Run the reference's moe_block with its expert products replaced;
    return its top-k ids, the capacity buffer it built, its coded output
    and the capacity."""
    seen = {}
    real_top_k = jax.lax.top_k

    class _Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        @staticmethod
        def top_k(probs, k):
            seen["top"] = real_top_k(probs, k)
            return seen["top"]

    def experts(buf, w, *, policy=None):
        seen.setdefault("bufs", []).append(buf)
        if len(seen["bufs"]) < 3:                 # w_gate, w_up
            return jnp.zeros(buf.shape[:-1] + (w.shape[-1],), buf.dtype)
        return jnp.asarray(_codes(buf.shape, x.shape[-1], buf.dtype))

    monkeypatch.setattr(jmoe, "lax", _Lax())
    monkeypatch.setattr(jmoe, "_expert_einsum", experts)
    out, _ = jmoe.moe_block(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in p.items()}, cfg)
    buf = seen["bufs"][0]
    return (np.asarray(seen["top"][1]), np.asarray(buf, np.float32),
            np.asarray(out, np.float32), buf.shape[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["smoke", "tie", "drops"])
def test_routing_equals_the_reference_exactly(monkeypatch, case, dtype):
    cfg, tcfg, x, p = _routing_case(case, dtype)
    topi_j, buf_j, out_j, cap = _reference_routing(monkeypatch, cfg, x, p)
    pos_j, keep_j = _read_codes(out_j, topi_j, cap)

    seen = {}
    real_route = tmoe.route

    def route(*args):
        seen["route"] = real_route(*args)
        return seen["route"]

    def experts(buf, w, *, policy=None):
        seen.setdefault("bufs", []).append(buf)
        if len(seen["bufs"]) < 3:
            return torch.zeros(buf.shape[:-1] + (w.shape[-1],),
                               dtype=buf.dtype)
        return tensor_from_numpy(_codes(tuple(buf.shape), x.shape[-1],
                                        np.float32), "cpu").to(buf.dtype)

    monkeypatch.setattr(tmoe, "route", route)
    monkeypatch.setattr(tmoe, "_expert_einsum", experts)
    tp = {k: tensor_from_numpy(v, "cpu") for k, v in p.items()}
    out, _ = tmoe.moe_block(tensor_from_numpy(x, "cpu"), tp, tcfg)
    _, pos, keep = seen["route"]
    logits = torch.einsum("gsd,de->gse", tensor_from_numpy(x, "cpu").float(),
                          tp["router"])
    _, topi = tmoe.top_k(torch.softmax(logits, -1), tcfg.top_k)

    np.testing.assert_array_equal(topi.numpy(), topi_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    np.testing.assert_array_equal(pos.numpy()[keep_j], pos_j[keep_j])
    np.testing.assert_array_equal(pos.numpy()[~keep_j], cap - 1)
    np.testing.assert_array_equal(seen["bufs"][0].float().numpy(), buf_j)
    pos_t, keep_t = _read_codes(out.float().numpy(), topi_j, cap)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_allclose(out.float().numpy(), out_j, rtol=0,
                               atol=WEIGHT_ATOL[dtype])
    dropped = int((~keep_j).sum())
    assert (dropped > 0) == (case == "drops")
    if case != "smoke":          # the lower index of a tied pair comes first
        pairs = 0
        for lo, hi in ((0, 1), (3, 5)):
            both = (topi_j == lo).any(-1) & (topi_j == hi).any(-1)
            first = np.argmax(topi_j == lo, -1) < np.argmax(topi_j == hi, -1)
            assert first[both].all()
            pairs += int(both.sum())
        assert pairs > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["smoke", "tie", "drops"])
def test_moe_block_output_and_aux_match_the_reference(case, dtype):
    cfg, tcfg, x, p = _routing_case(case, dtype)
    want, want_aux = jmoe.moe_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, cfg)
    got, got_aux = tmoe.moe_block(
        tensor_from_numpy(x, "cpu"),
        {k: tensor_from_numpy(v, "cpu") for k, v in p.items()}, tcfg)
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    assert float(np.max(np.abs(got.float().numpy() - want))) <= \
        RTOL[dtype] * scale
    assert abs(float(got_aux) - float(want_aux)) <= AUX_ATOL
    _, none = tmoe.moe_block(
        tensor_from_numpy(x, "cpu"),
        {k: tensor_from_numpy(v, "cpu") for k, v in p.items()}, tcfg,
        with_aux=False)
    assert none is None


def test_serving_steps_skip_the_aux_loss_and_forward_keeps_it(monkeypatch):
    cfg, params = _smoke("deepseek-moe-16b", "q8")
    asked = []
    real = tmoe.moe_block

    def spy(x, p, cfg_, *, with_aux=True):
        asked.append(with_aux)
        return real(x, p, cfg_, with_aux=with_aux)

    monkeypatch.setattr(ttf, "moe_block", spy)
    toks = torch.zeros((2, 5), dtype=torch.long)
    _, caches = ttf.prefill(params, cfg, tokens=toks, max_len=8)
    ttf.decode_step(params, cfg, caches, torch.tensor([5, 5]),
                    tokens=toks[:, 0])
    n_moe = cfg.num_layers - cfg.first_dense_layers
    assert asked == [False] * (2 * n_moe)
    asked.clear()
    _, _, aux = ttf.forward(params, cfg, tokens=toks)
    assert asked == [True] * n_moe and float(aux) > 0


# ---------------------------------------------------------------------------
# the runner's bookkeeping, on a stub graph backend
# ---------------------------------------------------------------------------

class StubGraphs:
    """A graph backend on the CPU.  A capture runs the step's Python once,
    as a real capture does (here that also computes it; a serving step
    writes the same values again when the replay that follows runs it);
    a replay runs the step on the static inputs and counts none of its
    launches (a replay runs no Python)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def capture(self, fn):
        self.captures += 1
        fn()
        return fn

    def replay(self, graph):
        self.replays += 1
        with registry.captured_launches():
            graph()


def test_runner_warms_up_captures_once_and_credits_replays():
    stub = StubGraphs()
    runner = StepGraphs("cpu", backend=stub)
    calls, got = [], []
    out = torch.zeros(2, dtype=torch.int32)   # the caller's output tensor

    def step(x):
        calls.append(x)
        kernels.registry.count_launch("dequant_matmul")
        kernels.registry.count_launch("flash_attention")
        out.copy_(x * 2)

    kernels.reset_launch_counts()
    for i in range(4):
        runner.run(("decode",), step, (np.array([i, i + 1], np.int32),))
        got.append(out.tolist())           # read before the next step
    assert got == [[2 * i, 2 * i + 2] for i in range(4)]
    assert runner.stats == {"eager": 1, "captures": 1, "replays": 3}
    assert (stub.captures, stub.replays) == (1, 3)
    # the eager step's launches, then one step's worth per replay; the
    # capture's own calls counted nothing
    assert kernels.launch_counts()["dequant_matmul"] == 4
    assert kernels.launch_counts()["flash_attention"] == 4
    # one static input buffer, filled anew before every replay
    assert len({id(c) for c in calls[1:]}) == 1
    # the graph keeps its inputs and nothing that the step wrote
    g = runner._graphs[("decode",)]
    assert set(vars(g)) == {"graph", "inputs", "staging", "launches",
                            "loaded"}

    with eager_steps():
        runner.run(("decode",), step, (np.array([7, 8], np.int32),))
    assert out.tolist() == [14, 16]
    assert runner.stats == {"eager": 1, "captures": 1, "replays": 3}
    assert kernels.launch_counts()["dequant_matmul"] == 5

    runner.run(("prefill", 2, 8, False), step, (np.zeros(2, np.int32),))
    assert runner.stats["eager"] == 2 and stub.captures == 1


def test_a_failed_capture_raises_and_runs_nothing_eagerly():
    class Failing(StubGraphs):
        def capture(self, fn):
            raise RuntimeError("capture failed")

    runner = StepGraphs("cpu", backend=Failing())
    ran = []

    def step(x):
        ran.append(1)

    runner.run("k", step, (np.zeros(2, np.int32),))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            runner.run("k", step, (np.zeros(2, np.int32),))
    assert ran == [1] and runner.stats["eager"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_session_on_stub_graphs_gives_the_eager_tokens(arch):
    """7 requests over 3 slots: admissions of 2 and 1 rows, padded and
    plain prefills, evictions at different lengths and refilled slots."""
    cfg, params = _smoke(arch, "q8")
    scfg = ServeConfig(slots=3, max_len=24,
                       prefill_buckets=(8,) if arch == "llama3-8b" else ())
    rng = np.random.default_rng(4)
    lens = (5, 5, 8, 5, 8, 5, 5) if arch == "llama3-8b" else (5,) * 7
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    new = (3, 6, 4, 5, 2, 6, 4)
    out = []
    stubs = []
    for graphs in (False, True):
        sess = ServeSession(cfg, params, backend="q8", device="cpu",
                            serve_cfg=scfg)
        if graphs:
            stubs.append(StubGraphs())
            sess.graphs = StepGraphs("cpu", backend=stubs[-1])
        hs = [sess.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        sess.run()
        out.append([h.tokens for h in hs])
    assert out[0] == out[1]
    assert sess.graphs.stats["replays"] > 0
    assert stubs[0].captures == sum(1 for _ in sess.graphs._graphs)
