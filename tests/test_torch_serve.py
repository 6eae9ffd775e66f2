"""The port's serving stack against ``repro.serve`` on the CPU.

Both sessions get the same JAX parameters (carried across as numpy) and
the same requests; tokens must be identical, greedy and sampled alike —
sampling is the reference's host numpy code, copied verbatim.  The smoke
model is f32, where the two packages' logits agree to ~1e-6 relative, far
inside the gaps between the top logits these prompts produce.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro import configs as jconfigs  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JConfig  # noqa: E402
from repro.serve import ServeSession as JSession  # noqa: E402
from repro_torch import configs, kernels  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, ServeSession  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    cfg = jconfigs.get("llama3-8b", smoke=True)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jflatten(params)


def _prompts(n, lengths, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (lengths[i % len(lengths)],)).astype(
        np.int32) for i in range(n)]


def _run(session, prompts, max_new, temps, cancel_after=None):
    hs = [session.submit(p, max_new_tokens=max_new, temperature=t)
          for p, t in zip(prompts, temps)]
    if cancel_after is not None:
        session.step()
        session.step()
        assert session.cancel(hs[cancel_after])
    session.run()
    return [(h.tokens, h.finish_reason) for h in hs]


def _both(weights, backend, scfg_kw, prompts, max_new, temps,
          cancel_after=None):
    cfg, params, flat = weights
    jsess = JSession(cfg, params, backend=backend,
                     serve_cfg=JConfig(**scfg_kw))
    tsess = ServeSession(configs.get("llama3-8b", smoke=True),
                         params_from_numpy(flat, "cpu"), backend=backend,
                         serve_cfg=ServeConfig(**scfg_kw), device="cpu")
    want = _run(jsess, prompts, max_new, temps, cancel_after)
    got = _run(tsess, prompts, max_new, temps, cancel_after)
    return got, want, tsess


@pytest.mark.parametrize("backend", ["q8", "bf16"])
@pytest.mark.parametrize("sampled", [False, True])
def test_session_tokens_match_reference(weights, backend, sampled):
    """Ragged continuous batching: 5 requests of mixed lengths over 3
    slots (queueing, same-length batched admission, ragged decode)."""
    cfg = weights[0]
    prompts = _prompts(5, (5, 5, 7, 3), cfg.vocab_size, seed=1)
    temps = [0.8 if sampled else 0.0] * 5
    got, want, tsess = _both(weights, backend, {"slots": 3, "max_len": 16},
                             prompts, 6, temps)
    assert got == want
    assert all(r == "length" for _, r in got)
    assert tsess.stats["prefill_tokens"] == sum(p.size for p in prompts)


def test_buckets_eos_and_cancel_match_reference(weights):
    cfg = weights[0]
    prompts = _prompts(4, (5, 7, 3, 6), cfg.vocab_size, seed=2)
    temps = [0.0, 0.7, 0.0, 0.0]
    base, _, _ = _both(weights, "q8", {"slots": 2, "max_len": 20,
                                       "prefill_buckets": (8, 16)},
                       prompts, 7, temps)
    eos = base[0][0][2]                   # request 0's third greedy token
    got, want, tsess = _both(
        weights, "q8", {"slots": 2, "max_len": 20, "prefill_buckets": (8,),
                        "eos_token": int(eos)},
        prompts, 7, temps, cancel_after=3)
    assert got == want
    assert got[0][1] == "eos" and got[0][0][-1] == eos
    assert got[3][1] == "cancelled"
    assert tsess.stats["prefill_tokens"] % 8 == 0      # padded to the bucket


def test_engine_generate_matches_reference(weights):
    cfg, params, flat = weights
    prompts = np.stack(_prompts(3, (6,), cfg.vocab_size, seed=3))
    want = JEngine(cfg, params, max_len=16, backend="q8").generate(
        prompts, 5, temperature=0.5, seed=7)
    got = ServeEngine(configs.get("llama3-8b", smoke=True),
                      params_from_numpy(flat, "cpu"), max_len=16,
                      backend="q8", device="cpu").generate(
        prompts, 5, temperature=0.5, seed=7)
    np.testing.assert_array_equal(got, want)


def test_unported_serving_paths_raise(weights):
    tcfg = configs.get("llama3-8b", smoke=True)
    flat = weights[2]
    # a manifest path is a weight source now: a missing one raises
    with pytest.raises(FileNotFoundError, match="params.manifest.json"):
        ServeSession(tcfg, "ckpt/step_1", backend="q8", device="cpu")
    with pytest.raises(TypeError, match="container backend loads DCBC"):
        ServeSession(tcfg, {}, backend="container", device="cpu")
    with pytest.raises(ValueError, match="DCBC"):
        ServeEngine.from_compressed(tcfg, b"NOPE" + bytes(8), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServeSession(tcfg, params_from_numpy(flat, "cpu"))


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    kernels.clear_dispatch_report()
    out = serve.main(["--smoke", "--backend", "q8", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--steps", "3"])
    assert out.shape == (2, 3)
    text = capsys.readouterr().out
    assert "backend=q8 device=cpu" in text and "kernel launches" in text


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_parity_phase_at_smoke_size_on_cpu():
    res = _load_chip_smoke().phase_parity("cpu")
    assert res["tokens_identical"] and res["logits_rel_diff"] == 0.0
    assert res["q8_mismatch_card_vs_cpu"] == {"float32": 0, "bfloat16": 0}


def test_chip_smoke_codec_parity_phase_at_smoke_size_on_cpu():
    res = _load_chip_smoke().phase_parity_codec("cpu")
    for dt in ("float32", "bfloat16"):
        assert set(res[dt]) == {"deepcabac-rd", "serve-q8", "deepcabac-v3"}
    assert res["served_container"] == res["served_q8"] == "tokens identical"


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
