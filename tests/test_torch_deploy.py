"""Serving from DCBC containers: the port against ``repro.serve`` on the
CPU, at smoke size.

One blob per codec is written by the JAX package (the two packages' blobs
are byte-identical, ``tests/test_torch_codec.py``); both packages'
``ServeEngine.from_compressed`` load it on the ``container``, ``q8`` and
``bf16`` backends and must produce identical tokens, greedy and sampled.
A tree session with ``policy_table`` must equal the session cold-started
from the matching ``deepcabac-rd`` container.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import compression, configs, kernels  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import init_params, param_specs  # noqa: E402
from repro_torch.serve import ServeEngine, ServeSession  # noqa: E402
from repro_torch.serve.backends import get_backend  # noqa: E402
from repro_torch.serve.session import ServeConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def rd_policy() -> dict:
    rows = json.loads((REPO / "BENCH_rd.json").read_text())["rows"]
    return next(r for r in rows if r["arch"] == "llama3-8b"
                and r["path"] == "policy")["policy"]


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.get("llama3-8b", smoke=True)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    blobs = {
        "serve-q8": jcompression.get("serve-q8").compress(params).blob,
        "deepcabac-rd": jcompression.get(
            "deepcabac-rd", policy_table=rd_policy(),
            assign="host").compress(params).blob,
    }
    return {"cfg": cfg, "tcfg": configs.get("llama3-8b", smoke=True),
            "params": params, "flat": jflatten(params), "blobs": blobs}


def _prompts(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (3, 6)).astype(
        np.int32)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("backend", ["container", "q8", "bf16"])
@pytest.mark.parametrize("codec", ["serve-q8", "deepcabac-rd"])
def test_from_compressed_tokens_match_reference(setup, codec, backend,
                                                sampled):
    blob = setup["blobs"][codec]
    prompts = _prompts(setup["cfg"].vocab_size, seed=len(codec))
    temp = 0.7 if sampled else 0.0
    want = JEngine.from_compressed(setup["cfg"], blob, max_len=16,
                                   backend=backend).generate(
        prompts, 6, temperature=temp, seed=3)
    kernels.clear_dispatch_report()
    eng = ServeEngine.from_compressed(setup["tcfg"], blob, max_len=16,
                                      backend=backend, device="cpu")
    got = eng.generate(prompts, 6, temperature=temp, seed=3)
    np.testing.assert_array_equal(got, want)
    wq = eng.params["layers"]["attn"]["wq"]
    q8_resident = backend == "q8" or (backend == "container"
                                      and codec == "serve-q8")
    assert isinstance(wq, dict) == q8_resident
    assert kernels.dispatch_report() == []


@pytest.mark.parametrize("backend", ["q8", "bf16"])
def test_policy_table_tree_session_equals_container_session(setup,
                                                            backend):
    """The reference's invariant: quantize-dequantize through the policy
    at load == cold start from the deepcabac-rd container."""
    tcfg = setup["tcfg"]
    tree = params_from_numpy(setup["flat"], "cpu")
    prompts = _prompts(tcfg.vocab_size, seed=5)

    def tokens(weights, be):
        sess = ServeSession(tcfg, weights, backend=be, device="cpu",
                            serve_cfg=ServeConfig(slots=3, max_len=16))
        hs = [sess.submit(p, max_new_tokens=6) for p in prompts]
        sess.run()
        return np.stack([h.result() for h in hs]), sess.params

    from_tree, p_tree = tokens(tree, get_backend(
        backend, policy_table=rd_policy()))
    from_blob, p_blob = tokens(setup["blobs"]["deepcabac-rd"], backend)
    np.testing.assert_array_equal(from_tree, from_blob)
    a = compression.flatten_tree(p_tree)
    b = compression.flatten_tree(p_blob)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the policy did change the weights the tree session serves
    wq = compression.flatten_tree(tree)["layers/attn/wq"]
    served = a["layers/attn/wq"] if backend == "bf16" else None
    assert served is None or not torch.equal(served, wq)


def test_container_blob_written_by_the_port_serves(setup):
    """The port's own deepcabac-rd container of its own init, cold-started
    on every backend, agrees with its policy-applied tree session."""
    tcfg = setup["tcfg"]
    tree = init_params(tcfg, 1, device="cpu")
    art = compression.get("deepcabac-rd", policy_table=rd_policy()).compress(
        tree)
    prompts = _prompts(tcfg.vocab_size, seed=9)
    outs = [ServeEngine.from_compressed(tcfg, art.blob, max_len=16,
                                        backend=b, device="cpu").generate(
        prompts, 5) for b in ("container", "bf16")]
    ref = ServeEngine(tcfg, tree, max_len=16, device="cpu",
                      backend=get_backend("bf16", policy_table=rd_policy())
                      ).generate(prompts, 5)
    np.testing.assert_array_equal(outs[0], ref)
    np.testing.assert_array_equal(outs[1], ref)
    assert art.report["bits_per_param"] < 16


def test_template_comes_from_shapes_and_checks_the_blob(setup):
    tcfg = setup["tcfg"]
    specs = param_specs(tcfg)
    tree = init_params(tcfg, 0, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            compression.flatten_tree(tree).items()} == {
        k: (tuple(s), d) for k, (s, d) in specs.items()}
    blob = setup["blobs"]["serve-q8"]
    wrong = configs.get("llama3-8b", smoke=True).replace(d_ff=128)
    with pytest.raises(ValueError, match="container shape"):
        ServeEngine.from_compressed(wrong, blob, device="cpu")
    partial = jcompression.get("raw").compress(
        {"embed": setup["params"]["embed"]}).blob
    with pytest.raises(KeyError, match="missing"):
        ServeEngine.from_compressed(tcfg, partial, device="cpu")


def test_launcher_serves_a_container_file(setup, tmp_path, capsys):
    path = tmp_path / "model.dcbc"
    path.write_bytes(setup["blobs"]["deepcabac-rd"])
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--ckpt", str(path), "--backend", "container",
         "--batch", "2", "--prompt-len", "5", "--steps", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "backend=container device=cpu" in res.stdout
    assert "generated (2, 3) tokens" in res.stdout
    from repro_torch.launch import serve
    out = serve.main(["--smoke", "--device", "cpu", "--backend",
                      "container", "--batch", "2", "--prompt-len", "5",
                      "--steps", "3"])
    assert out.shape == (2, 3)
    text = capsys.readouterr().out
    assert "packed serve-q8 container in process" in text
    assert "backend=container device=cpu" in text
