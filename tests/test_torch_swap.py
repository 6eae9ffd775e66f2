"""The live weight swap of the port (``ServeSession.swap_weights``,
``WeightBackend.apply_delta`` / ``load_entries`` / ``warm_from`` and
manifest sources) against the JAX package's, on the CPU.

One chain of the llama3-8b smoke model (a keyframe and two P-frames, one
drift apart, weights made by the JAX package from a seed) is written by the
port's manager, monolithic and sharded.  A swap with a request in flight
must keep the token prefix and leave leaves bit-identical to a cold start
of the direct step-locked encode, written in place; the swapped leaves
equal the JAX session's; a swap on a ``warm_from`` variant that shares its
base's leaves leaves the base session bit-identical.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro import configs as jconfigs  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.backends import get_backend as jget_backend  # noqa: E402
from repro.serve.session import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.session import ServeSession as JServeSession  # noqa: E402
from repro_torch import compression, configs  # noqa: E402
from repro_torch.arrays import to_storage  # noqa: E402
from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager, DeltaBaseMissingError,
                                    MeshSpec, delta)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.backends import get_backend  # noqa: E402
from repro_torch.serve.session import ServeConfig, ServeSession  # noqa: E402

SCFG = dict(slots=2, max_len=32)
PROMPT = np.arange(3, 8, dtype=np.int32)


def _drift(flat, seed):
    """Multiplicative drift of one optimizer step on a flat numpy map."""
    rng = np.random.default_rng(seed)
    return {k: (v * (1 + 1e-3 * rng.standard_normal(v.shape))
                ).astype(v.dtype) for k, v in flat.items()}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    jcfg = jconfigs.get("llama3-8b", smoke=True)
    flat = {k: np.asarray(v) for k, v in
            jflatten(jtf.init_params(jcfg, jax.random.PRNGKey(0))).items()}
    frames = [flat, _drift(flat, 1), _drift(_drift(flat, 1), 2)]
    root = tmp_path_factory.mktemp("swap")
    dirs = {}
    for kind in ("mono", "sharded"):
        mgr = CheckpointManager(CheckpointConfig(
            str(root / kind), codec="deepcabac-delta", delta_every=4,
            keep=10, sharded=kind == "sharded"))
        for step, f in enumerate(frames, start=1):
            mgr.save({"params": params_from_numpy(f, "cpu"),
                      "step": np.int32(step)}, step,
                     mesh=MeshSpec.from_any({"data": 2, "model": 1})
                     if kind == "sharded" else None)
        dirs[kind] = [os.path.join(mgr.cfg.directory, f"step_{s:08d}")
                      for s in (1, 2, 3)]
    with open(os.path.join(dirs["mono"][0], "params.dcbc"), "rb") as f:
        kf_blob = f.read()
    return {"jcfg": jcfg, "cfg": configs.get("llama3-8b", smoke=True),
            "frames": frames, "dirs": dirs, "kf_blob": kf_blob,
            "codec": mgr._codec()}


def _session(chain, source, backend, **kw):
    return ServeSession(chain["cfg"], source, backend=backend,
                        serve_cfg=ServeConfig(**SCFG), device="cpu", **kw)


def _direct_blob(chain, upto):
    """A direct encode of frame ``upto``'s step-locked quantization."""
    codec = chain["codec"]
    frames = [params_from_numpy(f, "cpu") for f in chain["frames"]]
    entries = codec.quantize_entries(frames[0])
    for f in frames[1:upto + 1]:
        entries = codec.quantize_like(f, entries)
    return codec.compress_entries(entries).blob


def _leaves(params) -> dict:
    return compression.flatten_tree(params)


def _assert_leaves_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def _source(chain, keyframe):
    return (chain["kf_blob"] if keyframe == "blob"
            else chain["dirs"]["sharded"][0])


# ---------------------------------------------------------------------------
# the swap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keyframe", ["blob", "manifest"])
@pytest.mark.parametrize("backend", ["container", "q8"])
def test_swap_with_a_request_in_flight_equals_direct_encode(chain, backend,
                                                            keyframe):
    dirs = chain["dirs"]["sharded" if keyframe == "manifest" else "mono"]
    sess = _session(chain, _source(chain, keyframe),
                    get_backend(backend, track_levels=True))
    h = sess.submit(PROMPT, max_new_tokens=10)
    sess.step()
    sess.step()
    resident = {k: v.data_ptr() for k, v in _leaves(sess.params).items()}
    pre = list(h.tokens)
    assert sess.swap_weights(dirs[1]) == len(chain["frames"][0])
    sess.step()
    assert sess.swap_weights(dirs[2]) == len(chain["frames"][0])
    sess.run()
    assert h.done and h.tokens[:len(pre)] == pre
    # written in place: every resident tensor kept its storage
    assert {k: v.data_ptr() for k, v in _leaves(sess.params).items()} == \
        resident
    assert sess.stats["swaps"] == 2 and sess.stats["graph_resets"] == 0
    cold = _session(chain, _direct_blob(chain, 2), backend)
    _assert_leaves_equal(sess.params, cold.params)
    # and a request admitted after the swaps decodes as on the cold start
    got, want = sess.submit(PROMPT, 6), cold.submit(PROMPT, 6)
    sess.run()
    cold.run()
    assert got.tokens == want.tokens


@pytest.mark.parametrize("backend", ["container", "q8"])
def test_swapped_leaves_and_tokens_equal_jax_session(chain, backend):
    dirs = chain["dirs"]["mono"]
    jsess = JServeSession(chain["jcfg"], chain["kf_blob"],
                          backend=jget_backend(backend, track_levels=True),
                          serve_cfg=JServeConfig(**SCFG))
    sess = _session(chain, chain["kf_blob"],
                    get_backend(backend, track_levels=True))
    hs = [s.submit(PROMPT, max_new_tokens=8) for s in (sess, jsess)]
    for s in (sess, jsess):
        s.step()
        s.step()
        s.swap_weights(dirs[1])
        s.step()
        s.swap_weights(dirs[2])
        s.run()
    assert hs[0].tokens == [int(t) for t in hs[1].tokens]
    mine = _leaves(sess.params)
    theirs = {k: np.asarray(v) for k, v in jflatten(jsess.params).items()}
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(to_storage(mine[k]), v, err_msg=k)


def test_load_entries_of_the_chain_tip_equals_jax(chain):
    from repro.checkpoint import delta as jdelta
    from repro.serve.backends import get_backend as jgb
    root = os.path.dirname(chain["dirs"]["sharded"][0])
    for backend in ("container", "q8"):
        mine = get_backend(backend).load_entries(
            chain["cfg"], delta.restore_levels(root, 3), device="cpu")
        theirs = jgb(backend).load_entries(chain["jcfg"],
                                           jdelta.restore_levels(root, 3))
        tf = {k: np.asarray(v) for k, v in jflatten(theirs).items()}
        for k, v in _leaves(mine).items():
            np.testing.assert_array_equal(to_storage(v), tf[k], err_msg=k)
    with pytest.raises(KeyError, match="entries missing"):
        get_backend("q8").load_entries(chain["cfg"], {}, device="cpu")


@pytest.mark.parametrize("backend", ["bf16", "q8", "container"])
def test_manifest_cold_start_equals_blob_and_jax(chain, backend):
    """A sharded keyframe's manifest serves the weights the monolithic
    container of the same frame does, in both packages."""
    from repro.serve.session import ServeSession as JS
    m = _session(chain, chain["dirs"]["sharded"][0], backend)
    b = _session(chain, chain["kf_blob"], backend)
    _assert_leaves_equal(m.params, b.params)
    j = JS(chain["jcfg"], chain["dirs"]["sharded"][0], backend=backend,
           serve_cfg=JServeConfig(**SCFG))
    tf = {k: np.asarray(v) for k, v in jflatten(j.params).items()}
    for k, v in _leaves(m.params).items():
        np.testing.assert_array_equal(to_storage(v), tf[k], err_msg=k)
    manifest = os.path.join(chain["dirs"]["sharded"][0],
                            "params.manifest.json")
    _assert_leaves_equal(_session(chain, manifest, backend).params,
                         m.params)


def test_swap_error_paths(chain):
    cfg, dirs = chain["cfg"], chain["dirs"]["mono"]
    with pytest.raises(RuntimeError, match="track_levels"):
        get_backend("container").apply_delta(cfg, dirs[1], device="cpu")
    be = get_backend("container", track_levels=True)
    be.load(cfg, chain["kf_blob"], device="cpu")
    # a monolithic keyframe has no manifest; a sharded one is no delta
    with pytest.raises(ValueError, match="not a delta"):
        be.apply_delta(cfg, dirs[0], device="cpu")
    with pytest.raises(ValueError, match="not a delta"):
        be.apply_delta(cfg, chain["dirs"]["sharded"][0], device="cpu")
    # the messages are the reference's
    jbe = jget_backend("container", track_levels=True)
    jbe.load(chain["jcfg"], chain["kf_blob"])
    for src in (dirs[0], chain["dirs"]["sharded"][0]):
        msgs = []
        for b, c in ((be, cfg), (jbe, chain["jcfg"])):
            with pytest.raises(ValueError) as e:
                b.apply_delta(c, src)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_swap_of_a_step_whose_payload_is_gone_raises(chain, tmp_path):
    import shutil
    step = tmp_path / "step_00000002"
    shutil.copytree(chain["dirs"]["mono"][1], step)
    os.remove(step / delta.DELTA_FILE)
    sess = _session(chain, chain["kf_blob"],
                    get_backend("q8", track_levels=True))
    with pytest.raises(DeltaBaseMissingError, match="is missing"):
        sess.swap_weights(str(step))


def test_swap_refuses_an_update_of_another_shape(chain, monkeypatch):
    sess = _session(chain, chain["kf_blob"],
                    get_backend("q8", track_levels=True))
    wq = _leaves(sess.params)["layers/attn/wq/q8"].clone()
    monkeypatch.setattr(sess.backend, "apply_delta", lambda *a, **k: {
        "layers/attn/wq": {"q8": wq[:1], "q8s": torch.zeros(1)}})
    with pytest.raises(ValueError, match="does not match the resident"):
        sess.swap_weights("unused")
    monkeypatch.setattr(sess.backend, "apply_delta", lambda *a, **k: {
        "final_norm": torch.zeros(chain["cfg"].d_model,
                                  dtype=torch.float64)})
    with pytest.raises(ValueError, match="does not match the resident"):
        sess.swap_weights("unused")


# ---------------------------------------------------------------------------
# warm_from and shared leaves
# ---------------------------------------------------------------------------

def _clone(params) -> dict:
    return {k: v.clone() for k, v in _leaves(params).items()}


@pytest.mark.parametrize("backend", ["container", "q8"])
def test_swap_on_a_warm_variant_leaves_the_base_session_alone(chain,
                                                              backend):
    cfg, dirs = chain["cfg"], chain["dirs"]["mono"]
    base_be = get_backend(backend, track_levels=True)
    base = _session(chain, chain["kf_blob"], base_be)
    h = base.submit(PROMPT, max_new_tokens=6)
    base.run()
    before, before_tokens = _clone(base.params), list(h.tokens)

    var_be = get_backend(backend, track_levels=True)
    tree = var_be.warm_from(cfg, base_be, base.params, [], device="cpu")
    # every leaf of the variant is the base's tensor
    assert var_be.shared == {k.removesuffix("/q8").removesuffix("/q8s")
                             for k in _leaves(base.params)}
    var = ServeSession.from_loaded(cfg, tree, backend=var_be,
                                   serve_cfg=ServeConfig(**SCFG),
                                   device="cpu")
    hv = var.submit(PROMPT, max_new_tokens=6)
    var.step()
    var.swap_weights(dirs[1])            # every leaf is the base's
    assert var.stats["graph_resets"] == 1 and not var_be.shared
    var.swap_weights(dirs[2])            # now its own: written in place
    assert var.stats["graph_resets"] == 1
    var.run()
    assert hv.done
    # the base session's weights and tokens are bit for bit what they were
    after = _leaves(base.params)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    h2 = base.submit(PROMPT, max_new_tokens=6)
    base.run()
    assert h2.tokens == before_tokens
    cold = _session(chain, _direct_blob(chain, 2), backend)
    _assert_leaves_equal(var.params, cold.params)


def test_warm_from_applies_the_variant_suffix(chain):
    cfg, dirs = chain["cfg"], chain["dirs"]["mono"]
    base_be = get_backend("q8", track_levels=True)
    base = _session(chain, chain["kf_blob"], base_be)
    var_be = get_backend("q8", track_levels=True)
    tree = var_be.warm_from(cfg, base_be, base.params, dirs[1:],
                            device="cpu")
    assert not var_be.shared          # a P-frame carries every tensor
    _assert_leaves_equal(tree, _session(chain, _direct_blob(chain, 2),
                                        "q8").params)
    with pytest.raises(RuntimeError, match="track_levels=True on the"):
        get_backend("q8").warm_from(cfg, base_be, base.params, [])
    with pytest.raises(RuntimeError, match="no tracked levels"):
        get_backend("q8", track_levels=True).warm_from(
            cfg, get_backend("q8"), base.params, [])


def test_from_container_and_from_loaded(chain):
    cfg = chain["cfg"]
    a = ServeSession.from_container(cfg, chain["kf_blob"],
                                    serve_cfg=ServeConfig(**SCFG),
                                    device="cpu")
    be = get_backend("container", track_levels=True)
    tree = be.load(cfg, chain["kf_blob"], device="cpu")
    b = ServeSession.from_loaded(cfg, tree, backend=be,
                                 serve_cfg=ServeConfig(**SCFG), device="cpu")
    assert b.params is tree
    _assert_leaves_equal(a.params, b.params)
    b.swap_weights(chain["dirs"]["mono"][1])
    _assert_leaves_equal(b.params, _session(
        chain, _direct_blob(chain, 1), "container").params)
