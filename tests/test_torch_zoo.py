"""The model zoo of the port (``repro_torch.serve.zoo``) against the JAX
package's, on the CPU.

One fixture, the reference's: the llama3-8b smoke keyframe sharded at step
1 and three partial-finetune P-frames at steps 2-4 chained to it, written
by the JAX package's ``CheckpointManager`` and ``write_delta``; both
packages' zoos read the same directories.  Store reports, records, views
and ``model_resident_bytes`` must be equal exactly; under one
deterministic fake clock (``time`` of both zoo modules), routed traffic
that forces stalls, evictions and warm admissions must give equal
admission kinds, eviction order, resident sets, stats and tokens, and the
tokens equal a dedicated cold session of the port's own.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import delta as jdelta  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models.transformer import init_params as jinit_params  # noqa: E402
from repro.serve import backends as jbackends  # noqa: E402
from repro.serve import zoo as jzoo  # noqa: E402
from repro.serve.session import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import compression, configs, serve  # noqa: E402
from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager, delta)
from repro_torch.checkpoint.sharded import MANIFEST_NAME  # noqa: E402
from repro_torch.compression.tree import flatten_tree  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve import zoo  # noqa: E402
from repro_torch.serve.backends import get_backend  # noqa: E402
from repro_torch.serve.session import ServeConfig, ServeSession  # noqa: E402

STEPS = {"base": 1, "var-a": 2, "var-b": 3, "var-c": 4}
ROUTED = ["llama3-base", "llama3-var-0", "llama3-var-1", "llama3-var-2"]
ROUTED_STEPS = dict(zip(ROUTED, (1, 2, 3, 4)))
# seconds each admission measures under the fake clock, in admission order:
# not all equal, so the victim is chosen by cost and not only by LRU
FAKE_ADMIT_S = (3.0, 1.0, 2.0, 0.5, 4.0, 1.5)


class FakeTime:
    """A ``time`` stand-in for both zoo modules: ``perf_counter`` is read
    twice per admission (start, end), and admission i lasts
    ``FAKE_ADMIT_S[i % 6]`` seconds."""

    def __init__(self):
        self.now = 0.0
        self.reads = 0

    def perf_counter(self) -> float:
        self.reads += 1
        if self.reads % 2 == 0:
            self.now += FAKE_ADMIT_S[(self.reads // 2 - 1) % len(FAKE_ADMIT_S)]
        return self.now


def _write_variant(root, step, flat, base_entries, codec, write_delta,
                   base_ref, seed):
    """One finetune variant (the reference's fixture): a P-frame chained
    straight to the keyframe at step 1, a quarter of the float tensors
    perturbed.  ``flat`` holds numpy arrays (JAX package) or tensors (the
    port); ``codec``, ``write_delta`` and ``base_ref`` are that package's."""
    rng = np.random.default_rng(seed)
    is_float = (lambda v: v.dtype.kind == "f") if isinstance(
        next(iter(flat.values())), np.ndarray) else (
        lambda v: v.is_floating_point())
    names = sorted(k for k, v in flat.items() if is_float(v))
    touched = set(names[:max(1, len(names) // 4)])
    pert = {}
    for k, v in flat.items():
        if k not in touched:
            pert[k] = v
        elif isinstance(v, np.ndarray):
            pert[k] = (v * (1 + 5e-4 * rng.standard_normal(v.shape))
                       ).astype(v.dtype)
        else:
            pert[k] = (v.double() * torch.from_numpy(
                1 + 5e-4 * rng.standard_normal(tuple(v.shape)))).to(v.dtype)
    dentries = codec.delta_entries(pert, base_entries)
    payloads, manifest = write_delta(
        dentries, codec_name=codec.name, base=base_ref(root, 1),
        num_gr=codec.coder.num_gr, chunk_size=codec.coder.chunk_size)
    d = delta.step_dir(root, step)
    os.makedirs(d)
    for fname, blob in payloads.items():
        with open(os.path.join(d, fname), "wb") as f:
            f.write(blob)
    with open(os.path.join(d, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)


@pytest.fixture(scope="module")
def variant_root(tmp_path_factory):
    """The reference's fixture: llama3 smoke keyframe (sharded, step 1) +
    three delta variants (steps 2-4), written by the JAX package."""
    jcfg = jconfigs.get("llama3-8b", smoke=True)
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    root = str(tmp_path_factory.mktemp("zoo-ckpt"))
    jmanager.CheckpointManager(jmanager.CheckpointConfig(
        directory=root, sharded=True, codec="deepcabac-delta")).save(
        {"params": params}, step=1)
    codec = jcompression.get("deepcabac-delta")
    flat = {k: np.asarray(v) for k, v in jflatten(params).items()}
    base_entries = codec.quantize_entries(jflatten(params))
    for i, step in enumerate((2, 3, 4)):
        _write_variant(root, step, flat, base_entries, codec,
                       jdelta.write_delta, jdelta.base_ref, seed=100 + i)
    return jcfg, configs.get("llama3-8b", smoke=True), root


def _dedicated_tokens(cfg, root, step, prompts, serve_cfg):
    """A dedicated single-model session of the port, cold-started from
    the original checkpoint, fed the same prompts in the same order."""
    backend = get_backend("container", track_levels=True)
    params = backend.load_entries(cfg, delta.restore_levels(root, step),
                                  device="cpu")
    sess = ServeSession.from_loaded(cfg, params, backend=backend,
                                    serve_cfg=serve_cfg, device="cpu")
    handles = [sess.submit(p, max_new_tokens=n) for p, n in prompts]
    sess.run(max_steps=2000)
    out = [list(map(int, h.result())) for h in handles]
    sess.close()
    return out


def _view_files(store, model_id):
    base = os.path.join(store.root, "views", model_id)
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, files in os.walk(base) for f in files)


def _record(store, rec):
    """A store record with its paths relative to the store's root."""
    return {**rec, "tip": os.path.relpath(rec["tip"], store.root),
            "steps": [os.path.relpath(s, store.root) for s in rec["steps"]]}


# ---------------------------------------------------------------------------
# the small pieces: exports, configs, backends
# ---------------------------------------------------------------------------

def test_lazy_exports_configs_wrappers_and_q8_resident():
    from repro import serve as jserve
    for name in ("ShardStore", "ModelZoo", "ZooConfig", "ZooRouter",
                 "ZooHandle", "ZooError", "AdmissionStall",
                 "model_resident_bytes"):
        assert name in serve.__all__ and name in jserve.__all__
        assert getattr(serve, name) is getattr(zoo, name)
    for arch in configs.names():
        assert configs.get_config(arch) == configs.get(arch)
        assert configs.get_smoke_config(arch) == configs.get(arch,
                                                             smoke=True)
    for name in ("bf16", "q8", "container"):
        assert (get_backend(name).q8_resident ==
                jbackends.get_backend(name).q8_resident)
    assert get_backend("q8").q8_resident is True
    assert issubclass(zoo.AdmissionStall, zoo.ZooError)


def test_zoo_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        zoo.ModelZoo(str(tmp_path / "store"), zoo.ZooConfig(hbm_budget=1))
    assert zoo.ModelZoo(str(tmp_path / "store"), zoo.ZooConfig(
        hbm_budget=1), device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# ShardStore against the reference's
# ---------------------------------------------------------------------------

def test_shard_store_equals_the_reference(variant_root, tmp_path):
    _jcfg, _cfg, root = variant_root
    stores = {}
    for pkg, mod in (("jax", jzoo), ("torch", zoo)):
        store = mod.ShardStore(str(tmp_path / pkg))
        recs = {m: store.add(m, delta.step_dir(root, s))
                for m, s in STEPS.items()}
        stores[pkg] = (store, recs)
    (js, jrecs), (ts, trecs) = stores["jax"], stores["torch"]
    assert ts.report() == js.report()
    assert ts.report()["dedup_ratio"] > 1.0
    for m in STEPS:
        assert _record(ts, trecs[m]) == _record(js, jrecs[m])
        assert _view_files(ts, m) == _view_files(js, m)
        assert len(trecs[m]["chain_keys"]) == (1 if m == "base" else 2)
    # removing a variant keeps the objects the others still reference
    for store in (js, ts):
        store.remove("var-a")
    left = sorted(os.listdir(os.path.join(ts.root, "objects")))
    assert left == sorted(os.listdir(os.path.join(js.root, "objects")))
    assert set(left) == set().union(*(trecs[m]["objects"]
                                      for m in STEPS if m != "var-a"))
    assert set(trecs["base"]["objects"]) <= set(left)
    assert ts.report() == js.report()
    assert delta.resolve_chain(trecs["var-b"]["tip"])[0]["kind"] == \
        "keyframe"
    for store in (js, ts):
        store.close()
    assert os.listdir(os.path.join(ts.root, "objects")) == []


def test_shard_store_refuses_a_corrupt_shard_and_leaves_nothing(
        variant_root, tmp_path):
    _jcfg, _cfg, root = variant_root
    victim = str(tmp_path / "bad-ckpt")
    shutil.copytree(root, victim)
    d = delta.step_dir(victim, 1)
    # the last shard the ingest copies, so the files before it were
    # written by the time the hash mismatch is found
    files = delta.chain_files(d)[0]["files"]
    shard = [f for f in files if f.startswith("shard_")][-1]
    with open(os.path.join(d, shard), "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="content hash"):
        jzoo.ShardStore(str(tmp_path / "jax")).add(
            "bad", delta.step_dir(victim, 2))
    store = zoo.ShardStore(str(tmp_path / "port"))
    with pytest.raises(ValueError, match="content hash"):
        store.add("bad", delta.step_dir(victim, 2))
    assert os.listdir(os.path.join(store.root, "objects")) == []
    assert os.listdir(os.path.join(store.root, "views")) == []
    assert "bad" not in store and store.report()["objects"] == 0
    # the refused model id is free again
    rec = store.add("bad", delta.step_dir(root, 2))
    assert len(rec["chain_keys"]) == 2
    store.close()


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

_ACCOUNTING = ([(a, True) for a in configs.names()] +
               [(a, False) for a in ("llama3-8b", "deepseek-moe-16b",
                                     "deepseek-v3-671b")])


@pytest.mark.parametrize("arch,smoke", _ACCOUNTING)
def test_model_resident_bytes_equals_the_reference(arch, smoke):
    """Every backend, slot mode, paged mode with the default pool and with
    ``kv_pool_pages``; full-size configs by shapes only."""
    jcfg = jconfigs.get(arch, smoke=smoke)
    cfg = configs.get(arch, smoke=smoke)
    modes = (dict(slots=2, max_len=40),
             dict(slots=2, max_len=40, kv_page_size=8),
             dict(slots=3, max_len=44, kv_page_size=8, kv_pool_pages=7))
    seen = set()
    for backend in (None, "bf16", "q8", "container"):
        for kw in modes:
            want = jzoo.model_resident_bytes(jcfg, JServeConfig(**kw),
                                             backend=backend)
            got = zoo.model_resident_bytes(cfg, ServeConfig(**kw),
                                           backend=backend)
            assert got == want, (backend, kw)
            seen.add(got)
    assert len(seen) > 1


# ---------------------------------------------------------------------------
# routing parity under one fake clock
# ---------------------------------------------------------------------------

def _routed(mod, cfg, root, store_dir, monkeypatch, **zoo_kw):
    """The reference's 4-model llama3 traffic (interleaved, distinct
    prompt lengths) through ``mod``'s zoo under a budget of 2.5 models;
    per router step the resident set, each model's last admission kind
    and the budget check; the eviction order, stats and tokens."""
    monkeypatch.setattr(mod, "time", FakeTime())
    scfg = (JServeConfig if mod is jzoo else ServeConfig)(slots=2,
                                                          max_len=64)
    one = mod.model_resident_bytes(cfg, scfg)
    z = mod.ModelZoo(store_dir, mod.ZooConfig(hbm_budget=2 * one + one // 2,
                                              serve=scfg), **zoo_kw)
    for m in ROUTED:
        z.register(m, cfg, delta.step_dir(root, ROUTED_STEPS[m]))
    evicted = []
    evict = z.evict

    def logged(model_id):
        evicted.append(model_id)
        evict(model_id)
    z.evict = logged
    rng = np.random.default_rng(11)
    prompts = {m: rng.integers(1, cfg.vocab_size, 8 + 2 * j)
               for j, m in enumerate(ROUTED)}
    router = mod.ZooRouter(z)
    order = ROUTED + ROUTED[::-1] + ROUTED[:2]
    handles = [(m, router.submit(m, prompts[m], max_new_tokens=5))
               for m in order]
    trace = []
    while router.pending:
        router.step()
        rep = z.zoo_report()
        trace.append((z.resident(),
                      {m: r["last_admit"] for m, r in rep["models"].items()},
                      rep["resident_bytes"] <= rep["hbm_budget"]))
        assert len(trace) < 500
    out = {"trace": trace, "evicted": list(evicted), "stats": dict(z.stats),
           "tokens": [list(map(int, h.result())) for _, h in handles],
           "handles": handles, "prompts": prompts}
    z.evict = evict
    z.close()
    return out


def test_routing_equals_the_reference_under_one_fake_clock(
        variant_root, tmp_path, monkeypatch):
    jcfg, cfg, root = variant_root
    want = _routed(jzoo, jcfg, root, str(tmp_path / "jax"), monkeypatch)
    got = _routed(zoo, cfg, root, str(tmp_path / "torch"), monkeypatch,
                  device="cpu")
    assert got["trace"] == want["trace"]
    assert got["evicted"] == want["evicted"]
    assert got["stats"] == want["stats"]
    assert got["tokens"] == want["tokens"]
    assert all(ok for _, _, ok in got["trace"])
    s = got["stats"]
    assert s["evictions"] > 0 and s["admits_warm"] > 0 and s["admits_cold"]
    for m in ROUTED:
        mine = [list(map(int, h.result())) for mid, h in got["handles"]
                if mid == m]
        ref = _dedicated_tokens(cfg, root, ROUTED_STEPS[m],
                                [(got["prompts"][m], 5)] * len(mine),
                                ServeConfig(slots=2, max_len=64))
        assert mine == ref, m


# ---------------------------------------------------------------------------
# the reference's other zoo cases, on the port
# ---------------------------------------------------------------------------

def test_warm_admission_matches_cold_tokens(variant_root, tmp_path):
    _jcfg, cfg, root = variant_root
    serve_cfg = ServeConfig(slots=2, max_len=64)
    one = zoo.model_resident_bytes(cfg, serve_cfg)
    z = zoo.ModelZoo(str(tmp_path / "store"),
                     zoo.ZooConfig(hbm_budget=3 * one, serve=serve_cfg),
                     device="cpu")
    z.register("base", cfg, delta.step_dir(root, 1))
    z.register("var-a", cfg, delta.step_dir(root, 2))
    router = zoo.ZooRouter(z)
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, 12)
    hb = router.submit("base", prompt, max_new_tokens=6)
    ha = router.submit("var-a", prompt, max_new_tokens=6)
    router.run(max_steps=500)
    assert z.stats["admits_warm"] == 1
    assert z.zoo_report()["models"]["var-a"]["last_admit"] == "warm"
    assert [list(map(int, ha.result()))] == _dedicated_tokens(
        cfg, root, 2, [(prompt, 6)], serve_cfg)
    assert [list(map(int, hb.result()))] == _dedicated_tokens(
        cfg, root, 1, [(prompt, 6)], serve_cfg)
    z.close()


def test_admission_stall_when_residents_busy_then_eviction(variant_root,
                                                           tmp_path):
    _jcfg, cfg, root = variant_root
    serve_cfg = ServeConfig(slots=1, max_len=64)
    one = zoo.model_resident_bytes(cfg, serve_cfg)
    z = zoo.ModelZoo(str(tmp_path / "store"),
                     zoo.ZooConfig(hbm_budget=int(1.5 * one),
                                   serve=serve_cfg), device="cpu")
    z.register("base", cfg, delta.step_dir(root, 1))
    z.register("var-a", cfg, delta.step_dir(root, 2))
    sess = z.admit("base")
    assert z.admit("base") is sess
    h = sess.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(zoo.AdmissionStall):
        z.admit("var-a")                   # base is busy, budget full
    sess.run(max_steps=100)
    assert h.done
    z.admit("var-a")                       # base idle now: evicted
    assert z.resident() == ["var-a"]
    assert z.stats["evictions"] == 1
    assert sess.params is None             # the evicted session is closed
    assert z.zoo_report()["models"]["var-a"]["last_admit"] == "cold"
    z.close()


def test_zoo_errors(variant_root, tmp_path):
    _jcfg, cfg, root = variant_root
    serve_cfg = ServeConfig(slots=1, max_len=64)
    one = zoo.model_resident_bytes(cfg, serve_cfg)
    z = zoo.ModelZoo(str(tmp_path / "store"),
                     zoo.ZooConfig(hbm_budget=one - 1, serve=serve_cfg),
                     device="cpu")
    z.register("base", cfg, delta.step_dir(root, 1))
    with pytest.raises(zoo.ZooError, match="not registered"):
        z.admit("nope")
    with pytest.raises(zoo.ZooError, match="budget"):
        z.admit("base")                    # cannot fit an empty zoo
    with pytest.raises(zoo.ZooError, match="already registered"):
        z.register("base", cfg, delta.step_dir(root, 1))
    with pytest.raises(zoo.ZooError, match="not registered"):
        zoo.ZooRouter(z).submit("nope", [1, 2], max_new_tokens=1)
    handle = zoo.ZooRouter(z).submit("base", [1, 2], max_new_tokens=1)
    assert not handle.admitted and not handle.done
    assert handle.new_tokens() == [] and handle.finish_reason is None
    with pytest.raises(RuntimeError, match="still in flight"):
        handle.result()
    z.close()


def test_q8_backend_admits_more_models_same_budget(variant_root, tmp_path):
    _jcfg, cfg, root = variant_root
    serve_cfg = ServeConfig(slots=2, max_len=32)
    full = zoo.model_resident_bytes(cfg, serve_cfg)
    q8 = zoo.model_resident_bytes(cfg, serve_cfg, backend="q8")
    budget = full + q8 // 2
    assert 3 * q8 <= budget < 2 * full
    counts = {}
    for backend in ("container", "q8"):
        z = zoo.ModelZoo(str(tmp_path / f"store-{backend}"),
                         zoo.ZooConfig(hbm_budget=budget, backend=backend,
                                       serve=serve_cfg), device="cpu")
        for m in ("base", "var-a", "var-b"):
            z.register(m, cfg, delta.step_dir(root, STEPS[m]))
        for m in ("base", "var-a", "var-b"):
            z.admit(m)
        counts[backend] = len(z.resident())
        assert z.resident_bytes() <= budget
        z.close()
    assert counts == {"container": 1, "q8": 3}


def test_zoo_ten_config_tenancy(variant_root, tmp_path):
    """The reference's acceptance run on the port alone: llama3 base + 3
    variants, plus 3 more architectures each with a keyframe and one
    variant written by the port; the four llama3 models routed under a
    budget of 2.5 of them must evict, give a dedicated session's tokens,
    and the store must dedup >= 2x."""
    _jcfg, cfg, root = variant_root
    serve_cfg = ServeConfig(slots=2, max_len=64)
    model_cfgs = {m: cfg for m in ROUTED}
    sources = {m: delta.step_dir(root, s) for m, s in ROUTED_STEPS.items()}
    codec = compression.get("deepcabac-delta")
    others = [a for a in configs.names() if a != "llama3-8b"][:3]
    for j, arch in enumerate(others):
        acfg = configs.get(arch, smoke=True)
        aroot = str(tmp_path / "ckpts" / arch)
        params = init_params(acfg, 1, device="cpu")
        CheckpointManager(CheckpointConfig(
            aroot, sharded=True, codec="deepcabac-delta")).save(
            {"params": params}, step=1)
        flat = flatten_tree(params)
        _write_variant(aroot, 2, flat, codec.quantize_entries(flat), codec,
                       delta.write_delta, delta.base_ref, seed=200 + j)
        for kind, step in (("base", 1), ("var", 2)):
            model_cfgs[f"{arch}-{kind}"] = acfg
            sources[f"{arch}-{kind}"] = delta.step_dir(aroot, step)
    assert len(model_cfgs) == 10
    one = zoo.model_resident_bytes(cfg, serve_cfg)
    z = zoo.ModelZoo(str(tmp_path / "store"),
                     zoo.ZooConfig(hbm_budget=2 * one + one // 2,
                                   serve=serve_cfg), device="cpu")
    for m in model_cfgs:
        z.register(m, model_cfgs[m], sources[m])
    assert z.models() == sorted(model_cfgs)
    rng = np.random.default_rng(11)
    prompts = {m: rng.integers(1, cfg.vocab_size, 8 + 2 * j)
               for j, m in enumerate(ROUTED)}
    router = zoo.ZooRouter(z)
    order = ROUTED + ROUTED[::-1] + ROUTED[:2]
    handles = [(m, router.submit(m, prompts[m], max_new_tokens=5))
               for m in order]
    router.run(max_steps=3000)
    assert all(h.done for _m, h in handles)
    rep = z.zoo_report()
    assert rep["stats"]["evictions"] > 0
    assert rep["resident_bytes"] <= rep["hbm_budget"]
    for m in ROUTED:
        mine = [list(map(int, h.result())) for mid, h in handles if mid == m]
        assert mine == _dedicated_tokens(cfg, root, ROUTED_STEPS[m],
                                         [(prompts[m], 5)] * len(mine),
                                         serve_cfg), m
    assert rep["store"]["dedup_ratio"] >= 2.0, rep["store"]
    assert rep["store"]["models"] == 10
    z.close()


# ---------------------------------------------------------------------------
# ServeSession.close with shared leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_close_keeps_the_leaves_a_warm_variant_shares(variant_root, paged):
    """Closing a base session drops its own references only: a
    ``warm_from(..., [])`` variant sharing every leaf keeps their storage
    and values and gives the same tokens after the close; a second
    close is a no-op."""
    _jcfg, cfg, root = variant_root
    scfg = ServeConfig(slots=2, max_len=32,
                       **(dict(kv_page_size=4) if paged else {}))
    bb = get_backend("q8", track_levels=True)
    base_params = bb.load_entries(cfg, delta.restore_levels(root, 1),
                                  device="cpu")
    vb = get_backend("q8", track_levels=True)
    var_params = vb.warm_from(cfg, bb, base_params, [], device="cpu")
    base = ServeSession.from_loaded(cfg, base_params, backend=bb,
                                    serve_cfg=scfg, device="cpu")
    var = ServeSession.from_loaded(cfg, var_params, backend=vb,
                                   serve_cfg=scfg, device="cpu")
    del base_params
    prompt = np.arange(3, 12, dtype=np.int32)

    def tokens(sess):
        h = sess.submit(prompt, max_new_tokens=6)
        sess.run()
        return h.tokens

    want = tokens(var)
    assert tokens(base) == want
    shared = flatten_tree(var.params)
    assert vb.shared == _serving_names(shared)
    before = {k: (v.data_ptr(), v.clone()) for k, v in shared.items()}
    base.close()
    assert base.params is None and base.graphs is None
    assert base.logits is None and base._caches is None and base._kv is None
    base.close()                                     # no-op
    after = flatten_tree(var.params)
    for k, (ptr, val) in before.items():
        assert after[k].data_ptr() == ptr and torch.equal(after[k], val), k
    assert tokens(var) == want
    var.close()


def _serving_names(flat: dict) -> set:
    """Flat serving-leaf names: a ``{"q8", "q8s"}`` pair is one leaf."""
    return {k.rsplit("/", 1)[0] if k.endswith(("/q8", "/q8s")) else k
            for k in flat}
