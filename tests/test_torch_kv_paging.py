"""The port's paged KV serving mode (``repro_torch.serve.kv``, the session's
paged scheduler) against ``repro.serve``'s, on the CPU.

Every scenario of the reference's ``tests/test_kv_paging.py`` runs through
both packages on the llama3-8b smoke model with ``q8_cache=True`` (f32,
the JAX package's weights carried across as numpy): no pressure, forced
eviction with a restore worker, a manual park and resume, copy-on-write
prefix sharing, sharing disabled, compacted decode batches, a live weight
swap on a paged session, the refusals, the capacity report, the bytes a
park moves to the host and the blob a cancel drops.  The port's tokens
must equal the reference's paged session's and the port's own slot
session's; the scheduler and page counters must equal the reference's;
the int8 levels a park codes must equal the reference's level for level
(and its blob byte for byte).  The MoE smoke model (nested dense/main
pools) and the MLA smoke model (latent pools) decode paged with the
reference's tokens, and ``calibrate_kv_cache_delta`` agrees to 1e-6
relative.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import quantized as jquantized  # noqa: E402
from repro.serve.backends import get_backend as jget_backend  # noqa: E402
from repro.serve.kv import kv_cache_bytes as jkv_cache_bytes  # noqa: E402
from repro.serve.session import ServeConfig as JConfig  # noqa: E402
from repro.serve.session import ServeSession as JSession  # noqa: E402
from repro_torch import compression, configs  # noqa: E402
from repro_torch.compression.tree import unflatten  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.models.transformer import init_cache, init_params  # noqa: E402
from repro_torch.serve import quantized as tquantized  # noqa: E402
from repro_torch.serve.backends import get_backend  # noqa: E402
from repro_torch.serve.kv import PageError, kv_cache_bytes  # noqa: E402
from repro_torch.serve.session import ServeConfig, ServeSession  # noqa: E402

# the reference's counters that the scheduler and the page pool keep
SCHED_KEYS = ("decode_steps", "decode_rows", "free_slot_rows",
              "padded_rows", "skipped_all_free_steps", "prefill_tokens",
              "prefix_reused_tokens", "parks", "resumes", "admit_stalls")
KV_KEYS = ("pages_evicted", "pages_restored", "restores", "bytes_to_host",
           "bytes_from_host", "prefix_hits", "prefix_pages_reused",
           "spills")


def _model(arch, jax_init=True):
    """Both packages' configs and one set of weights: the JAX package's
    from a seed, or (``jax_init=False``, much quicker for the MoE and SSM
    smoke models) the port's, carried across as numpy either way."""
    jcfg = jconfigs.get(arch, smoke=True).replace(q8_cache=True)
    tcfg = configs.get(arch, smoke=True).replace(q8_cache=True)
    if jax_init:
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
    else:
        flat = {k: tensor_to_numpy(v) for k, v in compression.flatten_tree(
            init_params(tcfg, 0, device="cpu")).items()}
        jparams = jax.tree.map(jnp.asarray, unflatten(flat))
    return {"jcfg": jcfg, "jparams": jparams, "tcfg": tcfg,
            "tparams": params_from_numpy(flat, "cpu"), "flat": flat}


@pytest.fixture(scope="module")
def smoke():
    return _model("llama3-8b")


def _sessions(m, scfg):
    return (JSession(m["jcfg"], m["jparams"], serve_cfg=JConfig(**scfg)),
            ServeSession(m["tcfg"], m["tparams"], device="cpu",
                         serve_cfg=ServeConfig(**scfg)))


def _run(session, prompts, max_new):
    hs = [session.submit(p, max_new_tokens=max_new) for p in prompts]
    session.run(max_steps=2000)
    assert all(h.done for h in hs)
    return [list(h.result()) for h in hs]


def _both(m, prompts, scfg, max_new=8):
    """(reference session, its tokens, port session, its tokens)."""
    js, ts = _sessions(m, scfg)
    return js, _run(js, prompts, max_new), ts, _run(ts, prompts, max_new)


def _same_counters(js, ts):
    for k in SCHED_KEYS:
        assert ts.stats[k] == js.stats[k], k
    if js._kv is not None:
        for k in KV_KEYS:
            assert ts._kv.stats[k] == js._kv.stats[k], k


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# -- scheduler: token identity -----------------------------------------------

def test_paged_matches_reference_and_slot_mode_no_pressure(smoke):
    prompts = _prompts(smoke["tcfg"].vocab_size, (5, 9, 7, 12), 2)
    js, want, ts, got = _both(smoke, prompts,
                              dict(slots=2, max_len=64, kv_page_size=8))
    slot = _run(_sessions(smoke, dict(slots=2, max_len=64))[1], prompts, 8)
    assert got == want == slot
    _same_counters(js, ts)
    ts.close()
    js.close()


def test_forced_eviction_with_a_restore_worker(smoke):
    """A pool too small for the active set parks and restores mid
    generation (the restores decode on a worker thread); tokens equal the
    reference's and the slot session's, and the page counters match."""
    prompts = _prompts(smoke["tcfg"].vocab_size, (12, 10, 9, 11), 3)
    scfg = dict(slots=4, max_len=64, kv_page_size=4, kv_pool_pages=20,
                kv_restore_workers=1)
    js, want, ts, got = _both(smoke, prompts, scfg, max_new=16)
    slot = _run(_sessions(smoke, dict(slots=4, max_len=64))[1], prompts, 16)
    assert ts.stats["parks"] > 0 and ts._kv.stats["pages_restored"] > 0
    assert ts._kv.stats["bytes_to_host"] > 0
    assert got == want == slot
    _same_counters(js, ts)
    assert ts.kv_report()["host_compressed_bytes"] == \
        js.kv_report()["host_compressed_bytes"]
    ts.close()
    js.close()


def test_manual_park_then_resume(smoke):
    """Park mid generation, finish the other request, resume: tokens equal
    a never-parked slot session's and the reference's; the parked blob
    equals the reference's byte for byte (the same int8 levels)."""
    p1, p2 = _prompts(smoke["tcfg"].vocab_size, (7, 9), 4)
    slot = _run(_sessions(smoke, dict(slots=2, max_len=64))[1], [p1, p2],
                10)
    outs, blobs = [], []
    for s in _sessions(smoke, dict(slots=2, max_len=64, kv_page_size=4)):
        h1 = s.submit(p1, max_new_tokens=10)
        h2 = s.submit(p2, max_new_tokens=10)
        s.step()
        s.step()
        assert not h1.done
        s.park(h1)
        assert s.num_parked == 1 and s._kv.stats["pages_evicted"] > 0
        blobs.append(s._kv.store.get(s._parked[h1.id][1].cold_key))
        s.run()
        assert h2.done and not h1.done
        s.resume(h1)
        s.run()
        outs.append([list(h1.result()), list(h2.result())])
        s.close()
    assert outs[1] == outs[0] == slot
    assert blobs[1] == blobs[0]


def test_parked_levels_equal_the_reference(smoke):
    """The int8 levels of a parked slot, decoded by each package from its
    own blob, equal level for level, and equal the pool pages they came
    from."""
    p = _prompts(smoke["tcfg"].vocab_size, (11,), 9)[0]
    levels = []
    for s in _sessions(smoke, dict(slots=1, max_len=32, kv_page_size=4)):
        h = s.submit(p, max_new_tokens=6)
        s.step()
        s.step()
        ids = s._kv.slot_ids(0)
        if isinstance(s, ServeSession):
            pages = s._kv.gather(ids)
        s.park(h)
        parked = s._parked[h.id][1]
        assert len(parked.prefix_keys) == 2          # (11 - 1) // 4 shared
        blob = s._kv.store.get(parked.cold_key)
        levels.append((blob, ids))
        s.close()
    (jblob, jids), (tblob, tids) = levels
    assert tids == jids
    want = jcompression.get("kv-q8-cabac").decompress(jblob)
    got = compression.get("kv-q8-cabac").decompress(tblob)
    assert sorted(got) == sorted(want) == ["k", "v"]
    for name in want:
        assert got[name].dtype == torch.int8
        np.testing.assert_array_equal(got[name].numpy(), want[name])
        assert torch.equal(got[name], pages[name][:, 2:])
        assert np.abs(want[name]).max() > 0


def test_park_requires_paged_mode(smoke):
    s = _sessions(smoke, dict(slots=1, max_len=16))[1]
    h = s.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="paged"):
        s.park(h)
    assert s.num_parked == 0


# -- prefix sharing -----------------------------------------------------------

def test_prefix_sharing_prefills_once_with_cow(smoke):
    """Two requests with a shared system prompt: the shared pages prefill
    once (the second admission runs a suffix-only partial prefill), the
    page tables alias only the read-only prefix pages, and tokens, counters
    and page ids equal the reference's."""
    vocab = smoke["tcfg"].vocab_size
    rng = np.random.default_rng(5)
    sys_p = rng.integers(0, vocab, 8).astype(np.int32)
    pa = np.concatenate([sys_p, rng.integers(0, vocab, 3).astype(np.int32)])
    pb = np.concatenate([sys_p, rng.integers(0, vocab, 5).astype(np.int32)])
    outs, tables = [], []
    sessions = _sessions(smoke, dict(slots=2, max_len=64, kv_page_size=4))
    for s in sessions:
        ha = s.submit(pa, max_new_tokens=6)
        hb = s.submit(pb, max_new_tokens=6)
        s.step()
        assert s._kv.stats["prefix_hits"] == 1
        assert s._kv.stats["prefix_pages_reused"] == 2
        assert s.stats["prefix_reused_tokens"] == 8
        assert s.stats["prefill_tokens"] == pa.size + (pb.size - 8)
        ids_a, ids_b = s._kv.slot_ids(0), s._kv.slot_ids(1)
        assert ids_a[:2] == ids_b[:2], "prefix pages must be aliased"
        assert not (set(ids_a[2:]) & set(ids_b[2:]))
        tables.append((ids_a, ids_b))
        s.run()
        outs.append([list(ha.result()), list(hb.result())])
    assert tables[1] == tables[0]
    assert outs[1] == outs[0]
    _same_counters(*sessions)


def test_prefix_sharing_disabled_never_aliases(smoke):
    p = _prompts(smoke["tcfg"].vocab_size, (9,), 6)[0]
    scfg = dict(slots=2, max_len=64, kv_page_size=4,
                kv_prefix_sharing=False)
    js, want, ts, got = _both(smoke, [p, p.copy()], scfg, max_new=4)
    assert got == want
    assert ts._kv.stats["prefix_hits"] == 0
    _same_counters(js, ts)
    s = _sessions(smoke, scfg)[1]
    s.submit(p, max_new_tokens=4)
    s.submit(p.copy(), max_new_tokens=4)
    s.step()
    assert not (set(s._kv.slot_ids(0)) & set(s._kv.slot_ids(1)))


# -- compacted decode ---------------------------------------------------------

def test_free_slots_burn_no_decode_rows(smoke):
    """One active request in a 4-slot paged session decodes one row a
    step, and an all-free tick skips decode; slot mode pays for free
    slots.  Counters equal the reference's in both modes."""
    p = np.arange(6, dtype=np.int32)
    for scfg in (dict(slots=4, max_len=32, kv_page_size=8),
                 dict(slots=4, max_len=32)):
        js, want, ts, got = _both(smoke, [p], scfg, max_new=5)
        assert got == want
        for s in (js, ts):
            s.step()                                  # all slots free
        _same_counters(js, ts)
        if "kv_page_size" in scfg:
            assert ts.stats["free_slot_rows"] == 0
            assert ts.stats["decode_rows"] == ts.stats["decode_steps"]
            assert ts.stats["skipped_all_free_steps"] >= 1
        else:
            assert ts.stats["free_slot_rows"] > 0


# -- composition --------------------------------------------------------------

def test_swap_weights_on_a_paged_session(smoke, tmp_path):
    """A live delta swap mid generation on a paged session: the reference's
    chain, served by each package; the port's paged tokens equal the
    reference's paged session's and the port's slot session's."""
    from repro.checkpoint import CheckpointConfig, CheckpointManager
    params = smoke["jparams"]
    rng = np.random.default_rng(7)
    pert = {k: (v * (1 + 1e-4 * rng.standard_normal(v.shape))).astype(v.dtype)
            if v.dtype.kind == "f" else v for k, v in smoke["flat"].items()}
    mgr = CheckpointManager(CheckpointConfig(
        str(tmp_path / "ckpt"), codec="deepcabac-delta", delta_every=4))
    mgr.save({"params": params, "opt": {"count": np.int32(0)}}, 1)
    mgr.save({"params": jcompression.unflatten_like(pert, params),
              "opt": {"count": np.int32(1)}}, 2)
    kf_dir = os.path.join(mgr.cfg.directory, "step_00000001")
    delta_dir = os.path.join(mgr.cfg.directory, "step_00000002")
    with open(os.path.join(kf_dir, "params.dcbc"), "rb") as f:
        kf_blob = f.read()

    def run(make, scfg):
        s = make(scfg)
        h = s.submit(np.arange(5, dtype=np.int32), max_new_tokens=8)
        s.step()
        s.step()
        assert s.swap_weights(delta_dir) > 0
        s.run()
        return list(h.result())

    def jmake(scfg):
        return JSession(smoke["jcfg"], kf_blob, serve_cfg=JConfig(**scfg),
                        backend=jget_backend("container", track_levels=True))

    def tmake(scfg):
        return ServeSession(smoke["tcfg"], kf_blob, device="cpu",
                            serve_cfg=ServeConfig(**scfg),
                            backend=get_backend("container",
                                                track_levels=True))

    paged = dict(slots=2, max_len=32, kv_page_size=4)
    got = run(tmake, paged)
    assert got == run(jmake, paged) == run(tmake, dict(slots=2, max_len=32))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_paged_refuses_stateful_families(arch):
    m = _model(arch, jax_init=False)
    jcfg, tcfg, tparams = m["jcfg"], m["tcfg"], m["tparams"]
    with pytest.raises(ValueError, match="token axis"):
        JSession(jcfg, m["jparams"], serve_cfg=JConfig(
            slots=1, max_len=32, kv_page_size=8))
    with pytest.raises(ValueError, match="token axis"):
        ServeSession(tcfg, tparams, device="cpu", serve_cfg=ServeConfig(
            slots=1, max_len=32, kv_page_size=8))
    cache = init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="token axis"):
        from repro_torch.models.transformer import decode_step
        decode_step(tparams, tcfg, cache, 0,
                    tokens=torch.zeros(1, dtype=torch.int64),
                    cache_pages=torch.zeros((1, 1), dtype=torch.int32))


def test_pool_must_hold_one_full_slot(smoke):
    scfg = dict(slots=2, max_len=64, kv_page_size=8, kv_pool_pages=4)
    with pytest.raises(Exception, match="kv_pool_pages"):
        JSession(smoke["jcfg"], smoke["jparams"], serve_cfg=JConfig(**scfg))
    with pytest.raises(PageError, match="kv_pool_pages"):
        ServeSession(smoke["tcfg"], smoke["tparams"], device="cpu",
                     serve_cfg=ServeConfig(**scfg))


# -- capacity accounting -------------------------------------------------------

def test_kv_report_and_bytes_per_slot_equal_the_reference(smoke):
    per_slot = kv_cache_bytes(smoke["tcfg"], 1, 64)
    assert per_slot == jkv_cache_bytes(smoke["jcfg"], 1, 64)
    assert per_slot == sum(t.numel() * t.element_size() for t in
                           init_cache(smoke["tcfg"], 1, 64,
                                      device="cpu").values())
    for scfg in (dict(slots=2, max_len=64, kv_page_size=8),
                 dict(slots=2, max_len=64)):
        js, ts = _sessions(smoke, scfg)
        assert ts.kv_bytes_per_slot() == js.kv_bytes_per_slot() == per_slot
        jr, tr = js.kv_report(), ts.kv_report()
        for k, v in jr.items():
            if k == "scheduler":
                assert {n: tr[k][n] for n in v} == v
            else:
                assert tr[k] == v, k
        assert tr["mode"] == ("paged" if "kv_page_size" in scfg
                              else "slots")
        ts.close()
        js.close()


def test_park_moves_compressed_bytes_and_cancel_drops_the_blob(smoke):
    for store in ("host", "dir"):
        s = _sessions(smoke, dict(slots=2, max_len=32, kv_page_size=4,
                                  kv_cold_store=store))[1]
        h = s.submit(np.arange(6, dtype=np.int32), max_new_tokens=6)
        g = s.submit(np.arange(3, 12, dtype=np.int32), max_new_tokens=6)
        s.step()
        s.park(h)
        r = s.kv_report()
        assert r["host_compressed_bytes"] > 0
        assert r["host_compressed_bytes"] < r["stats"]["pages_evicted"] * \
            (r["device_bytes"] // r["pool_pages"])
        s.resume(h)
        s.run()
        assert h.done and s.kv_report()["host_compressed_bytes"] == 0
        # a parked request that is cancelled drops its blob at once
        g = s.submit(np.arange(3, 12, dtype=np.int32), max_new_tokens=6)
        s.step()
        s.park(g)
        key = s._parked[g.id][1].cold_key
        assert key in s._kv.store
        assert s.cancel(g) and g.finish_reason == "cancelled"
        assert key not in s._kv.store and s.num_parked == 0
        assert s.kv_report()["host_compressed_bytes"] == 0
        s.close()


# -- MoE (nested pools) and MLA (latent pools) ---------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_paged_decode_of_moe_and_mla_models(arch):
    """deepseek-moe-16b's nested {"dense", "main"} pools and
    deepseek-v3-671b's MLA latent pools: a whole-prompt admission, a
    suffix prefill over a shared prefix and paged decode give the
    reference's tokens and counters, and a park of the nested pools codes
    the reference's blob byte for byte."""
    m = _model(arch, jax_init=False)
    vocab = m["tcfg"].vocab_size
    rng = np.random.default_rng(8)
    sys_p = rng.integers(0, vocab, 8).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, vocab, k)
                               .astype(np.int32)]) for k in (3, 5)]
    scfg = dict(slots=2, max_len=32, kv_page_size=4)
    js, want, ts, got = _both(m, prompts, scfg, max_new=6)
    assert got == want
    assert ts._kv.stats["prefix_hits"] == 1
    _same_counters(js, ts)
    blobs = []
    for s in (js, ts):
        s.submit(prompts[1], max_new_tokens=4)
        s.step()
        blobs.append(s._kv._compress(s._kv.slot_ids(0)))
    assert blobs[1] == blobs[0]
    names = sorted(compression.flatten_tree(ts._kv.pools))
    assert names == (["dense/k", "dense/v", "main/k", "main/v"]
                     if arch == "deepseek-moe-16b" else
                     ["dense/ckv", "dense/kr", "main/ckv", "main/kr"])
    ts.close()
    js.close()


def test_calibrate_kv_cache_delta_matches_reference(smoke):
    toks = np.stack(_prompts(smoke["tcfg"].vocab_size, (12, 12), 11))
    want = jquantized.calibrate_kv_cache_delta(smoke["jcfg"],
                                               smoke["jparams"], toks)
    got = tquantized.calibrate_kv_cache_delta(smoke["tcfg"],
                                              smoke["tparams"], toks)
    assert got == pytest.approx(want, rel=1e-6)
    assert got != smoke["tcfg"].kv_cache_delta
