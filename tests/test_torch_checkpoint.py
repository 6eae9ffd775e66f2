"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

Both packages' managers save the same numpy-seeded frames, one AdamW-like
drift apart: every payload file and manifest of every step directory must
be byte-identical (monolithic and sharded over a 2-way ``MeshSpec``, on the
C and the numpy lane engines); a chain written by either package restores
in the other to exactly equal levels; cadence, retention and the chain
errors (type and message) are the reference's; an ``async_save`` snapshot
is taken before ``save`` returns.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro.checkpoint import CheckpointConfig as JConfig  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import delta as jdelta  # noqa: E402
from repro.checkpoint.sharded import MeshSpec as JMeshSpec  # noqa: E402
from repro_torch.arrays import to_storage  # noqa: E402
from repro_torch.checkpoint import (CheckpointConfig,  # noqa: E402
                                    CheckpointManager, DeltaBaseMissingError,
                                    DeltaChainError, MeshSpec, delta, sharded)
from repro_torch.core import cabac_vec  # noqa: E402
from repro_torch.core.codec import DecodeOptions, QuantizedTensor  # noqa: E402

ENGINES = ["c", "numpy"]


@pytest.fixture(params=ENGINES)
def engine(request, monkeypatch):
    """The lane engine both packages encode and decode with: "numpy"
    disables the C engines, so "auto" resolves to numpy everywhere."""
    if request.param == "numpy":
        from repro.core import cabac_vec as jcabac_vec
        monkeypatch.setattr(cabac_vec, "_KERNEL", False)
        monkeypatch.setattr(jcabac_vec, "_KERNEL", False)
    elif cabac_vec.resolve_backend("auto") != "c":
        pytest.fail("the C lane engine did not build (no host cc?)")
    return request.param


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {"attn": {"wq": rng.standard_normal((2, 8, 16))},
                       "mlp": {"w_up": rng.standard_normal((2, 16, 12))},
                       "attn_norm": rng.standard_normal((2, 16))},
            "embed": rng.standard_normal((20, 16)),
            "final_norm": rng.standard_normal(16)}


def _drift(tree, seed):
    """Multiplicative drift of one optimizer step (zeros stay zero)."""
    rng = np.random.default_rng(seed)
    return {k: (_drift(v, seed + 1) if isinstance(v, dict) else
                v * (1 + 1e-4 * rng.standard_normal(v.shape)))
            for k, v in tree.items()}


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.astype(np.float32)
            for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(v.astype(np.float32))
            for k, v in tree.items()}


def _frames(n, seed=0):
    frames = [_tree(seed)]
    for i in range(1, n):
        frames.append(_drift(frames[-1], seed + 10 * i))
    return frames


def _mgr(root, name, port=True, **kw):
    kw.setdefault("codec", "deepcabac-delta")
    if port:
        return CheckpointManager(CheckpointConfig(str(root / name), **kw))
    return JManager(JConfig(str(root / name), **kw))


def _save(mgr, frames, port=True, mesh=None, first=1):
    for i, f in enumerate(frames):
        step = first + i
        params = _torch(f) if port else _f32(f)
        m = (MeshSpec if port else JMeshSpec).from_any(mesh) if mesh else None
        mgr.save({"params": params, "opt": {"count": np.int32(step)}}, step,
                 mesh=m)


def _step_dir(mgr, step):
    return os.path.join(mgr.cfg.directory, f"step_{step:08d}")


def _meta(mgr, step):
    with open(os.path.join(_step_dir(mgr, step), "meta.json")) as f:
        return json.load(f)


def _state(seed=0):
    return {"params": _torch(_tree(seed)), "opt": {"count": np.int32(0)}}


# ---------------------------------------------------------------------------
# byte identity and crossing chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sharded_save", [False, True])
def test_step_directories_equal_reference(tmp_path, engine, sharded_save):
    frames = _frames(5)
    mesh = {"data": 2, "model": 1} if sharded_save else None
    kw = dict(keep=10, delta_every=3, sharded=sharded_save)
    tm, jm = _mgr(tmp_path, "t", **kw), _mgr(tmp_path, "j", False, **kw)
    _save(tm, frames, mesh=mesh)
    _save(jm, frames, port=False, mesh=mesh)
    assert tm.steps() == jm.steps() == [1, 2, 3, 4, 5]
    kinds = []
    for step in tm.steps():
        a, b = _step_dir(tm, step), _step_dir(jm, step)
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b))
        for fname in names:
            if fname in ("meta.json", "state.npz"):
                continue      # hyperparams / zip timestamps
            with open(os.path.join(a, fname), "rb") as fa, \
                    open(os.path.join(b, fname), "rb") as fb:
                assert fa.read() == fb.read(), (step, fname)
        ma, mb = _meta(tm, step), _meta(jm, step)
        for key in ("kind", "chain_depth", "base_step",
                    "params_compressed_bytes", "params_raw_bytes",
                    "shard_files", "save_mesh"):
            assert ma.get(key) == mb.get(key), (step, key)
        kinds.append(ma["kind"])
    assert kinds == ["keyframe", "delta", "delta", "keyframe", "delta"]
    if sharded_save:
        assert _meta(tm, 1)["shard_files"] == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_chain_crosses_between_packages(tmp_path, writer):
    """A chain written by one package restores in the other (and in
    itself) to exactly equal levels, steps and raw bits."""
    frames = _frames(4)
    port = writer == "port"
    mgr = _mgr(tmp_path, "c", port, keep=10, delta_every=4, sharded=True)
    _save(mgr, frames, port=port, mesh={"data": 2, "model": 1})
    root = mgr.cfg.directory
    got = delta.restore_levels(root, 4)
    want = jdelta.restore_levels(root, 4)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if hasattr(w, "levels"):
            assert isinstance(g, QuantizedTensor), k
            np.testing.assert_array_equal(g.levels, w.levels, err_msg=k)
            assert g.step == w.step and g.dtype == w.dtype, k
        else:
            np.testing.assert_array_equal(to_storage(g), np.asarray(w),
                                          err_msg=k)
    flat = delta.restore_flat_delta(root, 4)
    jflat = jdelta.restore_flat_delta(root, 4)
    for k, w in jflat.items():
        np.testing.assert_array_equal(flat[k].numpy(), np.asarray(w),
                                      err_msg=k)
    assert [c["kind"] for c in delta.resolve_chain(root, 4)] == \
        [c["kind"] for c in jdelta.resolve_chain(root, 4)]
    assert [{k: c[k] for k in ("step", "files")}
            for c in delta.chain_files(root, 4)] == \
        [{k: c[k] for k in ("step", "files")}
         for c in jdelta.chain_files(root, 4)]


@pytest.mark.parametrize("backend", ENGINES)
def test_chain_restore_equals_direct_step_locked_encode(tmp_path, backend):
    """base + 3 chained P-frames, decoded on either lane engine, == one
    direct encode of the last frame's step-locked quantization, in level
    space."""
    frames = _frames(4)
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=4)
    _save(mgr, frames)
    codec = mgr._codec()
    direct = codec.quantize_entries(_torch(frames[0]))
    for f in frames[1:]:
        direct = codec.quantize_like(_torch(f), direct)
    got = delta.restore_levels(mgr.cfg.directory, 4,
                               opts=DecodeOptions(backend=backend))
    assert sorted(got) == sorted(direct)
    for k, b in direct.items():
        if isinstance(b, QuantizedTensor):
            assert got[k].step == b.step, k
            np.testing.assert_array_equal(got[k].levels, b.levels)
        else:
            assert torch.equal(got[k], b), k


def test_manager_restore_matches_flat_chain_restore(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=3)
    _save(mgr, _frames(5))
    restored, meta = mgr.restore(_state(), device="cpu")
    assert meta["step"] == 5 and meta["kind"] == "delta"
    assert restored["opt"]["count"] == np.int32(5)
    assert isinstance(restored["opt"]["count"], np.int32)
    flat = delta.restore_flat_delta(mgr.cfg.directory, 5)
    from repro_torch.compression.tree import flatten_tree
    got = flatten_tree(restored["params"])
    for k, v in flat.items():
        assert torch.equal(got[k], v), k


def test_restore_puts_tensors_on_the_asked_device(tmp_path):
    mgr = _mgr(tmp_path, "c", codec="ckpt-nearest")
    state = _state()
    state["opt"]["mu"] = torch.arange(6, dtype=torch.bfloat16)
    mgr.save(state, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mgr.restore(state)
    restored, _ = mgr.restore(state, device="cpu")
    mu = restored["opt"]["mu"]
    assert mu.dtype == torch.bfloat16 and mu.device.type == "cpu"
    assert torch.equal(mu, state["opt"]["mu"])
    assert restored["params"]["embed"].device.type == "cpu"


# ---------------------------------------------------------------------------
# cadence, retention, errors (the reference's tests, in the port)
# ---------------------------------------------------------------------------

def test_keyframe_cadence_and_meta(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=3)
    _save(mgr, _frames(6))
    assert [_meta(mgr, s)["kind"] for s in range(1, 7)] == \
        ["keyframe", "delta", "delta", "keyframe", "delta", "delta"]
    assert [_meta(mgr, s)["chain_depth"] for s in range(1, 7)] == \
        [0, 1, 2, 0, 1, 2]
    assert [_meta(mgr, s).get("base_step") for s in (2, 3, 5)] == [1, 2, 4]
    kf = _meta(mgr, 1)["params_compressed_bytes"]
    for s in (2, 3, 5, 6):
        assert _meta(mgr, s)["params_compressed_bytes"] < 0.7 * kf


def test_delta_every_zero_keeps_every_save_a_keyframe(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=4, delta_every=0)
    _save(mgr, _frames(2))
    for s in (1, 2):
        assert delta.base_step_of(_step_dir(mgr, s)) is None


def test_delta_every_needs_a_delta_codec(tmp_path):
    mgr = _mgr(tmp_path, "c", codec="deepcabac-v3", delta_every=2)
    with pytest.raises(ValueError, match="delta-capable"):
        mgr.save(_state(), 1)


def test_cold_manager_resumes_chain_without_cache(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=4)
    frames = _frames(3)
    _save(mgr, frames[:2])
    mgr2 = _mgr(tmp_path, "c", keep=10, delta_every=4)
    _save(mgr2, frames[2:], first=3)
    m = _meta(mgr2, 3)
    assert m["kind"] == "delta" and m["base_step"] == 2
    assert m["chain_depth"] == 2
    assert [c["kind"] for c in delta.resolve_chain(mgr2.cfg.directory, 3)] \
        == ["keyframe", "delta", "delta"]
    # the restarted manager's P-frame equals the warm one's
    mgr3 = _mgr(tmp_path, "w", keep=10, delta_every=4)
    _save(mgr3, frames)
    for fname in ("delta_00000.dcbc", sharded.MANIFEST_NAME):
        with open(os.path.join(_step_dir(mgr3, 3), fname), "rb") as a:
            want = a.read()
        with open(os.path.join(_step_dir(mgr2, 3), fname), "rb") as b:
            got = b.read()
        if fname == sharded.MANIFEST_NAME:   # the base's path differs
            got, want = json.loads(got), json.loads(want)
            got.pop("base"), want.pop("base")
        assert got == want, fname


def test_retention_never_orphans_a_live_chain(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=2, delta_every=4)
    frames = _frames(6)
    _save(mgr, frames[:4])
    assert mgr.steps() == [1, 2, 3, 4]
    delta.restore_flat_delta(mgr.cfg.directory, 4)
    _save(mgr, frames[4:], first=5)
    assert _meta(mgr, 5)["kind"] == "keyframe"
    assert mgr.steps() == [5, 6]


def _errors(call_port, call_ref):
    out = []
    for call in (call_port, call_ref):
        with pytest.raises(Exception) as e:
            call()
        out.append(e.value)
    return out


def test_missing_base_raises_as_the_reference(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=4)
    _save(mgr, _frames(3))
    shutil.rmtree(_step_dir(mgr, 1))
    root = mgr.cfg.directory
    port, ref = _errors(lambda: delta.restore_flat_delta(root, 3),
                        lambda: jdelta.restore_flat_delta(root, 3))
    assert isinstance(port, DeltaBaseMissingError)
    assert isinstance(port, FileNotFoundError)
    assert type(ref).__name__ == type(port).__name__
    assert str(port) == str(ref) and "retention" in str(port)


def test_rewritten_base_raises_as_the_reference(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=4)
    _save(mgr, _frames(2))
    with open(os.path.join(_step_dir(mgr, 1), "params.dcbc"), "ab") as f:
        f.write(b"\x00")
    delta.clear_hash_cache()
    root = mgr.cfg.directory
    port, ref = _errors(lambda: delta.resolve_chain(root, 2),
                        lambda: jdelta.resolve_chain(root, 2))
    assert isinstance(port, DeltaChainError)
    assert type(ref).__name__ == type(port).__name__
    assert str(port) == str(ref) and "rewritten" in str(port)


def test_hash_cache_reuses_a_verified_base(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=4)
    _save(mgr, _frames(3))
    delta.clear_hash_cache()
    delta.resolve_chain(mgr.cfg.directory, 3)
    misses = delta.hash_cache_stats()["misses"]
    delta.resolve_chain(mgr.cfg.directory, 3)
    stats = delta.hash_cache_stats()
    assert stats["misses"] == misses and stats["hits"] >= 2


def test_restore_helpers_reject_delta_manifests(tmp_path):
    mgr = _mgr(tmp_path, "c", keep=10, delta_every=4)
    _save(mgr, _frames(2))
    d = _step_dir(mgr, 2)
    with pytest.raises(ValueError, match="P-frame"):
        sharded.restore_flat(d)
    for call in (sharded.restore_on_mesh, sharded.restore_local_slices,
                 sharded.restore_tensor_on_mesh,
                 delta.restore_on_mesh_delta):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call(d)


def test_sharded_manifest_byte_ranges_and_hashes(tmp_path):
    from repro_torch.core.container import read_record_at
    mgr = _mgr(tmp_path, "c", codec="deepcabac-v3", sharded=True)
    _save(mgr, _frames(1), mesh={"data": 2, "model": 1})
    d = _step_dir(mgr, 1)
    manifest = sharded.load_manifest(d)
    sharded.verify_files(d, manifest)
    assert manifest["mesh"] == {"axes": ["data", "model"], "shape": [2, 1]}
    for tinfo in manifest["tensors"].values():
        for sh in tinfo["shards"]:
            with open(os.path.join(d, sh["file"]), "rb") as f:
                f.seek(sh["offset"])
                hdr, _ = read_record_at(f.read(sh["length"]))
            assert hdr.name == sh["record"]
    assert sharded.manifest_payload_bytes(manifest) == sum(
        os.path.getsize(os.path.join(d, f)) for f in manifest["files"])
    # a sub-box decodes only the chunks it needs, and equals the slice
    stats = sharded.RestoreStats()
    tinfo = manifest["tensors"]["layers/mlp/w_up"]
    part = sharded.assemble_slice(d, "layers/mlp/w_up", tinfo, (1, 8, 0),
                                  (2, 16, 12), dequantize=False, stats=stats)
    whole = sharded.assemble_slice(d, "layers/mlp/w_up", tinfo,
                                   dequantize=False)
    np.testing.assert_array_equal(part.levels, whole.levels[1:, 8:])
    with open(os.path.join(d, "shard_00001.dcbc"), "ab") as f:
        f.write(b"\x00")
    with pytest.raises(ValueError, match="hash mismatch"):
        sharded.verify_files(d, manifest)


# ---------------------------------------------------------------------------
# async save against in-place updates
# ---------------------------------------------------------------------------

def test_async_save_snapshots_before_returning(tmp_path):
    """The port's AdamW writes parameters in place: a change made right
    after ``save`` returns must not reach the step being written."""
    mgr = _mgr(tmp_path, "c", codec="raw", async_save=True)
    state = _state()
    want = {k: v.clone() for k, v in state["params"]["layers"]["attn"]
            .items()}
    embed = state["params"]["embed"].clone()
    mgr.save(state, 1)
    state["params"]["layers"]["attn"]["wq"].add_(1.0)
    state["params"]["embed"].mul_(3.0)
    mgr.wait()
    restored, meta = mgr.restore(_state(1), device="cpu")
    assert meta["step"] == 1
    assert torch.equal(restored["params"]["layers"]["attn"]["wq"],
                       want["wq"])
    assert torch.equal(restored["params"]["embed"], embed)
