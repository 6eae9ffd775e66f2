"""The port's KV-page codec (``kv-q8-cabac``), its q8 block primitives and
the KV cold stores against the JAX package's, on the CPU.

* ``q8_encode`` / ``q8_decode``: codes equal the reference's exactly and
  scales bit for bit, for blockable (last axis a multiple of 128) and
  other shapes, f32 and bf16, all-zero blocks included.
* ``kv-q8-cabac``: for the cases of the reference's
  ``test_kv_codec_roundtrip_property`` (page sizes 1, 3, 8, 16; int8, f32
  and bf16 pages), plus full-width pages (head dim 128, so float pages
  take per-block scales), a blob written by the port equals the
  reference's byte for byte, its report equals the reference's, and each
  package decodes the other's blob to the same tensors: int8 levels
  exactly, float pages as the q8 reconstruction.
* the ``host`` and ``dir`` stores through the registry, and ``BlobGC``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro.compression import q8 as jq8  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.compression import q8 as tq8  # noqa: E402
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.serve import backends  # noqa: E402

DTYPES = {"int8": np.int8, "float32": np.float32,
          "bfloat16": ml_dtypes.bfloat16}


def _page(seed, page, dtype, heads=(4,)):
    """The reference's property case: (2, n, page, *heads) of its dtype."""
    rng = np.random.default_rng(seed)
    shape = (2, int(rng.integers(1, 4)), page, *heads)
    if dtype == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    return (rng.standard_normal(shape) * rng.uniform(0.1, 4)).astype(
        DTYPES[dtype])


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the reference's numpy (bf16 as ml_dtypes)."""
    a = tensor_to_numpy(t)
    return a.view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 8, 4), (7,), (4, 256),
                                   (2, 2, 16, 2, 128), (3, 0, 128)])
def test_q8_encode_decode_equal_the_reference(shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[-1])
    for scale in (1e-3, 1.0, 37.0):
        x = (rng.standard_normal(shape) * scale).astype(DTYPES[dtype])
        if x.size:
            x.reshape(-1)[: x.size // 3] = 0       # all-zero blocks too
        jc, js = jq8.q8_encode(jnp.asarray(x))
        tc, ts = tq8.q8_encode(tensor_from_numpy(x, "cpu"))
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))
        assert tuple(ts.shape) == jq8.q8_scale_shape(shape) == \
            tq8.q8_scale_shape(shape)
        assert tq8.q8_blockable(shape) == jq8.q8_blockable(shape)
        jd = np.asarray(jq8.q8_decode(jc, js))
        td = tq8.q8_decode(tc, ts)
        np.testing.assert_array_equal(td.numpy().view(np.uint32),
                                      jd.view(np.uint32))


def test_q8_sqrt_pair_equals_the_reference():
    v = np.abs(np.random.default_rng(0).standard_normal((3, 256))).astype(
        np.float32) ** 3
    jc, js = jq8.q8_encode_sqrt(jnp.asarray(v))
    tc, ts = tq8.q8_encode_sqrt(torch.from_numpy(v))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq8.q8_decode_sqrt(tc, ts).numpy(),
        np.asarray(jq8.q8_decode_sqrt(jc, js)))


CASES = [(seed, page, dtype) for dtype in ("int8", "float32", "bfloat16")
         for page in (1, 3, 8, 16) for seed in (0, 1)]


@pytest.mark.parametrize("seed,page,dtype", CASES)
def test_blobs_byte_identical_and_cross_decoded(seed, page, dtype):
    x = _page(seed, page, dtype)
    pages = {"p": x, "q": _page(seed + 7, page, dtype)}
    j = jcompression.get("kv-q8-cabac", step=1 / 16)
    t = compression.get("kv-q8-cabac", step=1 / 16)
    jart = j.compress(pages)
    tart = t.compress({k: tensor_from_numpy(v, "cpu")
                       for k, v in pages.items()})
    assert tart.blob == jart.blob
    assert tart.report == jart.report
    assert tart.hyperparams == jart.hyperparams
    # each package decodes the other's blob to the same tensors
    want = j.decompress(tart.blob)
    got = t.decompress(jart.blob)
    assert sorted(got) == sorted(want) == ["p", "q"]
    for name, arr in want.items():
        assert got[name].dtype == tensor_from_numpy(pages[name], "cpu").dtype
        assert _np(got[name]).dtype == arr.dtype
        np.testing.assert_array_equal(_np(got[name]).view(np.uint8),
                                      arr.view(np.uint8))
        if dtype == "int8":
            np.testing.assert_array_equal(arr, pages[name])


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_full_width_pages_byte_identical(dtype):
    """llama3-8b's page layout, cut in layers: (L, n, page, 8 heads, 128),
    so float pages take per-128-block scales; unwritten positions stay
    zero, as in a pool (an all-zero block takes the 1e-12 floor)."""
    x = _page(3, 16, dtype, heads=(8, 128))
    x[:, :, 11:] = 0
    pages = {"k": x, "v": _page(4, 16, dtype, heads=(8, 128))}
    like = {k: tensor_from_numpy(v, "cpu") for k, v in pages.items()}
    jart = jcompression.get("kv-q8-cabac").compress(pages)
    tart = compression.get("kv-q8-cabac").compress(like)
    assert tart.blob == jart.blob
    assert tart.report["ratio"] < 1.0
    got = compression.get("kv-q8-cabac").decompress(jart.blob, like=like)
    want = jcompression.get("kv-q8-cabac").decompress(tart.blob)
    for name in pages:
        np.testing.assert_array_equal(_np(got[name]).view(np.uint8),
                                      want[name].view(np.uint8))


def test_codec_registered_with_the_reference_defaults():
    t = compression.get("kv-q8-cabac")
    j = jcompression.get("kv-q8-cabac")
    assert t.name == j.name == "kv-q8-cabac"
    assert (t.step, t.num_gr, t.chunk_size, t.backend) == \
        (j.step, j.num_gr, j.chunk_size, j.backend)
    from repro_torch.compression.kv_pages import KV_PAGE_CHUNK
    assert KV_PAGE_CHUNK == 1 << 14
    assert compression.KVPageCodec is type(t)


def test_kv_store_registry(tmp_path):
    assert {"host", "dir"} <= set(backends.available_kv_stores())
    with pytest.raises(KeyError):
        backends.get_kv_store("no-such-store")
    store = backends.get_kv_store("dir", root=str(tmp_path))
    store.put("a", b"xyz")
    assert "a" in store and store.get("a") == b"xyz"
    assert store.nbytes() == 3
    store.drop("a")
    assert "a" not in store and store.nbytes() == 0
    store.close()
    inst = backends.DirKVStore(root=str(tmp_path))
    assert backends.resolve_kv_store(inst) is inst
    inst.close()
    host = backends.resolve_kv_store("host")
    assert isinstance(host, backends.HostKVStore)
    host.put("b", bytearray(b"12"))
    assert host.get("b") == b"12" and host.nbytes() == 2
    host.close()
    assert "b" not in host
    own = backends.DirKVStore()                    # a private temp dir
    own.put("c", b"1")
    root = own._root
    own.close()
    import os
    assert not os.path.exists(root)


def test_blob_gc_drops_on_the_last_release():
    dropped = []
    gc = backends.BlobGC(dropped.append)
    assert gc.hold("a") == 1 and gc.hold("a") == 2 and gc.hold("b") == 1
    assert gc.release("a") is False and gc.refs("a") == 1
    assert gc.release("a") is True and dropped == ["a"]
    assert gc.release("a") is False                 # unknown: a no-op
    assert gc.live() == ["b"]
    gc.clear()
    assert dropped == ["a", "b"] and gc.live() == []
