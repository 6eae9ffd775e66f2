"""The paper's baselines in the port against the JAX package, on the CPU:
uniform quantization and weighted Lloyd (alg. 5 and 4: equal exactly),
the scalar Huffman coder and its two-part code, CSR-Huffman and bzip2
sizes, and the ``huffman`` codec, whose containers must be byte-identical
to the reference's (and decode in either package)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import ml_dtypes  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro.core import huffman as jhuff  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.arrays import to_storage  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import csr, huffman, quant  # noqa: E402


def _weights(seed, n=5000, sparsity=0.3):
    rng = np.random.default_rng(seed)
    w = (rng.standard_t(3, n) * 0.05).astype(np.float32)
    w[rng.random(n) < sparsity] = 0.0
    return w, rng.random(n).astype(np.float32) + 0.1


@pytest.mark.parametrize("k", [2, 7, 16, 33])
def test_uniform_quantize_equals_reference(k):
    w, _ = _weights(k)
    a, c = quant.uniform_quantize(w, k)
    ja, jc = jquant.uniform_quantize(w, k)
    np.testing.assert_array_equal(a, ja)                      # exact
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(quant.assign_nearest(w, c, chunk=777),
                                  jquant.assign_nearest(w, jc, chunk=777))


@pytest.mark.parametrize("k,lam,fisher", [(8, 0.0, False), (8, 1e-3, True),
                                          (16, 1e-4, True), (5, 0.0, True)])
def test_weighted_lloyd_equals_reference(k, lam, fisher):
    w, f = _weights(10 + k)
    imp = f if fisher else None
    got = quant.weighted_lloyd(w, imp, k, lam, iters=12, chunk=1 << 11,
                               seed=k)
    want = jquant.weighted_lloyd(w, imp, k, lam, iters=12, chunk=1 << 11,
                                 seed=k)
    for field in ("assignments", "centers", "probs"):          # exact
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.objective == want.objective


def test_huffman_code_payload_and_sizes_equal_reference():
    rng = np.random.default_rng(1)
    vals = (rng.standard_t(2, 5000) * 3).astype(np.int64)
    code, jcode = huffman.build_huffman(vals), jhuff.build_huffman(vals)
    np.testing.assert_array_equal(code.symbols, jcode.symbols)
    np.testing.assert_array_equal(code.lengths, jcode.lengths)
    assert code.codes == jcode.codes and code.table_bits == jcode.table_bits
    payload = huffman.pack_payload(vals, code)
    assert payload == jhuff.pack_payload(vals, jcode)          # bytes
    np.testing.assert_array_equal(huffman.unpack_payload(payload, vals.size),
                                  vals)
    enc = huffman.huffman_encode(vals, code)
    np.testing.assert_array_equal(huffman.huffman_decode(enc, vals.size,
                                                         code), vals)
    assert huffman.huffman_payload_bits(vals, code) == \
        jhuff.huffman_payload_bits(vals, jcode)
    assert huffman.scalar_huffman_size_bits(vals) == \
        jhuff.scalar_huffman_size_bits(vals)
    assert huffman.epmd_entropy_bits(vals) == jhuff.epmd_entropy_bits(vals)
    for edge in (np.zeros(0, np.int64), np.full(9, 4, np.int64)):
        assert huffman.pack_payload(edge, huffman.build_huffman(edge)) == \
            jhuff.pack_payload(edge, jhuff.build_huffman(edge))


def test_csr_and_bzip2_equal_reference():
    rng = np.random.default_rng(2)
    m = (rng.random((64, 700)) < 0.02).astype(np.int64) * \
        rng.integers(-15, 15, (64, 700))
    for arr in (m, m[0], m.reshape(8, 8, 700)):
        for got, want in zip(csr.csr_streams(arr, delta_cap=255),
                             jcsr.csr_streams(arr, delta_cap=255)):
            np.testing.assert_array_equal(got, want)
        assert csr.csr_huffman_size_bits(arr) == \
            jcsr.csr_huffman_size_bits(arr)
    lv = (rng.standard_normal(10000) * 2).astype(np.int64)
    assert csr.bzip2_size_bits(lv) == jcsr.bzip2_size_bits(lv)


@pytest.fixture(scope="module")
def smoke_tree():
    """The reference's llama3-8b smoke init, flat numpy (f32) and the port's
    tree from it."""
    cfg = jconfigs.get("llama3-8b", smoke=True)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    return flat, params_from_numpy(flat, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_huffman_codec_container_equals_reference(smoke_tree, dtype):
    flat, tree = smoke_tree
    jdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jtree = {k: v.astype(jdt) for k, v in flat.items()}
    ttree = {k: v.to(getattr(torch, dtype))
             for k, v in compression.flatten_tree(tree).items()}
    kw = {"delta_rel": 4e-3}
    blob = compression.get("huffman", **kw).compress(ttree).blob
    jblob = jcompression.get("huffman", **kw).compress(jtree).blob
    assert blob == jblob                                        # bytes
    mine = compression.decompress(jblob)
    theirs = jcompression.decompress(blob)
    for k in theirs:
        want = np.asarray(theirs[k])
        want = want.view(np.uint16) if want.dtype.name == "bfloat16" else want
        np.testing.assert_array_equal(to_storage(mine[k]), want, err_msg=k)
