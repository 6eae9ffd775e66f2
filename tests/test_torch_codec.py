"""The port's host codec against the JAX package's, on the CPU.

The wire format is pinned twice: the port re-encodes the golden fixtures'
entries to the committed bytes (``tests/golden``), and on the llama3-8b
smoke tree (f32 and its bf16 cast) every ported codec writes a container
byte-identical to the reference's.  Each package decodes the other's blob
to equal arrays.  bf16 travels without ``ml_dtypes`` in the port; the
tests still build ``ml_dtypes`` arrays to talk to the reference.
"""

import importlib.util
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
import ml_dtypes  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core.huffman import build_huffman, pack_payload  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.arrays import (cast_host, raw_bytes, tensor_from_bytes,  # noqa: E402
                                to_storage)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import binarization as B  # noqa: E402
from repro_torch.core import cabac_vec, codec  # noqa: E402
from repro_torch.core.cabac import RangeDecoder, RangeEncoder  # noqa: E402
from repro_torch.core.container import (VERSION, VERSION_V2,  # noqa: E402
                                        VERSION_V3, VERSION_V4,
                                        ContainerReader, ContainerWriter)

REPO = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "gen_goldens", REPO / "tests" / "golden" / "gen_goldens.py")
gg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gg)


def _bits(x) -> np.ndarray:
    """Comparable storage of a decoded value from either package: a torch
    tensor (bf16 as its bits) or a numpy array (ml_dtypes bf16 as bits)."""
    if isinstance(x, torch.Tensor):
        return to_storage(x)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same_value(got, want, name=""):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, name
    np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# golden fixtures
# ---------------------------------------------------------------------------

def _port_entries(entries):
    return {k: codec.QuantizedTensor(v.levels, v.step, v.dtype)
            if hasattr(v, "levels") else v for k, v in entries.items()}


def _port_build(name: str) -> bytes:
    if name == "v1_basic":
        return codec.encode_state_dict(_port_entries(gg.v1_entries()),
                                       num_gr=10, chunk_size=128)
    w = ContainerWriter()
    if name == "v2_mixed":
        huff, q8_levels, q8_scale, cab = gg.v2_parts()
        w.add_huffman("huf", "float32", (10, 20), 0.25,
                      pack_payload(huff, build_huffman(huff)))
        w.add_q8("q8", "float32", q8_levels, q8_scale)
        w.add_cabac("cab", "float32", (150,), 0.0625, 10, 64,
                    codec.encode_level_chunks(cab, 10, 64))
    elif name == "v4_delta":
        base, resid, intra = gg.v4_parts()
        chunks, counts = codec.encode_delta_chunks_batched(resid, base, 10,
                                                           64)
        w.add_cabac_delta("delta", "float32", (20, 15), 0.125, 10, 64,
                          chunks, counts)
        chunks, counts = codec.encode_level_chunks_batched(intra, 10, 64)
        w.add_cabac_v3("intra", "bfloat16", (40,), 0.5, 10, 64, chunks,
                       counts)
    else:
        big, small = gg.v3_parts()
        chunks, counts = codec.encode_level_chunks_batched(big, 10, 128)
        w.add_cabac_v3("big", "float32", (20, 25), 0.125, 10, 128,
                       chunks, counts)
        chunks, counts = codec.encode_level_chunks_batched(small, 10, 128)
        w.add_cabac_v3("small", "bfloat16", (33,), 0.5, 10, 128,
                       chunks, counts)
        w.add_raw("raw", torch.arange(6, dtype=torch.float32).reshape(2, 3)
                  / 8)
    return w.tobytes()


@pytest.mark.parametrize("name", ["v1_basic", "v2_mixed", "v3_lanes",
                                  "v4_delta"])
def test_golden_encode_is_byte_exact(name):
    assert _port_build(name) == gg.load_fixture(name)


@pytest.mark.parametrize("name,version", [
    ("v1_basic", VERSION), ("v2_mixed", VERSION_V2),
    ("v3_lanes", VERSION_V3), ("v4_delta", VERSION_V4)])
def test_golden_versions(name, version):
    assert ContainerReader(gg.load_fixture(name)).version == version


@pytest.mark.parametrize("name", ["v1_basic", "v2_mixed", "v3_lanes"])
@pytest.mark.parametrize("path", ["stream", "batched", "scalar"])
def test_golden_decodes_to_reference(name, path):
    blob = gg.load_fixture(name)
    if path == "batched":
        got = codec.decode_state_dict_batched(blob, dequantize=False)
        got_dq = codec.decode_state_dict_batched(blob)
    else:
        opts = codec.DecodeOptions(backend="scalar" if path == "scalar"
                                   else "auto")
        got = codec.decode_state_dict(blob, dequantize=False, opts=opts)
        got_dq = codec.decode_state_dict(blob, opts=opts)
    want = jcodec.decode_state_dict(blob, dequantize=False)
    want_dq = jcodec.decode_state_dict(blob)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if hasattr(w, "levels"):
            np.testing.assert_array_equal(g.levels, w.levels)
            assert g.levels.dtype == w.levels.dtype
            assert g.dtype == w.dtype
            if hasattr(w, "step"):
                assert g.step == w.step
            else:
                np.testing.assert_array_equal(g.scale, w.scale)
        else:
            _assert_same_value(g, w, k)
        _assert_same_value(got_dq[k], want_dq[k], k)


def test_v4_delta_record_is_not_yet_ported():
    """The v4 golden's delta record decodes against its base to the
    reference's levels (tests/test_torch_delta.py holds every decode path);
    alone it is refused, as the reference refuses it."""
    blob = gg.load_fixture("v4_delta")
    base, resid, intra = gg.v4_parts()
    with pytest.raises(ValueError, match="cannot be decoded standalone"):
        codec.decode_state_dict(blob)
    recs = {h.name: (h, p) for h, p in ContainerReader(blob)}
    h, p = recs["delta"]
    np.testing.assert_array_equal(
        codec.decode_delta_record(h, p, base).levels.ravel(), base + resid)
    # the intra record of the same container decodes on its own
    h, p = recs["intra"]
    np.testing.assert_array_equal(
        codec.decode_record(h, p, dequantize=False).levels.ravel(), intra)


def test_binarization_paper_vectors():
    """Worked examples of the paper (n = 1), as the reference pins them."""
    for v, bits in ((1, [1, 0, 0]), (-4, [1, 1, 1, 1, 0, 1]),
                    (7, [1, 0, 1, 1, 1, 0, 1, 0])):
        assert [b for _, b in B.binarize_value(v, num_gr=1)] == bits


@pytest.mark.parametrize("engine", ["c-1-thread", "c-3-threads", "numpy"])
def test_lane_engines_match_scalar_coder(engine):
    """Every lane equals the scalar coder's stream, whatever the C engine's
    split of the batch over threads."""
    rng = np.random.default_rng(5)
    lanes = [np.rint(rng.standard_normal(n) * s).astype(np.int64)
             for n, s in ((0, 1), (1, 5), (700, 0.4), (900, 30),
                          (200, 2000))]
    lanes[3][::7] = 0
    scalar = []
    for lv in lanes:
        enc = RangeEncoder(B.make_contexts(10))
        B.encode_levels(enc, lv, 10)
        scalar.append(enc.finish())
    counts = [lv.size for lv in lanes]
    if engine == "numpy":
        got = cabac_vec.encode_lanes(lanes, 10, "numpy")
        dec = cabac_vec.decode_lanes(got, counts, 10, "numpy")
    else:
        assert cabac_vec.resolve_backend("auto") == "c"
        lib, threads = cabac_vec._get_kernel(), int(engine[2])
        got = cabac_vec._encode_lanes_c(lanes, 10, lib, threads)
        dec = cabac_vec._decode_lanes_c(got, counts, 10, lib, threads)
    assert got == scalar
    for d, lv in zip(dec, lanes):
        np.testing.assert_array_equal(d, lv)
    for p, lv in zip(scalar, lanes):
        rdec = RangeDecoder(p, B.make_contexts(10))
        np.testing.assert_array_equal(B.decode_levels(rdec, lv.size, 10),
                                      lv)


def test_c_engine_builds_into_the_checkout():
    cabac_vec._get_kernel()
    path = cabac_vec._lib_path()
    assert path.parent == REPO / "build" / "host" and path.exists()


# ---------------------------------------------------------------------------
# bf16 without ml_dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [2.0 ** -7, 0.000533905667292585,
                                  0.006, 1.0 / 3.0, 37.5])
def test_bf16_dequantize_bit_equal_to_ml_dtypes(step):
    rng = np.random.default_rng(7)
    levels = np.concatenate([
        rng.integers(-300, 301, 600_000),
        rng.integers(-(1 << 20), 1 << 20, 400_000),
        np.arange(-1000, 1001)]).astype(np.int64)
    got = codec.QuantizedTensor(levels, step, "bfloat16").dequantize()
    want = jcodec.QuantizedTensor(levels, step, "bfloat16").dequantize()
    assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
    np.testing.assert_array_equal(to_storage(got), want.view(np.uint16))
    q8 = codec.Q8Tensor(np.clip(levels, -127, 127).astype(np.int8)
                        .reshape(-1, 1), np.float32([step]), "bfloat16")
    jq8 = jcodec.Q8Tensor(q8.levels, q8.scale, "bfloat16")
    np.testing.assert_array_equal(to_storage(q8.dequantize()),
                                  jq8.dequantize().view(np.uint16))


def test_cast_host_rounds_through_f32_like_ml_dtypes():
    """A value whose direct f64 -> bf16 rounding differs from the rounding
    through f32: ml_dtypes gives the latter, and so must the port."""
    x = np.array([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30),
                  3.0e38, 1e-40, 0.0])
    np.testing.assert_array_equal(
        to_storage(cast_host(x, "bfloat16")),
        x.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_raw_bytes_round_trip_bf16():
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    t = tensor_from_bytes(a.tobytes(), "bfloat16", a.shape)
    assert t.dtype == torch.bfloat16
    assert raw_bytes(t) == (a.tobytes(), "bfloat16")
    assert raw_bytes(a) == (a.tobytes(), "bfloat16")


def test_port_imports_no_ml_dtypes():
    code = ("import sys, pkgutil, importlib\n"
            "sys.path[:0] = ['src', '.']\n"
            "import repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "assert 'ml_dtypes' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# the two packages' containers on the llama3-8b smoke tree
# ---------------------------------------------------------------------------

def rd_policy() -> dict:
    """The llama3-8b winner of the committed RD sweep (BENCH_rd.json)."""
    rows = json.loads((REPO / "BENCH_rd.json").read_text())["rows"]
    return next(r for r in rows if r["arch"] == "llama3-8b"
                and r["path"] == "policy")["policy"]


CODECS = {
    "serve-q8": {},
    "raw": {},
    "deepcabac-v3": {"delta_rel": 0.006, "lam": 1e-5},
    "deepcabac-rd-host": {"assign": "host"},
    "deepcabac-rd-kernel": {"assign": "kernel"},
}


@pytest.fixture(scope="module")
def trees():
    cfg = jconfigs.get("llama3-8b", smoke=True)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    out = {}
    for dt in ("float32", "bfloat16"):
        jpp = jax.tree_util.tree_map(lambda x: x.astype(dt), jp)
        out[dt] = (jpp, params_from_numpy(jflatten(jpp), "cpu"))
    return out


def _codec(pkg, key):
    kw = dict(CODECS[key])
    name = key
    if key.startswith("deepcabac-rd"):
        name, kw["policy_table"] = "deepcabac-rd", rd_policy()
    return pkg.get(name, **kw)


_BLOBS: dict = {}


def _blobs(trees, key, dt):
    if (key, dt) not in _BLOBS:
        jtree, ttree = trees[dt]
        _BLOBS[key, dt] = (_codec(jcompression, key).compress(jtree).blob,
                           _codec(compression, key).compress(ttree).blob)
    return _BLOBS[key, dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", sorted(CODECS))
def test_container_bytes_identical_across_packages(trees, key, dt):
    want, got = _blobs(trees, key, dt)
    assert got == want


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["serve-q8", "deepcabac-rd-kernel", "raw"])
def test_each_package_decodes_the_others_blob(trees, key, dt):
    jblob, tblob = _blobs(trees, key, dt)
    mine = compression.decompress(jblob)
    theirs = jcompression.decompress(tblob)
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        _assert_same_value(mine[k], theirs[k], k)
    like = trees[dt][1]
    rebuilt = compression.decompress(jblob, like=like)
    assert rebuilt["layers"]["attn"]["wq"].dtype == like["layers"]["attn"][
        "wq"].dtype


def test_registry_strictness_and_unported_codecs():
    with pytest.raises(TypeError, match="lamda"):
        compression.get("deepcabac-v3", lamda=0.1)
    c = compression.get("serve-q8", strict=False, delta_rel=0.1)
    assert c.hyperparams["dropped_overrides"] == ["delta_rel"]
    for name in ("kv-q8-cabac",):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            compression.get(name)
    with pytest.raises(ValueError, match="policy_table"):
        compression.get("deepcabac-rd")
    assert compression.available() == sorted(
        ["deepcabac-v2", "deepcabac-v3", "deepcabac-rd", "deepcabac-delta",
         "ckpt-nearest", "serve-q8", "huffman", "raw"])


def test_size_report_matches_reference(trees):
    jtree, ttree = trees["bfloat16"]
    j = jcompression.get("serve-q8").compress(jtree)
    t = compression.get("serve-q8").compress(ttree)
    assert t.report == j.report
