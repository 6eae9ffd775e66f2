"""The port's temporal-context ("P-frame") coding against the JAX
package's, on the CPU.

The same numpy levels go through both packages: the context classes, the
bins and their contexts, the scalar stream, the C and numpy lane engines,
the v4 container (the golden fixture included) and ``DeltaCodec``'s blobs
must be equal byte for byte, and a chain of P-frames must reconstruct the
direct step-locked encode's levels exactly.  Residual distributions: all
zero, dense +-1, wide, and each against a zero base (class 0 only).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro.core import binarization as JB  # noqa: E402
from repro.core import cabac_vec as jcabac_vec  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core.cabac import RangeEncoder as JRangeEncoder  # noqa: E402
from repro.core.cabac import temporal_classes as jtemporal_classes  # noqa: E402
from repro.core.container import ContainerWriter as JWriter  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.arrays import to_storage  # noqa: E402
from repro_torch.core import binarization as B  # noqa: E402
from repro_torch.core import cabac_vec, codec  # noqa: E402
from repro_torch.core.cabac import (TEMPORAL_CLASSES, RangeDecoder,  # noqa: E402
                                    RangeEncoder, temporal_classes)
from repro_torch.core.container import (ENC_CABAC_DELTA,  # noqa: E402
                                        VERSION_V4, ContainerReader,
                                        ContainerWriter)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "gen_goldens", REPO / "tests" / "golden" / "gen_goldens.py")
gg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gg)

N = 1500
ENGINES = ["c", "numpy"]
DISTS = ["zero", "pm1", "wide", "zero-base"]


def _base(n=N, seed=0):
    """Base levels covering the three classes (0, |l| <= 2, larger)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_t(2, n) * 4).astype(np.int64)


def _resid(dist, n=N, seed=1):
    rng = np.random.default_rng(seed)
    if dist == "zero":
        return np.zeros(n, dtype=np.int64)
    if dist in ("pm1", "zero-base"):
        return rng.integers(-1, 2, n).astype(np.int64)
    return (rng.standard_t(2, n) * 300).astype(np.int64)


def _pair(dist):
    base = np.zeros(N, dtype=np.int64) if dist == "zero-base" else _base()
    return base, _resid(dist)


# ---------------------------------------------------------------------------
# classes, bins, scalar streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
def test_temporal_classes_equal_reference(dist):
    base, _ = _pair(dist)
    got, want = temporal_classes(base), jtemporal_classes(base)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert set(np.unique(got)) <= set(range(TEMPORAL_CLASSES))
    assert B.num_contexts_tc(7) == JB.num_contexts_tc(7)


@pytest.mark.parametrize("num_gr", [1, 10])
@pytest.mark.parametrize("dist", DISTS)
def test_tc_bins_and_contexts_equal_reference(dist, num_gr):
    base, resid = _pair(dist)
    cls = temporal_classes(base)
    got = B.expand_bins_tc(resid, cls, num_gr)
    want = JB.expand_bins_tc(resid, cls, num_gr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("dist", DISTS)
def test_tc_scalar_stream_equals_reference(dist):
    base, resid = _pair(dist)
    cls = temporal_classes(base)
    enc, jenc = (RangeEncoder(B.make_contexts_tc(10)),
                 JRangeEncoder(JB.make_contexts_tc(10)))
    B.encode_levels_tc(enc, resid, cls, 10)
    JB.encode_levels_tc(jenc, resid, cls, 10)
    blob = enc.finish()
    assert blob == jenc.finish()
    dec = RangeDecoder(blob, B.make_contexts_tc(10))
    np.testing.assert_array_equal(B.decode_levels_tc(dec, cls, 10), resid)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("engine", ENGINES)
def test_tc_lanes_equal_reference(engine, dist):
    """Lanes of ragged sizes: the port's engine = the reference's lanes =
    the scalar coder per lane, and the port's engine decodes them."""
    if engine == "c" and cabac_vec.resolve_backend("auto") != "c":
        pytest.fail("the C lane engine did not build (no host cc?)")
    base, resid = _pair(dist)
    cuts = [0, 0, 1, 301, 900, N]
    lanes = [resid[a:b] for a, b in zip(cuts, cuts[1:])]
    cls = temporal_classes(base)
    cl = [cls[a:b] for a, b in zip(cuts, cuts[1:])]
    got = cabac_vec.encode_lanes_tc(lanes, cl, 10, backend=engine)
    assert got == jcabac_vec.encode_lanes_tc(lanes, cl, 10, backend="numpy")
    for lv, c, payload in zip(lanes, cl, got):
        enc = JRangeEncoder(JB.make_contexts_tc(10))
        JB.encode_levels_tc(enc, lv, c, 10)
        assert payload == enc.finish()
    back = cabac_vec.decode_lanes_tc(got, cl, 10, backend=engine)
    for lv, b in zip(lanes, back):
        np.testing.assert_array_equal(b, lv)


def test_tc_lanes_reject_bad_classes():
    with pytest.raises(ValueError, match="temporal class ids"):
        cabac_vec.encode_lanes_tc([np.zeros(3, np.int64)],
                                  [np.array([0, 1, 3])], backend="numpy")
    with pytest.raises(ValueError, match="class array of 2"):
        cabac_vec.encode_lanes_tc([np.zeros(3, np.int64)],
                                  [np.zeros(2, np.int64)], backend="numpy")


# ---------------------------------------------------------------------------
# delta records and the v4 container
# ---------------------------------------------------------------------------

def _delta_blob(cod, writer_cls, resid, base, dtype="float32", chunk=64,
                num_gr=10, backend="auto"):
    chunks, counts = cod.encode_delta_chunks_batched(resid, base, num_gr,
                                                     chunk, backend=backend)
    w = writer_cls()
    w.add_cabac_delta("t", dtype, np.asarray(resid).shape, 0.5, num_gr,
                      chunk, chunks, counts)
    return w.tobytes()


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("engine", ENGINES)
def test_delta_record_equals_reference(engine, dist):
    base, resid = _pair(dist)
    blob = _delta_blob(codec, ContainerWriter, resid, base, backend=engine)
    assert blob == _delta_blob(jcodec, JWriter, resid, base,
                               backend="numpy")
    assert ContainerReader(blob).version == VERSION_V4
    hdr, payload = next(iter(ContainerReader(blob)))
    assert hdr.encoding == ENC_CABAC_DELTA
    got = codec.decode_delta_record(hdr, payload, base,
                                    opts=codec.DecodeOptions(backend=engine))
    np.testing.assert_array_equal(got.levels, base + resid)
    dq = codec.decode_delta_record(hdr, payload, base, dequantize=True)
    np.testing.assert_array_equal(
        dq.numpy(), ((base + resid) * 0.5).astype(np.float32))


@pytest.mark.parametrize("backend", ["auto", "numpy", "scalar"])
def test_v4_golden_decodes_to_reference_levels(backend):
    base, resid, intra = gg.v4_parts()
    opts = codec.DecodeOptions(backend=backend)
    out = {}
    for hdr, payload in ContainerReader(gg.load_fixture("v4_delta")):
        if hdr.encoding == ENC_CABAC_DELTA:
            out[hdr.name] = codec.decode_delta_record(hdr, payload, base,
                                                      opts=opts)
        else:
            out[hdr.name] = codec.decode_record(hdr, payload,
                                                dequantize=False, opts=opts)
    np.testing.assert_array_equal(out["delta"].levels.ravel(), base + resid)
    assert out["delta"].step == 0.125 and out["delta"].shape == (20, 15)
    np.testing.assert_array_equal(out["intra"].levels, intra)
    assert out["intra"].dtype == "bfloat16"


def test_v4_delta_record_standalone_decode_raises_as_the_reference():
    blob = gg.load_fixture("v4_delta")
    msgs = []
    for dec in (codec.decode_state_dict, jcodec.decode_state_dict):
        with pytest.raises(ValueError, match="cannot be decoded standalone"
                           ) as e:
            dec(blob, dequantize=False)
        msgs.append(str(e.value))
    assert msgs[0].split(" — ")[0] == msgs[1].split(" — ")[0]
    hdr, payload = next(iter(ContainerReader(blob)))
    base, _, _ = gg.v4_parts()
    with pytest.raises(ValueError, match="against a base of"):
        codec.decode_delta_record(hdr, payload, base[:-1])


def test_wide_residuals_fall_back_to_the_scalar_tc_decoder():
    base = np.array([0, 3, 40], dtype=np.int64)
    resid = np.array([1 << 62, -(1 << 62), 7], dtype=np.int64)
    enc = RangeEncoder(B.make_contexts_tc(10))
    B.encode_levels_tc(enc, resid, temporal_classes(base), 10)
    out = codec.decode_delta_chunks_batched([enc.finish()], [3], base, 10,
                                            codec.DecodeOptions())
    np.testing.assert_array_equal(out, resid)


SHAPES = [(), (0,), (1,), (37,), (3, 4), (2, 3, 4), (16, 17)]
PROFILES = ["random", "zeros", "pm1", "wide"]


def _levels(shape, profile, seed):
    n = int(np.prod(shape)) if shape else 1
    rng = np.random.default_rng(seed)
    if profile == "zeros":
        flat = np.zeros(n, dtype=np.int64)
    elif profile == "pm1":
        flat = rng.integers(-1, 2, n).astype(np.int64)
    elif profile == "wide":
        flat = np.where(np.arange(n) % 2 == 0, 1 << 40,
                        -(1 << 40)).astype(np.int64)
    else:
        flat = (rng.standard_t(2, n) * 5).astype(np.int64)
    return flat.reshape(shape)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), shape=st.sampled_from(SHAPES),
       base_profile=st.sampled_from(PROFILES),
       resid_profile=st.sampled_from(PROFILES),
       chunk=st.sampled_from([1, 3, 16, 100, 1 << 16]),
       num_gr=st.sampled_from([1, 10]),
       backend=st.sampled_from(["auto", "numpy", "scalar"]))
def test_delta_record_roundtrip_equals_reference(seed, shape, base_profile,
                                                 resid_profile, chunk,
                                                 num_gr, backend):
    base = _levels(shape, base_profile, seed).ravel()
    resid = _levels(shape, resid_profile, seed + 1)
    enc = "numpy" if backend == "numpy" else "auto"
    blob = _delta_blob(codec, ContainerWriter, resid, base, chunk=chunk,
                       num_gr=num_gr, backend=enc)
    assert blob == _delta_blob(jcodec, JWriter, resid, base, chunk=chunk,
                               num_gr=num_gr, backend=enc)
    hdr, payload = next(iter(ContainerReader(blob)))
    out = codec.decode_delta_record(hdr, payload, base,
                                    opts=codec.DecodeOptions(backend=backend))
    np.testing.assert_array_equal(out.levels, base.reshape(shape) + resid)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 4),
       backend=st.sampled_from(["auto", "numpy", "scalar"]))
def test_chained_deltas_reconstruct_the_last_frame(seed, k, backend):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    frames = [(rng.standard_t(2, n) * 5).astype(np.int64)]
    for _ in range(k):
        frames.append(frames[-1] + rng.integers(-3, 4, n).astype(np.int64))
    cur = frames[0]
    for prev, new in zip(frames, frames[1:]):
        blob = _delta_blob(codec, ContainerWriter, new - prev, prev,
                           chunk=32)
        hdr, payload = next(iter(ContainerReader(blob)))
        cur = codec.decode_delta_record(
            hdr, payload, cur,
            opts=codec.DecodeOptions(backend=backend)).levels.ravel()
    np.testing.assert_array_equal(cur, frames[-1])


# ---------------------------------------------------------------------------
# DeltaCodec
# ---------------------------------------------------------------------------

def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {"attn": {"wq": rng.standard_normal((2, 24, 16))},
                       "mlp": {"w_up": rng.standard_normal((2, 16, 40))},
                       "attn_norm": rng.standard_normal((2, 16))},
            "embed": rng.standard_normal((50, 16)),
            "final_norm": rng.standard_normal(16)}


def _drift(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: (_drift(v, seed + 1) if isinstance(v, dict) else
                v * (1 + 1e-3 * rng.standard_normal(v.shape)))
            for k, v in tree.items()}


def _both(tree, dtype):
    """The same values as the reference's numpy tree (bf16 as
    ml_dtypes) and the port's torch tree, bit for bit."""
    import ml_dtypes
    j, t = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            j[k], t[k] = _both(v, dtype)
            continue
        tv = torch.from_numpy(v.astype(np.float32))
        if dtype == "bfloat16":
            tv = tv.to(torch.bfloat16)
            j[k] = to_storage(tv).view(ml_dtypes.bfloat16)
        else:
            j[k] = v.astype(np.float32)
        t[k] = tv
    return j, t


def _frames(dtype, n=4):
    frames = [_np_tree(0)]
    for i in range(1, n):
        frames.append(_drift(frames[-1], 10 * i))
    return [_both(f, dtype) for f in frames]


@pytest.mark.parametrize("min_ndim", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_codec_blobs_equal_reference(dtype, min_ndim):
    frames = _frames(dtype, 3)
    jc = jcompression.get("deepcabac-delta", min_ndim=min_ndim)
    tc = compression.get("deepcabac-delta", min_ndim=min_ndim)
    ja, ta = jc.compress(frames[0][0]), tc.compress(frames[0][1])
    assert ta.blob == ja.blob
    jb, tb = ja.quantized, ta.quantized
    for jf, tf in frames[1:]:
        ja, ta = jc.compress_delta(jf, jb), tc.compress_delta(tf, tb)
        assert ta.blob == ja.blob
        assert ta.report == ja.report
        assert ContainerReader(ta.blob).version == VERSION_V4
        jb, tb = ja.quantized, ta.quantized
        assert sorted(jb) == sorted(tb)
        for k, w in jb.items():
            if hasattr(w, "levels"):
                np.testing.assert_array_equal(tb[k].levels, w.levels)
                assert tb[k].step == w.step and tb[k].dtype == w.dtype


def test_delta_codec_chain_equals_direct_step_locked_encode():
    """A keyframe and three chained P-frames decode to the levels of a
    direct encode of ``quantize_like``, whose blob is the reference's."""
    frames = _frames("float32", 4)
    tc = compression.get("deepcabac-delta")
    jc = jcompression.get("deepcabac-delta")
    art = tc.compress(frames[0][1])
    levels = {k: e.levels for k, e in art.quantized.items()
              if hasattr(e, "levels")}
    direct, jdirect = art.quantized, jc.compress(frames[0][0]).quantized
    for jf, tf in frames[1:]:
        art = tc.compress_delta(tf, direct)
        for hdr, payload in ContainerReader(art.blob):
            if hdr.encoding == ENC_CABAC_DELTA:
                levels[hdr.name] = codec.decode_delta_record(
                    hdr, payload, levels[hdr.name]).levels
        direct = tc.quantize_like(tf, direct)
        jdirect = jc.quantize_like(jf, jdirect)
    assert tc.compress_entries(direct).blob == \
        jc.compress_entries(jdirect).blob
    for k, lv in levels.items():
        np.testing.assert_array_equal(lv, direct[k].levels, err_msg=k)


def test_delta_codec_without_a_base_codes_intra_records():
    tc = compression.get("deepcabac-delta")
    _, tree = _frames("float32", 1)[0]
    art = tc.compress_delta(tree, {})
    assert art.report["delta_records"] == 0
    assert art.blob == tc.compress(tree).blob
    with pytest.raises(ValueError, match="no delta coder"):
        compression.DeltaCodec("x").compress_delta(tree, {})
