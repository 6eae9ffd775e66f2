"""The port's kernel modules against the JAX reference.

Each test builds its inputs with numpy from a seed and hands the same
arrays to the JAX function (Pallas kernels in interpret mode, or their
plain reference) and to its ``repro_torch`` counterpart.  Tolerances: f32
results agree to 1e-5 relative to the largest magnitude — both sides sum
the same f32 products in a different order.  The CUDA kernels are held
against these plain versions in ``test_torch_cuda.py``, on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.dequant_matmul.ops import dequant_matmul as jdm  # noqa: E402
from repro.kernels.flash_attention import scan as jscan  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.dequant_matmul import dequant_matmul  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import scan as tscan  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rtol * scale


# ---------------------------------------------------------------------------
# dequant_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 100, 130), (1, 160, 96),
                                   ((2, 3), 160, 96), (17, 64, 33)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_dequant_matmul_plain_matches_jax(shape, xdt):
    lead, k, n = shape
    lead = lead if isinstance(lead, tuple) else (lead,)
    rng = np.random.default_rng(k * 7 + n)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    if xdt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sc = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    got = dequant_matmul(_t(x), _t(wq), _t(sc))
    assert got.dtype == torch.float32 and tuple(got.shape) == (*lead, n)
    for kw in ({"interpret": True}, {"use_ref": True}):
        want = jdm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sc), **kw)
        _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# flash attention: plain version, scan and naive paths
# ---------------------------------------------------------------------------

def _qkv(b, sq, skv, h, g, d, seed, dv=None):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, skv, g, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, skv, g, dv or d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,sq,skv,h,g,d", [(2, 16, 16, 4, 2, 32),
                                            (1, 8, 32, 4, 1, 16),
                                            (2, 32, 32, 8, 8, 32)])
def test_flash_plain_matches_jax_interpret(b, sq, skv, h, g, d):
    q, k, v = _qkv(b, sq, skv, h, g, d, seed=sq + skv + h)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  interpret=True, bq=8, bk=8)
    got = fops.flash_attention(_t(q), _t(k), _t(v))
    _close(got.numpy(), want)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("sq", [1, 6])
def test_scan_and_naive_match_jax(ragged, sq):
    b, skv, g, r, d = 3, 20, 2, 2, 16
    q, k, v = _qkv(b, sq, skv, g * r, g, d, seed=sq * 10 + ragged)
    q5 = q.reshape(b, sq, g, r, d)
    qpos = (np.arange(sq)[None, :] + np.array([[3], [9], [14]])).astype(
        np.int32)
    kv_len = np.array([4, 12, 20], np.int32) if ragged else None
    jk = None if kv_len is None else jnp.asarray(kv_len)
    tk = None if kv_len is None else _t(kv_len)
    want_n = jscan.naive_attend(jnp.asarray(q5), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(qpos), jk)
    got_n = tscan.naive_attend(_t(q5), _t(k), _t(v), _t(qpos), tk)
    _close(got_n.numpy(), want_n)
    want_s = jscan.online_softmax_scan(jnp.asarray(q5), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(qpos), 8,
                                       jk)
    got_s = tscan.online_softmax_scan(_t(q5), _t(k), _t(v), _t(qpos), 8, tk)
    _close(got_s.numpy(), want_s)


def test_attention_routing_records_like_the_registry():
    """On the CPU the scan is the platform default: nothing is recorded,
    decode included.  The kernel's contract checks name each fallback, and
    only the three the reference has."""
    q, k, v = _qkv(2, 8, 8, 4, 2, 32, seed=5)
    qpos = _t(np.broadcast_to(np.arange(8), (2, 8)).copy())
    registry.clear_dispatch_report()
    out = fops.attention(_t(q), _t(k), _t(v), qpos, kv_block=4,
                         kv_len=_t(np.array([5, 8], np.int32)))
    assert out.shape == (2, 8, 4, 32)
    assert kernels.dispatch_report() == []
    tq, tk, tv = _t(q), _t(k), _t(v)
    assert fops._kernel_constraint(tq, tk, tv, qpos, None, None) is None
    assert "ragged" in fops._kernel_constraint(tq, tk, tv, qpos,
                                               _t(np.array([5, 8])), None)
    assert "d != dv" in fops._kernel_constraint(tq, tk, tv[..., :16], qpos,
                                                None, None)
    assert "canonical" in fops._kernel_constraint(tq, tk, tv, qpos + 1,
                                                  None, None)
    # a head dim the kernel was not built for is no fallback: the kernel
    # wrapper raises on it
    assert fops._kernel_constraint(tq[..., :24], tk[..., :24], tv[..., :24],
                                   qpos, None, None) is None


# ---------------------------------------------------------------------------
# registry, devices, build, imports
# ---------------------------------------------------------------------------

def test_registry_events_and_launch_counts():
    registry.clear_dispatch_report()
    registry.record_event(op="x", platform="cpu", impl="y", reason="z",
                          kind="fallback")
    (rec,) = kernels.dispatch_report()
    assert rec == {"op": "x", "platform": "cpu", "requested": None,
                   "impl": "y", "reason": "z", "kind": "fallback"}
    registry.clear_dispatch_report()
    assert kernels.dispatch_report() == []
    registry.count_launch("flash_attention")
    assert kernels.launch_counts()["flash_attention"] >= 1
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        kernels.resolve_device("cuda")
    assert kernels.resolve_device("cpu").type == "cpu"


def test_build_sources_exist_and_nothing_builds_at_import():
    from repro_torch.kernels import _build
    for name, src in _build.SOURCES.items():
        assert src.is_file() and src.suffix == ".cu", name
        text = src.read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build._LIBS == {}
    assert _build.BUILD_DIR == REPO / "build" / "kernels"


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, the headers beside it and those in
    ``common/``: an edit to a shared PTX wrapper rebuilds every kernel that
    includes it."""
    from repro_torch.kernels import _build
    assert sorted(p.name for p in _build.COMMON_DIR.glob("*.cuh")) == \
        ["ptx.cuh"]
    for name in ("flash_attention", "dequant_matmul_grouped"):
        assert '#include "../../common/ptx.cuh"' in \
            _build.SOURCES[name].read_text()
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    edited = tmp_path / "ptx.cuh"
    edited.write_text((_build.COMMON_DIR / "ptx.cuh").read_text() + "\n")
    monkeypatch.setattr(_build, "COMMON_DIR", tmp_path)
    for n in _build.SOURCES:
        assert _build._lib_path(n) != before[n], n
        assert _build._lib_path(n).parent == _build.BUILD_DIR


def _needs_a_card_and_imports_no_jax(module: str) -> None:
    """A parent-against-change timing script fails without a card, prints
    no result, and imports nothing of JAX or of the JAX package."""
    script = REPO / f"{module}.py"
    res = subprocess.run([sys.executable, str(script), str(REPO)], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "{" not in res.stdout
    code = ("import sys; sys.path[:0] = ['.']\n"
            f"import {module}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernel_yardsticks_needs_a_card_and_imports_no_jax():
    _needs_a_card_and_imports_no_jax("kernel_yardsticks")


def test_serve_yardsticks_needs_a_card_and_imports_no_jax():
    _needs_a_card_and_imports_no_jax("serve_yardsticks")


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.path[:0] = ['src', '.']\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
