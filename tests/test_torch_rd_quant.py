"""The ``rd_quant`` kernel's plain version and the port's RD routing
against the JAX package, on the CPU.

The plain version computes in f32 one IEEE operation at a time, as the
jnp oracle ``repro.kernels.rd_quant.rd_quant(..., use_ref=True)`` does;
the two must agree on every level (no tolerance), as must the Pallas body
in interpret mode on the inputs of ``tests/test_kernels.py``, where the
reference itself holds it equal to the oracle.  The device-side bin
statistics must equal numpy's exactly, and the host route must equal
``quantize_tensor_rd``.  The CUDA kernel itself is held against this plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import ml_dtypes  # noqa: E402

from repro.compression.rd_search import rd_assign_levels as j_assign  # noqa: E402
from repro.core.deepcabac import quantize_tensor_rd as j_qrd  # noqa: E402
from repro.core.quant import nearest_level  # noqa: E402
from repro.core.rate_model import estimate_bin_probs as j_probs  # noqa: E402
from repro.kernels.rd_quant import rd_quant as j_rd_quant  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.compression.rd_search import rd_assign_levels  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import rate_model  # noqa: E402
from repro_torch.core.deepcabac import quantize_tensor_rd  # noqa: E402
from repro_torch.kernels.rd_quant import rd_quant  # noqa: E402
from repro_torch.kernels.rd_quant import ops as rd_ops  # noqa: E402

POINTS = [(0.004, 1e-5), (0.008, 2e-4), (0.016, 1e-3)]   # tests/test_kernels


def _weights(seed, n, sparsity=0.5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(n) * 0.05).astype(dtype)
    w[rng.random(n) < sparsity] = 0
    return w


def _both(w, fisher, step, lam, window, max_level=None, passes=2,
          interpret=False):
    nn = nearest_level(np.asarray(w, np.float64), step)
    probs = j_probs(nn)
    ml = max_level or int(np.abs(nn).max()) + window + 1
    kw = dict(step=step, lam=lam, window=window, max_level=ml,
              passes=passes)
    # the reference widens w to f32 before anything else, so a bf16 w goes
    # in as its exact f32 values: one jit signature for both dtypes
    want = np.asarray(j_rd_quant(np.asarray(w, np.float32), fisher, probs,
                                 use_ref=not interpret, interpret=interpret,
                                 **kw))
    got = rd_quant(tensor_from_numpy(w, "cpu"),
                   None if fisher is None
                   else tensor_from_numpy(fisher, "cpu"), probs, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == np.shape(w)
    return got.numpy(), want


# every window with every (step, lam) point; the sizes (none a multiple of
# the reference's 1024-lane rows) rotate, so each meets every point and
# three of the windows — each case costs one jit compile of the oracle
SIZES = [1, 1023, 20000, 70001]
CASES = [(SIZES[(i + j) % 4], window, *POINTS[j])
         for i, window in enumerate([1, 2, 4, 8]) for j in range(3)]


@pytest.mark.parametrize("n,window,step,lam", CASES)
def test_plain_equals_jnp_oracle(n, window, step, lam):
    got, want = _both(_weights(n + window, n), None, step, lam, window)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step,lam", POINTS)
def test_plain_equals_jnp_oracle_fisher_and_bf16(step, lam):
    w = _weights(3, 20000)
    wb = w.astype(ml_dtypes.bfloat16)
    rng = np.random.default_rng(4)
    fisher = (rng.random(20000) * 3).astype(np.float32)
    fisher[:5000] = 1e4
    # one max_level for both calls, so the oracle compiles once
    ml = max(int(np.abs(nearest_level(np.asarray(v, np.float64),
                                      step)).max()) for v in (w, wb)) + 5
    got, want = _both(w, fisher, step, lam, 4, max_level=ml)
    np.testing.assert_array_equal(got, want)
    got, want = _both(wb, None, step, lam, 4, max_level=ml)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [100, 4096, 262144 + 17])
def test_plain_equals_pallas_interpret(n):
    """tests/test_kernels.py::test_rd_quant_kernel_vs_oracle's inputs."""
    w = _weights(n, n)
    nn = nearest_level(w, 0.008)
    got, want = _both(w, None, 0.008, 2e-4, 4,
                      max_level=int(np.abs(nn).max()) + 8, interpret=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [1, 2, 6])
def test_plain_equals_pallas_interpret_windows(window):
    """tests/test_kernels.py::test_rd_quant_windows's inputs."""
    w = _weights(window, 30000)
    got, want = _both(w, None, 0.008, 1e-4, window, max_level=1 << 20,
                      interpret=True)
    np.testing.assert_array_equal(got, want)


def test_plain_equals_pallas_interpret_fisher():
    """tests/test_kernels.py::test_rd_quant_fisher's inputs."""
    w = _weights(5, 30000)
    fisher = np.ones(30000, np.float32)
    fisher[:15000] = 1e5
    got, want = _both(w, fisher, 0.01, 1e-2, 4, max_level=1 << 20,
                      interpret=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["zeros", "one", "small", "wide", "huge"])
def test_torch_bin_probs_equal_numpy(case, monkeypatch):
    rng = np.random.default_rng(11)
    v = {"zeros": np.zeros(1000, np.int64),
         "one": np.array([-3]),
         "small": np.rint(rng.standard_normal(5000) * 0.7),
         "wide": np.rint(rng.standard_normal(30001) * 40),
         "huge": rng.integers(-(1 << 22), 1 << 22, 9000)}[case]
    v = np.asarray(v, np.int64)
    monkeypatch.setattr(rate_model, "STATS_CHUNK", 777)   # chunk borders
    want = rate_model.estimate_bin_probs(v)
    assert repr(want) == repr(j_probs(v))
    for dt in (torch.int32, torch.int64):
        got = rate_model.estimate_bin_probs_torch(torch.from_numpy(v).to(dt))
        for f in ("p_sig", "p_gr", "p_eg"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.p_sign == want.p_sign and got.num_gr == want.num_gr
    bits = rate_model.estimate_level_bits(v)
    assert abs(rate_model.estimate_level_bits_torch(torch.from_numpy(v))
               - bits) <= 1e-12 * max(bits, 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,lam", POINTS)
def test_host_route_equals_quantize_tensor_rd(dtype, step, lam):
    w = _weights(int(step * 1e4), 4200).reshape(60, 70)
    w = w.astype(getattr(ml_dtypes, dtype) if dtype == "bfloat16" else dtype)
    t = tensor_from_numpy(w, "cpu")
    got = rd_assign_levels(t, step, lam, assign="host")
    assert got.dtype == torch.int64 and tuple(got.shape) == (60, 70)
    want = j_qrd(w, step, lam).levels
    np.testing.assert_array_equal(got.numpy(), want)
    mine = quantize_tensor_rd(w.astype(np.float64), step, lam,
                              dtype=dtype)
    np.testing.assert_array_equal(mine.levels, want)
    assert mine.dtype == dtype


@pytest.mark.parametrize("step,lam", POINTS + [(0.008, 0.0)])
def test_kernel_route_on_cpu_equals_reference_kernel_route(step, lam):
    """``assign="kernel"`` on the CPU: the plain version here, the jnp
    oracle in the reference (its registry's CPU default)."""
    w = _weights(9, 8000).reshape(80, 100)
    before = kernels.launch_counts()["rd_quant"]
    got = rd_assign_levels(tensor_from_numpy(w, "cpu"), step, lam,
                           assign="kernel")
    assert kernels.launch_counts()["rd_quant"] == before   # no kernel here
    want = j_assign(w, step, lam, assign="kernel")
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_route_takes_the_host_oracle_for_cpu_tensors():
    w = _weights(2, 3000)
    t = tensor_from_numpy(w, "cpu")
    np.testing.assert_array_equal(
        rd_assign_levels(t, 0.008, 2e-4).numpy(),
        rd_assign_levels(t, 0.008, 2e-4, assign="host").numpy())
    with pytest.raises(ValueError, match="assign"):
        rd_assign_levels(t, 0.008, 2e-4, assign="gpu")


def test_cuda_request_without_card_raises():
    """A CUDA route never falls back to the plain version: without a card
    the kernel wrapper refuses a CPU tensor and CUDA tensors cannot be
    made; with one, the kernel is launched (tests/test_torch_cuda.py)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    w = torch.zeros(10)
    sc, mg = np.zeros((1, 8), np.float32), np.zeros((1, 42), np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        rd_ops.rd_quant_cuda(w, None, sc, mg, step=0.1, lam=1e-3, window=4,
                             max_level=10, num_gr=10, passes=2)
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(10, device="cuda")
