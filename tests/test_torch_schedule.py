"""How ``dequant_matmul`` cuts its grid (``ops.schedule``), checked on the
CPU for every main-path shape of the registered models at decode (M = 1,
4) and prefill (M = 512; MLA's whole-cache up-projection at M = 640) on a
card of 132 SMs: the K chunks cover
K exactly once, in whole steps of the instance, at most MAX_SPLITS of
them (one thread-block cluster); a decode block stages at most
DECODE_X_BYTES of x; and the grid fills the card.  Only the kernel's
arithmetic needs the card (``tests/test_torch_cuda.py``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.dequant_matmul import ops  # noqa: E402

SMS = 132
SHAPES = {  # (K, N) of each model's dequant_matmul calls (chip_smoke.py)
    "llama3-8b": [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                  (4096, 128256)],
    "deepseek-moe-16b": [(2048, 2048), (2048, 64), (2048, 2816),
                         (2816, 2048), (2048, 10944), (10944, 2048),
                         (2048, 102400)],
    "qwen3-8b": [(4096, 12288), (12288, 4096), (4096, 151936)],
    "qwen1.5-4b": [(2560, 2560), (2560, 6912), (6912, 2560),
                   (2560, 151936)],
    "mistral-nemo-12b": [(5120, 4096), (5120, 1024), (4096, 5120),
                         (5120, 14336), (14336, 5120), (5120, 131072)],
    "qwen2-vl-7b": [(3584, 3584), (3584, 512), (3584, 18944),
                    (18944, 3584), (3584, 152064)],
    "musicgen-medium": [(1536, 1536), (1536, 6144), (6144, 1536),
                        (1536, 2048)],
    "deepseek-v3-671b": [(7168, 1536), (1536, 24576), (7168, 512),
                         (7168, 64), (16384, 7168), (7168, 18432),
                         (18432, 7168), (7168, 256), (7168, 2048),
                         (2048, 7168), (7168, 129280)],
}
CASES = [(m, k, n) for shapes in SHAPES.values() for k, n in shapes
         for m in (1, 4, 512)] + [(640, 512, 16384), (512, 512, 16384)]


@pytest.mark.parametrize("m,k,n", CASES)
def test_schedule_covers_k_once_in_whole_steps(m, k, n):
    kc, splits, tiles, bm = ops.schedule(m, k, n, SMS)
    step = ops.DECODE_ROWS if m <= ops.DECODE_MAX_M else ops.TC_BK
    assert kc > 0 and kc % step == 0
    assert (splits - 1) * kc < k <= splits * kc
    assert 1 <= splits <= ops.MAX_SPLITS
    if m <= ops.DECODE_MAX_M:
        assert bm == m and m * kc * 4 <= ops.DECODE_X_BYTES
        assert tiles == -(-n // ops.TILE)
    else:
        assert bm in (ops.TILE, ops.SMALL_BM)
        assert tiles == -(-n // ops.TILE) * -(-m // bm)


@pytest.mark.parametrize("m,k,n", CASES)
def test_schedule_fills_the_card(m, k, n):
    """Decode: a wave of blocks wherever K and the cluster's MAX_SPLITS
    blocks allow (4096 x 1024 has 8 strips of columns, the router's
    2048 x 64 one, and a block keeps 4 load rounds); tensor cores: at
    least half a wave of the 4-warp blocks, or all MAX_SPLITS chunks, and
    no large-tile block runs more than TC_MAX_STEPS steps."""
    kc, splits, tiles, bm = ops.schedule(m, k, n, SMS)
    blocks = splits * tiles
    if bm == m:
        rounds = -(-k // ops.DECODE_ROWS)
        want = min(SMS, tiles * min(ops.MAX_SPLITS,
                                    -(-rounds // ops.DECODE_MIN_STEPS)))
        assert blocks >= want * 0.9
    else:
        assert blocks >= SMS // 2 or splits == ops.MAX_SPLITS
        if bm == ops.TILE:
            assert kc <= ops.TC_MAX_STEPS * ops.TC_BK


def test_schedule_picks_the_small_tile_for_few_rows_and_narrow_n():
    assert ops.schedule(16, 4096, 4096, SMS)[3] == ops.SMALL_BM
    assert ops.schedule(512, 2048, 64, SMS)[3] == ops.SMALL_BM
    assert ops.schedule(512, 4096, 1024, SMS)[3] == ops.SMALL_BM
    assert ops.schedule(512, 4096, 4096, SMS)[3] == ops.TILE


@pytest.mark.parametrize("m", [1, 4, 8])
def test_schedule_takes_the_tensor_cores_where_decode_x_would_not_fit(m):
    """Eight K chunks of a decode block must hold their share of x in
    DECODE_X_BYTES; a longer K goes to the 32-row tensor-core tile."""
    rows = ops.DECODE_X_BYTES // (4 * m)
    fits = ops.MAX_SPLITS * rows
    assert ops.schedule(m, fits, 1024, SMS)[3] == m
    kc, splits, _, bm = ops.schedule(m, fits + ops.DECODE_ROWS, 1024, SMS)
    assert bm == ops.SMALL_BM and kc % ops.TC_BK == 0
    assert splits <= ops.MAX_SPLITS
