"""The launch plan of ``quant_matmul``, on the CPU.

``quant_matmul.qmm_plan`` picks the kernel body by x's dtype and row count
and cuts K into splits when the output tiles alone would not fill the
card; the C launcher checks the plan it is given.  The kernels run only on
the card (``tests/test_torch_cuda.py``); these are the host-side rules they
rely on: fp32 never reaches a tensor-core body, every M maps to exactly
one body, the splits cover K exactly once with none empty, and one split
when the grid already fills the card.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import quant_matmul as QM

SM = 132   # an H100 SXM's SMs

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
MS = [1, 3, 8, 9, 16, 40, 256, 300]
KS = [1, 63, 64, 100, 1024, 2560, 9728]
NS = [1, 130, 1024, 9728, 151936]


def _unit(body):
    return QM.SIMT_K_CHUNK if body == "simt" else QM.MMA_K_TILE


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_dtype_and_row_count_has_one_body(dtype):
    for M in MS + [2, 7, 17, 65, 4096]:
        body = QM.qmm_plan(M, 2560, 4096, dtype, SM).body
        assert body in QM.BODIES
        if dtype == torch.float32:
            assert body == "simt"             # never TF32 tensor cores
        else:
            assert body == ("mma_decode" if M <= QM.DECODE_MAX_ROWS
                            else "mma_tiled")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", KS)
def test_splits_cover_k_once_and_none_is_empty(dtype, K):
    for M, N in itertools.product(MS, NS):
        p = QM.qmm_plan(M, K, N, dtype, SM)
        unit = _unit(p.body)
        assert 1 <= p.splits <= QM.MAX_SPLITS
        assert p.k_per_split >= unit and p.k_per_split % unit == 0
        ranges = [range(s * p.k_per_split, min((s + 1) * p.k_per_split, K))
                  for s in range(p.splits)]
        assert [k for r in ranges for k in r] == list(range(K))
        assert all(len(r) > 0 for r in ranges)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_and_scratch_follow_from_the_plan(dtype):
    for M, K, N in itertools.product(MS, KS, NS):
        p = QM.qmm_plan(M, K, N, dtype, SM)
        target = QM.BLOCKS_PER_SM[p.body] * SM
        k_tiles = -(-K // _unit(p.body))
        want = min(k_tiles, -(-target // p.tiles), QM.MAX_SPLITS)
        assert p.splits <= max(want, 1) and 2 * p.splits > want
        if p.tiles >= target or k_tiles <= 1:
            assert p.splits == 1              # the grid fills the card
        if p.splits == 1:
            assert p.scratch_floats == 0
        elif p.body == "simt":
            assert p.scratch_floats == p.splits * M * N
        else:
            rows = QM.MMA_TILE_ROWS[p.body]
            assert p.tiles == -(-N // QM.MMA_COLS) * -(-M // rows)
            assert p.scratch_floats == p.tiles * p.splits * rows * QM.MMA_COLS


def test_qwen3_shapes():
    bf16 = torch.bfloat16
    # the tied head at decode fills the card: 1,187 column tiles, no split
    head = QM.qmm_plan(8, 2560, 151936, bf16, SM)
    assert (head.body, head.splits, head.tiles) == ("mma_decode", 1, 1187)
    # the k / v projections (N = 1024): 8 tiles, K cut into 14 splits
    kv = QM.qmm_plan(8, 2560, 1024, bf16, SM)
    assert (kv.body, kv.splits, kv.k_per_split) == ("mma_decode", 14, 192)
    # a 256-token prefill stream: 4 x 76 tiles fill the card
    assert QM.qmm_plan(256, 2560, 9728, bf16, SM)[:2] == ("mma_tiled", 1)
    # a verify stream of 8 slots x 5 tokens: 40 rows, split
    verify = QM.qmm_plan(40, 2560, 4096, bf16, SM)
    assert (verify.body, verify.splits) == ("mma_tiled", 8)
    # fp32 keeps the CUDA-core plan of its 256-row K chunks
    assert QM.qmm_plan(8, 2560, 4096, torch.float32, SM)[:3] == (
        "simt", 5, 512)


def test_empty_k_is_one_split():
    p = QM.qmm_plan(4, 0, 100, torch.bfloat16, SM)
    assert p.splits == 1 and p.k_per_split == QM.MMA_K_TILE


def test_plan_rejects_other_dtypes():
    with pytest.raises(ValueError, match="fp32, fp16 or bf16"):
        QM.qmm_plan(8, 64, 64, torch.float64, SM)
