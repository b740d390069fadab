"""The launch plan of the packed paged-attention pair, on the CPU.

``decode_attention.packed_plan`` picks the body of
``paged_packed_attention`` / ``_q8`` by q's dtype and, for the tensor-core
body, the warps a block runs (one work row's 8 lanes x the g heads of a kv
head, 16 rows a warp), its row tiles and the split of the page walk.  The
kernel runs only on the card (``tests/test_torch_cuda.py``); these are the
rules it relies on: fp32 never reaches the tensor-core body, every page of
a block-table row lies in exactly one split, the grid of a full serve
stream is not split, and the work table the kernel walks is still the
reference's.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as JDA
from repro_torch.core.engine import packed_width_buckets
from repro_torch.kernels import decode_attention as DA

SM = 132   # an H100 SXM's SMs
HALF = [torch.bfloat16, torch.float16]
NPAGES = [1, 2, 3, 16, 17, 64, 257]
SLOTS = 8


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_fp32_keeps_the_cuda_core_body(g):
    for n_work, Hkv, npages in itertools.product([1, 10, 40], [1, 8, 16],
                                                 NPAGES):
        assert DA.packed_plan(n_work, Hkv, g, npages, torch.float32,
                              SM) == DA.PackedPlan("simt", 1, 1, npages)
        for dtype in HALF:
            assert DA.packed_plan(n_work, Hkv, g, npages, dtype,
                                  SM).body == "mma"


@pytest.mark.parametrize("g,row_tiles", [(1, 1), (2, 1), (4, 1), (8, 1),
                                         (16, 2), (17, 3)])
def test_rows_of_a_block(g, row_tiles):
    # a block takes up to 64 of one work row's 8 lanes x g heads: one row
    # tile up to g = 8 (the kernel runs 16 rows a warp: half of one warp at
    # unimo-text's g = 1, two warps at qwen3-4b's g = 4), more above
    for dtype in HALF:
        plan = DA.packed_plan(40, 8, g, 16, dtype, SM)
        assert plan.row_tiles == row_tiles
        assert (row_tiles - 1) * DA.MMA_ROWS < DA.PACKED_BLOCK_Q * g \
            <= row_tiles * DA.MMA_ROWS


@pytest.mark.parametrize("npages", NPAGES)
def test_splits_cover_every_page_once(npages):
    for n_work, Hkv, g in itertools.product([1, 2, 9, 10, 40], [1, 2, 8],
                                            [1, 4, 16]):
        plan = DA.packed_plan(n_work, Hkv, g, npages, torch.bfloat16, SM)
        pps = plan.pages_per_split
        pages = [p for s in range(plan.splits)
                 for p in range(s * pps, min((s + 1) * pps, npages))]
        assert pages == list(range(npages))
        assert all(s * pps < npages for s in range(plan.splits))
        assert 1 <= plan.splits <= DA.MAX_SPLITS
        assert (plan.splits, pps) == DA.mixed_splits(
            n_work, plan.row_tiles, Hkv, npages, SM)


def test_serve_streams_split_only_when_narrow():
    # the work table of a width-W packed iteration with 8 slots has W / 8
    # + 8 rows; at qwen3-4b's 8 kv heads every width from 72 lanes up
    # gives a block per SM (the timed 256-lane stream: 40 x 8 = 320
    # blocks), and the narrowest widths split the walk in two
    for W in packed_width_buckets(256):
        n_work = W // DA.PACKED_BLOCK_Q + SLOTS
        plan = DA.packed_plan(n_work, 8, 4, 16, torch.bfloat16, SM)
        assert plan.splits == (1 if n_work * 8 >= SM else 2), W
    # unimo-text's 16 kv heads: never split
    for W in packed_width_buckets(256):
        n_work = W // DA.PACKED_BLOCK_Q + SLOTS
        assert DA.packed_plan(n_work, 16, 1, 16, torch.bfloat16,
                              SM).splits == 1


@pytest.mark.parametrize("seg", [[1, 1, 1, 1, 90, 70, 50, 30],
                                 [1] * 8, [256], [7, 9, 16, 1, 33]])
def test_meta_table_is_the_references(seg):
    # the table layout and PACKED_BLOCK_Q mirror the reference's, which
    # the tensor-core body reads as it is (slot, window start and end)
    T = packed_width_buckets(256)[-1]
    lens = np.asarray(seg, np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    slots = np.arange(len(seg), dtype=np.int32)
    n_work = T // DA.PACKED_BLOCK_Q + SLOTS
    ours = DA.packed_meta_table(starts, lens, slots, T, n_work)
    np.testing.assert_array_equal(
        ours, JDA.packed_meta_table(starts, lens, slots, T, n_work))
    assert DA.PACKED_BLOCK_Q == JDA.PACKED_BLOCK_Q == 8
    live = ours[ours[:, 0] >= 0]
    assert (live[:, 3] - live[:, 2] <= DA.PACKED_BLOCK_Q).all()
    assert (live[:, 3] > live[:, 2]).all()
