"""The split-K plan of the tensor-core mixed kernel, on the CPU.

``decode_attention.mixed_splits`` cuts each (slot, kv head, row tile)'s
page walk into runs of consecutive pages when the grid alone would not
cover the card's SMs; ``mixed_scratch_floats`` sizes the scratch the
splits write their partials to.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); these are the host-side rules it relies
on: every page in exactly one split, no empty split, one split when the
grid already fills the card.
"""
import itertools

import pytest

from repro_torch.kernels import decode_attention as DA

SM = 132   # an H100 SXM's SMs

NPAGES = [0, 1, 2, 5, 16, 17, 64]
GRIDS = list(itertools.product([1, 3, 8], [1, 2, 16], [1, 8, 16]))


def _ranges(splits, pps, npages):
    return [range(s * pps, min((s + 1) * pps, npages))
            for s in range(splits)]


@pytest.mark.parametrize("npages", NPAGES)
def test_splits_cover_every_page_once_and_none_is_empty(npages):
    for B, tiles, Hkv in GRIDS:
        splits, pps = DA.mixed_splits(B, tiles, Hkv, npages, SM)
        assert splits >= 1 and pps >= 1
        ranges = _ranges(splits, pps, npages)
        assert [p for r in ranges for p in r] == list(range(npages))
        if npages:
            assert all(len(r) > 0 for r in ranges)


@pytest.mark.parametrize("npages", NPAGES)
def test_split_grid_covers_the_card_where_pages_allow(npages):
    for B, tiles, Hkv in GRIDS:
        blocks = B * tiles * Hkv
        splits, _ = DA.mixed_splits(B, tiles, Hkv, npages, SM)
        want = min(max(npages, 1), -(-SM // blocks), DA.MAX_SPLITS)
        assert 2 * splits > want and splits <= want
        assert splits <= DA.MAX_SPLITS
        if blocks >= SM or npages <= 1:
            assert splits == 1


def test_splits_are_capped():
    # one slot, one kv head: 132 blocks wanted, at most MAX_SPLITS made
    assert DA.mixed_splits(1, 1, 1, 64, SM) == (16, 4)
    assert DA.mixed_splits(1, 1, 1, 33, SM) == (11, 3)


def test_one_split_when_the_grid_fills_the_card():
    # (8, 256) prefill chunks at qwen3-4b's heads: 8 slots x 16 row tiles
    # x 8 kv heads = 1,024 blocks
    assert DA.mixed_splits(8, 16, 8, 16, SM) == (1, 16)
    assert DA.mixed_splits(1, 1, SM, 40, SM) == (1, 40)
    assert DA.mixed_splits(4, 1, 8, 1, SM) == (1, 1)


def test_verify_window_shapes():
    # qwen3-4b verify: 8 slots x 5 lanes x 4 heads = 20 rows (one tile),
    # 8 kv heads: 64 blocks, so each 16-page walk is split
    tiles = DA.mixed_row_tiles(5, 4)
    assert tiles == 1
    assert DA.mixed_splits(8, tiles, 8, 16, SM) == (3, 6)
    # unimo-text verify (g = 1): 5 rows, 16 kv heads: 128 blocks
    assert DA.mixed_splits(8, DA.mixed_row_tiles(5, 1), 16, 16, SM) == (
        2, 8)
    assert DA.mixed_row_tiles(256, 4) == 16
    assert DA.mixed_row_tiles(65, 1) == 2
    assert DA.mixed_row_tiles(64, 1) == 1


@pytest.mark.parametrize("Dv", [32, 40, 128, 256])
def test_scratch_size_follows_from_the_split(Dv):
    for (B, tiles, Hkv), npages in itertools.product(GRIDS, NPAGES):
        splits, _ = DA.mixed_splits(B, tiles, Hkv, npages, SM)
        n = DA.mixed_scratch_floats(B, tiles, Hkv, splits, Dv)
        if splits == 1:
            assert n == 0
            continue
        # the kernel's layout: per (group, split) MMA_ROWS rows of Dv
        # accumulators, then per (group, split) MMA_ROWS (m, l) pairs
        parts = B * tiles * Hkv * splits * DA.MMA_ROWS
        assert n == parts * Dv + parts * 2


def test_decode_split_plan_at_one_lane():
    # the decode kernel's rows are one token's g heads of a kv head: one
    # row tile at every smoke shape
    assert DA.mixed_row_tiles(1, 4) == DA.mixed_row_tiles(1, 1) == 1
    assert DA.mixed_row_tiles(1, 64) == 1 and DA.mixed_row_tiles(1, 65) == 2
    # qwen3-4b decode: 8 slots x 8 kv heads = 64 blocks over 16 pages
    assert DA.mixed_splits(8, DA.mixed_row_tiles(1, 4), 8, 16, SM) == (3, 6)
    # unimo-text decode: 8 slots x 16 kv heads = 128 blocks
    assert DA.mixed_splits(8, DA.mixed_row_tiles(1, 1), 16, 16, SM) == (
        2, 8)
    # a full batch of 132 slots already fills the card
    assert DA.mixed_splits(132, 1, 8, 16, SM) == (1, 16)


@pytest.mark.parametrize("g", [1, 4, 8])
def test_decode_scratch_follows_from_the_split(g):
    for B, Hkv, npages in itertools.product([1, 3, 8], [1, 8, 16], NPAGES):
        tiles = DA.mixed_row_tiles(1, g)
        splits, pps = DA.mixed_splits(B, tiles, Hkv, npages, SM)
        assert [p for r in _ranges(splits, pps, npages) for p in r] == list(
            range(npages))
        n = DA.mixed_scratch_floats(B, tiles, Hkv, splits, 128)
        assert n == (0 if splits == 1
                     else B * Hkv * splits * DA.MMA_ROWS * 130)
