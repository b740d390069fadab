"""The launch plan of the dense ``decode_attention``, on the CPU.

``decode_attention.dense_decode_plan`` picks the body by q's dtype and the
inputs' alignment and, for the tensor-core body, cuts the keys of each
(row, kv head, group of 8 query heads) into splits only where the grid
alone leaves at least half the card idle; ``dense_scratch_floats`` sizes
the scratch the splits write their partials to.  The kernel runs only on
the card (``tests/test_torch_cuda.py``); these are the host-side rules it
relies on: fp32 never reaches the tensor-core body, every key lies in
exactly one split and none is empty, splits are whole 32-key tiles, and a
split grid fits in one wave of the card.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import decode_attention as DA

SM = 132   # an H100 SXM's SMs

SKS = [1, 31, 32, 33, 256, 300, 511, 512, 4096, 40000]
GRIDS = list(itertools.product([1, 3, 8, 64], [1, 2, 8], [1, 4, 16, 40]))
HALF = [torch.bfloat16, torch.float16]


def _ranges(plan, Sk):
    kps = plan.keys_per_split
    return [range(s * kps, min((s + 1) * kps, Sk))
            for s in range(plan.splits)]


@pytest.mark.parametrize("Sk", SKS)
def test_fp32_and_unaligned_inputs_take_the_cuda_core_body(Sk):
    for (B, Hkv, g), dtype in itertools.product(GRIDS, HALF):
        assert DA.dense_decode_plan(B, Hkv, g, Sk, torch.float32, True,
                                    SM) == DA.DensePlan(
            "simt", -(-g // DA.DENSE_ROWS), 1, Sk)
        plan = DA.dense_decode_plan(B, Hkv, g, Sk, dtype, False, SM)
        assert (plan.body, plan.splits) == ("simt", 1)
        assert DA.dense_decode_plan(B, Hkv, g, Sk, dtype, True,
                                    SM).body == "mma"


@pytest.mark.parametrize("Sk", SKS)
def test_splits_cover_every_key_once_in_whole_tiles(Sk):
    for B, Hkv, g in GRIDS:
        plan = DA.dense_decode_plan(B, Hkv, g, Sk, torch.bfloat16, True, SM)
        assert 1 <= plan.splits <= DA.DENSE_MAX_SPLITS
        assert plan.keys_per_split % DA.DENSE_KEYS == 0
        ranges = _ranges(plan, Sk)
        assert [j for r in ranges for j in r] == list(range(Sk))
        assert all(len(r) > 0 for r in ranges)
        assert plan.row_tiles == -(-g // DA.DENSE_ROWS)


@pytest.mark.parametrize("Sk", SKS)
def test_a_split_grid_fits_one_wave_and_splits_are_long(Sk):
    for B, Hkv, g in GRIDS:
        plan = DA.dense_decode_plan(B, Hkv, g, Sk, torch.float16, True, SM)
        blocks = B * Hkv * plan.row_tiles
        if plan.splits == 1:
            continue
        assert blocks * plan.splits <= SM
        # every split but the last walks at least DENSE_MIN_SPLIT_TILES
        assert plan.keys_per_split >= DA.DENSE_MIN_SPLIT_TILES * DA.DENSE_KEYS


@pytest.mark.parametrize("B,Hkv,g", GRIDS)
def test_one_split_where_the_grid_fills_half_the_card_or_keys_are_few(
        B, Hkv, g):
    blocks = B * Hkv * -(-g // DA.DENSE_ROWS)
    for Sk in SKS:
        plan = DA.dense_decode_plan(B, Hkv, g, Sk, torch.bfloat16, True, SM)
        tiles = -(-Sk // DA.DENSE_KEYS)
        if 2 * blocks > SM or tiles < 2 * DA.DENSE_MIN_SPLIT_TILES:
            assert plan.splits == 1
            assert plan.keys_per_split == tiles * DA.DENSE_KEYS


def test_qwen3_4b_heads():
    # 8 rows x 8 kv heads x one group of 4 heads: 64 blocks; 256 keys stay
    # in one split, 4096 take two (128 blocks, one wave)
    assert DA.dense_decode_plan(8, 8, 4, 256, torch.bfloat16, True, SM) == \
        DA.DensePlan("mma", 1, 1, 256)
    assert DA.dense_decode_plan(8, 8, 4, 4096, torch.bfloat16, True, SM) == \
        DA.DensePlan("mma", 1, 2, 2048)
    # one row: 8 blocks, 4096 keys in eight splits of 512
    assert DA.dense_decode_plan(1, 8, 4, 4096, torch.bfloat16, True, SM) == \
        DA.DensePlan("mma", 1, 8, 512)
    # a full batch fills the card: no split
    assert DA.dense_decode_plan(64, 8, 4, 4096, torch.bfloat16, True,
                                SM).splits == 1


def test_many_heads_take_several_row_tiles():
    # 64 heads of one kv head: 8 row tiles, 3125 tiles of keys in 16
    # splits of 196
    assert DA.dense_decode_plan(1, 1, 64, 100000, torch.float16, True,
                                SM) == DA.DensePlan("mma", 8, 16, 6272)
    assert DA.dense_decode_plan(2, 2, 17, 33, torch.float16, True,
                                SM).row_tiles == 3
    assert DA.dense_decode_plan(2, 2, 8, 33, torch.float16, True,
                                SM).row_tiles == 1


@pytest.mark.parametrize("Dv", [8, 40, 128, 256])
def test_scratch_size_follows_from_the_split(Dv):
    for (B, Hkv, g), Sk in itertools.product(GRIDS, SKS):
        plan = DA.dense_decode_plan(B, Hkv, g, Sk, torch.bfloat16, True, SM)
        n = DA.dense_scratch_floats(B, Hkv, plan, Dv)
        if plan.splits == 1:
            assert n == 0
            continue
        # the kernel's layout: per (group, split) DENSE_ROWS rows of Dv
        # accumulators, then per (group, split) DENSE_ROWS (m, l) pairs
        parts = B * Hkv * plan.row_tiles * plan.splits * DA.DENSE_ROWS
        assert n == parts * Dv + parts * 2
