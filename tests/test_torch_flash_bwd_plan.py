"""The launch plan of the flash-attention backward, on the CPU.

``flash_attention.bwd_plan`` picks the body of ``flash_attention_bwd`` by
q's dtype ("mma" at bf16 / fp16, "split" at fp32: the same kernels over
fp32 tiles, every operand cut into bf16 parts) and, for both, the keys of
a dK/dV block by head-dim bucket, the split of a kv head's query heads
over dK/dV blocks and the shared memory of each block; the launcher sizes
its grids and blocks from the plan and refuses one its kernels were not
built for.  The kernels run only on the card (``tests/test_torch_cuda.py``,
whose cases reach every split through shapes whose own plan picks it);
these are the rules the plan keeps: fp32 takes the split body and only
fp32 does, every block fits in the card's shared memory, the launcher's
grids give every key and every (query, head) row exactly one block, and a
split divides the g heads, so that the splits' partials, added in split
order, cover each head once.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import flash_attention as FA

SM = 132   # an H100 SXM's SMs
HALF = [torch.bfloat16, torch.float16]
DTYPES = HALF + [torch.float32]
DIMS = list(range(8, FA.MAX_HEAD_DIM + 1, 8))
# (B, S, Hq, Hkv, D, Dv): the train shapes (unimo-text, qwen3-4b's
# microbatch, gemma2-2b, MLA's naive form) and small or ragged ones
SHAPES = [(8, 128, 16, 16, 64, 64), (4, 128, 32, 8, 128, 128),
          (4, 256, 8, 4, 256, 256), (1, 128, 128, 128, 192, 128),
          (2, 77, 14, 2, 64, 64), (3, 1, 4, 2, 96, 96),
          (1, 128, 32, 8, 128, 128), (2, 45, 8, 2, 32, 32)]


@pytest.mark.parametrize("D,Dv", [(64, 64), (96, 96), (128, 128),
                                  (192, 128), (256, 256), (8, 8)])
def test_fp32_takes_the_split_body(D, Dv):
    # fp32 takes the split body, with the tensor-core geometry (its keys
    # a dK/dV block, rows a dQ block and head splits) and its own shared
    # memory; bf16 / fp16 the mma body
    for B, S, Hkv, g in itertools.product([1, 4], [1, 77, 256], [1, 8],
                                          [1, 4, 7]):
        fp32 = FA.bwd_plan(B, S, S, Hkv * g, Hkv, D, Dv, torch.float32, SM)
        assert fp32.body == "split"
        assert (fp32.smem_dq, fp32.smem_dkdv) == FA.bwd_smem_bytes(D, Dv,
                                                                   True)
        for dtype in HALF:
            plan = FA.bwd_plan(B, S, S, Hkv * g, Hkv, D, Dv, dtype, SM)
            assert plan.body == "mma"
            assert (plan.smem_dq, plan.smem_dkdv) == FA.bwd_smem_bytes(D,
                                                                       Dv)
            assert fp32[1:4] == plan[1:4]
        assert fp32.dq_rows == FA.BWD_DQ_ROWS
        assert fp32.block_keys == FA.bwd_block_keys(FA.bwd_dmax(D, Dv))


@pytest.mark.parametrize("D", DIMS)
def test_shared_memory_fits_every_bucket(D):
    # every (D, Dv) pair up to 256 (MLA's 192 / 128 among them), for both
    # bodies: the split body's fp32 rows take twice the bytes, so its
    # rings are shallower in the 256 bucket
    for Dv in DIMS:
        for fp32 in (False, True):
            dq, dkdv = FA.bwd_smem_bytes(D, Dv, fp32)
            assert 0 < dq <= FA.MAX_SMEM and 0 < dkdv <= FA.MAX_SMEM, \
                (D, Dv, fp32)
    for dtype in DTYPES:
        plan = FA.bwd_plan(1, 128, 128, 128, 128, 192, 128, dtype, SM)
        assert (plan.smem_dq, plan.smem_dkdv) == FA.bwd_smem_bytes(
            192, 128, dtype == torch.float32)


@pytest.mark.parametrize("D,Dv,keys", [(64, 64, 64), (96, 96, 64),
                                       (128, 128, 64), (136, 64, 32),
                                       (192, 128, 32), (256, 256, 32)])
def test_block_keys_by_bucket(D, Dv, keys):
    # 16 keys a warp, 16 a pair of warps above a head dim of 128: dK and dV
    # of 16 keys stay within 128 fp32 accumulators a lane
    plan = FA.bwd_plan(4, 128, 128, 32, 8, D, Dv, torch.bfloat16, SM)
    assert plan.block_keys == keys
    warps_a_key_group = FA.BWD_WARPS * 16 // keys
    assert FA.bwd_dmax(D, Dv) // warps_a_key_group <= 128


def _grids(plan, B, Sq, Sk, Hkv, g):
    """The launcher's grids for ``plan``, as
    ``csrc/flash_attention_bwd.cu`` sizes them (x, y, z), for either body:
    dQ blocks over (query, head) rows of a kv head, dK/dV blocks over key
    tiles x head splits."""
    return ((-(-Sq * g // plan.dq_rows), Hkv, B),
            (-(-Sk // plan.block_keys) * plan.head_splits, Hkv, B))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv", SHAPES)
def test_every_key_and_row_in_one_block(B, S, Hq, Hkv, D, Dv):
    # a block of the grid owns plan-sized runs of keys (and rows); the
    # runs of the grid's blocks tile them with the last one short and none
    # empty
    g = Hq // Hkv
    for dtype, Sq in itertools.product(DTYPES, [S, 1, 3]):
        plan = FA.bwd_plan(B, Sq, S, Hq, Hkv, D, Dv, dtype, SM)
        (dq_x, dq_y, _), (kv_x, kv_y, _) = _grids(plan, B, Sq, S, Hkv, g)
        rows = Sq * g
        assert (dq_x - 1) * plan.dq_rows < rows <= dq_x * plan.dq_rows
        tiles = kv_x // plan.head_splits
        assert kv_x == tiles * plan.head_splits
        assert (tiles - 1) * plan.block_keys < S <= tiles * plan.block_keys
        assert dq_y * g == Hq
        assert kv_y == Hkv


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv", SHAPES)
def test_head_splits_fill_the_card_and_sum_each_head_once(B, S, Hq, Hkv, D,
                                                          Dv):
    g = Hq // Hkv
    for dtype in DTYPES:
        plan = FA.bwd_plan(B, S, S, Hq, Hkv, D, Dv, dtype, SM)
        blocks = -(-S // plan.block_keys) * Hkv * B
        if blocks >= SM:
            assert plan.head_splits == 1
        else:
            # the fewest splits that fill one wave, else every head its own
            fills = [d for d in range(1, g + 1)
                     if g % d == 0 and blocks * d >= SM]
            assert plan.head_splits == (fills[0] if fills else g)
        # split s takes heads [s g / splits, (s + 1) g / splits) and the
        # sum kernel adds splits 0, 1, ... of each key: each head once
        assert g % plan.head_splits == 0
        gs = g // plan.head_splits
        order = [h for s in range(plan.head_splits)
                 for h in range(s * gs, (s + 1) * gs)]
        assert order == list(range(g))


def test_train_shapes_split_as_planned():
    # qwen3-4b's microbatch: 2 key tiles x 8 kv heads x 4 rows = 64 blocks,
    # its g = 4 heads split four ways; gemma2-2b's D 256: 8 x 4 x 4 = 128
    # blocks, split two ways; unimo-text and MLA fill the card unsplit
    splits = [FA.bwd_plan(B, S, S, Hq, Hkv, D, Dv, torch.bfloat16,
                          SM).head_splits
              for B, S, Hq, Hkv, D, Dv in SHAPES[:4]]
    assert splits == [1, 4, 2, 1]
