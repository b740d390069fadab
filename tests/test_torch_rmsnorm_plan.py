"""The launch plan of ``fused_rmsnorm``, on the CPU.

``rmsnorm.rmsnorm_plan`` picks the body from the row width and x's
alignment: whole 16-byte vectors from an aligned x go to the register body
(``rows``) while a row fits its warps' registers; everything else (wider
rows included) goes to the element-wise ``scalar`` body, which reads x
again from L2.  The kernels run only on the card
(``tests/test_torch_cuda.py``); these are the host-side rules the C
launcher checks: a row fits the warps and vectors the plan gives it, the
fewest warps are used, and the grid is bounded.
"""
import itertools

import pytest

from repro_torch.kernels import rmsnorm as RN

SM = 132   # an H100 SXM's SMs

DS = [1, 7, 100, 128, 768, 2560, 4096, 8192, 9000, 16384, 20000, 65536]
ROWS = [0, 1, 3, 4096, 4099, 100000]
SIZES = [2, 4]


def _nvec(D, itemsize):
    return D * itemsize // RN.VEC_BYTES


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("itemsize", SIZES)
def test_unaligned_or_partial_vectors_take_the_scalar_body(D, itemsize):
    for rows in ROWS:
        plan = RN.rmsnorm_plan(rows, D, itemsize, False, SM)
        assert plan == RN.RmsPlan("scalar", 0, 0, rows)
        # aligned: whole vectors within the rows body's registers take it
        aligned = RN.rmsnorm_plan(rows, D, itemsize, True, SM)
        fits = (D * itemsize % RN.VEC_BYTES == 0 and _nvec(D, itemsize)
                <= 32 * max(RN.ROW_WARPS) * max(RN.LANE_VECS))
        assert (aligned.body == "rows") == fits
        if not fits:
            assert aligned == RN.RmsPlan("scalar", 0, 0, rows)


@pytest.mark.parametrize("D", [d for d in DS if d % 8 == 0])
@pytest.mark.parametrize("itemsize", SIZES)
def test_rows_fit_the_warps_and_vectors_the_plan_gives(D, itemsize):
    nvec = _nvec(D, itemsize)
    plan = RN.rmsnorm_plan(4096, D, itemsize, True, SM)
    fits = [w for w in RN.ROW_WARPS
            if -(-nvec // (32 * w)) <= max(RN.LANE_VECS)]
    if not fits:
        assert plan == RN.RmsPlan("scalar", 0, 0, 4096)
        return
    assert plan.body == "rows"
    assert plan.warps_per_row == fits[0]            # the fewest warps
    assert plan.lane_vecs in RN.LANE_VECS
    per_lane = -(-nvec // (32 * plan.warps_per_row))
    assert per_lane <= plan.lane_vecs
    assert plan.lane_vecs == min(n for n in RN.LANE_VECS if n >= per_lane)


@pytest.mark.parametrize("rows", ROWS)
def test_grid_is_bounded_and_covers_the_rows(rows):
    for D, itemsize in itertools.product(DS, SIZES):
        plan = RN.rmsnorm_plan(rows, D, itemsize, True, SM)
        if plan.body == "scalar":
            assert plan.blocks == rows                 # a block per row
            continue
        assert plan.blocks <= RN.BLOCKS_PER_SM * SM
        per_block = RN.BLOCK_WARPS // plan.warps_per_row
        # every row is reached by the grid stride; no block is idle
        assert plan.blocks == min(-(-rows // per_block),
                                  RN.BLOCKS_PER_SM * SM)


def test_smoke_shapes():
    # qwen3-4b's width: one warp a row at bf16, two at fp32
    assert RN.rmsnorm_plan(4096, 2560, 2, True, SM) == RN.RmsPlan(
        "rows", 1, 16, 264)
    assert RN.rmsnorm_plan(4096, 2560, 4, True, SM) == RN.RmsPlan(
        "rows", 2, 16, 264)
    # D = 16384: four warps a row at bf16; at fp32 the row is wider than
    # four warps' registers and the scalar body reads x twice
    assert RN.rmsnorm_plan(4099, 16384, 2, True, SM).body == "rows"
    assert RN.rmsnorm_plan(4099, 16384, 2, True, SM).warps_per_row == 4
    assert RN.rmsnorm_plan(4099, 16384, 4, True, SM) == RN.RmsPlan(
        "scalar", 0, 0, 4099)
    # D = 100 at 16-bit types is not whole vectors
    assert RN.rmsnorm_plan(3, 100, 2, True, SM).body == "scalar"
    assert RN.rmsnorm_plan(3, 100, 4, True, SM) == RN.RmsPlan(
        "rows", 1, 4, 1)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        RN.rmsnorm_plan(4, 0, 2, True, SM)
    with pytest.raises(ValueError):
        RN.rmsnorm_plan(4, 16, 8, True, SM)
