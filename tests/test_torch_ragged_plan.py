"""The grouped product's host-side plan (``repro_torch.kernels.
ragged_matmul``), which the wrappers call before every launch: the body
chosen by dtype, shape and alignment, and the grids each body is launched
with.  CPU only: these are host functions; the kernels themselves are
checked on the card (``tests/test_torch_cuda.py -k ragged``).

Every MoE width of the eleven archs (full and reduced; the forward reads
(d, f) and (f, d) stacks, dRows and dW the same shapes) runs on the wgmma
+ TMA body at bf16 / fp16, fp32 on CUDA cores, and a K or N that is not a
multiple of 8 (TMA's 16-byte row strides), an empty dimension or an
unaligned operand on mma.sync.  The static grid bound covers the most row
tiles any group sizes summing to at most R can make (a property test).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.configs.registry import get_config, get_reduced, list_archs
from repro_torch.kernels import ragged_matmul as RM

MOE_ARCHS = [a for a in list_archs() if get_config(a).moe is not None]


def _moe_shapes(cfg):
    """(K, N) of each expert stack a grouped product reads: wi / wg (d,
    f) and wo (f, d)."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    return [(d, f), (f, d)]


def test_the_moe_archs_are_found():
    assert sorted(MOE_ARCHS) == ["deepseek-v3-671b", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_every_moe_width_takes_the_wgmma_body(arch, reduced, dtype):
    cfg = (get_reduced if reduced else get_config)(arch)
    for K, N in _moe_shapes(cfg):
        assert RM.ragged_body(dtype, K, N) == "wgmma_tma", (K, N)
        assert RM.ragged_body(dtype, K, N, aligned=False) == "mma_sync"


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_fp32_takes_the_cuda_core_body(arch, reduced):
    cfg = (get_reduced if reduced else get_config)(arch)
    for K, N in _moe_shapes(cfg) + [(100, 70), (8, 8)]:
        assert RM.ragged_body(torch.float32, K, N) == "cuda_cores"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("K,N,body", [
    (100, 70, "mma_sync"), (96, 70, "mma_sync"), (100, 72, "mma_sync"),
    (0, 64, "mma_sync"), (64, 0, "mma_sync"), (4, 8, "mma_sync"),
    (96, 72, "wgmma_tma"), (200, 136, "wgmma_tma"), (8, 8, "wgmma_tma"),
    (64, 128, "wgmma_tma")])
def test_body_by_shape(dtype, K, N, body):
    assert RM.ragged_body(dtype, K, N) == body


def test_every_body_has_a_launcher_code():
    assert set(RM.BODIES) == {"cuda_cores", "mma_sync", "wgmma_tma"}
    assert sorted(RM.BODIES.values()) == [0, 1, 2]


def _tiles(sizes, R, rows):
    """Row tiles of ``rows`` rows the kernels make for these sizes: each
    group's (clamped to the R rows there are, in order), then those of
    the rows past the last group."""
    off, n = 0, 0
    for s in sizes:
        s = min(max(int(s), 0), R - off)
        n += -(-s // rows)
        off += s
    return n + -(-(R - off) // rows)


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_static_bound_covers_every_split_of_the_rows(data):
    R = data.draw(st.integers(1, 3000))
    E = data.draw(st.integers(1, 300))
    total = data.draw(st.integers(0, R))
    cuts = sorted(data.draw(st.lists(st.integers(0, total), min_size=E - 1,
                                     max_size=E - 1)))
    sizes = np.diff([0] + cuts + [total])
    for rows in (RM.MMA_TILE[0], RM.WGMMA_TILE[0]):
        assert _tiles(sizes, R, rows) <= RM.tiles_bound(R, E, rows)


@pytest.mark.parametrize("rows", [RM.MMA_TILE[0], RM.WGMMA_TILE[0]])
def test_static_bound_covers_one_row_a_group(rows):
    """The most partial tiles: one row in each of E groups, the rest of the
    rows past them, for E at and around the rows of a tile."""
    for E in (1, rows - 1, rows, rows + 1, 128, 256):
        for R in (E, E + 1, E + rows - 1, E + 3 * rows + 5):
            assert _tiles([1] * E, R, rows) <= RM.tiles_bound(R, E, rows)


@pytest.mark.parametrize("R,E,Nout", [(64, 128, 1536), (4992, 256, 2048),
                                      (65536, 128, 1536), (1, 1, 8),
                                      (4096, 128, 4096)])
def test_grids(R, E, Nout):
    sms = 132
    gx, gy = RM.ragged_grid("wgmma_tma", R, E, Nout, sms)
    items = RM.tiles_bound(R, E, 64) * -(-Nout // 128)
    assert gy == 1 and gx == min(items, RM.BLOCKS_PER_SM * sms) and gx >= 1
    for body in ("mma_sync", "cuda_cores"):
        assert RM.ragged_grid(body, R, E, Nout, sms) == (
            RM.tiles_bound(R, E, 16), -(-Nout // 64))
    K, N = Nout, 72
    gx, gy, gz = RM.ragged_dw_grid("wgmma_tma", E, K, N, sms)
    assert (gy, gz) == (1, 1) and gx == min(
        E * -(-K // 64) * -(-N // 128), RM.BLOCKS_PER_SM * sms)
    assert RM.ragged_dw_grid("mma_sync", E, K, N, sms) == (
        -(-N // 64), -(-K // 64), E)


def test_wrappers_refuse_cpu_tensors():
    """The wrappers plan for CUDA tensors only; CPU tensors go to the
    plain version through ``ops``."""
    rows = torch.zeros(4, 8, dtype=torch.bfloat16)
    w = torch.zeros(2, 8, 8, dtype=torch.bfloat16)
    sizes = torch.tensor([1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        RM.ragged_matmul(rows, w, sizes)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        RM.ragged_matmul_bwd(rows, w, sizes, torch.zeros(4, 8))
