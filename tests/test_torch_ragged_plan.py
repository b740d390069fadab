"""The grouped product's host-side plan (``repro_torch.kernels.
ragged_matmul``), which the wrappers call before every launch: the body
chosen by dtype, shape and alignment, and the grids each body is launched
with.  CPU only: these are host functions; the kernels themselves are
checked on the card (``tests/test_torch_cuda.py -k ragged``).

Every MoE width of the eleven archs (full and reduced; the forward reads
(d, f) and (f, d) stacks, dRows and dW the same shapes) runs on the wgmma
+ TMA body at bf16, fp16 and fp32; a K or N that is not a multiple of 16
bytes' elements (TMA's row strides: 8 at 16 bits, 4 at fp32), an empty
dimension or an unaligned operand on mma.sync (16 bits) or CUDA cores
(fp32).  The static grid bound covers the most row tiles any group sizes
summing to at most R can make (a property test).  The fp32 wgmma body's
arithmetic (three bf16 parts an operand, the part pairs i + j < 3, the
leading pair's sums apart, a fresh sum a 64-deep stage) is emulated in
plain torch against the product in fp64.
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
    """fp32 at every MoE width takes the wgmma body (bf16 parts); the
    CUDA-core body keeps the shapes TMA cannot describe and unaligned
    operands."""
    cfg = (get_reduced if reduced else get_config)(arch)
    for K, N in _moe_shapes(cfg) + [(8, 8), (4, 12)]:
        assert RM.ragged_body(torch.float32, K, N) == "wgmma_tma", (K, N)
        assert RM.ragged_body(torch.float32, K, N,
                              aligned=False) == "cuda_cores"
    for K, N in [(100, 70), (6, 8), (8, 2), (0, 64)]:
        assert RM.ragged_body(torch.float32, K, N) == "cuda_cores"


@pytest.mark.parametrize("K,N,body", [
    (100, 70, "cuda_cores"), (102, 72, "cuda_cores"), (0, 64, "cuda_cores"),
    (64, 0, "cuda_cores"), (2, 8, "cuda_cores"), (4, 4, "wgmma_tma"),
    (100, 68, "wgmma_tma"), (96, 72, "wgmma_tma"), (200, 136, "wgmma_tma"),
    (64, 128, "wgmma_tma")])
def test_fp32_body_by_shape(K, N, body):
    assert RM.ragged_body(torch.float32, K, N) == body


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("R,E,Nout", [(64, 128, 1536), (4992, 256, 2048),
                                      (65536, 128, 1536), (1, 1, 8),
                                      (4096, 128, 4096)])
def test_grids(R, E, Nout, dtype):
    """The wgmma body's persistent grid: at most BLOCKS_PER_SM[dtype] an
    SM (two at 16 bits; one at fp32, whose raw stages and bf16 planes
    take 170 KB of shared memory) and one a work item."""
    sms = 132
    assert RM.BLOCKS_PER_SM[dtype] == (1 if dtype == torch.float32 else 2)
    gx, gy = RM.ragged_grid("wgmma_tma", R, E, Nout, sms, dtype)
    items = RM.tiles_bound(R, E, 64) * -(-Nout // 128)
    assert gy == 1 and gx == min(items, RM.BLOCKS_PER_SM[dtype] * sms) \
        and gx >= 1
    for body in ("mma_sync", "cuda_cores"):
        assert RM.ragged_grid(body, R, E, Nout, sms, dtype) == (
            RM.tiles_bound(R, E, 16), -(-Nout // 64))
    K, N = Nout, 72
    gx, gy, gz = RM.ragged_dw_grid("wgmma_tma", E, K, N, sms, dtype)
    assert (gy, gz) == (1, 1) and gx == min(
        E * -(-K // 64) * -(-N // 128), RM.BLOCKS_PER_SM[dtype] * sms)
    assert RM.ragged_dw_grid("mma_sync", E, K, N, sms, dtype) == (
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


def _parts(x, n):
    out, r = [], x
    for _ in range(n):
        p = r.to(torch.bfloat16).to(x.dtype)
        out.append(p)
        r = r - p
    return out


def split_grouped_product(rows, w, sizes, parts=3):
    """The fp32 wgmma body's arithmetic in plain torch: per group, per
    64-deep stage of K, each operand cut into ``parts`` bf16 parts, the
    part pairs i + j < 3 multiplied (each product exact in fp32), the
    leading pair's stage sum and the other pairs' kept apart, and both
    added to the running sums in fp32."""
    R, N = rows.shape[0], w.shape[2]
    out = torch.zeros(R, N)
    start = 0
    for e, n in enumerate(sizes.tolist()):
        a, b = rows[start:start + n], w[e]
        acc = torch.zeros(n, N)
        for k0 in range(0, a.shape[1], 64):
            ap = _parts(a[:, k0:k0 + 64], parts)
            bp = _parts(b[k0:k0 + 64], parts)
            lo = torch.zeros(n, N)
            for i, x in enumerate(ap):
                for j, y in enumerate(bp):
                    if 0 < i + j < 3:
                        lo += x @ y
            acc += ap[0] @ bp[0] + lo
        out[start:start + n] = acc
        start += n
    return out


def _fp64_err(got, truth):
    return (got.double() - truth).abs().max().item() / \
        truth.abs().max().item()


@pytest.mark.parametrize("sizes,K,N", [([5, 0, 33, 2], 256, 64),
                                       ([1] * 8, 4096, 16),
                                       ([64, 3], 1536, 32)])
def test_fp32_parts_hold_the_fp64_gate(sizes, K, N):
    """Three bf16 parts an operand keep the grouped product within the
    card's fp64 gate: four times the plain fp32 product's error against
    fp64, or 1e-6 of the output's scale; one part (bf16 operands) misses
    it by orders of magnitude."""
    rng = np.random.default_rng(K + N)
    R = sum(sizes)
    rows = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(len(sizes), K, N))
                          / K ** 0.5).astype(np.float32))
    sz = torch.tensor(sizes, dtype=torch.int32)
    truth = RM.ragged_matmul_ref(rows.double(), w.double(), sz)
    plain = _fp64_err(RM.ragged_matmul_ref(rows, w, sz), truth)
    got = _fp64_err(split_grouped_product(rows, w, sz), truth)
    assert got <= max(4 * plain, 1e-6), (got, plain)
    one = _fp64_err(split_grouped_product(rows, w, sz, parts=1), truth)
    assert one > 100 * max(4 * plain, 1e-6), (one, plain)
