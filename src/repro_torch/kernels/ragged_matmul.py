"""Grouped (ragged) matrix product on the card: the wrapper around the
hand-written CUDA kernels in ``repro_torch/csrc/ragged_matmul.cu`` (built
for ``sm_90a`` by :mod:`repro_torch.kernels.build`), with its plain
PyTorch version beside it.

:func:`ragged_matmul` computes what ``jax.lax.ragged_dot`` does in the
reference's ``moe_apply_ragged`` (``REPRO_PERF_OPTS=moe_ragged``; XLA's
product, no Pallas kernel): rows (R, K) sorted by group, group e owning
the ``sizes[e]`` rows after those of the groups before it, each times its
own w[e] (K, N); rows past the last group come out zero.  The kernels find
each work item's group on the device, so nothing is read back to the host,
and an expert that received no rows is never read.
:func:`ragged_matmul_bwd` gives the gradients of rows (the forward kernel
reading w transposed) and of w (a kernel over w's tiles that sums each
group's rows in order).

Bodies, chosen here on the host by dtype, shape and alignment
(:func:`ragged_body`), each raising on failure:

* ``wgmma_tma`` (K and N positive multiples of 16 bytes' elements -- 8 at
  bf16 / fp16, 4 at fp32 -- and 16-byte aligned tensors: every MoE width
  of the eleven archs): persistent blocks of one wgmma warpgroup fed by a
  TMA producer warp through an mbarrier ring.  A forward work item is an
  expert's 64 rows times 128 output columns, so an admission's expert (up
  to 64 rows) reads its weight slab once a product, and the row tiles of a
  larger group run side by side; dW's item is a 64 x 128 tile of dw[e].
  At 16 bits dW's tile is staged in shared memory and written by TMA
  stores that drain while the next tile is summed.  At fp32 (one block an
  SM: BLOCKS_PER_SM) TMA brings raw fp32 tiles, the warpgroup cuts each
  into three bf16 planes and wgmma runs the six part pairs i + j < 3, the
  leading pair's sums kept apart, so the fp32 result keeps fp32 accuracy.
* ``mma_sync`` (other bf16 / fp16 shapes): 16-row tiles on
  ``mma.sync`` through a cp.async ring, dW a block per 64 x 64 tile.
* ``cuda_cores`` (other fp32 shapes): FMA tiles.

Every output is written by one block in a fixed order (no split over K, no
atomics): two calls give the same bits.  :func:`ragged_grid` and
:func:`ragged_dw_grid` size each body's grid.

The wrappers take CUDA tensors only: they check device, dtype, shape and
layout, allocate the outputs, launch on the current stream and raise if a
launch failed.  They never fall back to the plain version; dispatch by
device lives in :mod:`repro_torch.kernels.ops`.  Launches are counted in
``ragged_matmul.launches`` and ``ragged_matmul_bwd.launches`` (one a call,
however many of its two kernels it runs).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import scratch
from repro_torch.kernels.ref import ragged_matmul_ref  # noqa: F401

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the bodies, by the codes the launchers take
BODIES = {"cuda_cores": 0, "mma_sync": 1, "wgmma_tma": 2}
# a forward tile's rows and output columns: the mma.sync / CUDA-core
# blocks', the wgmma work items' (dW's item: 64 of K x 128 of N)
MMA_TILE = (16, 64)
WGMMA_TILE = (64, 128)
WGMMA_DW_TILE = (64, 128)
# the wgmma bodies' persistent blocks on each SM, by dtype (fp32: two raw
# stages of 48 KB and 72 KB of bf16 planes, one block an SM)
BLOCKS_PER_SM = {torch.float32: 1, torch.float16: 2, torch.bfloat16: 2}


def ragged_body(dtype, K, N, aligned=True):
    """The body that runs a grouped product of (K, N) weights at
    ``dtype`` (``aligned``: every operand 16-byte aligned): wgmma fed by
    TMA where TMA can describe the operands (K and N positive multiples of
    16 bytes' elements, 8 at bf16 / fp16 and 4 at fp32: row strides of 16
    bytes; aligned), else mma.sync at bf16 / fp16 and CUDA cores at
    fp32.  At fp32 the wgmma body is slower than the CUDA-core one at a
    decode step's 64 rows (PERF.md, row 12j) and faster from an
    admission's thousands of rows up; the fix is that body's redesign
    (ROADMAP A5), not a switch back to CUDA cores by shape."""
    q = 16 // dtype.itemsize
    if K > 0 and N > 0 and K % q == 0 and N % q == 0 and aligned:
        return "wgmma_tma"
    return "cuda_cores" if dtype == torch.float32 else "mma_sync"


def tiles_bound(R, E, rows):
    """The most row tiles of ``rows`` rows that group sizes summing to at
    most R over E groups can make, the tiles of the rows past the last
    group included: each of at most min(E + 1, R) nonempty parts adds at
    most one partial tile."""
    return -(-R // rows) + min(E, R)


def ragged_grid(body, R, E, Nout, sms, dtype):
    """(gx, gy) of a forward / dRows launch with Nout output columns at
    ``dtype`` on a card of ``sms`` SMs: the wgmma body's persistent blocks
    (at most BLOCKS_PER_SM[dtype] an SM and one a work item), else a block
    per 16-row tile (the static bound) and 64 columns."""
    if body == "wgmma_tma":
        rows, cols = WGMMA_TILE
        items = tiles_bound(R, E, rows) * -(-Nout // cols)
        return min(items, BLOCKS_PER_SM[dtype] * sms), 1
    rows, cols = MMA_TILE
    return tiles_bound(R, E, rows), -(-Nout // cols)


def ragged_dw_grid(body, E, K, N, sms, dtype):
    """(gx, gy, gz) of a dW launch at ``dtype``: the wgmma body's
    persistent blocks over the E x (K / 64) x (N / 128) tiles, else a block
    per 64 x 64 tile of each expert."""
    if body == "wgmma_tma":
        kr, nc = WGMMA_DW_TILE
        items = E * -(-K // kr) * -(-N // nc)
        return min(items, BLOCKS_PER_SM[dtype] * sms), 1, 1
    return -(-N // 64), -(-K // 64), E


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check(name, rows, w, sizes, other=None):
    tensors = (rows, w, sizes) + (() if other is None else (other,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the CUDA {name} kernel takes CUDA tensors only "
                         f"(CPU tensors go to the plain version through "
                         f"repro_torch.kernels.ops)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must be on one device")
    if rows.dtype not in _DTYPE_CODES or w.dtype != rows.dtype or (
            other is not None and other.dtype != rows.dtype):
        raise ValueError(f"{name} takes fp32, fp16 or bf16 rows and w of "
                         f"one dtype (got {rows.dtype}, {w.dtype})")
    if sizes.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 group sizes, not {sizes.dtype}")
    if rows.dim() != 2 or w.dim() != 3 or sizes.shape != (w.shape[0],) \
            or rows.shape[1] != w.shape[1] or w.shape[0] < 1:
        raise ValueError(f"{name}: shapes do not fit rows (R, K), w (E, K, "
                         f"N), sizes (E,): {tuple(rows.shape)}, "
                         f"{tuple(w.shape)}, {tuple(sizes.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def _raise_on(err, name, lib):
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def ragged_matmul(rows, w, sizes):
    """rows (R, K) x w[e] (K, N) for the rows of each group e -> (R, N) at
    rows' dtype (fp32 sums): fp32, fp16 or bf16 rows and w of one dtype,
    int32 sizes (E,) summing to at most R (rows past them come out zero),
    all contiguous on one CUDA device."""
    from repro_torch.kernels import build
    _check("ragged_matmul", rows, w, sizes)
    R, K = rows.shape
    E, _, N = w.shape
    out = torch.empty(R, N, dtype=rows.dtype, device=rows.device)
    if R == 0 or N == 0:
        return out
    lib = build.load()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    body = ragged_body(rows.dtype, K, N, _aligned(rows, w))
    gx, gy = ragged_grid(body, R, E, N, scratch.sm_count(rows.device.index),
                         rows.dtype)
    with torch.cuda.device(rows.device):
        err = lib.ragged_matmul_launch(
            rows.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[rows.dtype], R, E, K, N, 0, BODIES[body], gx, gy,
            stream)
    _raise_on(err, "ragged_matmul", lib)
    ragged_matmul.launches += 1
    return out


def ragged_matmul_bwd(rows, w, sizes, dout, *, need_rows=True,
                      need_w=True):
    """The gradients of :func:`ragged_matmul` for the cotangent dout (R,
    N): (drows (R, K) = dout_e x w[e]^T per group, or None; dw (E, K, N) =
    rows_e^T x dout_e, zeros for an expert with no rows, or None).  The
    sizes take none."""
    from repro_torch.kernels import build
    _check("ragged_matmul_bwd", rows, w, sizes, dout)
    R, K = rows.shape
    E, _, N = w.shape
    if dout.shape != (R, N):
        raise ValueError(f"ragged_matmul_bwd: dout must be {(R, N)}, not "
                         f"{tuple(dout.shape)}")
    lib = build.load()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    code = _DTYPE_CODES[rows.dtype]
    sms = scratch.sm_count(rows.device.index)
    drows = dw = None
    with torch.cuda.device(rows.device):
        if need_rows:
            drows = torch.empty_like(rows)
            if R and K:
                body = ragged_body(rows.dtype, K, N, _aligned(dout, w))
                gx, gy = ragged_grid(body, R, E, K, sms, rows.dtype)
                _raise_on(lib.ragged_matmul_launch(
                    dout.data_ptr(), w.data_ptr(), sizes.data_ptr(),
                    drows.data_ptr(), code, R, E, K, N, 1, BODIES[body], gx,
                    gy, stream), "ragged_matmul_bwd (rows)", lib)
        if need_w:
            dw = torch.empty_like(w)
            if K and N:
                # no rows: nothing for a tensor map to describe
                body = ragged_body(rows.dtype, K, N, R > 0
                                   and _aligned(rows, dout))
                grid = ragged_dw_grid(body, E, K, N, sms, rows.dtype)
                _raise_on(lib.ragged_matmul_dw_launch(
                    rows.data_ptr(), dout.data_ptr(), sizes.data_ptr(),
                    dw.data_ptr(), code, R, E, K, N, BODIES[body], *grid,
                    stream), "ragged_matmul_bwd (w)", lib)
    ragged_matmul_bwd.launches += 1
    return drows, dw


ragged_matmul.launches = 0
ragged_matmul_bwd.launches = 0
