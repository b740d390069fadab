"""Fused RMSNorm on the card: the wrapper around the hand-written CUDA
kernels in ``repro_torch/csrc/rmsnorm.cu`` (built for ``sm_90a`` by
:mod:`repro_torch.kernels.build`), with its plain PyTorch version beside
it.

:func:`fused_rmsnorm` replaces the reference's Pallas kernel
``repro.kernels.rmsnorm.fused_rmsnorm``: ``x * rsqrt(mean(x^2) + eps) *
(1 + w)`` over the last dim, in fp32, at x's dtype.  Like the reference's
kernel it has no model call site (the models' norms are plain code in
both packages); it is reached through ``ops.rmsnorm``.  Any row count and
any D are taken.

:func:`rmsnorm_plan` picks the body from the shape and x's alignment: rows
that are a whole number of 16-byte vectors from an aligned x, and that fit
the registers, go to a body that keeps each row in registers between the
sum of squares and the scale (``rows``); any other row (a D that is not a
whole number of vectors, an x that starts off a 16-byte boundary, a row
wider than the registers hold) goes to the element-wise ``scalar`` body,
which reads x again from L2 for the scale.

The wrapper takes CUDA tensors only: it checks device, dtype, layout and
shapes, allocates the output, launches on the current stream and raises if
the launch failed.  It counts its launches in ``fused_rmsnorm.launches``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import scratch
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: F401

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
BODIES = ("scalar", "rows")          # codes 0, 1 in the kernel
VEC_BYTES = 16                        # one vector load / store a lane
BLOCK_WARPS = 8                       # 256 threads a block
ROW_WARPS = (1, 2, 4)                 # warps a row in the rows body
LANE_VECS = (4, 8, 16)                # vectors a lane holds (rows body)
BLOCKS_PER_SM = 2                     # grid of the rows body: blocks an SM


class RmsPlan(NamedTuple):
    body: str            # one of BODIES
    warps_per_row: int   # rows body: warps that share a row
    lane_vecs: int       # rows body: the kernel's vectors per lane
    blocks: int          # grid (the scalar body: one block per row)


def rmsnorm_plan(rows: int, D: int, itemsize: int, aligned: bool,
                 sm_count: int) -> RmsPlan:
    """The launch plan of ``fused_rmsnorm`` for ``rows`` rows of ``D``
    elements of ``itemsize`` bytes, x 16-byte ``aligned`` or not, on a card
    of ``sm_count`` SMs.  The rows body takes the fewest warps per row that
    hold the row at no more than max(LANE_VECS) vectors a lane, and the
    smallest LANE_VECS entry that holds a lane's share; its grid is at most
    BLOCKS_PER_SM blocks an SM, each walking rows (BLOCK_WARPS / warps per
    row at a time) with a grid stride, so 1 + w is staged once a block.
    Every other shape takes the scalar body, a block per row."""
    if D < 1 or itemsize not in (2, 4):
        raise ValueError(f"rmsnorm_plan: D={D}, itemsize={itemsize}")
    scalar = RmsPlan("scalar", 0, 0, rows)
    if not aligned or D * itemsize % VEC_BYTES:
        return scalar
    nvec = D * itemsize // VEC_BYTES
    grid = BLOCKS_PER_SM * sm_count
    for wpr in ROW_WARPS:
        per_lane = -(-nvec // (32 * wpr))
        if per_lane <= LANE_VECS[-1]:
            nv = next(n for n in LANE_VECS if n >= per_lane)
            groups = BLOCK_WARPS // wpr
            return RmsPlan("rows", wpr, nv, min(-(-rows // groups), grid))
    return scalar


def fused_rmsnorm(x, w, *, eps: float = 1e-6):
    """x: (..., D) at fp32, fp16 or bf16; w: (D,) at x's dtype or fp32.
    Returns the normalised x at x's dtype."""
    from repro_torch.kernels import build
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("the CUDA RMSNorm kernel takes CUDA tensors only "
                         "(CPU tensors go to the plain version through "
                         "repro_torch.kernels.ops)")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the RMSNorm kernel needs contiguous inputs")
    if x.dtype not in _DTYPE_CODES or w.dtype not in (x.dtype,
                                                      torch.float32):
        raise ValueError(f"x must be fp32, fp16 or bf16 and w at x's dtype "
                         f"or fp32 (got {x.dtype}, {w.dtype})")
    if x.dim() < 1 or x.shape[-1] < 1 or w.shape != x.shape[-1:]:
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}: it must be (D,)")
    D = x.shape[-1]
    rows = x.numel() // D
    lib = build.load()
    out = torch.empty_like(x)
    plan = rmsnorm_plan(rows, D, x.element_size(),
                        x.data_ptr() % VEC_BYTES == 0,
                        scratch.sm_count(x.device.index))
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
            int(w.dtype == torch.float32), rows, D, float(eps),
            BODIES.index(plan.body), plan.warps_per_row, plan.lane_vecs,
            plan.blocks, torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"fused_rmsnorm launch failed: CUDA error {err} "
                           f"({msg})")
    fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0
