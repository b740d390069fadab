"""Fused RMSNorm on the card: the wrapper around the hand-written CUDA
kernel in ``repro_torch/csrc/rmsnorm.cu`` (built for ``sm_90a`` by
:mod:`repro_torch.kernels.build`), with its plain PyTorch version beside
it.

:func:`fused_rmsnorm` replaces the reference's Pallas kernel
``repro.kernels.rmsnorm.fused_rmsnorm``: ``x * rsqrt(mean(x^2) + eps) *
(1 + w)`` over the last dim, in fp32, at x's dtype.  Like the reference's
kernel it has no model call site (the models' norms are plain code in
both packages); it is reached through ``ops.rmsnorm``.  Any row count and
any D are taken.

The wrapper takes CUDA tensors only: it checks device, dtype, layout and
shapes, allocates the output, launches on the current stream and raises if
the launch failed.  It counts its launches in ``fused_rmsnorm.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import rmsnorm_ref  # noqa: F401

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


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
    lib = build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
            int(w.dtype == torch.float32), x.numel() // D, D, float(eps),
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"fused_rmsnorm launch failed: CUDA error {err} "
                           f"({msg})")
    fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0
