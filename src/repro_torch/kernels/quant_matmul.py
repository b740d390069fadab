"""Weight-only int8 matmul on the card: the wrapper around the hand-written
CUDA kernel in ``repro_torch/csrc/quant_matmul.cu`` (built for ``sm_90a``
by :mod:`repro_torch.kernels.build`), with its plain PyTorch version
beside it.

:func:`quant_matmul` replaces the reference's Pallas kernel
``repro.kernels.quant_matmul.quant_matmul``: ``(x @ q) * s`` in fp32 for
activations x (..., K), int8 codes q (K, N) and per-output-channel fp32
scales s (N,) (``core.precision.quantize_weights``).  It serves every
dense matmul of the serve path when ``weights_dtype="int8"``.

The wrapper takes CUDA tensors only: it checks device, dtype and layout,
allocates the output (and, for small N, the split-K workspace), launches
on the current stream and raises if the launch failed.  It never falls
back to the plain version; dispatch by device lives in
:mod:`repro_torch.kernels.ops`.  It counts its launches in
``quant_matmul.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import quant_matmul_ref  # noqa: F401

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_ROWS = 65535 * 32          # the kernel's grid limit on x's rows


def quant_matmul(x, q, s):
    """``x @ (q * s)`` in fp32 on the card: x (..., K) fp32/fp16/bf16,
    q (K, N) int8 row-major, s (N,) fp32, all contiguous on one CUDA
    device.  Returns (..., N) fp32 (callers cast back to their compute
    dtype)."""
    from repro_torch.kernels import build
    if not (x.is_cuda and q.is_cuda and s.is_cuda):
        raise ValueError("the CUDA quant_matmul kernel takes CUDA tensors "
                         "only (CPU tensors go to the plain version through "
                         "repro_torch.kernels.ops)")
    if not x.device == q.device == s.device:
        raise ValueError("x, q and s must be on one device")
    if x.dtype not in _DTYPE_CODES or q.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise ValueError(f"quant_matmul takes x fp32/fp16/bf16, q int8 and "
                         f"s fp32 (got {x.dtype}, {q.dtype}, {s.dtype})")
    if q.dim() != 2 or s.shape != (q.shape[1],) or x.dim() < 1 \
            or x.shape[-1] != q.shape[0]:
        raise ValueError(f"shapes do not fit x (..., K) @ q (K, N), s (N,): "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("quant_matmul needs contiguous x, q and s")
    K, N = q.shape
    M = x.shape[:-1].numel()
    if M > MAX_ROWS:
        raise ValueError(f"{M} rows exceed the kernel's limit of {MAX_ROWS}")
    out = torch.empty((*x.shape[:-1], N), dtype=torch.float32,
                      device=x.device)
    if M == 0 or N == 0:
        return out
    lib = build.load()
    splits = lib.quant_matmul_splits(M, K, N)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = lib.quant_matmul_launch(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            _DTYPE_CODES[x.dtype], M, K, N, splits,
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err} "
                           f"({msg})")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
