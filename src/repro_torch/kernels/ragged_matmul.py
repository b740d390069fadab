"""Grouped (ragged) matrix product on the card: the wrapper around the
hand-written CUDA kernels in ``repro_torch/csrc/ragged_matmul.cu`` (built
for ``sm_90a`` by :mod:`repro_torch.kernels.build`), with its plain
PyTorch version beside it.

:func:`ragged_matmul` computes what ``jax.lax.ragged_dot`` does in the
reference's ``moe_apply_ragged`` (``REPRO_PERF_OPTS=moe_ragged``; XLA's
product, no Pallas kernel): rows (R, K) sorted by group, group e owning
the ``sizes[e]`` rows after those of the groups before it, each times its
own w[e] (K, N); rows past the last group come out zero.  The kernel finds
each tile's group on the device, so nothing is read back to the host, and
an expert that received no rows is never read.  :func:`ragged_matmul_bwd`
gives the gradients of rows (the same kernel reading w transposed) and of
w (a kernel over w's tiles that sums each group's rows in order).

The wrappers take CUDA tensors only: they check device, dtype, shape and
layout, allocate the outputs, launch on the current stream and raise if a
launch failed.  They never fall back to the plain version; dispatch by
device lives in :mod:`repro_torch.kernels.ops`.  Launches are counted in
``ragged_matmul.launches`` and ``ragged_matmul_bwd.launches`` (one a call,
however many of its two kernels it runs).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import ragged_matmul_ref  # noqa: F401

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
ROW_TILE, COL_TILE = 16, 64     # a ragged_mm block's rows and columns


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
    with torch.cuda.device(rows.device):
        err = lib.ragged_matmul_launch(
            rows.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[rows.dtype], R, E, K, N, 0, stream)
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
    drows = dw = None
    with torch.cuda.device(rows.device):
        if need_rows:
            drows = torch.empty_like(rows)
            if R and K:
                _raise_on(lib.ragged_matmul_launch(
                    dout.data_ptr(), w.data_ptr(), sizes.data_ptr(),
                    drows.data_ptr(), code, R, E, K, N, 1, stream),
                    "ragged_matmul_bwd (rows)", lib)
        if need_w:
            dw = torch.empty_like(w)
            if K and N:
                _raise_on(lib.ragged_matmul_dw_launch(
                    rows.data_ptr(), dout.data_ptr(), sizes.data_ptr(),
                    dw.data_ptr(), code, R, E, K, N, stream),
                    "ragged_matmul_bwd (w)", lib)
    ragged_matmul_bwd.launches += 1
    return drows, dw


ragged_matmul.launches = 0
ragged_matmul_bwd.launches = 0
