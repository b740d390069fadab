"""Chunkwise mLSTM on the card: the wrapper around the hand-written CUDA
kernel in ``repro_torch/csrc/mlstm_chunk.cu`` (built for ``sm_90a`` by
:mod:`repro_torch.kernels.build`), with its plain PyTorch version beside
it.

:func:`mlstm_chunked` replaces the reference's Pallas kernel
``repro.kernels.mlstm_chunk.mlstm_chunked_kernel``: the stabilised xLSTM
matrix-memory recurrence over a whole prompt, carrying C, n and m from
chunk to chunk.  In the port it carries every mLSTM prefill
(``models.ssm.mlstm_apply``), i.e. every xLSTM admission.  Unlike the
reference's wrapper, any S is taken: the kernel masks the ragged last
chunk itself, and its chunk length (32) is its own choice (the result
does not depend on it beyond fp32 rounding).

The wrapper takes CUDA tensors only: it checks device, dtype, layout,
shapes and the shared memory the launch needs, allocates the outputs,
launches on the current stream and raises if the launch failed.  It never
falls back to the plain version; dispatch by device lives in
:mod:`repro_torch.kernels.ops`.  It counts its launches in
``mlstm_chunked.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import mlstm_chunked_ref  # noqa: F401

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def mlstm_chunked(q, k, v, i_pre, logf, state):
    """q, k, v: (B, S, H, dh) at one of fp32, fp16, bf16; i_pre / logf:
    (B, S, H) fp32; state: {"C": (B,H,dh,dh), "n": (B,H,dh), "m": (B,H)}
    fp32.  Returns h (B, S, H, dh) fp32 and the final state (new tensors;
    the initial state is not written)."""
    from repro_torch.kernels import build
    C0, n0, m0 = state["C"], state["n"], state["m"]
    tensors = (q, k, v, i_pre, logf, C0, n0, m0)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA mLSTM kernel takes CUDA tensors only "
                         "(CPU tensors go to the plain version through "
                         "repro_torch.kernels.ops)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the mLSTM kernel needs contiguous inputs")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v must share one of fp32, fp16, bf16 (got "
                         f"{q.dtype}, {k.dtype}, {v.dtype})")
    if not all(t.dtype == torch.float32 for t in (i_pre, logf, C0, n0, m0)):
        raise ValueError("gates and state must be fp32")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, dh), got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape \
            or i_pre.shape != (B, S, H) or logf.shape != (B, S, H) \
            or C0.shape != (B, H, dh, dh) or n0.shape != (B, H, dh) \
            or m0.shape != (B, H):
        raise ValueError(f"shapes do not fit q {tuple(q.shape)}: k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
                         f"{tuple(i_pre.shape)}/{tuple(logf.shape)}, state "
                         f"{tuple(C0.shape)}/{tuple(n0.shape)}/"
                         f"{tuple(m0.shape)}")
    if S < 1 or dh < 1:
        raise ValueError(f"S={S}, dh={dh}: both must be at least 1")
    lib = build.load()
    limit = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if lib.mlstm_chunk_smem_bytes(dh) > limit:
        raise ValueError(f"dh={dh} needs {lib.mlstm_chunk_smem_bytes(dh)} "
                         f"bytes of shared memory per block; the device "
                         f"allows {limit}")
    h = torch.empty((B, S, H, dh), dtype=torch.float32, device=q.device)
    C, n, m = (torch.empty_like(t) for t in (C0, n0, m0))
    with torch.cuda.device(q.device):
        err = lib.mlstm_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            logf.data_ptr(), C0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
            h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
            _DTYPE_CODES[q.dtype], B, S, H, dh,
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"mlstm_chunked launch failed: CUDA error {err} "
                           f"({msg})")
    mlstm_chunked.launches += 1
    return h, {"C": C, "n": n, "m": m}


mlstm_chunked.launches = 0
