"""Dense flash attention on the card: the wrapper around the hand-written
CUDA kernel in ``repro_torch/csrc/flash_attention.cu`` (built for
``sm_90a`` by :mod:`repro_torch.kernels.build`), with its plain PyTorch
version beside it.

:func:`flash_attention` replaces the reference's Pallas kernel
``repro.kernels.flash_attention.flash_attention``: q (B, Sq, Hq, D)
against k/v (B, Sk, Hkv, D[v]) with masks from absolute positions (-1 =
invalid; causal, optional window), an optional softcap and GQA.  In the
port it carries every dense attention call of more than one query
(``layers.mha_attention``): the dense-cache prefill of
``generate_batch``, the no-cache baseline's full forwards, the bucketed
admission prefill and its prefix-attend variant over gathered pages, and
the draft model's full forwards in speculative decoding
(``core.speculative.DraftModelDrafter``).  Unlike the reference's wrapper,
any Sq and Sk are taken: the kernel masks the ragged tiles itself.
bf16/fp16 run the tensor-core body (``csrc/attn_mma.cuh``: all g query
heads of a kv head in one block, mma.sync, a cp.async ring); fp32 keeps
the CUDA-core body, whose fp32 products equal the CPU's where TF32 tensor
cores would not.

The wrapper takes CUDA tensors only: it checks device, dtype, layout and
shapes, allocates the output, launches on the current stream and raises if
the launch failed.  It never falls back to the plain version; dispatch by
device lives in :mod:`repro_torch.kernels.ops`.  It counts its launches in
``flash_attention.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import flash_attention_ref  # noqa: F401

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def flash_attention(q, k, v, q_pos, k_pos, *, window: Optional[int],
                    scale: float, attn_softcap: Optional[float] = None):
    """Dense attention on the card.  q: (B, Sq, Hq, D); k: (B, Sk, Hkv, D);
    v: (B, Sk, Hkv, Dv), all at one dtype (fp32, fp16 or bf16); q_pos
    (B, Sq) and k_pos (B, Sk) int32 absolute positions, -1 = invalid.  A
    key is visible when ``0 <= kp <= qp`` (and ``kp > qp - window`` with a
    window); a query that sees no key returns zeros.  Returns
    (B, Sq, Hq, Dv) at q's dtype."""
    from repro_torch.kernels import build
    tensors = (q, k, v, q_pos, k_pos)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA flash-attention kernel takes CUDA tensors "
                         "only (CPU tensors go to the plain version through "
                         "repro_torch.kernels.ops)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention needs contiguous inputs")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v must share one of fp32, fp16, bf16 (got "
                         f"{q.dtype}, {k.dtype}, {v.dtype})")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise ValueError("q_pos and k_pos must be int32")
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (B, Sk, Hkv, D) or v.shape[:3] != (B, Sk, Hkv) \
            or q_pos.shape != (B, Sq) or k_pos.shape != (B, Sk) \
            or Hq % Hkv:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}")
    for n, d in (("D", D), ("Dv", Dv)):
        if d % 8 or not 0 < d <= MAX_HEAD_DIM:
            raise ValueError(f"{n}={d}: head dims must be multiples of 8 "
                             f"up to {MAX_HEAD_DIM}")
    if q.dtype != torch.float32 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the tensor-core flash kernel needs q, k and v "
                         "16-byte aligned")
    lib = build.load()
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], B, Sq,
            Sk, Hq, Hkv, D, Dv, float(scale),
            float(attn_softcap) if attn_softcap is not None else 0.0,
            int(window) if window is not None else 0,
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({msg})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
