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

For training, ``return_lse=True`` also returns each row's log-sum-exp,
and :func:`flash_attention_bwd` is the gradient: the hand-written kernels
of ``repro_torch/csrc/flash_attention_bwd.cu`` (the reference's Pallas
kernel has none; it trains by differentiating its plain attention).
``ops.FlashAttentionFn`` ties the two together for autograd.

The wrappers take CUDA tensors only: they check device, dtype, layout and
shapes, allocate the outputs, launch on the current stream and raise if
the launch failed.  They never fall back to the plain versions; dispatch
by device lives in :mod:`repro_torch.kernels.ops`.  They count their
launches in ``flash_attention.launches`` and
``flash_attention_bwd.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: F401
                                     flash_attention_lse_ref,
                                     flash_attention_ref)

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check(name, q, k, v, q_pos, k_pos, *extra):
    """The checks both wrappers make; returns (B, Sq, Sk, Hq, Hkv, D,
    Dv)."""
    tensors = (q, k, v, q_pos, k_pos) + extra
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the CUDA {name} kernel takes CUDA tensors only "
                         f"(CPU tensors go to the plain version through "
                         f"repro_torch.kernels.ops)")
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
    return B, Sq, Sk, Hq, Hkv, D, Dv


def _raise_on(lib, err, name):
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({msg})")


def _mask_args(window, scale, attn_softcap):
    return (float(scale),
            float(attn_softcap) if attn_softcap is not None else 0.0,
            int(window) if window is not None else 0)


def flash_attention(q, k, v, q_pos, k_pos, *, window: Optional[int],
                    scale: float, attn_softcap: Optional[float] = None,
                    return_lse: bool = False):
    """Dense attention on the card.  q: (B, Sq, Hq, D); k: (B, Sk, Hkv, D);
    v: (B, Sk, Hkv, Dv), all at one dtype (fp32, fp16 or bf16); q_pos
    (B, Sq) and k_pos (B, Sk) int32 absolute positions, -1 = invalid.  A
    key is visible when ``0 <= kp <= qp`` (and ``kp > qp - window`` with a
    window); a query that sees no key returns zeros.  Returns
    (B, Sq, Hq, Dv) at q's dtype; with ``return_lse`` also each row's
    log-sum-exp (B, Hq, Sq) fp32 (+inf for a row that sees no key), which
    :func:`flash_attention_bwd` takes."""
    from repro_torch.kernels import build
    B, Sq, Sk, Hq, Hkv, D, Dv = _check("flash-attention", q, k, v, q_pos,
                                       k_pos)
    if q.dtype != torch.float32 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the tensor-core flash kernel needs q, k and v "
                         "16-byte aligned")
    lib = build.load()
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODES[q.dtype], B, Sq, Sk, Hq, Hkv, D, Dv,
            *_mask_args(window, scale, attn_softcap),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, q_pos, k_pos, o, lse, do, *,
                        window: Optional[int], scale: float,
                        attn_softcap: Optional[float] = None):
    """The gradient of :func:`flash_attention` on the card: from the
    forward's inputs, its output o and log-sum-exp lse (B, Hq, Sq) fp32,
    and the output's gradient do (B, Sq, Hq, Dv) at q's dtype, (dq, dk,
    dv) at q's dtype, summed over each kv head's query heads for dk and
    dv.  Three launches (D = rowsum(do o), then dk / dv, then dq), counted
    as one call; deterministic (no atomics)."""
    from repro_torch.kernels import build
    B, Sq, Sk, Hq, Hkv, D, Dv = _check("flash-attention backward", q, k, v,
                                       q_pos, k_pos, o, lse, do)
    if o.shape != (B, Sq, Hq, Dv) or do.shape != o.shape \
            or lse.shape != (B, Hq, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError("o and do must be at q's dtype and lse fp32")
    if not (o.is_contiguous() and do.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("the flash backward needs contiguous o, do and lse")
    lib = build.load()
    dev = q.device
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(dev):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], B, Sq, Sk,
            Hq, Hkv, D, Dv, *_mask_args(window, scale, attn_softcap),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
