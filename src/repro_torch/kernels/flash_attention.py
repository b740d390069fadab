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
any Sq and Sk are taken: the kernel masks the ragged tiles itself.  Every
dtype runs the tensor-core body (``csrc/attn_mma.cuh``: all g query heads
of a kv head in one block, mma.sync, a cp.async ring); at fp32 each
operand of each product is cut into three bf16 parts whose sum is the
value, so its products are as exact as fp32 FMAs, where TF32 tensor cores
would keep about three decimal digits.

For training, ``return_lse=True`` also returns each row's log-sum-exp,
and :func:`flash_attention_bwd` is the gradient: the hand-written kernels
of ``repro_torch/csrc/flash_attention_bwd.cu`` (the reference's Pallas
kernel has none; it trains by differentiating its plain attention), in
the geometry of :func:`bwd_plan`: a dQ kernel over blocks of 64 (query,
head) rows (which also writes D = rowsum(dO o)), then a dK/dV kernel over
blocks of 16 keys a warp that walk their kv head's (query, head) pairs,
the g heads split over blocks where the grid would be under one wave
(their fp32 partials added in order by a third launch), all on mma.sync
with cp.async rings; no atomics, so two calls give the same bits.
bf16/fp16 take the "mma" body (operands at their type), fp32 the "split"
body (every operand, P and dS included, cut into three bf16 parts).
``ops.FlashAttentionFn`` ties the two together for autograd.

The wrappers take CUDA tensors only: they check device, dtype, layout and
shapes, allocate the outputs, launch on the current stream and raise if
the launch failed.  They never fall back to the plain versions; dispatch
by device lives in :mod:`repro_torch.kernels.ops`.  They count their
launches in ``flash_attention.launches`` and
``flash_attention_bwd.launches``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: F401
                                     flash_attention_lse_ref,
                                     flash_attention_ref)

MAX_HEAD_DIM = 256
MAX_SMEM = 232448          # bytes of shared memory a block may take (H100)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# the backward's kernels (csrc/flash_attention_bwd.cu)
BWD_TILE = 32              # keys (dQ) or (query, head) pairs (dK/dV) a tile
BWD_WIN_TILES = 32         # tiles whose positions are read at once
BWD_WARPS = 4              # warps of a block of either kernel
BWD_DQ_ROWS = 16 * BWD_WARPS   # (query, head) rows of a dQ block
SPLIT_PARTS = 3            # bf16 parts of each fp32 operand ("split" body)
_BWD_BODIES = {"mma": 1, "split": 2}


class BwdPlan(NamedTuple):
    """The launch geometry of :func:`flash_attention_bwd`, all of which the
    launcher takes (``flash_attention_bwd_launch``): it sizes the grids and
    the blocks' shared memory from it, and refuses a plan its kernels were
    not built for."""
    body: str          # "mma": bf16 / fp16; "split": fp32 as bf16 parts
    block_keys: int    # keys of a dK/dV block
    dq_rows: int       # (query, head) rows of a dQ block
    head_splits: int   # dK/dV blocks over the g query heads of a kv head
    smem_dq: int       # shared-memory bytes of a dQ block
    smem_dkdv: int     # ... and of a dK/dV block


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def bwd_dmax(D: int, Dv: int) -> int:
    """The head-dim bucket of (D, Dv), as the forward's: the widest
    accumulator a warp may need, which picks the tensor-core kernels."""
    d = _round16(max(D, Dv))
    return 64 if d <= 64 else 128 if d <= 128 else 256


def bwd_block_keys(dmax: int) -> int:
    """Keys of a dK/dV block: 16 a warp; above a head dim of 128 two warps
    share 16 keys and split dK's and dV's columns, so that the two
    accumulators stay within 128 registers a lane."""
    return BWD_WARPS * 16 if dmax <= 128 else BWD_WARPS // 2 * 16


def bwd_smem_bytes(D: int, Dv: int,
                   fp32: bool = False) -> tuple[int, int]:
    """Shared-memory bytes of a (dQ, dK/dV) block: the layouts ``DqSmem`` /
    ``DkdvSmem`` of ``csrc/flash_attention_bwd.cu``, which the launcher
    holds this figure to.  Rows of 2-byte elements are padded to a
    multiple of 16 elements plus 16 bytes, fp32 rows (``fp32``, the split
    body) to a multiple of 16 plus 8 floats.  Rings of 3 tiles, 2 in the
    256 bucket so that two dK/dV blocks fit an SM; at fp32 a dQ block of
    the 256 bucket holds one (its 64 rows' Q and dO take 132 KB).  dQ: its
    64 rows' Q, dO and (2-byte elements; fp32 reads o from device memory)
    o, then per stage a key tile's K and V and its positions, then the
    rows' positions, lse and D, the position window and the warps' live
    bits.  dK/dV: its keys' K and V, then per stage a pair tile's Q and
    dO, lse, D and positions, then the keys' positions, the window, the
    bits."""
    esz = 4 if fp32 else 2
    kstr, vstr = (_round16(D) + 8) * esz, (_round16(Dv) + 8) * esz
    dmax = bwd_dmax(D, Dv)
    dq_st, kv_st = ((3, 3) if dmax <= 128 else (1 if fp32 else 2, 2))
    walk = BWD_WIN_TILES * BWD_TILE + BWD_WARPS
    dq = (BWD_DQ_ROWS * (kstr + (1 if fp32 else 2) * vstr)
          + dq_st * (BWD_TILE * (kstr + vstr) + (BWD_TILE + 4) * 4)
          + (3 * BWD_DQ_ROWS + walk) * 4)
    keys = bwd_block_keys(dmax)
    dkdv = (keys * (kstr + vstr)
            + kv_st * (BWD_TILE * (kstr + vstr) + (3 * BWD_TILE + 4) * 4)
            + (keys + walk) * 4)
    return dq, dkdv


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int, Dv: int,
             dtype: torch.dtype, sm_count: int) -> BwdPlan:
    """The launch plan of :func:`flash_attention_bwd` on a card of
    ``sm_count`` SMs.  The body by dtype: "mma" at bf16/fp16, "split" at
    fp32 (every operand cut into SPLIT_PARTS bf16 parts: TF32 tensor cores
    would break the card-vs-CPU fp32 parity of training).  Either way a
    dQ block takes BWD_DQ_ROWS (query, head) rows of one kv head, a dK/dV
    block :func:`bwd_block_keys`, and where the dK/dV grid (ceil(Sk /
    keys) x Hkv x B blocks) is under one wave, its kv head's g query heads
    are split over the fewest blocks that fill it (a divisor of g; g
    itself if none does): each split then writes fp32 partials, added in
    split order by a third launch.  Shared memory: :func:`bwd_smem_bytes`.
    Cached: a train step asks for the same few plans every layer."""
    fp32 = dtype == torch.float32
    keys = bwd_block_keys(bwd_dmax(D, Dv))
    g = Hq // Hkv
    blocks = -(-Sk // keys) * Hkv * B
    head_splits = 1
    if blocks < sm_count:
        head_splits = next((d for d in range(1, g + 1)
                            if g % d == 0 and blocks * d >= sm_count), g)
    return BwdPlan("split" if fp32 else "mma", keys, BWD_DQ_ROWS,
                   head_splits, *bwd_smem_bytes(D, Dv, fp32))


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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
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
    dv.  Two or three launches (dq with D = rowsum(do o), dk / dv, and the
    head splits' sum where :func:`bwd_plan` splits), counted as one call;
    deterministic (no atomics)."""
    from repro_torch.kernels import build, scratch
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
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("the tensor-core flash backward needs q, k, v, o "
                         "and do 16-byte aligned")
    lib = build.load()
    dev = q.device
    plan = bwd_plan(B, Sq, Sk, Hq, Hkv, D, Dv, q.dtype,
                    scratch.sm_count(dev.index))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        part = (scratch.split_scratch(dev, stream, B * Sk * Hkv
                                      * plan.head_splits * (D + Dv))
                if plan.head_splits > 1 else None)
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], B, Sq, Sk,
            Hq, Hkv, D, Dv, *_mask_args(window, scale, attn_softcap),
            _BWD_BODIES[plan.body], plan.block_keys, plan.dq_rows,
            plan.head_splits, plan.smem_dq, plan.smem_dkdv,
            part.data_ptr() if part is not None else None, stream)
    _raise_on(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
