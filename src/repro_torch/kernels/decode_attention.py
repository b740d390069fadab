"""Paged attention on the card: wrappers around the hand-written CUDA
kernels in ``repro_torch/csrc/paged_attention.cu`` (built for ``sm_90a``
by :mod:`repro_torch.kernels.build`), with their plain PyTorch versions
beside them.

  * :func:`paged_decode_attention` replaces the reference's Pallas kernel
    ``repro.kernels.decode_attention.paged_decode_attention``: one query
    token per slot against the slot's pages (every decode step).  bf16/fp16
    q runs the tensor-core body at one query lane (the g heads of a kv
    head as its rows), its page walk split like the mixed kernel's
    (:func:`mixed_splits` with ``mixed_row_tiles(1, g)``); fp32 q keeps the
    CUDA-core body.
  * :func:`paged_packed_attention` replaces
    ``repro.kernels.decode_attention.paged_packed_attention``: one flat
    (1, T) stream of decode tokens and prefill-chunk tokens, each lane
    against its own slot's pages (every mixed iteration).  bf16/fp16 q
    runs the tensor-core body, one block per (work row of up to 8 lanes,
    kv head), its page walk split only where the grid is small
    (:func:`packed_plan`); fp32 q keeps the CUDA-core body.
  * :func:`paged_mixed_attention` replaces
    ``repro.kernels.decode_attention.paged_mixed_attention``: a window of
    W query lanes per slot (a speculative verify window of k+1 tokens, or
    one prefill chunk of the ``packed=False`` path), each lane against its
    slot's pages; lanes at position -1 are padding and come back as zeros.
    bf16/fp16 q runs the tensor-core body (``csrc/attn_mma.cuh``) with the
    page walk split over several blocks when the grid is small
    (:func:`mixed_splits`); fp32 q keeps the CUDA-core body, whose fp32
    products equal the CPU's where TF32 tensor cores would not.
  * :func:`paged_decode_attention_q8`, :func:`paged_packed_attention_q8`
    and :func:`paged_mixed_attention_q8` replace the reference's ``_q8``
    kernels: the same three over int8 pools (``kv_dtype="int8"``), whose
    codes are dequantized with their per-entry, per-kv-head fp32 scales as
    the kernel stages them.
  * :func:`decode_attention` replaces
    ``repro.kernels.decode_attention.decode_attention``: one query token
    per row against the row's own contiguous (B, Sk, Hkv, D) cache: the
    decode step of ``generate_batch`` over the dense KV cache, reached
    through ``layers.mha_attention`` and ``ops.decode_attention`` (the
    reference computes that step in plain jnp).
    bf16/fp16 q runs its own tensor-core body (``csrc/dense_decode.cu``),
    whose warps split the keys and whose keys are split across blocks
    where the grid is small (:func:`dense_decode_plan`); fp32 q, and q/k/v
    off a 16-byte boundary, keep the CUDA-core body.

A wrapper takes CUDA tensors only: it checks device, dtype, contiguity and
shapes, allocates the output, launches on the current stream (a split
launch's scratch and arrival counters are kept per device and stream,
:mod:`repro_torch.kernels.scratch`) and raises if the launch failed.  It
never falls back to the plain version; dispatch by device lives in
:mod:`repro_torch.kernels.ops`.  Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import scratch
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: F401
                                     paged_decode_attention_ref,
                                     paged_mixed_attention_ref,
                                     paged_packed_attention_ref)

PACKED_BLOCK_Q = 8          # stream lanes per packed work row
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SMEM_LIMIT = 227 * 1024


def packed_meta_table(seg_starts, seg_lengths, seg_slots, n_tokens,
                      n_work):
    """Host-side helper: cut each packed segment into PACKED_BLOCK_Q-wide
    query windows and emit the (n_work, 4) int32 work table the packed
    kernel walks — rows ``(slot, tile_start, win_start, win_end)`` in
    global stream coordinates, where tile_start is the window's start
    clamped to ``n_tokens - PACKED_BLOCK_Q``.  Unused rows carry slot = -1.
    (The CUDA kernel reads only slot and the window; tile_start is kept so
    the table equals the reference's.)"""
    bq = PACKED_BLOCK_Q
    meta = np.full((n_work, 4), -1, np.int32)
    meta[:, 1:] = 0
    w = 0
    for s0, ln, slot in zip(seg_starts, seg_lengths, seg_slots):
        for blk in range(0, int(ln), bq):
            ws = int(s0) + blk
            we = min(int(s0) + int(ln), ws + bq)
            meta[w] = (int(slot), min(ws, n_tokens - bq), ws, we)
            w += 1
    if w > n_work:
        raise ValueError(f"packed meta overflow: {w} windows > n_work "
                         f"{n_work}")
    return meta


MMA_ROWS = 64   # (lane, group head) rows per block of the tensor-core body
MAX_SPLITS = 16  # splits of one page walk (kMmaMaxSplits in attn_mma.cuh)


def mixed_row_tiles(W: int, g: int) -> int:
    """Blocks of up to MMA_ROWS rows that one slot's W lanes x g query
    heads of a kv head take in the tensor-core mixed kernel."""
    return -(-W * g // MMA_ROWS)


def mixed_splits(B: int, row_tiles: int, Hkv: int, npages: int,
                 sm_count: int):
    """(splits, pages_per_split) of the tensor-core mixed kernel's page
    walk.  Its grid has B x row_tiles x Hkv blocks, each over the
    ``npages`` pages of its slot's block-table row; where those blocks do
    not cover the card's ``sm_count`` SMs, each walk is cut into
    ``splits`` runs of ``pages_per_split`` consecutive pages (split s takes
    pages [s * pps, min((s + 1) * pps, npages))), so every page lies in
    exactly one split and no split is empty.  ``want`` = min(npages,
    ceil(sm_count / blocks), MAX_SPLITS) and pps = ceil(npages / want)
    give want/2 < splits <= want: at least half the SMs are covered
    wherever the pages allow, and never more than MAX_SPLITS splits (the
    kernel's merge holds every split's weights in shared memory).  One
    split when the grid already fills the card or there is at most one
    page."""
    want = min(npages, -(-sm_count // max(B * row_tiles * Hkv, 1)),
               MAX_SPLITS)
    if want <= 1:
        return 1, max(npages, 1)
    pps = -(-npages // want)
    return -(-npages // pps), pps


def mixed_scratch_floats(B: int, row_tiles: int, Hkv: int, splits: int,
                         Dv: int) -> int:
    """fp32 scratch of a split launch: for every split of every (slot, kv
    head, row tile), each of its MMA_ROWS rows' Dv accumulators and (m,
    l); none with one split."""
    if splits == 1:
        return 0
    return B * row_tiles * Hkv * splits * MMA_ROWS * (Dv + 2)


DENSE_KEYS = 32          # keys a tile of the dense tensor-core body
DENSE_ROWS = 8           # query heads of a kv group a dense block takes
DENSE_MIN_SPLIT_TILES = 16   # tiles a split walks at least (4 a warp)
DENSE_MAX_SPLITS = 32    # kDenseMaxSplits in csrc/dense_decode.cu


class DensePlan(NamedTuple):
    body: str            # "mma" (csrc/dense_decode.cu) or "simt"
    row_tiles: int       # blocks of DENSE_ROWS heads per (row, kv head)
    splits: int          # runs of keys, each in its own blocks
    keys_per_split: int  # a whole number of DENSE_KEYS tiles


def dense_decode_plan(B: int, Hkv: int, g: int, Sk: int,
                      dtype: torch.dtype, aligned: bool,
                      sm_count: int) -> DensePlan:
    """The launch plan of the dense :func:`decode_attention` for B rows of
    Sk keys, Hkv kv heads of g query heads each, q of ``dtype``, q/k/v
    16-byte ``aligned`` or not, on a card of ``sm_count`` SMs.  bf16/fp16
    aligned inputs take the tensor-core body; fp32 (TF32 would break the
    fp32 card-vs-CPU parity) and unaligned inputs the CUDA-core body, in
    one split.  The tensor-core grid has B x Hkv x row_tiles blocks; only
    where sm_count // blocks >= 2 and the keys give every split at least
    DENSE_MIN_SPLIT_TILES tiles are the keys cut into ``splits`` runs of
    ``keys_per_split`` (split s takes keys [s * kps, min((s + 1) * kps,
    Sk))), so every key lies in exactly one split, none is empty, and the
    grid stays within one wave of the card.  At most DENSE_MAX_SPLITS."""
    row_tiles = -(-g // DENSE_ROWS)
    tiles = -(-Sk // DENSE_KEYS)
    if dtype == torch.float32 or not aligned:
        return DensePlan("simt", row_tiles, 1, Sk)
    blocks = max(B * Hkv * row_tiles, 1)
    want = min(sm_count // blocks, tiles // DENSE_MIN_SPLIT_TILES,
               DENSE_MAX_SPLITS)
    if want <= 1:
        return DensePlan("mma", row_tiles, 1, tiles * DENSE_KEYS)
    per = -(-tiles // want)
    return DensePlan("mma", row_tiles, -(-tiles // per), per * DENSE_KEYS)


def dense_scratch_floats(B: int, Hkv: int, plan: DensePlan, Dv: int) -> int:
    """fp32 scratch of a split dense launch: for every split of every
    (row, kv head, row tile), its DENSE_ROWS rows' Dv accumulators and (m,
    l); none with one split."""
    if plan.splits == 1:
        return 0
    return B * Hkv * plan.row_tiles * plan.splits * DENSE_ROWS * (Dv + 2)


class PackedPlan(NamedTuple):
    body: str            # "mma" (csrc/attn_mma.cuh) or "simt"
    row_tiles: int       # blocks of MMA_ROWS rows per (work row, kv head)
    splits: int          # runs of pages, each in its own blocks
    pages_per_split: int


def packed_plan(n_work: int, Hkv: int, g: int, npages: int,
                dtype: torch.dtype, sm_count: int) -> PackedPlan:
    """The launch plan of :func:`paged_packed_attention` for a work table
    of ``n_work`` rows (each up to PACKED_BLOCK_Q lanes of one slot), Hkv
    kv heads of g query heads, block-table rows of ``npages`` pages, q of
    ``dtype``, on a card of ``sm_count`` SMs.  fp32 q keeps the CUDA-core
    body in one split (TF32 would break the fp32 card-vs-CPU parity).
    bf16/fp16 q: a block takes up to MMA_ROWS of one work row's
    PACKED_BLOCK_Q x g rows (of one kv head), in as many 16-row warps as
    they fill (one at g = 1, two at g = 4); the page walk is split as the
    mixed kernel's is (:func:`mixed_splits` over n_work x row_tiles x Hkv
    blocks), so only a narrow stream splits: at qwen3-4b's heads a table
    of 17 rows or more already gives a block per SM."""
    if dtype == torch.float32:
        return PackedPlan("simt", 1, 1, max(npages, 1))
    row_tiles = mixed_row_tiles(PACKED_BLOCK_Q, g)
    return PackedPlan("mma", row_tiles,
                      *mixed_splits(n_work, row_tiles, Hkv, npages, sm_count))


def _split_buffers(device, stream: int, B: int, tiles: int, Hkv: int,
                   splits: int, Dv: int):
    """(scratch, counters) of a split launch on ``stream``, one counter per
    (slot, kv head, row tile) (:mod:`repro_torch.kernels.scratch`); (None,
    None) with one split."""
    if splits == 1:
        return None, None
    return (scratch.split_scratch(device, stream, mixed_scratch_floats(
                B, tiles, Hkv, splits, Dv)),
            scratch.split_counters(device, stream, B * tiles * Hkv))


def _check_aligned(q, kpool, vpool):
    """The tensor-core bodies' copies need q and the pools 16-byte
    aligned."""
    if any(t.data_ptr() % 16 for t in (q, kpool, vpool)):
        raise ValueError("the tensor-core attention kernels need q and the "
                         "pools 16-byte aligned")


def _mma_splits(q, kpool, vpool, B: int, tiles: int, Hkv: int,
                npages: int):
    """The tensor-core body's split of the page walk."""
    _check_aligned(q, kpool, vpool)
    return mixed_splits(B, tiles, Hkv, npages,
                        scratch.sm_count(q.device.index))


def _check_common(q, kpool, vpool, ppos, block_tables, q_pos,
                  k_scale=None, v_scale=None):
    """Check the operands of one launch; with ``k_scale``/``v_scale`` the
    pools hold int8 codes, else they are at q's dtype."""
    quant = k_scale is not None
    tensors = (q, kpool, vpool, ppos, block_tables, q_pos) + (
        (k_scale, v_scale) if quant else ())
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA paged-attention kernels take CUDA tensors "
                         "only (CPU tensors go to the plain version through "
                         "repro_torch.kernels.ops)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged-attention kernels need contiguous inputs")
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODES or kpool.dtype != pool_dtype \
            or vpool.dtype != pool_dtype:
        raise ValueError(f"q/pool dtypes: q must be fp32, fp16 or bf16 and "
                         f"the pools {'int8' if quant else 'at q dtype'} "
                         f"(got {q.dtype}, {kpool.dtype}, {vpool.dtype})")
    for t in (ppos, block_tables, q_pos):
        if t.dtype != torch.int32:
            raise ValueError("positions and block tables must be int32")
    P, page, Hkv, D = kpool.shape
    Dv = vpool.shape[3]
    Hq = q.shape[2]
    if vpool.shape[:3] != kpool.shape[:3] or ppos.shape != (P, page):
        raise ValueError("kpool/vpool/ppos disagree on (P, page, Hkv)")
    if quant and not (k_scale.dtype == v_scale.dtype == torch.float32
                      and k_scale.shape == v_scale.shape == (P, page, Hkv)):
        raise ValueError("k_scale/v_scale must be fp32 (P, page, Hkv)")
    if q.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools with "
                         f"Hkv={Hkv}, D={D}")
    for n, v in (("D", D), ("Dv", Dv)):
        if v % 8 or not 0 < v <= MAX_HEAD_DIM:
            raise ValueError(f"{n}={v}: head dims must be multiples of 8 "
                             f"up to {MAX_HEAD_DIM}")
    if page % 8:
        raise ValueError(f"page size {page} must be a multiple of 8")
    return Hq, Hkv, D, Dv, page


def _check_smem(lib, rows: int, D: int, Dv: int):
    if lib.paged_attention_smem_bytes(rows, D, Dv) > _SMEM_LIMIT:
        raise ValueError(f"{rows} query rows at D={D}, Dv={Dv} need more "
                         f"shared memory than a block has")


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _softcap_window(attn_softcap, window):
    return (float(attn_softcap) if attn_softcap is not None else 0.0,
            int(window) if window is not None else 0)


def _pool_ptrs(kpool, vpool, k_scale, v_scale):
    """The pool arguments of a launch: (kpool, vpool), or (kpool, k_scale,
    vpool, v_scale) for the _q8 entry points."""
    if k_scale is None:
        return kpool.data_ptr(), vpool.data_ptr()
    return (kpool.data_ptr(), k_scale.data_ptr(), vpool.data_ptr(),
            v_scale.data_ptr())


def _decode(q, kpool, vpool, ppos, block_tables, q_pos, k_scale, v_scale,
            window, scale, attn_softcap, name):
    from repro_torch.kernels import build
    Hq, Hkv, D, Dv, page = _check_common(q, kpool, vpool, ppos,
                                         block_tables, q_pos, k_scale,
                                         v_scale)
    B = q.shape[0]
    if q.shape[1] != 1 or block_tables.shape[0] != B \
            or q_pos.shape != (B, 1):
        raise ValueError("decode attention takes q (B,1,Hq,D), "
                         "block_tables (B,npages) and q_pos (B,1)")
    lib = build.load()
    g, npages = Hq // Hkv, block_tables.shape[1]
    tiles = mixed_row_tiles(1, g)
    if q.dtype == torch.float32:              # the CUDA-core body
        _check_smem(lib, g, D, Dv)
        splits, pps = 1, max(npages, 1)
    else:                                     # the tensor-core body
        splits, pps = _mma_splits(q, kpool, vpool, B, tiles, Hkv, npages)
    out = torch.empty((B, 1, Hq, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bufs = _split_buffers(q.device, stream, B, tiles, Hkv, splits, Dv)
    cap, win = _softcap_window(attn_softcap, window)
    pools = _pool_ptrs(kpool, vpool, k_scale, v_scale)
    fn = (lib.paged_decode_attention_launch if k_scale is None
          else lib.paged_decode_attention_q8_launch)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *pools, ppos.data_ptr(),
                 block_tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in bufs),
                 _DTYPE_CODES[q.dtype], B, Hq, Hkv, D, Dv, page, npages,
                 splits, pps, float(scale), cap, win, stream)
    _raise_on(lib, err, name)
    return out


def _mixed(q, kpool, vpool, ppos, block_tables, q_pos, k_scale, v_scale,
           window, scale, attn_softcap, name):
    from repro_torch.kernels import build
    Hq, Hkv, D, Dv, page = _check_common(q, kpool, vpool, ppos,
                                         block_tables, q_pos, k_scale,
                                         v_scale)
    B, W = q.shape[:2]
    if block_tables.shape[0] != B or q_pos.shape != (B, W):
        raise ValueError("mixed attention takes q (B,W,Hq,D), "
                         "block_tables (B,npages) and q_pos (B,W)")
    lib = build.load()
    g, npages = Hq // Hkv, block_tables.shape[1]
    tiles = mixed_row_tiles(W, g)
    if q.dtype == torch.float32:              # the CUDA-core body
        _check_smem(lib, min(W, PACKED_BLOCK_Q) * g, D, Dv)
        splits, pps = 1, max(npages, 1)
    else:                                     # the tensor-core body
        splits, pps = _mma_splits(q, kpool, vpool, B, tiles, Hkv, npages)
    out = torch.empty((B, W, Hq, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bufs = _split_buffers(q.device, stream, B, tiles, Hkv, splits, Dv)
    cap, win = _softcap_window(attn_softcap, window)
    pools = _pool_ptrs(kpool, vpool, k_scale, v_scale)
    fn = (lib.paged_mixed_attention_launch if k_scale is None
          else lib.paged_mixed_attention_q8_launch)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *pools, ppos.data_ptr(),
                 block_tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in bufs),
                 _DTYPE_CODES[q.dtype], B, W, Hq, Hkv, D,
                 Dv, page, npages, splits, pps, float(scale), cap, win,
                 stream)
    _raise_on(lib, err, name)
    return out


def _packed(q, kpool, vpool, ppos, block_tables, q_pos, meta, k_scale,
            v_scale, window, scale, attn_softcap, name):
    from repro_torch.kernels import build
    Hq, Hkv, D, Dv, page = _check_common(q, kpool, vpool, ppos,
                                         block_tables, q_pos, k_scale,
                                         v_scale)
    T = q.shape[1]
    if q.shape[0] != 1 or q_pos.shape != (1, T):
        raise ValueError("packed attention takes q (1,T,Hq,D) and "
                         "q_pos (1,T)")
    if not (meta.is_cuda and meta.device == q.device and meta.is_contiguous()
            and meta.dtype == torch.int32 and meta.dim() == 2
            and meta.shape[1] == 4):
        raise ValueError("meta must be a contiguous (n_work, 4) int32 CUDA "
                         "tensor on q's device")
    lib = build.load()
    n_work, npages = meta.shape[0], block_tables.shape[1]
    plan = packed_plan(n_work, Hkv, Hq // Hkv, npages, q.dtype,
                       scratch.sm_count(q.device.index))
    if plan.body == "simt":
        _check_smem(lib, PACKED_BLOCK_Q * (Hq // Hkv), D, Dv)
    else:
        _check_aligned(q, kpool, vpool)
    out = torch.zeros((1, T, Hq, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bufs = _split_buffers(q.device, stream, n_work, plan.row_tiles, Hkv,
                          plan.splits, Dv)
    cap, win = _softcap_window(attn_softcap, window)
    pools = _pool_ptrs(kpool, vpool, k_scale, v_scale)
    fn = (lib.paged_packed_attention_launch if k_scale is None
          else lib.paged_packed_attention_q8_launch)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *pools, ppos.data_ptr(),
                 block_tables.data_ptr(), q_pos.data_ptr(), meta.data_ptr(),
                 out.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in bufs),
                 _DTYPE_CODES[q.dtype], n_work, Hq, Hkv, D, Dv, page, npages,
                 plan.splits, plan.pages_per_split, float(scale), cap, win,
                 stream)
    _raise_on(lib, err, name)
    return out


def paged_decode_attention(q, kpool, vpool, ppos, block_tables, q_pos, *,
                           window: Optional[int], scale: float,
                           attn_softcap: Optional[float] = None):
    """Decode attention over a paged KV pool, on the card.

    q: (B,1,Hq,D); kpool/vpool: (P,page,Hkv,D[v]) at q's dtype; ppos:
    (P,page) int32 absolute positions (-1 empty); block_tables:
    (B,npages) int32 physical page ids with -1 = unallocated; q_pos:
    (B,1) int32.  Keys are visible when ``0 <= kp <= q_pos`` (and
    ``kp > q_pos - window`` with a window); a row with no visible key
    returns zeros.  Returns (B,1,Hq,Dv) at q's dtype.
    """
    out = _decode(q, kpool, vpool, ppos, block_tables, q_pos, None, None,
                  window, scale, attn_softcap, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_q8(q, kpool, k_scale, vpool, v_scale, ppos,
                              block_tables, q_pos, *,
                              window: Optional[int], scale: float,
                              attn_softcap: Optional[float] = None):
    """:func:`paged_decode_attention` over an int8 pool: kpool/vpool are
    (P,page,Hkv,D[v]) int8 codes, k_scale/v_scale (P,page,Hkv) fp32
    per-entry scales.  q and the output stay at q's dtype."""
    out = _decode(q, kpool, vpool, ppos, block_tables, q_pos, k_scale,
                  v_scale, window, scale, attn_softcap,
                  "paged_decode_attention_q8")
    paged_decode_attention_q8.launches += 1
    return out


def paged_packed_attention(q, kpool, vpool, ppos, block_tables, q_pos,
                           meta, *, window: Optional[int], scale: float,
                           attn_softcap: Optional[float] = None):
    """Token-packed ragged attention over a paged KV pool, on the card.

    q: (1, T, Hq, D) flat token stream; q_pos: (1, T) int32 absolute
    positions (-1 = padding lane); block_tables: (slots, npages) int32;
    meta: (n_work, 4) int32 work table from :func:`packed_meta_table`.
    The stream's own K/V must already be in the pool.  Each work row
    writes only its own lanes, and the output starts as zeros, so padding
    lanes (owned by no row) come back as zeros.
    """
    out = _packed(q, kpool, vpool, ppos, block_tables, q_pos, meta, None,
                  None, window, scale, attn_softcap, "paged_packed_attention")
    paged_packed_attention.launches += 1
    return out


def paged_packed_attention_q8(q, kpool, k_scale, vpool, v_scale, ppos,
                              block_tables, q_pos, meta, *,
                              window: Optional[int], scale: float,
                              attn_softcap: Optional[float] = None):
    """:func:`paged_packed_attention` over an int8 pool (the scale-pool
    contract of :func:`paged_decode_attention_q8`)."""
    out = _packed(q, kpool, vpool, ppos, block_tables, q_pos, meta, k_scale,
                  v_scale, window, scale, attn_softcap,
                  "paged_packed_attention_q8")
    paged_packed_attention_q8.launches += 1
    return out


def paged_mixed_attention(q, kpool, vpool, ppos, block_tables, q_pos, *,
                          window: Optional[int], scale: float,
                          attn_softcap: Optional[float] = None):
    """Multi-query paged attention over per-slot windows, on the card.

    q: (B, W, Hq, D), lane w of row b a query of slot b at absolute
    position ``q_pos[b, w]`` (int32, -1 = padding lane); block_tables:
    (B, npages).  The window's own K/V must already be in the pool: the
    stored positions then give every lane its exact causal mask inside
    the window.  Padding lanes come back as zeros.  Returns (B, W, Hq, Dv)
    at q's dtype.
    """
    out = _mixed(q, kpool, vpool, ppos, block_tables, q_pos, None, None,
                 window, scale, attn_softcap, "paged_mixed_attention")
    paged_mixed_attention.launches += 1
    return out


def paged_mixed_attention_q8(q, kpool, k_scale, vpool, v_scale, ppos,
                             block_tables, q_pos, *,
                             window: Optional[int], scale: float,
                             attn_softcap: Optional[float] = None):
    """:func:`paged_mixed_attention` over an int8 pool (the scale-pool
    contract of :func:`paged_decode_attention_q8`)."""
    out = _mixed(q, kpool, vpool, ppos, block_tables, q_pos, k_scale,
                 v_scale, window, scale, attn_softcap,
                 "paged_mixed_attention_q8")
    paged_mixed_attention_q8.launches += 1
    return out


def decode_attention(q, k, v, k_pos, q_pos, *, window: Optional[int],
                     scale: float, attn_softcap: Optional[float] = None):
    """Single-query attention against a contiguous cache, on the card.

    q: (B,1,Hq,D); k: (B,Sk,Hkv,D) and v: (B,Sk,Hkv,Dv) at q's dtype;
    k_pos: (B,Sk) int32 absolute positions (-1 = invalid); q_pos: (B,1)
    int32.  A key is visible when ``0 <= kp <= q_pos`` (and ``kp > q_pos
    - window`` with a window); a row with no visible key returns zeros.
    Any Sk is taken.  Returns (B,1,Hq,Dv) at q's dtype.
    """
    from repro_torch.kernels import build
    tensors = (q, k, v, k_pos, q_pos)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA decode-attention kernel takes CUDA "
                         "tensors only (CPU tensors go to the plain version "
                         "through repro_torch.kernels.ops)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode attention needs contiguous inputs")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v must share one of fp32, fp16, bf16 (got "
                         f"{q.dtype}, {k.dtype}, {v.dtype})")
    if k_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError("k_pos and q_pos must be int32")
    B, _, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.shape[1] != 1 or k.shape != (B, Sk, Hkv, D) \
            or v.shape[:3] != (B, Sk, Hkv) or k_pos.shape != (B, Sk) \
            or q_pos.shape != (B, 1) or Hq % Hkv or Sk < 1:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)} must be "
                         f"(B,1,Hq,D); k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, k_pos {tuple(k_pos.shape)}, "
                         f"q_pos {tuple(q_pos.shape)}")
    for n, d in (("D", D), ("Dv", Dv)):
        if d % 8 or not 0 < d <= MAX_HEAD_DIM:
            raise ValueError(f"{n}={d}: head dims must be multiples of 8 "
                             f"up to {MAX_HEAD_DIM}")
    lib = build.load()
    plan = dense_decode_plan(
        B, Hkv, Hq // Hkv, Sk, q.dtype,
        not any(t.data_ptr() % 16 for t in (q, k, v)),
        scratch.sm_count(q.device.index))
    if plan.body == "simt":
        _check_smem(lib, Hq // Hkv, D, Dv)
    out = torch.empty((B, 1, Hq, Dv), dtype=q.dtype, device=q.device)
    cap, win = _softcap_window(attn_softcap, window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if plan.body == "simt":
            err = lib.decode_attention_launch(
                *ptrs, _DTYPE_CODES[q.dtype], B, Hq, Hkv, D, Dv, Sk,
                float(scale), cap, win, stream)
        else:
            ws = counters = None              # kept alive over the launch
            if plan.splits > 1:
                ws = scratch.split_scratch(
                    q.device, stream, dense_scratch_floats(B, Hkv, plan, Dv))
                counters = scratch.split_counters(q.device, stream,
                                                  B * Hkv * plan.row_tiles)
            err = lib.dense_decode_mma_launch(
                *ptrs, *(None if t is None else t.data_ptr()
                         for t in (ws, counters)),
                _DTYPE_CODES[q.dtype], B, Hq, Hkv, D, Dv, Sk, plan.splits,
                plan.keys_per_split, float(scale), cap, win, stream)
    _raise_on(lib, err, "decode_attention")
    decode_attention.launches += 1
    return out


KERNELS = (paged_decode_attention, paged_packed_attention,
           paged_decode_attention_q8, paged_packed_attention_q8,
           paged_mixed_attention, paged_mixed_attention_q8,
           decode_attention)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
